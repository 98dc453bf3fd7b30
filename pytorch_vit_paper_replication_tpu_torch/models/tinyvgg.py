"""TinyVGG baseline CNN (port of the JAX package's ``models/tinyvgg.py``).

Reference: ``going_modular/going_modular/model_builder.py:7-56``. The
params keep the Flax names and layouts (``block{b}_conv{c}.kernel [3, 3,
C_in, C_out]``, ``classifier.kernel [in, out]``), so a Flax tree converts
through :func:`..convert.params_from_flax`. Images are NHWC, as in the JAX
package, and the classifier reads the **NHWC** feature map flattened: a
flatten of the NCHW map would feed it the same numbers in another order.
The classifier's input size follows from ``image_size`` (the JAX module
infers it at init), so any input size of 16 px and up works.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .vit import _DTYPES


def feature_size(image_size: int) -> int:
    """Side of the feature map after two (conv 3x3 VALID x2, pool 2x2)
    blocks."""
    s = image_size
    for _ in range(2):
        s = (s - 4) // 2
    return s


class TinyVGG(nn.Module):
    """Two blocks of (Conv 3x3 VALID + ReLU) x2 then 2x2 max-pool, then a
    Linear classifier on the flattened features. The convs run in
    ``dtype``; the classifier in f32. ``forward`` takes the engine's
    ``(images, rng)`` call; TinyVGG has no dropout and ignores ``rng``."""

    def __init__(self, hidden_units: int = 10, num_classes: int = 3,
                 dtype: str = "float32", image_size: int = 64):
        super().__init__()
        self.dtype = _DTYPES[dtype]
        s = feature_size(image_size)
        if s < 1:
            raise ValueError(f"image_size {image_size} leaves no features "
                             "after two TinyVGG blocks (needs >= 16)")
        c_in = 3
        for b in range(2):
            for c in range(2):
                conv = nn.Module()
                conv.kernel = nn.Parameter(torch.zeros(3, 3, c_in,
                                                       hidden_units))
                conv.bias = nn.Parameter(torch.zeros(hidden_units))
                setattr(self, f"block{b}_conv{c}", conv)
                c_in = hidden_units
        self.classifier = nn.Module()
        self.classifier.kernel = nn.Parameter(
            torch.zeros(s * s * hidden_units, num_classes))
        self.classifier.bias = nn.Parameter(torch.zeros(num_classes))

    def forward(self, images: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        x = images.to(dt).permute(0, 3, 1, 2)           # NHWC -> NCHW
        for b in range(2):
            for c in range(2):
                conv = getattr(self, f"block{b}_conv{c}")
                x = F.relu(F.conv2d(x, conv.kernel.to(dt).permute(3, 2, 0, 1),
                                    conv.bias.to(dt)))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return x.float() @ self.classifier.kernel + self.classifier.bias
