"""Host-side image transforms (numpy/PIL) for inference.

The eval and pretrained subset of the JAX package's ``data/transforms.py``
(copied; no augmentation, no native JPEG path): PIL stages first, then
**NHWC float32** numpy arrays in [0,1], optionally ImageNet-normalized —
the exact preprocessing the JAX package's predict/serve path applies, so
both packages feed their models identical pixels.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
from PIL import Image

# ImageNet statistics, as hardcoded in reference predictions.py:49-53.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Transform = Callable[[Image.Image], np.ndarray]


def to_array(img: Image.Image) -> np.ndarray:
    """PIL → float32 HWC in [0,1] (torchvision ``ToTensor`` minus the CHW
    transpose — the models take NHWC)."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr


class Resize:
    """Resize to (size, size) with bilinear interpolation."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        return img.resize((self.size, self.size), Image.BILINEAR)


class ResizeShorter:
    """Resize the SHORTER side to `size`, keeping aspect ratio — the
    torchvision ``Resize(int)`` semantics used by pretrained-weight
    transforms (reference main notebook cell 117)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if w <= h:
            new_w, new_h = self.size, max(1, round(h * self.size / w))
        else:
            new_w, new_h = max(1, round(w * self.size / h)), self.size
        return img.resize((new_w, new_h), Image.BILINEAR)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        s = self.size
        left, top = (w - s) // 2, (h - s) // 2
        return img.crop((left, top, left + s, top + s))


class Normalize:
    """Channel-wise (x - mean) / std on the float32 array."""

    def __init__(self, mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


class Compose:
    """Apply transforms in order; PIL stages first, then array stages."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img: Image.Image) -> np.ndarray:
        x = img
        for t in self.transforms:
            x = t(x)
        if isinstance(x, Image.Image):
            x = to_array(x)
        return x


def eval_transform(image_size: int = 224, normalize: bool = True) -> Compose:
    """Resize + [0,1] + ImageNet-normalize — the reference's prediction
    default (predictions.py:46-54)."""
    stages = [Resize(image_size), to_array]
    if normalize:
        stages.append(Normalize())
    return Compose(stages)


def pretrained_transform(image_size: int = 224,
                         resize_size: Optional[int] = None,
                         normalize: bool = True) -> Compose:
    """The pretrained-weights eval transform: resize shorter side, center
    crop, ImageNet normalize — what ``ViT_B_16_Weights.DEFAULT.transforms()``
    applies in the reference's transfer workflow (main notebook cells 110,
    117; SWAG@384 uses resize=crop=384, exercises cell 49)."""
    if resize_size is None:
        # torchvision's 256/224 ratio, e.g. 224->256; 384 stays 384 (SWAG).
        resize_size = image_size if image_size >= 384 else round(
            image_size * 256 / 224)
    stages = [ResizeShorter(resize_size), CenterCrop(image_size), to_array]
    if normalize:
        stages.append(Normalize())
    return Compose(stages)


def make_transform(image_size: int, *, pretrained: bool = False,
                   normalize: Optional[bool] = None,
                   resize_size: Optional[int] = None) -> Compose:
    """THE input-transform decision, shared by train and predict.

    ``normalize=None`` resolves to ``pretrained`` — fine-tuning pretrained
    weights must feed them the ImageNet-normalized distribution they were
    trained on, while scratch runs keep the
    reference notebooks' plain [0,1] inputs. Pretrained additionally uses
    resize-shorter + center-crop instead of squashing to square;
    ``resize_size`` overrides its shorter-side target (packed-shard runs
    record their pack size here so predict crops the identical region).
    """
    if normalize is None:
        normalize = pretrained
    if pretrained:
        return pretrained_transform(image_size, resize_size=resize_size,
                                    normalize=normalize)
    return eval_transform(image_size, normalize=normalize)
