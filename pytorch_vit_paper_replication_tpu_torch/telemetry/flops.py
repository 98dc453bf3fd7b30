"""Analytic ViT training-step FLOP math and the cards' peak rates — one copy
(port of the JAX package's ``telemetry/flops.py``).

The live ``tel_mfu`` gauge (:mod:`.spans`) and ``chip_smoke.py``'s bounds
read the same numbers from here.

Convention (the JAX package's): FLOPs = 2 x MACs over every matmul,
backward ~ 2x forward (dL/dW and dL/dx each cost one forward-sized matmul
per layer) -> x3 total; remat recompute is NOT counted — this is model
FLOPs (the MFU numerator convention), not hardware FLOPs.

The MFU denominator is the card's bf16 dense tensor peak (the port trains
in bf16 with f32 params); :func:`peaks` finds it by the card's name
(``torch.cuda.get_device_name``) and returns None for a card the table
lacks — the gauge is then left out, never computed against a made-up
peak.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peaks(NamedTuple):
    """A card's published dense peak rates at its full power limit."""

    bf16_flops: float     # tensor-core bf16 FLOP/s
    f32_flops: float      # non-tensor f32 FLOP/s
    hbm_bytes: float      # device-memory bytes/s


# NVIDIA data sheets, dense, at the full power limit. Matched by substring
# of the card's name, in this order ("H100 PCIe" before "H100").
PEAKS = {
    "H100 PCIe": Peaks(756e12, 51e12, 2.0e12),
    "H200": Peaks(989e12, 67e12, 4.8e12),
    "H100": Peaks(989e12, 67e12, 3.35e12),
}


def peaks(card_name: str) -> Optional[Peaks]:
    """The peak rates of the card named ``card_name``, None when the
    table has no entry for it."""
    for key, val in PEAKS.items():
        if key in card_name:
            return val
    return None


def bf16_peak_tflops(card_name: str) -> Optional[float]:
    """The MFU denominator of a card, in TFLOP/s (None when unknown)."""
    p = peaks(card_name)
    return None if p is None else p.bf16_flops / 1e12


def train_step_flops_per_image(cfg) -> float:
    """Analytic FLOPs of one training step, per image, for a ViT config
    (anything with ``seq_len``/``embedding_dim``/``mlp_size``/
    ``num_layers``/``patch_size``/``color_channels``/``num_patches``/
    ``num_classes`` — :class:`..configs.ViTConfig`)."""
    t, d, m, l = cfg.seq_len, cfg.embedding_dim, cfg.mlp_size, cfg.num_layers
    p, c = cfg.patch_size, cfg.color_channels
    patchify = 2 * cfg.num_patches * (p * p * c) * d
    per_layer = (
        2 * t * d * 3 * d          # qkv projection
        + 2 * t * t * d            # QK^T
        + 2 * t * t * d            # attn · V
        + 2 * t * d * d            # out projection
        + 2 * t * d * m            # fc1
        + 2 * t * m * d            # fc2
    )
    head = 2 * d * cfg.num_classes
    forward = patchify + l * per_layer + head
    return 3.0 * forward


def analytic_mfu(images_per_sec_per_card: float, flops_per_image: float,
                 peak_tflops: float) -> float:
    """Model-FLOPs utilization from a per-card image rate."""
    return images_per_sec_per_card * flops_per_image / 1e12 / peak_tflops
