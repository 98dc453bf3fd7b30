"""Pack/unpack of the 8-bit storage formats of the attention probs.

Port of the JAX package's ``ops/quant.py``. The tensor these serve is the
xla attention path's materialized softmax weights (``ops/attention.py``):
values in [0, 1], ``[B, H, T, T]``, the largest tensor of a ViT train step
at short sequence lengths. Storing them (and/or their backward residual)
in 8 bits halves its bytes; :func:`.attention._quantized_softmax_pv` is
the attention core that does it.

Storage formats (the ``ViTConfig.attention_probs_dtype`` axis):

* ``"bf16"``     — no quantization: the compute dtype (f32 for f32
                   models; the name keeps the JAX package's spelling).
* ``"fp8_e4m3"`` — ``torch.float8_e4m3fn`` (4 exponent / 3 mantissa bits,
                   no inf); values below 2^-6 go subnormal.
* ``"fp8_e5m2"`` — ``torch.float8_e5m2``: coarser, more range.
* ``"u8"``       — fixed point ``round(w * 255)`` in ``torch.uint8``, ties
                   to even as ``jnp.round``: 256 levels over exactly [0, 1].

Dequantization runs in f32 (``u8``'s 1/255 is not a power of two), then
casts to the compute dtype.
"""

from __future__ import annotations

import torch

# The ViTConfig.attention_probs_dtype axis. "bf16" means "compute dtype,
# unquantized".
PROBS_DTYPES = ("bf16", "fp8_e4m3", "fp8_e5m2", "u8")

_STORAGE = {
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "u8": torch.uint8,
}


def storage_dtype(name: str) -> torch.dtype:
    """The stored dtype of an 8-bit format (``"bf16"`` has none: it
    follows the compute dtype)."""
    return _STORAGE[name]


def storage_bits(name: str) -> int:
    """Bits per element a format stores (16 for the unquantized path)."""
    return 16 if name == "bf16" else 8


def probs_tensor_mb(batch: int, heads: int, seq: int, name: str) -> float:
    """MB of one materialized ``[B, H, T, T]`` attention-probs tensor in
    storage format ``name``."""
    return batch * heads * seq * seq * storage_bits(name) / 8 / 1e6


def quantize_probs(w: torch.Tensor, name: str) -> torch.Tensor:
    """Pack probabilities (f32 values in [0, 1]) into storage ``name``;
    ``"bf16"`` is a plain cast to bfloat16."""
    if name == "bf16":
        return w.to(torch.bfloat16)
    if name == "u8":
        # 0.0 -> 0, 1.0 -> 255; the clip guards values a dropout rescale
        # pushed past 1.
        return torch.round(w.float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    return w.float().to(_STORAGE[name])


def dequantize_probs(wq: torch.Tensor, name: str,
                     dtype: torch.dtype) -> torch.Tensor:
    """Unpack storage ``name`` to ``dtype`` through f32."""
    if name == "u8":
        return (wq.float() * (1.0 / 255.0)).to(dtype)
    return wq.float().to(dtype)
