"""uint8-threshold dropout and the positional (counter-based) keep hash.

Torch port of the JAX package's ``ops/dropout.py``. The drop probability is
quantized to ``round(rate * 256) / 256`` and survivors are rescaled by the
quantized keep probability, so the expectation is exactly preserved.

:func:`positional_keep_u8` is THE definition of the positional mask that
both CUDA kernels (``csrc/vit_common.cuh``) evaluate in native ``uint32``:
an element's keep bit is a pure hash of ``(seed, tag, row, col)``, so any
kernel, block order or device regenerates the identical mask. Torch has no
full ``uint32`` arithmetic on the CPU, so the hash is emulated in ``int64``
with every product reduced ``& 0xFFFFFFFF`` (a 32x32-bit product is split
into 16-bit halves so it never leaves the int64 range).

Randomness comes from explicit ``torch.Generator``s. :func:`dropout` draws
uint8 bits from one and keeps JAX's threshold compare; the bits differ from
JAX's threefry stream (same statistics, different numbers), so the tests
compare it by statistics. :func:`derive_positional_seed` draws the int32
seed of the positional hash, the counterpart of the JAX function of that
name.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch
from torch import nn

_MASK32 = 0xFFFFFFFF


def _threshold(rate: float) -> int:
    """uint8 compare threshold for ``rate``; validates the range.

    Rates in (255.5/256, 1) clamp to 255 — the largest representable drop
    probability below 1 — rather than overflowing the uint8 compare.
    """
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
    t = min(round(rate * 256), 255)
    if rate > 0.0 and t == 0:
        warnings.warn(
            f"dropout rate {rate} quantizes to 0/256 — dropout is a no-op",
            stacklevel=3)
    return t


def quantized_rate(rate: float) -> float:
    """The effective drop probability after uint8 quantization."""
    if rate == 1.0:
        return 1.0
    return _threshold(rate) / 256.0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, without leaving the int64 range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def avalanche_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style integer avalanche mix on uint32 values held in an
    int64 tensor (in and out in [0, 2**32))."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def positional_keep_u8(seed, bh, row, col, threshold: int) -> torch.Tensor:
    """Keep/drop bit keyed on global element coordinates:
    ``uint8 hash(seed, bh, row, col) >= threshold``.

    ``seed``/``bh``/``row``/``col`` are integers or integer tensors that
    broadcast together; returns a bool tensor of the broadcast shape.
    Bit-equal to the JAX package's function, including the wraparound of
    every 32-bit product.
    """
    def u32(v):
        return torch.as_tensor(v, dtype=torch.int64) & _MASK32

    x = (u32(seed) + _mul32(u32(row), 0x9E3779B1)
         + _mul32(u32(col), 0x85EBCA77)
         + _mul32((1 + u32(bh)) & _MASK32, 0xC2B2AE3D)) & _MASK32
    return (avalanche_u32(x) & 0xFF) >= threshold


def derive_positional_seed(generator: torch.Generator) -> int:
    """An int32 seed for :func:`positional_keep_u8`, drawn from
    ``generator``."""
    return int(torch.randint(-2**31, 2**31, (1,), generator=generator,
                             device=generator.device))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            window: Optional[tuple] = None) -> torch.Tensor:
    """Functional dropout with a uint8-threshold mask.

    Drops with probability ``quantized_rate(rate)`` (``bits <
    round(rate * 256)`` on uint8 bits drawn from ``generator``, which must
    live on ``x``'s device) and rescales survivors by ``1 / (1 - t/256)``
    cast to ``x.dtype``, so the expectation is preserved. ``rate = 1``
    drops everything. ``window`` ``(shape, offsets)``: ``x`` is the block
    at ``offsets`` of a tensor of ``shape``; the bits are drawn for that
    whole shape and the block's kept, so each block of a sharded tensor
    drops what the whole tensor's call would.
    """
    if rate == 1.0:
        return torch.zeros_like(x)
    threshold = _threshold(rate)
    if threshold <= 0:
        return x
    shape, offsets = window if window is not None else (x.shape, None)
    bits = torch.randint(0, 256, shape, dtype=torch.uint8,
                         generator=generator, device=x.device)
    if offsets is not None:
        for d, (off, n) in enumerate(zip(offsets, x.shape)):
            bits = bits.narrow(d, off, n)
    scale = torch.tensor(1.0 / (1.0 - threshold / 256.0), dtype=x.dtype,
                         device=x.device)
    return torch.where(bits >= threshold, x * scale, x.new_zeros(()))


class Dropout(nn.Module):
    """The uint8-threshold dropout as a module: the identity when the
    module is not training or the rate quantizes to 0, else
    :func:`dropout` with the ``generator`` the caller passes."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if quantized_rate(self.rate) == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("training-mode Dropout needs a generator")
        return dropout(x, self.rate, generator)
