"""Attention dispatch: one entry point, two execution paths.

Port of the JAX package's ``ops/attention.py::dot_product_attention``.
Operands are ``[batch, seq, heads, head_dim]`` (the JAX layout):

* ``"xla"``   — :func:`_xla_attention`, the materialized-logits path in
                plain PyTorch with the JAX path's rounding points: logits
                stored in the compute dtype and scaled in that dtype, an f32
                softmax (saturating or exact), weights cast to the compute
                dtype before the ``P @ V`` product (left to ``torch.matmul``
                as the JAX package leaves it to XLA). Training-mode dropout
                applies to the f32 weights before the cast, with uint8 bits
                from a generator seeded by ``seed``; autograd runs through
                plain torch, as JAX leaves it to XLA.
* ``"flash"`` — the hand-written CUDA flash kernel
                (:mod:`.flash_attention`); its plain version on CPU tensors.
* ``"auto"``  — flash on a CUDA tensor at T >= 197 whose head dim is one
                the kernels are built for (:func:`_flash_ok`), else xla.
                The JAX package keeps its TPU rule (flash only when the
                materialized logits would not fit); on the H100 the flash
                B/16 train step took 12 ms less device time than the xla
                one at T = 197 (PERF.md section 5), so the port picks
                flash there.

Not ported yet (raise ``NotImplementedError`` naming the ROADMAP item):
sequence parallelism, 8-bit softmax storage (``probs_dtype`` other than
``"bf16"``), flash masks.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..configs import PROBS_DTYPES
from .dropout import dropout
from .flash_attention import KERNEL_HEAD_DIMS, flash_attention

# auto picks flash on the card from this sequence length (ViT at 224 px).
_FLASH_MIN_SEQ = 197
_SOFTMAX_SHIFT = 16.0
_SOFTMAX_CLAMP = 80.0


@contextlib.contextmanager
def sequence_parallel(*args, **kwargs):
    """The JAX package routes attention through ring/Ulysses attention
    inside this context; the port has no sequence parallelism yet."""
    raise NotImplementedError(
        "sequence-parallel attention is not ported yet (ROADMAP Queue 1, "
        "parallelism slice)")
    yield  # pragma: no cover


def _softmax32(logits32: torch.Tensor, softmax: str) -> torch.Tensor:
    """The xla path's f32 softmax over ``[B, H, T, Tk]`` logits."""
    if softmax == "exact":
        m = logits32.amax(-1, keepdim=True)
        e = torch.exp(logits32 - m)
        return e / e.sum(-1, keepdim=True)
    e = torch.exp(torch.clamp(logits32 - _SOFTMAX_SHIFT, max=_SOFTMAX_CLAMP))
    return e / (e.sum(-1, keepdim=True) + 1e-35)


def _xla_attention(q, k, v, *, dropout_rate: float = 0.0,
                   seed: Optional[int] = None,
                   deterministic: bool = True, mask=None,
                   softmax: str = "saturating", probs_dtype: str = "bf16",
                   residual_dtype: Optional[str] = None) -> torch.Tensor:
    """Materialized-logits attention, shapes ``[B, T, H, Dh]``."""
    if probs_dtype != "bf16" or residual_dtype not in (None, "bf16"):
        raise NotImplementedError(
            "8-bit attention-probs storage is not ported yet (ROADMAP "
            "Queue 1, model slice: _quantized_softmax_pv)")
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits * torch.tensor(scale, dtype=logits.dtype)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    weights = _softmax32(logits.float(), softmax)
    if not deterministic and dropout_rate > 0.0:
        if seed is None:
            raise ValueError("attention dropout needs a seed")
        gen = torch.Generator(device=q.device).manual_seed(seed)
        weights = dropout(weights, dropout_rate, gen)
    weights = weights.to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _flash_ok(q: torch.Tensor) -> bool:
    """auto-mode: the flash kernel for a CUDA tensor of at least
    ``_FLASH_MIN_SEQ`` tokens and a head dim the kernels are built for
    (others, such as ViT-H/14's 80, run flash only when asked for)."""
    _, t, _, dh = q.shape
    return q.is_cuda and t >= _FLASH_MIN_SEQ and dh in KERNEL_HEAD_DIMS


def dot_product_attention(q, k, v, *, impl: str = "auto",
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None,
                          deterministic: bool = True, mask=None,
                          heads_already_local: bool = False,
                          softmax: str = "saturating",
                          probs_dtype: str = "bf16",
                          residual_dtype: Optional[str] = None
                          ) -> torch.Tensor:
    """Multi-head scaled dot-product attention over ``[B, T, H, Dh]``.

    Same contract as the JAX function; ``seed`` replaces the JAX
    ``dropout_rng``: the int32 positional-hash seed of the flash path, the
    seed of the dropout generator on the xla path.
    ``heads_already_local`` only matters under sequence parallelism and is
    accepted for signature parity.
    """
    del heads_already_local
    if impl not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if probs_dtype not in PROBS_DTYPES:
        raise ValueError(f"unknown probs_dtype {probs_dtype!r}; "
                         f"expected one of {PROBS_DTYPES}")
    if residual_dtype is not None and residual_dtype not in PROBS_DTYPES:
        raise ValueError(f"unknown residual_dtype {residual_dtype!r}; "
                         f"expected one of {PROBS_DTYPES}")
    if impl == "flash" or (impl == "auto" and _flash_ok(q)):
        return flash_attention(q, k, v, mask=mask,
                               dropout_rate=dropout_rate, seed=seed,
                               deterministic=deterministic)
    return _xla_attention(q, k, v, dropout_rate=dropout_rate, seed=seed,
                          deterministic=deterministic, mask=mask,
                          softmax=softmax, probs_dtype=probs_dtype,
                          residual_dtype=residual_dtype)
