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
                plain torch, as JAX leaves it to XLA. ``probs_dtype`` /
                ``residual_dtype`` other than ``"bf16"`` store the softmax
                weights (and/or the backward's residual) in an 8-bit
                format of :mod:`.quant` through
                :class:`_QuantizedSoftmaxPV` (JAX's
                ``_quantized_softmax_pv``, plain PyTorch as JAX leaves it
                to XLA).
* ``"flash"`` — the hand-written CUDA flash kernels
                (:mod:`.flash_attention`), masks and Tq != Tk included;
                their plain versions on CPU tensors.
* ``"auto"``  — flash on a CUDA tensor at T >= 197 whose head dim is one
                the kernels are built for (:func:`_flash_ok`), with or
                without a mask, else xla. The JAX package keeps its TPU
                rule (flash only when the materialized logits would not
                fit); on the H100 the flash B/16 train step took 12 ms
                less device time than the xla one at T = 197 (PERF.md
                section 5), so the port picks flash there.

Not ported yet (raises ``NotImplementedError`` naming the ROADMAP item):
sequence parallelism.
"""

from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Optional

import torch

from .dropout import dropout
from .flash_attention import KERNEL_HEAD_DIMS, flash_attention
from .quant import PROBS_DTYPES, dequantize_probs, quantize_probs

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


@functools.lru_cache(maxsize=None)
def _warn_once(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)


class _QuantizedSoftmaxPV(torch.autograd.Function):
    """``softmax(logits) @ v`` with the softmax weights stored in
    ``probs_dtype`` and the backward's residual in ``residual_dtype``
    (:mod:`.quant` formats; "bf16" = the compute dtype): the JAX
    ``custom_vjp`` ``_quantized_softmax_pv``. ``logits32`` f32 ``[B, H,
    T, Tk]`` already scaled and masked, ``v`` ``[B, Tk, H, Dh]``; returns
    ``[B, T, H, Dh]`` in ``out_dtype``.

    The residual is the narrow tensor by construction, dequantized in the
    backward. With ``w = e / (sum e + eps)`` (either softmax) the vjp is
    ``dl = w * (dw - sum(dw * w))``; the saturating softmax's clamp gate
    (no gradient through logits past the clamp) cannot be recovered from
    the saved weights and passes through, as in JAX.
    """

    @staticmethod
    def forward(ctx, logits32, v, softmax: str, probs_dtype: str,
                residual_dtype: str, out_dtype: torch.dtype):
        w32 = _softmax32(logits32, softmax)
        if probs_dtype == "bf16":
            # Forward-exact storage; only the backward residual is narrow.
            w_pv = w32.to(out_dtype)
            wq = (w_pv if residual_dtype == "bf16"
                  else quantize_probs(w32, residual_dtype))
        else:
            wq_fwd = quantize_probs(w32, probs_dtype)
            w_pv = dequantize_probs(wq_fwd, probs_dtype, out_dtype)
            if residual_dtype == probs_dtype:
                wq = wq_fwd
            elif residual_dtype == "bf16":
                wq = w32.to(out_dtype)
            else:
                wq = quantize_probs(w32, residual_dtype)
        ctx.save_for_backward(wq, v)
        ctx.residual_dtype, ctx.out_dtype = residual_dtype, out_dtype
        return torch.einsum("bhqk,bkhd->bqhd", w_pv, v)

    @staticmethod
    def backward(ctx, g):
        wq, v = ctx.saved_tensors
        w = (wq if ctx.residual_dtype == "bf16"
             else dequantize_probs(wq, ctx.residual_dtype, ctx.out_dtype))
        # The products in the compute dtype, as JAX's AD path.
        g = g.to(ctx.out_dtype)
        dv = torch.einsum("bhqk,bqhd->bkhd", w, g)
        dw = torch.einsum("bqhd,bkhd->bhqk", g, v)
        w32, dw32 = w.float(), dw.float()
        dl = w32 * (dw32 - (dw32 * w32).sum(-1, keepdim=True))
        return dl, dv, None, None, None, None


def _xla_attention(q, k, v, *, dropout_rate: float = 0.0,
                   seed: Optional[int] = None,
                   deterministic: bool = True, mask=None,
                   softmax: str = "saturating", probs_dtype: str = "bf16",
                   residual_dtype: Optional[str] = None) -> torch.Tensor:
    """Materialized-logits attention, shapes ``[B, T, H, Dh]``.

    ``probs_dtype`` / ``residual_dtype``: storage of the softmax weights
    and of the backward's residual (``residual_dtype=None`` follows
    ``probs_dtype``); anything other than ``"bf16"`` goes through
    :class:`_QuantizedSoftmaxPV`. Quantized storage does not compose with
    attention dropout (the 1/keep rescale leaves [0, 1]): such calls warn
    once and store in bf16, as in JAX.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    logits = logits * torch.tensor(scale, dtype=logits.dtype)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.finfo(logits.dtype).min)
    logits32 = logits.float()
    rd = residual_dtype if residual_dtype is not None else probs_dtype
    quantized = probs_dtype != "bf16" or rd != "bf16"
    if quantized and not deterministic and dropout_rate > 0.0:
        _warn_once(
            "attention probs quantization (attention_probs_dtype/"
            "attention_probs_residual_dtype) does not compose with "
            "attention dropout: the 1/keep rescale exceeds the [0,1] "
            "packing range; using bf16 storage for dropout calls")
        quantized = False
    if quantized:
        return _QuantizedSoftmaxPV.apply(logits32, v, softmax, probs_dtype,
                                         rd, q.dtype)
    weights = _softmax32(logits32, softmax)
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
