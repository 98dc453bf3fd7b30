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

Sequence parallelism rides on top of the dispatch rather than on ``impl``,
as in JAX: inside :func:`sequence_parallel` (entered by
``parallel.api``'s steps when the mesh's ``seq`` axis is > 1) every
attention call goes through ring or Ulysses attention
(:mod:`..parallel.ring_attention`, :mod:`..parallel.ulysses`), whatever
``impl`` says. The operands there are the rank's shards (its data rows,
its token piece, its heads). Two cases fall back, each with JAX's
warning once per process, to the *gathered* xla path (every rank gathers
the whole sequence, runs :func:`_xla_attention` on it and keeps its
rows), as JAX falls back to its gathered XLA path: a mask; Ulysses with
heads not divisible by the seq axis. JAX's third, a batch or token count
not divisible by the mesh axes, cannot arise here: the operands are
already equal shards, and ``parallel.sharding.validate_sp_divisibility``
refuses such a configuration up front with JAX's message. Nothing else
falls back, and a CUDA tensor stays on its card.
"""

from __future__ import annotations

import contextlib
import functools
import threading
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


# --- sequence-parallel context --------------------------------------------

_SP = threading.local()


@contextlib.contextmanager
def sequence_parallel(mesh, *, data_axis: str = "data",
                      seq_axis: str = "seq", model_axis: str = "model",
                      sp_impl: str = "ring"):
    """Route attention through sequence parallelism while active.

    ``mesh`` is this rank's :class:`..parallel.mesh.Mesh`; with its
    ``seq_axis`` > 1, :func:`dot_product_attention` takes the rank's
    shards and runs ``sp_impl``: ``"ring"`` (K/V rotate around the ring,
    ``O(T T_local)`` memory) or ``"ulysses"`` (two all-to-alls re-shard
    tokens to heads; needs heads divisible by the seq axis; see
    ``parallel/ulysses.py``). Entered by ``parallel.api``'s train and eval
    steps around the forward and backward (autograd's backward calls the
    collectives' own backward, which needs no context).
    """
    if sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}")
    prev = getattr(_SP, "ctx", None)
    _SP.ctx = (mesh, data_axis, seq_axis, model_axis, sp_impl)
    try:
        yield
    finally:
        _SP.ctx = prev


def _sp_context():
    ctx = getattr(_SP, "ctx", None)
    if ctx is None or ctx[0].shape.get(ctx[2], 1) <= 1:
        return None
    return ctx


def _sp_attention(q, k, v, ctx, *, heads_local: bool, dropout_rate=0.0,
                  seed=None, deterministic=True):
    """Ring or Ulysses attention over the seq axis (per the context's
    ``sp_impl``). The batch is sharded over the data axis, and the heads
    over the model axis when ``heads_local`` (a size-1 axis shards
    nothing), so one call serves dp x tp x sp meshes; attention dropout
    runs inside either strategy on the positional hash."""
    from ..parallel.ring_attention import make_ring_attention
    from ..parallel.ulysses import make_ulysses_attention

    mesh, data_axis, seq_axis, model_axis, sp_impl = ctx
    make = (make_ulysses_attention if sp_impl == "ulysses"
            else make_ring_attention)
    fn = make(mesh, seq_axis, data_axis=data_axis,
              head_axis=model_axis if heads_local else None,
              dropout_rate=dropout_rate, dropout_seed=seed,
              deterministic=deterministic)
    return fn(q, k, v)


def _gathered_attention(q, k, v, ctx, *, heads_local: bool,
                        **xla_kwargs):
    """The gathered fallback: every rank gathers the whole token axis of
    ``q``, ``k`` and ``v`` (one exchange, stacked), runs
    :func:`_xla_attention` over it (a ``mask`` broadcasts to ``[B, H, T,
    T]`` in global token coordinates) and keeps its own rows. The dropout
    bits are drawn from the seed for the whole ``[B, H, T, T]`` of the
    unsharded call, and the rank keeps its block of them (its data rows,
    and its model slice of the heads when ``heads_local``): the rows are
    those of the unsharded call on every data and model coordinate."""
    from ..parallel.collectives import all_gather_tokens

    mesh, data_axis, seq_axis, model_axis, _ = ctx
    b, t, h = q.shape[:3]
    g = all_gather_tokens(torch.stack([q, k, v]), mesh.groups[seq_axis], 2)
    n_model = mesh.shape.get(model_axis, 1) if heads_local else 1
    window = (b * mesh.shape.get(data_axis, 1), h * n_model,
              b * mesh.coords.get(data_axis, 0),
              h * mesh.coords.get(model_axis, 0) if heads_local else 0)
    out = _xla_attention(g[0], g[1], g[2], dropout_window=window,
                         **xla_kwargs)
    return out.narrow(1, t * mesh.coords[seq_axis], t)


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
                   residual_dtype: Optional[str] = None,
                   dropout_window: Optional[tuple] = None) -> torch.Tensor:
    """Materialized-logits attention, shapes ``[B, T, H, Dh]``.

    ``dropout_window`` ``(B_all, H_all, b_off, h_off)``: the operands are
    the block at those offsets of a ``[B_all, T, H_all, Dh]`` call, whose
    dropout bits are drawn and this block's kept (the gathered fallback);
    None draws bits for the operands' own shape.

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
        window = None
        if dropout_window is not None:
            b_all, h_all, b_off, h_off = dropout_window
            window = ((b_all, h_all, *weights.shape[2:]),
                      (b_off, h_off, 0, 0))
        weights = dropout(weights, dropout_rate, gen, window=window)
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
    ``dropout_rng``: the int32 positional-hash seed of the flash, ring and
    Ulysses paths, the seed of the dropout generator on the xla path.

    Inside :func:`sequence_parallel` (seq axis > 1) the operands are the
    rank's shards and ``impl`` is not read: ring or Ulysses attention, or
    the gathered fallback (module docstring). ``heads_already_local`` says
    the operands hold the rank's ``model`` slice of the heads (a
    tensor-parallel block), which then offsets the dropout mask's head
    indices; else they hold every head. JAX divides a traced global head
    count by the model axis for the Ulysses check; here the check reads
    the heads the operands hold, which are the ones Ulysses splits.
    """
    if impl not in ("xla", "flash", "auto"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if probs_dtype not in PROBS_DTYPES:
        raise ValueError(f"unknown probs_dtype {probs_dtype!r}; "
                         f"expected one of {PROBS_DTYPES}")
    if residual_dtype is not None and residual_dtype not in PROBS_DTYPES:
        raise ValueError(f"unknown residual_dtype {residual_dtype!r}; "
                         f"expected one of {PROBS_DTYPES}")
    sp = _sp_context()
    if sp is not None:
        mesh, seq_axis, sp_impl = sp[0], sp[2], sp[4]
        h, seq_size = q.shape[2], mesh.shape[seq_axis]
        if mask is not None:
            _warn_once(
                "sequence_parallel: attention masks are not supported by "
                "ring/ulysses attention; using the (gathered) XLA path "
                "instead")
        elif sp_impl == "ulysses" and h % seq_size:
            _warn_once(
                f"sequence_parallel: sp_impl='ulysses' needs heads ({h}) "
                f"divisible by the seq axis ({seq_size}); using the "
                "(gathered) XLA path instead — or use sp_impl='ring'")
        else:
            return _sp_attention(q, k, v, sp,
                                 heads_local=heads_already_local,
                                 dropout_rate=dropout_rate, seed=seed,
                                 deterministic=deterministic)
        return _gathered_attention(
            q, k, v, sp, heads_local=heads_already_local,
            dropout_rate=dropout_rate, seed=seed,
            deterministic=deterministic, mask=mask, softmax=softmax,
            probs_dtype=probs_dtype, residual_dtype=residual_dtype)

    if impl == "flash" or (impl == "auto" and _flash_ok(q)):
        return flash_attention(q, k, v, mask=mask,
                               dropout_rate=dropout_rate, seed=seed,
                               deterministic=deterministic)
    return _xla_attention(q, k, v, dropout_rate=dropout_rate, seed=seed,
                          deterministic=deterministic, mask=mask,
                          softmax=softmax, probs_dtype=probs_dtype,
                          residual_dtype=residual_dtype)
