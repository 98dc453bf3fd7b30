"""Flash attention as hand-written CUDA kernels (forward, dq, dk/dv).

Port of the JAX package's ``ops/flash_attention.py::flash_attention``.
Inputs are ``[B, Tq, H, Dh]`` queries against ``[B, Tk, H, Dh]`` keys and
values (the JAX layout; Tq and Tk may differ); the wrapper folds them to
``[B*H, T, Dh]``. On a CUDA tensor it launches ``csrc/flash_attention.cu``
(online softmax over 64-key blocks, the ``[Tq, Tk]`` logits never in
device memory); on a CPU tensor it runs :func:`flash_attention_plain`, the
straightforward exact-softmax attention in f32 with the same padding,
``l == 0`` guard, mask and dropout semantics:

* logits ``q @ k^T * Dh**-0.5`` in f32;
* the mask (True = attend, broadcasting to ``[B, H, Tq, Tk]``) is folded
  by :func:`normalize_mask` as JAX's ``_normalize_mask`` folds it, to
  ``[G, Tq|1, Tk]`` with no broadcast batch, head or query axis
  materialized; masked logits take the fill ``-1e30`` and their weights
  are zeroed, so a query row that attends to no key has ``l = 0``: a zero
  output, ``lse = -1e30``, zero dq and nothing in dk or dv;
* dropout applies to the normalized weights: the normalizer sums the
  undropped probabilities, a positional-hash keep bit on
  ``(seed, b*h, row, col)`` zeroes dropped ones, and the output is
  divided by ``l * keep`` with ``keep = 1 - t/256``;
* the row logsumexp ``m + log(l)`` is returned beside the output for the
  backward.

Training: when an input requires grad the wrapper goes through
:class:`_FlashFunction` (the JAX ``custom_vjp``), which saves ``(q, k, v,
out, lse)`` and the seed; its backward computes ``delta = rowsum(dO * O)``
in f32 and launches ``csrc/flash_attention_bwd.cu`` (the ports of
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) on CUDA tensors, or runs
:func:`flash_attention_bwd_plain` on CPU tensors. The dropout mask
enters through dP (and P for dV) with the forward's hash; the attention
mask zeroes P.

Which kernel runs is the operands' dtype, decided in the C entry points:

* **bf16**: the forward, dq and dk/dv are Hopper kernels (TMA tile loads
  on mbarriers, wgmma with f32 accumulators; dq and dk/dv with two
  consumer warpgroups a CTA): every product takes bf16 operands, so P (and
  dS in dq and dk/dv) is rounded to bf16 before its product, where the
  Pallas kernels keep f32; the logits and ``lse`` keep f32 values up to
  summation order. They read q, k, v (and dO) through TMA, which takes
  16-byte aligned tensors.
* **f32**: every kernel is the SIMT kernel with f32 math (TF32 would not
  hold the f32 bounds).

The kernels are built for head dims 32, 64, 128 and 256
(``KERNEL_HEAD_DIMS``). Any other ``Dh`` up to 256 (ViT-H/14's 80) runs
the next wider kernel on operands zero-padded on their last axis, with the
true scale ``Dh**-0.5``: zero columns add nothing to ``q . k`` and the
positional hash and the mask do not read ``Dh``, so P and the keep masks
are those of the unpadded problem; out, dq, dk and dv are sliced back to
``Dh``.

The kernels read the folded mask packed into bits (:meth:`Mask.bits`:
one 64-bit word per query row and 64-key tile, packed once per call and
kept for the backward), with plain loads; the mask is a template flag of
each kernel, so the unmasked instantiations are unchanged.

This is not a fallback: each dtype has one kernel per function, and a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .dropout import _threshold, positional_keep_u8

# Head dims the kernels are instantiated for; others up to 256 are padded.
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
# Launches of the CUDA kernels (one per call on a CUDA tensor).
launches = 0
dq_launches = 0
dkv_launches = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# How a folded head b*h picks its mask group (the C code of each mode).
MASK_MODES = {"full": 0, "batch": 1, "head": 2, "one": 3}
_NEG_INF = -1e30
_FN = None
_BWD_FNS = {}


# sum over k < 8 of 2 ** (56 - 7 k): see Mask.bits.
_GATHER = 0x0102040810204080


class Mask:
    """An attention mask folded by :func:`normalize_mask`: ``rows`` bool
    ``[G, Tq|1, Tk]`` (True = attend), ``mode`` (a key of
    :data:`MASK_MODES`) and the head count ``heads`` that map a folded
    head ``b*h`` to its group."""

    def __init__(self, rows: torch.Tensor, mode: str, heads: int):
        self.rows, self.mode, self.heads = rows, mode, heads
        self._bits = None

    def bits(self) -> torch.Tensor:
        """The rows packed for the kernels, computed once: uint8 ``[G,
        Tq|1, 8 * ceil(Tk / 64)]``, the bytes of little-endian 64-bit
        words in which key c is bit ``c % 64`` of word ``c // 64`` (bit
        ``c % 8`` of byte ``c // 8``), keys past Tk 0."""
        if self._bits is None:
            g, r, tk = self.rows.shape
            nbytes = -(-tk // 64) * 8
            padded = self.rows.new_zeros((g, r, nbytes * 8))
            padded[..., :tk] = self.rows
            # Eight 0/1 bytes read as one little-endian int64 x have bit
            # 8 i set for key i; x * _GATHER moves bit 8 i to bit 56 + i
            # with no carries, so bits 56..63 are the eight keys' bits.
            x = padded.view(torch.uint8).view(torch.int64)
            self._bits = ((x * _GATHER) >> 56 & 0xFF).to(torch.uint8)
        return self._bits

    def expand(self, bh: int) -> torch.Tensor:
        """The mask of every folded head: bool ``[BH, Tq|1, Tk]``."""
        i = torch.arange(bh, device=self.rows.device)
        g = {"full": i, "batch": i // self.heads, "head": i % self.heads,
             "one": torch.zeros_like(i)}[self.mode]
        return self.rows[g]


def normalize_mask(mask, b: int, h: int, q_len: int,
                   kv_len: int) -> Optional[Mask]:
    """Fold a bool mask that broadcasts to ``[B, H, Tq, Tk]`` (True =
    attend) as JAX's ``_normalize_mask`` does: leading axes added up to
    4-D, a key-broadcast mask ``[..., 1]`` materialized along Tk, the
    batch and head axes folded to one group axis by the mode, a
    q-broadcast mask kept at one row. None for ``mask=None``; raises
    ``ValueError`` naming "broadcast" for a mask that does not."""
    if mask is None:
        return None
    while mask.dim() < 4:
        mask = mask[None]
    mb, mh, mq, mk = mask.shape
    if mk == 1 and kv_len > 1:
        mask = mask.expand(mb, mh, mq, kv_len)
        mk = kv_len
    if mk != kv_len or mq not in (1, q_len) or mb not in (1, b) \
            or mh not in (1, h):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} does not broadcast to "
            f"[{b}, {h}, {q_len}, {kv_len}]")
    if mb > 1 and mh > 1:
        mode = "full"
    elif mb > 1:
        mode = "batch"
    elif mh > 1:
        mode = "head"
    else:
        mode = "one"
    rows = mask.to(torch.bool).reshape(mb * mh, mq, mk).contiguous()
    return Mask(rows, mode, h)


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, Dh] -> [B*H, T, Dh] (contiguous)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, Dh] -> [B, T, H, Dh]."""
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_attention_plain(q, k, v, *, seed: int, threshold: int,
                          scale: Optional[float] = None,
                          mask: Optional[Mask] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-softmax attention in f32 on folded ``[BH, Tq, Dh]`` queries
    and ``[BH, Tk, Dh]`` keys and values (logits scaled by ``scale``,
    ``Dh**-0.5`` by default; ``mask`` from :func:`normalize_mask`);
    returns ``(out in q.dtype, lse f32 [BH, Tq])``."""
    bh, t, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    if mask is not None:
        attend = mask.expand(bh)
        s = torch.where(attend, s, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        # A fully masked row has m at the fill, where exp gives 1.
        p = torch.where(attend, p, 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    if threshold:
        p = torch.where(_keep_mask(seed, bh, t, k.shape[1], threshold,
                                   q.device), p, 0.0)
    out = (p @ v.float()) / (l_safe * (1.0 - threshold / 256.0))
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _keep_mask(seed, bh, t, tk, threshold, device):
    """The forward's positional keep mask over ``[BH, T, Tk]``."""
    return positional_keep_u8(
        seed, torch.arange(bh, device=device)[:, None, None],
        torch.arange(t, device=device)[None, :, None],
        torch.arange(tk, device=device)[None, None, :], threshold)


def flash_attention_bwd_plain(q, k, v, dout, lse, delta, *, seed: int,
                              threshold: int, scale: Optional[float] = None,
                              mask: Optional[Mask] = None):
    """The backward kernels' arithmetic in f32 on folded operands:
    ``P = exp(s - lse)`` (zero where ``mask`` does not attend), ``dS = P *
    (M/keep * dP - delta) * scale`` (``scale`` ``Dh**-0.5`` by default);
    returns ``(dq, dk, dv)`` in the operands' dtypes."""
    bh, t, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp((qf @ kf.transpose(1, 2)) * scale - lse[..., None])
    if mask is not None:
        p = torch.where(mask.expand(bh), p, 0.0)
    dp = dof @ vf.transpose(1, 2)
    p_drop = p
    if threshold:
        keep = _keep_mask(seed, bh, t, k.shape[1], threshold, q.device)
        inv_keep = 256.0 / (256.0 - threshold)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = ds @ kf
    dk = ds.transpose(1, 2) @ qf
    dv = p_drop.transpose(1, 2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").vit_flash_fwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel(name: str):
    fn = _BWD_FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention_bwd"), name)
        p = ctypes.c_void_p
        n_ptr = 8 if name == "vit_flash_bwd_dq" else 9
        fn.argtypes = [ctypes.c_int] + [p] * n_ptr + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _BWD_FNS[name] = fn
    return fn


def kernel_width(dh: int) -> int:
    """The instantiated head dim that runs ``dh``: the smallest of
    ``KERNEL_HEAD_DIMS`` not below it; raises above 256."""
    for width in KERNEL_HEAD_DIMS:
        if dh <= width:
            return width
    raise ValueError(f"flash kernel takes Dh up to {KERNEL_HEAD_DIMS[-1]}, "
                     f"got {dh}")


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x [..., Dh]`` zero-padded on its last axis to ``width``."""
    dh = x.shape[-1]
    return x if dh == width else torch.nn.functional.pad(x, (0, width - dh))


def _check(q, k, **others):
    """Raise unless q ``[BH, Tq, Dh]``, k ``[BH, Tk, Dh]`` and ``others``
    (``v`` of k's shape, ``dout`` of q's; one dtype and device) are what
    the kernels take."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    kernel_width(q.shape[-1])
    bh, _, dh = q.shape
    for name, a in dict(k=k, **others).items():
        like = q if name == "dout" else k
        if (a.dim() != 3 or a.shape[0] != bh or a.shape[2] != dh
                or a.shape != like.shape or a.dtype != q.dtype
                or a.device != q.device):
            raise ValueError(f"{name} must be {q.dtype} [{bh}, T, {dh}] on "
                             f"{q.device} (k and v of one length, dout of "
                             f"q's), got {a.dtype} {tuple(a.shape)} on "
                             f"{a.device}")
    if not all(a.is_contiguous() for a in (q, k, *others.values())):
        raise ValueError("flash kernel operands must be contiguous")


def _mask_args(mask: Optional[Mask], q, kv_len: int):
    """The C entry points' mask arguments ``(bits pointer, mode, heads,
    q_bcast)``; raises unless the folded mask fits the operands."""
    if mask is None:
        return (None, 0, 0, 0)
    rows = mask.rows
    if (rows.dtype != torch.bool or rows.device != q.device
            or rows.dim() != 3 or rows.shape[1] not in (1, q.shape[1])
            or rows.shape[2] != kv_len):
        raise ValueError(f"flash mask must be a bool [G, {q.shape[1]} or 1, "
                         f"{kv_len}] on {q.device}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    bits = mask.bits()
    return (bits.data_ptr(), MASK_MODES[mask.mode], mask.heads,
            int(rows.shape[1] == 1))


_check_tma = _build.check_tma


def _launch(q, k, v, *, seed: int, threshold: int,
            mask: Optional[Mask] = None):
    """Validate and launch the forward kernel on folded operands (padded
    to the kernel's head dim and sliced back, see the module docstring)."""
    global launches
    bh, t, dh = q.shape
    _check(q, k, v=v)
    margs = _mask_args(mask, q, k.shape[1])
    width = kernel_width(dh)
    q, k, v = (pad_head_dim(a, width) for a in (q, k, v))
    _check_tma(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(), *margs,
                        bh, t, k.shape[1], width, dh ** -0.5,
                        seed & 0xFFFFFFFF, threshold,
                        1.0 - threshold / 256.0, stream)
    _build.check(err, "vit_flash_fwd")
    launches += 1
    return out[..., :dh], lse


def _bwd_operands(q, k, v, dout, lse, delta, seed, threshold, mask):
    """Validate the backward's operands; returns them padded to the
    kernel's head dim and the kernels' scalar arguments (the mask's, the
    lengths, the scale from the true ``Dh``)."""
    bh, t, dh = q.shape
    _check(q, k, v=v, dout=dout)
    margs = _mask_args(mask, q, k.shape[1])
    for name, a in (("lse", lse), ("delta", delta)):
        if (a.shape != (bh, t) or a.dtype != torch.float32
                or a.device != q.device or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(bh, t)} on {q.device}")
    width = kernel_width(dh)
    padded = [pad_head_dim(a, width) for a in (q, k, v, dout)]
    _check_tma(*padded)
    return padded, (*margs, bh, t, k.shape[1], width, dh ** -0.5,
                     seed & 0xFFFFFFFF, threshold, 256.0 / (256.0 - threshold))


def _launch_bwd_dq(q, k, v, dout, lse, delta, *, seed: int, threshold: int,
                   mask: Optional[Mask] = None):
    """Validate and launch the dq kernel on folded operands."""
    global dq_launches
    dh = q.shape[-1]
    (q, k, v, dout), args = _bwd_operands(q, k, v, dout, lse, delta, seed,
                                          threshold, mask)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _bwd_kernel("vit_flash_bwd_dq")(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vit_flash_bwd_dq")
    dq_launches += 1
    return dq[..., :dh]


def _launch_bwd_dkv(q, k, v, dout, lse, delta, *, seed: int,
                    threshold: int, mask: Optional[Mask] = None):
    """Validate and launch the dk/dv kernel on folded operands."""
    global dkv_launches
    dh = q.shape[-1]
    (q, k, v, dout), args = _bwd_operands(q, k, v, dout, lse, delta, seed,
                                          threshold, mask)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_kernel("vit_flash_bwd_dkv")(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *args,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vit_flash_bwd_dkv")
    dkv_launches += 1
    return dk[..., :dh], dv[..., :dh]


class _FlashFunction(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``_flash`` on folded operands: saves
    ``(q, k, v, out, lse)``; the seed, threshold and mask ride on
    ``ctx``."""

    @staticmethod
    def forward(ctx, q, k, v, seed: int, threshold: int,
                mask: Optional[Mask]):
        kw = dict(seed=seed, threshold=threshold, mask=mask)
        if q.is_cuda:
            out, lse = _launch(q, k, v, **kw)
        else:
            out, lse = flash_attention_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O) in f32 outside the kernels, as in JAX.
        delta = (dout.float() * out.float()).sum(-1)
        kw = ctx.kw
        if q.is_cuda:
            dq = _launch_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = _launch_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, mask=None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Flash attention of ``[B, Tq, H, Dh]`` queries over ``[B, Tk, H, Dh]``
    keys and values, optional mask and dropout.

    ``mask``: a bool tensor that broadcasts to ``[B, H, Tq, Tk]`` (True =
    attend), folded by :func:`normalize_mask` with no broadcast axis
    materialized (a key-padding mask ``[B, 1, 1, Tk]`` stays ``B * Tk``
    bytes); a query row that attends to no key gets a zero output and
    zero gradient. ``seed`` is the int32 positional-hash seed (required
    with dropout). Inputs that require grad go through
    :class:`_FlashFunction`.
    """
    b, t, h, _ = q.shape
    if k.shape[0] != b or k.shape[2] != h or v.shape != k.shape:
        raise ValueError(f"k and v must be [{b}, Tk, {h}, Dh], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    folded = normalize_mask(mask, b, h, t, k.shape[1])
    threshold = 0
    if not deterministic and dropout_rate > 0.0:
        threshold = _threshold(dropout_rate)
    if threshold and seed is None:
        raise ValueError("flash_attention dropout needs a seed")
    qf, kf, vf = _fold_heads(q), _fold_heads(k), _fold_heads(v)
    kw = dict(seed=int(seed or 0), threshold=threshold, mask=folded)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        out = _FlashFunction.apply(qf, kf, vf, kw["seed"], threshold, folded)
    elif q.is_cuda:
        out, _ = _launch(qf, kf, vf, **kw)
    else:
        out, _ = flash_attention_plain(qf, kf, vf, **kw)
    return _unfold_heads(out, b, h)
