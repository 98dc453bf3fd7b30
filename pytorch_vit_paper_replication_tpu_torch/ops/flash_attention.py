"""Flash attention as hand-written CUDA kernels (forward, dq, dk/dv).

Port of the JAX package's ``ops/flash_attention.py::flash_attention`` in
its ``mask=None`` form. Inputs are ``[B, T, H, Dh]`` (the JAX layout);
the wrapper folds them to ``[B*H, T, Dh]``. On a CUDA tensor it launches
``csrc/flash_attention.cu`` (online softmax over 64-key blocks, the
``[T, T]`` logits never in device memory); on a CPU tensor it runs
:func:`flash_attention_plain`, the straightforward exact-softmax
attention in f32 with the same padding, ``l == 0`` guard and dropout
semantics:

* logits ``q @ k^T * Dh**-0.5`` in f32;
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
enters through dP (and P for dV) with the forward's hash.

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
positional hash does not read ``Dh``, so P and the keep masks are those of
the unpadded problem; out, dq, dk and dv are sliced back to ``Dh``.

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
_FN = None
_BWD_FNS = {}


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, Dh] -> [B*H, T, Dh] (contiguous)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, Dh] -> [B, T, H, Dh]."""
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_attention_plain(q, k, v, *, seed: int, threshold: int,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-softmax attention in f32 on folded ``[BH, T, Dh]`` operands
    (logits scaled by ``scale``, ``Dh**-0.5`` by default); returns ``(out
    in q.dtype, lse f32 [BH, T])``."""
    bh, t, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    s = (q.float() @ k.float().transpose(1, 2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
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
                              threshold: int, scale: Optional[float] = None):
    """The backward kernels' arithmetic in f32 on folded operands:
    ``P = exp(s - lse)``, ``dS = P * (M/keep * dP - delta) * scale``
    (``scale`` ``Dh**-0.5`` by default); returns ``(dq, dk, dv)`` in the
    operands' dtypes."""
    bh, t, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp((qf @ kf.transpose(1, 2)) * scale - lse[..., None])
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
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel(name: str):
    fn = _BWD_FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("flash_attention_bwd"), name)
        p = ctypes.c_void_p
        n_ptr = 7 if name == "vit_flash_bwd_dq" else 8
        fn.argtypes = [ctypes.c_int] + [p] * n_ptr + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
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


def _check(q, **others):
    """Raise unless q and ``others`` (same shape, dtype, device) are what
    the kernels take."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    kernel_width(q.shape[-1])
    for name, a in others.items():
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)} on {q.device}), got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    if not all(a.is_contiguous() for a in (q, *others.values())):
        raise ValueError("flash kernel operands must be contiguous")


_check_tma = _build.check_tma


def _launch(q, k, v, *, seed: int, threshold: int):
    """Validate and launch the forward kernel on folded operands (padded
    to the kernel's head dim and sliced back, see the module docstring)."""
    global launches
    bh, t, dh = q.shape
    _check(q, k=k, v=v)
    width = kernel_width(dh)
    q, k, v = (pad_head_dim(a, width) for a in (q, k, v))
    _check_tma(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t,
                        width, dh ** -0.5, seed & 0xFFFFFFFF, threshold,
                        1.0 - threshold / 256.0, stream)
    _build.check(err, "vit_flash_fwd")
    launches += 1
    return out[..., :dh], lse


def _bwd_operands(q, k, v, dout, lse, delta, seed, threshold):
    """Validate the backward's operands; returns them padded to the
    kernel's head dim and the kernels' scalars (the scale from the true
    ``Dh``)."""
    bh, t, dh = q.shape
    _check(q, k=k, v=v, dout=dout)
    for name, a in (("lse", lse), ("delta", delta)):
        if (a.shape != (bh, t) or a.dtype != torch.float32
                or a.device != q.device or not a.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"{(bh, t)} on {q.device}")
    width = kernel_width(dh)
    padded = [pad_head_dim(a, width) for a in (q, k, v, dout)]
    _check_tma(*padded)
    return padded, (bh, t, width, dh ** -0.5, seed & 0xFFFFFFFF, threshold,
                    256.0 / (256.0 - threshold))


def _launch_bwd_dq(q, k, v, dout, lse, delta, *, seed: int, threshold: int):
    """Validate and launch the dq kernel on folded operands."""
    global dq_launches
    dh = q.shape[-1]
    (q, k, v, dout), args = _bwd_operands(q, k, v, dout, lse, delta, seed,
                                          threshold)
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
                    threshold: int):
    """Validate and launch the dk/dv kernel on folded operands."""
    global dkv_launches
    dh = q.shape[-1]
    (q, k, v, dout), args = _bwd_operands(q, k, v, dout, lse, delta, seed,
                                          threshold)
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
    ``(q, k, v, out, lse)``; the seed and threshold ride on ``ctx``."""

    @staticmethod
    def forward(ctx, q, k, v, seed: int, threshold: int):
        if q.is_cuda:
            out, lse = _launch(q, k, v, seed=seed, threshold=threshold)
        else:
            out, lse = flash_attention_plain(q, k, v, seed=seed,
                                             threshold=threshold)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seed, ctx.threshold = seed, threshold
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O) in f32 outside the kernels, as in JAX.
        delta = (dout.float() * out.float()).sum(-1)
        kw = dict(seed=ctx.seed, threshold=ctx.threshold)
        if q.is_cuda:
            dq = _launch_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = _launch_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, dout, lse, delta,
                                                   **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, mask=None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Flash attention over ``[B, T, H, Dh]`` inputs, optional dropout.

    ``seed`` is the int32 positional-hash seed (required with dropout).
    ``mask`` is not ported yet and raises (no model path passes one).
    Inputs that require grad go through :class:`_FlashFunction`.
    """
    if mask is not None:
        raise NotImplementedError(
            "flash_attention masks are not ported yet (ROADMAP Queue 2 "
            "row 3: the mask forms)")
    if k.shape[1] != q.shape[1]:
        raise ValueError("flash_attention port takes self-attention "
                         "(equal q/k lengths)")
    b, t, h, _ = q.shape
    threshold = 0
    if not deterministic and dropout_rate > 0.0:
        threshold = _threshold(dropout_rate)
    if threshold and seed is None:
        raise ValueError("flash_attention dropout needs a seed")
    qf, kf, vf = _fold_heads(q), _fold_heads(k), _fold_heads(v)
    kw = dict(seed=int(seed or 0), threshold=threshold)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        out = _FlashFunction.apply(qf, kf, vf, kw["seed"], threshold)
    elif q.is_cuda:
        out, _ = _launch(qf, kf, vf, **kw)
    else:
        out, _ = flash_attention_plain(qf, kf, vf, **kw)
    return _unfold_heads(out, b, h)
