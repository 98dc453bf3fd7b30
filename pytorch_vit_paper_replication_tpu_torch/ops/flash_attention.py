"""Flash attention forward as a hand-written CUDA kernel.

Port of the JAX package's ``ops/flash_attention.py::flash_attention`` in
its ``mask=None`` form. Inputs are ``[B, T, H, Dh]`` (the JAX layout);
the wrapper folds them to ``[B*H, T, Dh]``. On a CUDA tensor it launches
``csrc/flash_attention.cu`` (online softmax over 64-key blocks, all math
in f32, the ``[T, T]`` logits never in device memory); on a CPU tensor it
runs :func:`flash_attention_plain`, the straightforward exact-softmax
attention in f32 with the same padding, ``l == 0`` guard and dropout
semantics:

* logits ``q @ k^T * Dh**-0.5`` in f32;
* dropout applies to the normalized weights: the normalizer sums the
  undropped probabilities, a positional-hash keep bit on
  ``(seed, b*h, row, col)`` zeroes dropped ones, and the output is
  divided by ``l * keep`` with ``keep = 1 - t/256``;
* the row logsumexp ``m + log(l)`` is returned beside the output for the
  training slice's backward.

Forward only: a CUDA input that requires grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .dropout import _threshold, positional_keep_u8

SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
# Launches of the CUDA kernel (one per call on a CUDA tensor).
launches = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _fold_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, Dh] -> [B*H, T, Dh] (contiguous)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _unfold_heads(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, T, Dh] -> [B, T, H, Dh]."""
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_attention_plain(q, k, v, *, seed: int, threshold: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-softmax attention in f32 on folded ``[BH, T, Dh]`` operands;
    returns ``(out in q.dtype, lse f32 [BH, T])``."""
    bh, t, dh = q.shape
    s = (q.float() @ k.float().transpose(1, 2)) * (dh ** -0.5)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    if threshold:
        dev = q.device
        keep = positional_keep_u8(
            seed, torch.arange(bh, device=dev)[:, None, None],
            torch.arange(t, device=dev)[None, :, None],
            torch.arange(k.shape[1], device=dev)[None, None, :], threshold)
        p = torch.where(keep, p, 0.0)
    out = (p @ v.float()) / (l_safe * (1.0 - threshold / 256.0))
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


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


def _launch(q, k, v, *, seed: int, threshold: int):
    """Validate and launch the CUDA kernel on folded operands."""
    global launches
    bh, t, dh = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel takes Dh in {SUPPORTED_HEAD_DIMS}, "
                         f"got {dh}")
    for name, a in (("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must match q ({q.dtype} "
                             f"{tuple(q.shape)} on {q.device}), got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel operands must be contiguous")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t,
                        dh, dh ** -0.5, seed & 0xFFFFFFFF, threshold,
                        1.0 - threshold / 256.0, stream)
    _build.check(err, "vit_flash_fwd")
    launches += 1
    return out, lse


def flash_attention(q, k, v, *, mask=None, dropout_rate: float = 0.0,
                    seed: Optional[int] = None,
                    deterministic: bool = True) -> torch.Tensor:
    """Flash attention over ``[B, T, H, Dh]`` inputs, optional dropout.

    ``seed`` is the int32 positional-hash seed (required with dropout).
    ``mask`` is not ported yet and raises (no model path passes one).
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
    if q.is_cuda:
        if torch.is_grad_enabled() and any(
                a.requires_grad for a in (q, k, v)):
            raise NotImplementedError(
                "flash_attention on CUDA is forward-only: the backward "
                "kernels come with the training slice (ROADMAP Queue 2 "
                "rows 4-5); run under torch.inference_mode()")
        out, _ = _launch(qf, kf, vf, **kw)
    else:
        out, _ = flash_attention_plain(qf, kf, vf, **kw)
    return _unfold_heads(out, b, h)
