"""The encoder block's MLP half as one CUDA kernel (forward).

``x + drop1(fc2(drop0(gelu(fc1(LN(x))))))`` — the port of the JAX
package's ``ops/fused_mlp.py::fused_ln_mlp_residual``. On a CUDA tensor the
wrapper launches the hand-written kernel in ``csrc/fused_mlp.cu`` (the
``[rows, mlp_size]`` hidden tile never goes to device memory); on a CPU
tensor it runs :func:`ln_mlp_residual_plain`, which repeats the kernel's
arithmetic in PyTorch with the same rounding points:

* LayerNorm statistics in f32 (mean, centred variance, ``rsqrt``);
* ``y`` cast to the compute dtype before fc1; ``h = y @ W1 + b1`` in f32;
* exact GELU through the Abramowitz & Stegun 7.1.26 ``erf`` polynomial
  (the form the Pallas kernel evaluates), in f32;
* hidden dropout (positional hash tag 0), survivors scaled by
  ``256 / (256 - t)``; ``g`` cast to the compute dtype before fc2;
* ``+ b2`` in f32, output dropout (tag 1), residual added in f32, cast.

Forward only: a CUDA input that requires grad raises (the backward
kernel comes with the training slice).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .dropout import _threshold, positional_keep_u8

_SQRT_HALF = math.sqrt(0.5)
# Launches of the CUDA kernel (one per call on a CUDA tensor).
launches = 0
# Embedding widths D the kernel is instantiated for (S/16, B/16).
SUPPORTED_DIMS = (384, 768)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7)."""
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    y = 1.0 - poly * torch.exp(-a * a)
    return torch.where(x < 0.0, -y, y)


def _gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return h * 0.5 * (1.0 + _erf(h * _SQRT_HALF))


def _keep(seed: int, tag: int, n: int, width: int, threshold: int,
          device) -> torch.Tensor:
    row = torch.arange(n, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(width, device=device, dtype=torch.int64)[None, :]
    return positional_keep_u8(seed, tag, row, col, threshold)


def ln_mlp_residual_plain(x2, gamma, beta, w1, b1, w2, b2, *, eps: float,
                          seed: int, threshold: int) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch on ``[N, D]`` rows (see the
    module docstring). ``w1``/``b1``/``w2``/``b2`` in the compute dtype
    (``x2.dtype``), ``gamma``/``beta`` in f32."""
    dt = x2.dtype
    x32 = x2.float()
    mu = x32.mean(-1, keepdim=True)
    c = x32 - mu
    var = (c * c).mean(-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    h = y.to(dt).float() @ w1.float() + b1.float()
    g = _gelu_exact(h)
    inv_keep = 256.0 / (256.0 - threshold)
    if threshold:
        keep = _keep(seed, 0, g.shape[0], g.shape[1], threshold, g.device)
        g = torch.where(keep, g * inv_keep, 0.0)
    f = g.to(dt).float() @ w2.float() + b2.float()
    if threshold:
        keep2 = _keep(seed, 1, f.shape[0], f.shape[1], threshold, f.device)
        f = torch.where(keep2, f * inv_keep, 0.0)
    return (x32 + f).to(dt)


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("fused_mlp").vit_lnmlp_fwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x2, gamma, beta, w1, b1, w2, b2, *, eps, seed, threshold):
    """Validate and launch the CUDA kernel on ``[N, D]`` rows."""
    global launches
    n, d = x2.shape
    f = w1.shape[1]
    dt = x2.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused_ln_mlp_residual kernel takes float32 or "
                        f"bfloat16, got {dt}")
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"fused_ln_mlp_residual kernel is built for D in "
                         f"{SUPPORTED_DIMS}, got {d}")
    if f % 64:
        raise ValueError(f"fused_ln_mlp_residual kernel needs mlp_size % 64 "
                         f"== 0, got {f}")
    expect = {"gamma": (gamma, (d,), torch.float32),
              "beta": (beta, (d,), torch.float32),
              "w1": (w1, (d, f), dt), "b1": (b1, (f,), dt),
              "w2": (w2, (f, d), dt), "b2": (b2, (d,), dt)}
    for name, (t, shape, want) in expect.items():
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{name} must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(x2)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = _kernel()(_DTYPE_CODE[dt], x2.data_ptr(), gamma.data_ptr(),
                        beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                        w2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, d,
                        f, eps, seed & 0xFFFFFFFF, threshold,
                        256.0 / (256.0 - threshold), stream)
    _build.check(err, "vit_lnmlp_fwd")
    launches += 1
    return out


def fused_ln_mlp_residual(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, *, eps: float = 1e-6,
                          dropout_rate: float = 0.0,
                          seed: Optional[int] = None,
                          deterministic: bool = True) -> torch.Tensor:
    """The encoder block's full MLP half: ``x + drop(fc2(drop(gelu(fc1(
    LN(x))))))`` over ``[..., D]`` input.

    ``gamma``/``beta`` are the LayerNorm's f32 ``[D]`` params; ``w1 [D,
    F]``, ``b1 [F]``, ``w2 [F, D]``, ``b2 [D]`` are in the compute dtype
    (``x.dtype``). ``dropout_rate`` applies to both dropout sites when not
    ``deterministic``; ``seed`` is the int32 positional-hash seed (the
    JAX package derives it from a PRNG key with
    ``derive_positional_seed``). CPU tensors run the plain PyTorch
    version; CUDA tensors launch the kernel or raise.
    """
    *_, d = x.shape
    if w2.shape[1] != d:
        raise ValueError(
            f"residual form needs fc2 out dim == input dim, got "
            f"{w2.shape[1]} != {d}")
    threshold = 0
    if not deterministic and dropout_rate > 0.0:
        threshold = _threshold(dropout_rate)
    if threshold and seed is None:
        raise ValueError("fused_ln_mlp_residual dropout needs a seed")
    seed = int(seed or 0)
    x2 = x.reshape(-1, d)
    args = (x2, gamma, beta, w1, b1, w2, b2)
    if x.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in args):
            raise NotImplementedError(
                "fused_ln_mlp_residual on CUDA is forward-only: the "
                "backward kernel comes with the training slice (ROADMAP "
                "Queue 2 row 2); run under torch.inference_mode()")
        out = _launch(x2.contiguous(), *args[1:], eps=eps, seed=seed,
                      threshold=threshold)
    else:
        out = ln_mlp_residual_plain(*args, eps=eps, seed=seed,
                                    threshold=threshold)
    return out.reshape(x.shape)
