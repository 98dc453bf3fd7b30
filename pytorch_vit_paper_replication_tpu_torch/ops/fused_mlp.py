"""The encoder block's MLP half as hand-written CUDA kernels, with autograd.

``x + drop1(fc2(drop0(gelu(fc1(LN(x))))))`` — the port of the JAX
package's ``ops/fused_mlp.py::fused_ln_mlp_residual``. On a CUDA tensor the
wrapper launches the hand-written passes in ``csrc/fused_mlp.cu`` (an LN
row pass, then fc1 with the GELU / keep-bit epilogue and fc2 with the
residual epilogue, on Hopper's wgmma with TMA operands in bf16; the hidden
activation ``g`` makes one round trip through a workspace in the compute
dtype); on a CPU tensor it runs :func:`ln_mlp_residual_plain`, which
repeats the kernels' arithmetic in PyTorch with the same rounding points:

* LayerNorm statistics in f32 (mean, centred variance, ``rsqrt``);
* ``y`` cast to the compute dtype before fc1; ``h = y @ W1 + b1`` in f32;
* exact GELU through the Abramowitz & Stegun 7.1.26 ``erf`` polynomial
  (the form the Pallas kernel evaluates), in f32;
* hidden dropout (positional hash tag 0), survivors scaled by
  ``256 / (256 - t)``; ``g`` cast to the compute dtype before fc2;
* ``+ b2`` in f32, output dropout (tag 1), residual added in f32, cast.

Training: when an input requires grad the wrapper goes through
:class:`_LnMlpFunction` (the JAX ``custom_vjp``): its forward also saves
``h = y @ W1 + b1`` rounded to the compute dtype, its backward launches
``csrc/fused_mlp_bwd.cu`` (the port of ``_lnmlp_bwd``) on CUDA tensors and
:func:`ln_mlp_residual_bwd_plain` on CPU tensors. In bf16 the backward's
four products run on Hopper's wgmma with operands loaded by TMA. Every
kernel takes 16-byte aligned operands (TMA in bf16, vector loads in f32;
checked before the launch), a width ``D`` and hidden width ``F`` that
are multiples of 64, and its scratch as one workspace of the size the
library reports (``_workspace``). Any other ``D`` or ``F`` runs on
operands zero-padded to the next multiple of 64 (:func:`_pad_operands`):
the padded columns of x, W1, b1, W2, b2, gamma and beta are zero, so the
padded hidden columns carry ``GELU(0) = 0`` and the padded output columns
0; the LN statistics run over the true ``D`` (the C entry points take it
beside the padded width); the keep bits hash (row, column) and so stay
those of the real elements; every output and gradient is sliced back. The
backward keeps the Pallas kernel's rounding points: LN statistics recomputed from x, ``df``
and ``dh`` cast to the compute dtype before their products, ``db1``/
``db2``/``dgamma``/``dbeta`` summed in f32, ``dx = dO + dx_ln`` in f32,
GELU' = ``Phi(h) + h phi(h)`` with the A&S erf, and every gradient
returned in the dtype of the parameter passed.

The MLP core without LN and residual, ``fc2(drop0(gelu(fc1(x))))`` — the
port of the JAX ``fused_mlp`` that manual tensor parallelism runs on each
rank's hidden slice — is :func:`fused_mlp`: the CUDA kernels of
``csrc/fused_mlp_core.cu`` (forward with optional saved ``h``, backward) on
CUDA tensors, :func:`mlp_core_plain` / :func:`mlp_core_bwd_plain` on CPU
tensors, wired by :class:`_MlpFunction`, with launch counters of their own
(``core_launches``, ``core_bwd_launches``). Its rounding points are the
Pallas ``_fwd_kernel``/``_bwd_kernel``'s: ``h = x @ W1 + b1`` in f32 (``h``
saved in the compute dtype), GELU in f32, hidden dropout (tag 0, keyed on
the flattened row and the *local* hidden column), ``g`` cast before fc2,
``+ b2`` in f32; backward ``dg = dO W2^T`` masked and scaled, ``dh = dg
GELU'(h)``, ``dh_c`` cast, ``dx = dh_c W1^T``, ``dW1 = x^T dh_c`` and ``dW2
= g_c^T dO`` in f32, ``db1 = sum dh`` and ``db2 = sum dO`` over f32 values;
``db2`` leaves in ``dO``'s dtype, the others in their parameters'.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .dropout import _threshold, positional_keep_u8

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
# Launches of the CUDA kernels (one per wrapper call on a CUDA tensor):
# the forward, and the backward (its four CUDA kernels count as one).
launches = 0
bwd_launches = 0
# ... and of the MLP core's (csrc/fused_mlp_core.cu), counted apart.
core_launches = 0
core_bwd_launches = 0
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None
_BWD_FN = None
_CORE_FN = None
_CORE_BWD_FN = None


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


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact GELU: ``Phi(h) + h * phi(h)``."""
    phi = torch.exp(-0.5 * h * h) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + _erf(h * _SQRT_HALF))
    return cdf + h * phi


def _keep(seed: int, tag: int, n: int, width: int, threshold: int,
          device) -> torch.Tensor:
    row = torch.arange(n, device=device, dtype=torch.int64)[:, None]
    col = torch.arange(width, device=device, dtype=torch.int64)[None, :]
    return positional_keep_u8(seed, tag, row, col, threshold)


def _ln(x32, gamma, beta, eps):
    """LayerNorm in f32 (two-pass mean / centred variance, as the kernels):
    returns ``(xhat, rstd, y)``."""
    mu = x32.mean(-1, keepdim=True)
    c = x32 - mu
    var = (c * c).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = c * rstd
    return xhat, rstd, xhat * gamma.float() + beta.float()


def ln_mlp_residual_plain(x2, gamma, beta, w1, b1, w2, b2, *, eps: float,
                          seed: int, threshold: int, save_h: bool = False):
    """The kernel's arithmetic in PyTorch on ``[N, D]`` rows (see the
    module docstring). ``w1``/``b1``/``w2``/``b2`` in the compute dtype
    (``x2.dtype``), ``gamma``/``beta`` in f32. With ``save_h`` returns
    ``(out, h)``, ``h`` rounded to the compute dtype."""
    dt = x2.dtype
    x32 = x2.float()
    _, _, y = _ln(x32, gamma, beta, eps)
    h = y.to(dt).float() @ w1.float() + b1.float()
    h_saved = h.to(dt) if save_h else None
    g = _gelu_exact(h)
    inv_keep = 256.0 / (256.0 - threshold)
    if threshold:
        keep = _keep(seed, 0, g.shape[0], g.shape[1], threshold, g.device)
        g = torch.where(keep, g * inv_keep, 0.0)
    f = g.to(dt).float() @ w2.float() + b2.float()
    if threshold:
        keep2 = _keep(seed, 1, f.shape[0], f.shape[1], threshold, f.device)
        f = torch.where(keep2, f * inv_keep, 0.0)
    out = (x32 + f).to(dt)
    return (out, h_saved) if save_h else out


def ln_mlp_residual_bwd_plain(x2, h, gamma, beta, w1, w2, dout, *,
                              eps: float, seed: int, threshold: int):
    """The backward kernel's arithmetic in PyTorch (the Pallas
    ``_lnmlp_bwd_kernel`` step by step) from the saved ``h``; returns
    ``(dx, dgamma, dbeta, dw1, db1, dw2, db2)`` in the dtypes of ``x2``,
    ``gamma``, ``beta``, ``w1``, ``w1``, ``w2``, ``w2``."""
    dt = x2.dtype
    n, d = x2.shape
    f = w1.shape[1]
    x32 = x2.float()
    xhat, rstd, y = _ln(x32, gamma, beta, eps)
    do32 = dout.float()
    inv_keep = 256.0 / (256.0 - threshold)
    df = do32
    if threshold:
        keep2 = _keep(seed, 1, n, d, threshold, x2.device)
        df = torch.where(keep2, do32 * inv_keep, 0.0)
    df_c = df.to(dt).float()
    h32 = h.float()
    g_drop = _gelu_exact(h32)
    if threshold:
        keep = _keep(seed, 0, n, f, threshold, x2.device)
        g_drop = torch.where(keep, g_drop * inv_keep, 0.0)
    dw2 = g_drop.to(dt).float().t() @ df_c
    db2 = df.sum(0)
    dg = df_c @ w2.float().t()
    if threshold:
        dg = torch.where(keep, dg * inv_keep, 0.0)
    dh = dg * _gelu_grad(h32)
    dh_c = dh.to(dt).float()
    dw1 = y.to(dt).float().t() @ dh_c
    db1 = dh.sum(0)
    dy = dh_c @ w1.float().t()
    dgamma = (dy * xhat).sum(0)
    dbeta = dy.sum(0)
    dxhat = dy * gamma.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (do32 + rstd * (dxhat - m1 - xhat * m2)).to(dt)
    return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw1.to(w1.dtype), db1.to(w1.dtype), dw2.to(w2.dtype),
            db2.to(w2.dtype))


def _kernel():
    global _FN
    if _FN is None:
        fn = _build.load("fused_mlp").vit_lnmlp_fwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 10 + [ctypes.c_longlong] + [
            ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel():
    global _BWD_FN
    if _BWD_FN is None:
        fn = _build.load("fused_mlp_bwd").vit_lnmlp_bwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 15 + [ctypes.c_longlong] + [
            ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def _workspace(lib: str, fn: str, x2, n: int, d: int, f: int):
    """A kernel's scratch: one uint8 tensor of the size the library's
    ``fn`` reports for these shapes."""
    query = getattr(_build.load(lib), fn)
    query.argtypes = [ctypes.c_int] * 4
    query.restype = ctypes.c_longlong
    nbytes = query(_DTYPE_CODE[x2.dtype], n, d, f)
    if nbytes < 0:
        raise ValueError(f"{fn}: shapes n={n} d={d} f={f} not supported")
    return torch.empty(nbytes, dtype=torch.uint8, device=x2.device)


def _padded(width: int) -> int:
    """The width the kernels run for ``width``: the next multiple of 64
    (the 64-column boxes of the TMA maps and the f32 GEMM tiles)."""
    return -(-width // 64) * 64


def _pad_operands(d: int, f: int, **tensors):
    """The operands zero-padded to the kernels' widths (``D`` and ``F`` to
    :func:`_padded`): returns ``{name: tensor}`` in the order given.
    Each name says which axes are ``D`` and which ``F``: rows (``x2``,
    ``dout`` ``[N, D]``, ``h`` ``[N, F]``), ``w1`` ``[D, F]``, ``w2`` ``[F,
    D]`` and the vectors (``gamma``, ``beta``, ``b2`` ``[D]``, ``b1``
    ``[F]``). Unchanged when both widths are multiples of 64."""
    dp, fp = _padded(d), _padded(f)
    axes = {"x2": (None, dp), "dout": (None, dp), "h": (None, fp),
            "w1": (dp, fp), "w2": (fp, dp), "gamma": (dp,), "beta": (dp,),
            "b2": (dp,), "b1": (fp,)}
    out = {}
    for name, t in tensors.items():
        pad = []
        for size, want in zip(reversed(t.shape), reversed(axes[name])):
            pad += [0, 0 if want is None else want - size]
        out[name] = (torch.nn.functional.pad(t, pad) if any(pad) else t)
    return out


def _check_operands(x2, gamma, beta, w1, w2, **rest):
    """Raise unless the operands are what the CUDA kernels take; ``rest``
    holds any of ``b1``, ``b2``, ``h``, ``dout``."""
    n, d = x2.shape
    f = w1.shape[1]
    dt = x2.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused_ln_mlp_residual kernel takes float32 or "
                        f"bfloat16, got {dt}")
    shapes = {"gamma": (d,), "beta": (d,), "w1": (d, f), "w2": (f, d),
              "b1": (f,), "b2": (d,), "h": (x2.shape[0], f),
              "dout": tuple(x2.shape)}
    for name, t in dict(gamma=gamma, beta=beta, w1=w1, w2=w2,
                        **rest).items():
        shape = shapes[name]
        want = torch.float32 if name in ("gamma", "beta") else dt
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"{name} must be {want} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _sliced(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t`` cut back to ``shape`` (the true widths), contiguous."""
    if tuple(t.shape) == shape:
        return t
    return t[tuple(slice(0, s) for s in shape)].contiguous()


def _launch(x2, gamma, beta, w1, b1, w2, b2, *, eps, seed, threshold,
            save_h: bool = False):
    """Validate and launch the forward kernel on ``[N, D]`` rows (any
    ``D`` and ``F``, padded as the module docstring says); with ``save_h``
    returns ``(out, h)``."""
    global launches
    _check_operands(x2, gamma, beta, w1, w2, b1=b1, b2=b2)
    n, d = x2.shape
    f = w1.shape[1]
    p = _pad_operands(d, f, x2=x2, gamma=gamma, beta=beta, w1=w1, b1=b1,
                      w2=w2, b2=b2)
    _build.check_aligned(p["x2"], p["w1"], p["w2"])
    _build.check_aligned(p["b1"], p["b2"], align=4)
    dp, fp = _padded(d), _padded(f)
    out = p["x2"].new_empty((n, dp))
    h = x2.new_empty((n, fp)) if save_h else None
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        work = _workspace("fused_mlp", "vit_lnmlp_fwd_workspace", x2, n, dp,
                          fp)
        err = _kernel()(_DTYPE_CODE[x2.dtype], p["x2"].data_ptr(),
                        p["gamma"].data_ptr(), p["beta"].data_ptr(),
                        p["w1"].data_ptr(), p["b1"].data_ptr(),
                        p["w2"].data_ptr(), p["b2"].data_ptr(),
                        out.data_ptr(), h.data_ptr() if save_h else None,
                        work.data_ptr(), work.numel(), n, dp, fp, d, eps,
                        seed & 0xFFFFFFFF, threshold,
                        256.0 / (256.0 - threshold), stream)
    _build.check(err, "vit_lnmlp_fwd")
    launches += 1
    out = _sliced(out, n, d)
    return (out, _sliced(h, n, f)) if save_h else out


def _launch_bwd(x2, h, gamma, beta, w1, w2, dout, *, eps, seed, threshold):
    """Validate and launch the backward kernels; returns the seven
    gradients as :func:`ln_mlp_residual_bwd_plain` does."""
    global bwd_launches
    n, d = x2.shape
    f = w1.shape[1]
    dt = x2.dtype
    _check_operands(x2, gamma, beta, w1, w2, h=h, dout=dout)
    p = _pad_operands(d, f, x2=x2, h=h, gamma=gamma, beta=beta, w1=w1,
                      w2=w2, dout=dout)
    _build.check_aligned(p["x2"], p["h"], p["w1"], p["w2"], p["dout"])
    dp, fp = _padded(d), _padded(f)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = x2.new_empty((n, dp))
    dgamma, dbeta, db2 = (torch.empty(dp, **f32) for _ in range(3))
    db1 = torch.empty(fp, **f32)
    dw1 = torch.empty((dp, fp), **f32)
    dw2 = torch.empty((fp, dp), **f32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        work = _workspace("fused_mlp_bwd", "vit_lnmlp_bwd_workspace", x2, n,
                          dp, fp)
        err = _bwd_kernel()(
            _DTYPE_CODE[dt], *(p[k].data_ptr() for k in (
                "x2", "h", "gamma", "beta", "w1", "w2", "dout")),
            dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            work.data_ptr(), work.numel(), n, dp, fp, d, eps,
            seed & 0xFFFFFFFF, threshold, 256.0 / (256.0 - threshold),
            stream)
    _build.check(err, "vit_lnmlp_bwd")
    bwd_launches += 1
    return (_sliced(dx, n, d), _sliced(dgamma, d).to(gamma.dtype),
            _sliced(dbeta, d).to(beta.dtype), _sliced(dw1, d, f).to(w1.dtype),
            _sliced(db1, f).to(w1.dtype), _sliced(dw2, f, d).to(w2.dtype),
            _sliced(db2, d).to(w2.dtype))


class _LnMlpFunction(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``_lnmlp``: saves ``(x, h, gamma, beta,
    W1, W2)`` and the seed; the backward is one kernel call on CUDA, the
    plain version on the CPU."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, seed: int,
                threshold: int, eps: float):
        kw = dict(eps=eps, seed=seed, threshold=threshold, save_h=True)
        if x2.is_cuda:
            out, h = _launch(x2, gamma, beta, w1, b1, w2, b2, **kw)
        else:
            out, h = ln_mlp_residual_plain(x2, gamma, beta, w1, b1, w2, b2,
                                           **kw)
        ctx.save_for_backward(x2, h, gamma, beta, w1, w2)
        ctx.seed, ctx.threshold, ctx.eps = seed, threshold, eps
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, h, gamma, beta, w1, w2 = ctx.saved_tensors
        kw = dict(eps=ctx.eps, seed=ctx.seed, threshold=ctx.threshold)
        if x2.is_cuda:
            grads = _launch_bwd(x2, h, gamma, beta, w1, w2,
                                dout.contiguous(), **kw)
        else:
            grads = ln_mlp_residual_bwd_plain(x2, h, gamma, beta, w1, w2,
                                              dout, **kw)
        return (*grads, None, None, None)


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
    version; CUDA tensors launch the kernel or raise. Inputs that require
    grad go through :class:`_LnMlpFunction`.
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
    if x.is_cuda:
        x2 = x2.contiguous()
    args = (x2, gamma, beta, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _LnMlpFunction.apply(*args, seed, threshold, eps)
    elif x.is_cuda:
        out = _launch(*args, eps=eps, seed=seed, threshold=threshold)
    else:
        out = ln_mlp_residual_plain(*args, eps=eps, seed=seed,
                                    threshold=threshold)
    return out.reshape(x.shape)


# --------------------------------------------------------------------------
# The MLP core without LN and residual (JAX ``fused_mlp``)
# --------------------------------------------------------------------------

def mlp_core_plain(x2, w1, b1, w2, b2, *, seed: int, threshold: int,
                   save_h: bool = False):
    """The core forward kernel's arithmetic on ``[N, D]`` rows:
    ``fc2(drop0(gelu(fc1(x))))`` with ``w1 [D, F]``, ``w2 [F, D_out]`` and
    the biases in the compute dtype (``x2.dtype``). With ``save_h`` returns
    ``(out, h)``, ``h`` rounded to the compute dtype."""
    dt = x2.dtype
    h = x2.float() @ w1.float() + b1.float()
    h_saved = h.to(dt) if save_h else None
    g = _gelu_exact(h)
    if threshold:
        keep = _keep(seed, 0, g.shape[0], g.shape[1], threshold, g.device)
        g = torch.where(keep, g * (256.0 / (256.0 - threshold)), 0.0)
    out = (g.to(dt).float() @ w2.float() + b2.float()).to(dt)
    return (out, h_saved) if save_h else out


def mlp_core_bwd_plain(x2, h, w1, b1, w2, dout, *, seed: int,
                       threshold: int):
    """The core backward kernel's arithmetic (the Pallas ``_bwd_kernel``
    step by step) from the saved ``h``; returns ``(dx, dw1, db1, dw2,
    db2)`` in the dtypes of ``x2``, ``w1``, ``b1``, ``w2`` and ``dout``."""
    dt = x2.dtype
    n, f = h.shape
    h32 = h.float()
    do32 = dout.float()
    inv_keep = 256.0 / (256.0 - threshold)
    g_drop = _gelu_exact(h32)
    dg = do32 @ w2.float().t()
    if threshold:
        keep = _keep(seed, 0, n, f, threshold, x2.device)
        g_drop = torch.where(keep, g_drop * inv_keep, 0.0)
        dg = torch.where(keep, dg * inv_keep, 0.0)
    dh = dg * _gelu_grad(h32)
    dh_c = dh.to(dt).float()
    dx = (dh_c @ w1.float().t()).to(dt)
    dw1 = x2.float().t() @ dh_c
    dw2 = g_drop.to(dt).float().t() @ do32
    return (dx, dw1.to(w1.dtype), dh.sum(0).to(b1.dtype), dw2.to(w2.dtype),
            do32.sum(0).to(dout.dtype))


def _core_kernel():
    global _CORE_FN
    if _CORE_FN is None:
        fn = _build.load("fused_mlp_core").vit_mlp_fwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _CORE_FN = fn
    return _CORE_FN


def _core_bwd_kernel():
    global _CORE_BWD_FN
    if _CORE_BWD_FN is None:
        fn = _build.load("fused_mlp_core").vit_mlp_bwd
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int] + [p] * 11 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _CORE_BWD_FN = fn
    return _CORE_BWD_FN


def _check_core(x2, w1, w2, **rest):
    """Raise unless the operands are what the core kernels take; ``rest``
    holds any of ``b1``, ``b2``, ``h``, ``dout``."""
    n, d = x2.shape
    f = w1.shape[1]
    dt = x2.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"fused_mlp kernel takes float32 or bfloat16, got "
                        f"{dt}")
    shapes = {"w1": (d, f), "w2": (f, d), "b1": (f,), "b2": (d,),
              "h": (n, f), "dout": (n, d)}
    for name, t in dict(w1=w1, w2=w2, **rest).items():
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if tuple(t.shape) != shapes[name] or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shapes[name]} (the "
                             f"kernel takes D_out = D), got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch_core(x2, w1, b1, w2, b2, *, seed, threshold,
                 save_h: bool = False):
    """Validate and launch the core forward kernel on ``[N, D]`` rows; with
    ``save_h`` returns ``(out, h)``."""
    global core_launches
    _check_core(x2, w1, w2, b1=b1, b2=b2)
    n, d = x2.shape
    f = w1.shape[1]
    p = _pad_operands(d, f, x2=x2, w1=w1, b1=b1, w2=w2, b2=b2)
    _build.check_aligned(p["x2"], p["w1"], p["w2"])
    _build.check_aligned(p["b1"], p["b2"], align=4)
    dp, fp = _padded(d), _padded(f)
    out = x2.new_empty((n, dp))
    h = x2.new_empty((n, fp)) if save_h else None
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        work = _workspace("fused_mlp_core", "vit_mlp_fwd_workspace", x2, n,
                          dp, fp)
        err = _core_kernel()(
            _DTYPE_CODE[x2.dtype], *(p[k].data_ptr() for k in (
                "x2", "w1", "b1", "w2", "b2")), out.data_ptr(),
            h.data_ptr() if save_h else None, work.data_ptr(), work.numel(),
            n, dp, fp, seed & 0xFFFFFFFF, threshold,
            256.0 / (256.0 - threshold), stream)
    _build.check(err, "vit_mlp_fwd")
    core_launches += 1
    out = _sliced(out, n, d)
    return (out, _sliced(h, n, f)) if save_h else out


def _launch_core_bwd(x2, h, w1, b1, w2, dout, *, seed, threshold):
    """Validate and launch the core backward kernels; returns the five
    gradients as :func:`mlp_core_bwd_plain` does."""
    global core_bwd_launches
    n, d = x2.shape
    f = w1.shape[1]
    _check_core(x2, w1, w2, h=h, dout=dout)
    p = _pad_operands(d, f, x2=x2, h=h, w1=w1, w2=w2, dout=dout)
    _build.check_aligned(*p.values())
    dp, fp = _padded(d), _padded(f)
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = x2.new_empty((n, dp))
    dw1 = torch.empty((dp, fp), **f32)
    dw2 = torch.empty((fp, dp), **f32)
    db1 = torch.empty(fp, **f32)
    db2 = torch.empty(dp, **f32)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        work = _workspace("fused_mlp_core", "vit_mlp_bwd_workspace", x2, n,
                          dp, fp)
        err = _core_bwd_kernel()(
            _DTYPE_CODE[x2.dtype], *(t.data_ptr() for t in p.values()),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
            db2.data_ptr(), work.data_ptr(), work.numel(), n, dp, fp,
            seed & 0xFFFFFFFF, threshold, 256.0 / (256.0 - threshold),
            stream)
    _build.check(err, "vit_mlp_bwd")
    core_bwd_launches += 1
    return (_sliced(dx, n, d), _sliced(dw1, d, f).to(w1.dtype),
            _sliced(db1, f).to(b1.dtype), _sliced(dw2, f, d).to(w2.dtype),
            _sliced(db2, d).to(dout.dtype))


def _launch_gemm(a: torch.Tensor, b: torch.Tensor, form: str,
                 splits: int = 1) -> torch.Tensor:
    """The bf16 wgmma GEMM kernel of the backward on its own (for its
    tests): ``form="nt"`` takes ``a [m, k]``, ``b [n, k]`` and returns
    ``a @ b.T``; ``form="tn"`` takes ``a [k, m]``, ``b [k, n]`` and returns
    ``a.T @ b`` (the weight gradients' form, both operands read MN-major),
    its reduction cut into ``splits`` ranges summed in order. f32 out."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or \
            not (a.is_cuda and b.is_cuda):
        raise ValueError("the GEMM kernel takes bf16 CUDA tensors")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the GEMM kernel takes contiguous operands")
    if form == "nt":
        (m, k), (n, k2) = a.shape, b.shape
    elif form == "tn":
        (k, m), (k2, n) = a.shape, b.shape
    else:
        raise ValueError(f"form must be 'nt' or 'tn', got {form!r}")
    if k != k2 or a.shape[1] % 8 or b.shape[1] % 8 or n % 4:
        raise ValueError(f"GEMM operands {tuple(a.shape)}, {tuple(b.shape)}: "
                         "reductions must match, rows of 16-byte multiples")
    _build.check_tma(a, b)
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    work = torch.empty((splits, m, n) if splits > 1 else 1,
                       dtype=torch.float32, device=a.device)
    fn = _build.load("fused_mlp_bwd").vit_gemm_bf16
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, p, p] + [ctypes.c_int] * 4 + [p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(0 if form == "nt" else 1, a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), m, n, k, splits, work.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "vit_gemm_bf16")
    return c


class _MlpFunction(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``_fused``: saves ``(x, h, W1, b1, W2)``
    and the seed; the backward is one kernel call on CUDA, the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, seed: int, threshold: int):
        kw = dict(seed=seed, threshold=threshold, save_h=True)
        if x2.is_cuda:
            out, h = _launch_core(x2, w1, b1, w2, b2, **kw)
        else:
            out, h = mlp_core_plain(x2, w1, b1, w2, b2, **kw)
        ctx.save_for_backward(x2, h, w1, b1, w2)
        ctx.seed, ctx.threshold = seed, threshold
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, h, w1, b1, w2 = ctx.saved_tensors
        kw = dict(seed=ctx.seed, threshold=ctx.threshold)
        if x2.is_cuda:
            grads = _launch_core_bwd(x2, h, w1, b1, w2, dout.contiguous(),
                                     **kw)
        else:
            grads = mlp_core_bwd_plain(x2, h, w1, b1, w2, dout, **kw)
        return (*grads, None, None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, *,
              dropout_rate: float = 0.0, seed: Optional[int] = None,
              deterministic: bool = True) -> torch.Tensor:
    """Fused ``gelu(x @ w1 + b1) -> dropout -> @ w2 + b2`` over ``[..., D]``
    input (the JAX ``fused_mlp``); returns ``[..., D_out]`` in ``x.dtype``.

    ``w1 [D, F]``, ``b1 [F]``, ``w2 [F, D_out]``, ``b2 [D_out]`` in the
    compute dtype. ``dropout_rate`` applies to the hidden activation when
    not ``deterministic``; ``seed`` is its int32 positional-hash seed. CPU
    tensors run the plain PyTorch version (any ``D_out``); CUDA tensors
    launch the kernels (``D_out = D``, any ``D`` and ``F``) or raise.
    Inputs that require grad go through :class:`_MlpFunction`.
    """
    *lead, d = x.shape
    threshold = 0
    if not deterministic and dropout_rate > 0.0:
        threshold = _threshold(dropout_rate)
    if threshold and seed is None:
        raise ValueError("fused_mlp dropout needs a seed")
    seed = int(seed or 0)
    x2 = x.reshape(-1, d)
    if x.is_cuda:
        x2 = x2.contiguous()
    args = (x2, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = _MlpFunction.apply(*args, seed, threshold)
    elif x.is_cuda:
        out = _launch_core(*args, seed=seed, threshold=threshold)
    else:
        out = mlp_core_plain(*args, seed=seed, threshold=threshold)
    return out.reshape(*lead, w2.shape[1])
