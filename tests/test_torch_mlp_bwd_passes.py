"""The bf16 MLP backward's pass decomposition, rehearsed on the CPU.

The bf16 backward of rows 2 and 7 (``csrc/mlp_bwd.cuh``, wgmma passes)
computes the gradients in six passes instead of one sequential program:

1. (LN) the statistics recomputed from x, ``y_c = cast(LN(x))`` and
   ``df_c = cast(keep1 dO / keep)``;
2. ``dg = df_c W2^T`` in 128-row tiles whose epilogue applies GELU' and
   the hidden keep bit, writes ``dh_c`` and ``g_c`` and the column sums of
   the f32 ``dh`` per tile (the db1 partials);
3. ``dy = dh_c W1^T`` into an f32 buffer (LN) or cast straight to dx;
4. (LN) the LN backward of 32-row tiles from that buffer into dx and the
   dgamma / dbeta partials; the db2 partials of the f32 ``df``;
5. ``dW1 = y_c^T dh_c`` and ``dW2 = g_c^T df_c`` with the reduction over
   the rows cut into ``splits`` contiguous ranges of 64-row tiles, the
   partials summed in split order;
6. the bias and LN gradients as fixed-order sums of their tile partials.

:func:`emulate` runs that decomposition in plain torch (zero-padded
ragged tiles, as TMA reads them). With f32 operands it must equal the
plain versions (``ln_mlp_residual_bwd_plain``, ``mlp_core_bwd_plain``) to
f32 summation order (1e-5 of each gradient's largest element) and the JAX
package's ``_lnmlp_bwd`` / ``_fused_bwd`` (Pallas, interpret mode, as the
JAX package's tests run them on the CPU) within its grad tolerance, 2e-3;
with bf16 operands it must stay within the card's bound of the plain
version, 2e-2. N = 67 rows is ragged at 16, 32, 64 and 128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.fused_mlp import (
    _fused_bwd as jax_fused_bwd, _lnmlp_bwd as jax_lnmlp_bwd)
from pytorch_vit_paper_replication_tpu_torch.ops import _build, fused_mlp

N, D, F = 67, 64, 256
EPS = 1e-6
SEED = -1234567
ROW_TILE = 32   # rows per CTA of the row passes (mlp_bwd::kBM)
GEMM_ROWS = 128  # rows per dg GEMM tile, the db1 partials' tile
K_TILE = 64     # rows per reduction stage of the weight GEMMs
JAX_BLOCK = 16  # the Pallas kernels' row block


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = dict(x=rng.standard_normal((N, D)).astype(f32),
             gamma=(1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
             beta=(0.1 * rng.standard_normal(D)).astype(f32),
             w1=(0.2 * rng.standard_normal((D, F))).astype(f32),
             b1=(0.1 * rng.standard_normal(F)).astype(f32),
             w2=(0.1 * rng.standard_normal((F, D))).astype(f32),
             b2=(0.1 * rng.standard_normal(D)).astype(f32),
             dout=rng.standard_normal((N, D)).astype(f32))
    return p


def _tensors(p, dtype):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    for k in ("x", "w1", "b1", "w2", "b2", "dout"):
        t[k] = t[k].to(dtype)
    return t


def _saved_h(t, ln, threshold):
    """The forward's saved h (compute dtype), from the plain forward."""
    if ln:
        _, h = fused_mlp.ln_mlp_residual_plain(
            t["x"], t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"],
            t["b2"], eps=EPS, seed=SEED, threshold=threshold, save_h=True)
    else:
        _, h = fused_mlp.mlp_core_plain(
            t["x"], t["w1"], t["b1"], t["w2"], t["b2"], seed=SEED,
            threshold=threshold, save_h=True)
    return h


def _tile_sums(v, rows):
    """Column sums of ``v`` per tile of ``rows`` rows, [tiles, width]."""
    return torch.stack([v[r:r + rows].sum(0)
                        for r in range(0, v.shape[0], rows)])


def _fixed_order_sum(parts):
    out = torch.zeros_like(parts[0])
    for part in parts:
        out = out + part
    return out


def _split_gemm(a, b, splits):
    """``a^T b`` with the reduction over the rows cut into ``splits``
    contiguous ranges of 64-row tiles, summed in split order."""
    k_tiles = -(-a.shape[0] // K_TILE)
    per = -(-k_tiles // splits) * K_TILE
    return _fixed_order_sum([a[z * per:(z + 1) * per].t()
                             @ b[z * per:(z + 1) * per]
                             for z in range(splits)])


def emulate(t, h, *, ln, threshold, splits):
    """The passes of the bf16 backward on ``[N, D]`` rows; returns the
    plain version's gradient tuple, in its dtypes."""
    dt = t["x"].dtype

    def rnd(v):
        return v.to(dt).float()

    n = t["x"].shape[0]
    inv_keep = 256.0 / (256.0 - threshold)
    x32, do32, h32 = t["x"].float(), t["dout"].float(), h.float()
    w1, w2 = t["w1"].float(), t["w2"].float()
    # 1. the LN row pass (LN), else the operands as they are.
    if ln:
        xhat, rstd, y = fused_mlp._ln(x32, t["gamma"], t["beta"], EPS)
        y_c = rnd(y)
        df = do32
        if threshold:
            keep1 = fused_mlp._keep(SEED, 1, n, D, threshold, "cpu")
            df = torch.where(keep1, do32 * inv_keep, 0.0)
        df_c = rnd(df)
    else:
        y_c, df, df_c = x32, do32, do32
    # 2. dg in 128-row tiles (rows past N zero-filled), then the epilogue.
    pad = (-n) % GEMM_ROWS
    dg = torch.cat([torch.nn.functional.pad(df_c, (0, 0, 0, pad))[
        r:r + GEMM_ROWS] @ w2.t() for r in range(0, n + pad, GEMM_ROWS)])[:n]
    g_drop = fused_mlp._gelu_exact(h32)
    if threshold:
        keep0 = fused_mlp._keep(SEED, 0, n, F, threshold, "cpu")
        dg = torch.where(keep0, dg * inv_keep, 0.0)
        g_drop = torch.where(keep0, g_drop * inv_keep, 0.0)
    dh = dg * fused_mlp._gelu_grad(h32)
    dh_c, g_c = rnd(dh), rnd(g_drop)
    p_db1 = _tile_sums(dh, GEMM_ROWS)
    # 3. dy into the f32 buffer.
    dy = dh_c @ w1.t()
    # 4. the LN backward and the column partials of 32-row tiles.
    if ln:
        dxhat = dy * t["gamma"]
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = do32 + rstd * (dxhat - m1 - xhat * m2)
        dgamma = _fixed_order_sum(list(_tile_sums(dy * xhat, ROW_TILE)))
        dbeta = _fixed_order_sum(list(_tile_sums(dy, ROW_TILE)))
    else:
        dx = dy
    db2 = _fixed_order_sum(list(_tile_sums(df, ROW_TILE)))
    # 5. the weight GEMMs, split, and 6. the fixed-order column sums.
    dw1 = _split_gemm(y_c, dh_c, splits)
    dw2 = _split_gemm(g_c, df_c, splits)
    db1 = _fixed_order_sum(list(p_db1))
    if ln:
        return (dx.to(dt), dgamma, dbeta, dw1.to(dt), db1.to(dt),
                dw2.to(dt), db2.to(dt))
    return (dx.to(dt), dw1.to(dt), db1.to(dt), dw2.to(dt), db2.to(dt))


def _plain(t, h, *, ln, threshold):
    if ln:
        return fused_mlp.ln_mlp_residual_bwd_plain(
            t["x"], h, t["gamma"], t["beta"], t["w1"], t["w2"], t["dout"],
            eps=EPS, seed=SEED, threshold=threshold)
    return fused_mlp.mlp_core_bwd_plain(
        t["x"], h, t["w1"], t["b1"], t["w2"], t["dout"], seed=SEED,
        threshold=threshold)


def _rel(a, b):
    """max |a - b| / max |b|; ``a`` a tensor or a numpy array."""
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("ln", [True, False], ids=["row2", "row7"])
def test_pass_emulation_equals_plain_f32(ln, threshold, splits):
    t = _tensors(_inputs(10 + threshold), torch.float32)
    h = _saved_h(t, ln, threshold)
    got = emulate(t, h, ln=ln, threshold=threshold, splits=splits)
    want = _plain(t, h, ln=ln, threshold=threshold)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) < 1e-5


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("ln", [True, False], ids=["row2", "row7"])
def test_pass_emulation_matches_jax_interpret(ln, threshold):
    """The emulation against the JAX package's backward kernel (Pallas in
    interpret mode) on the same h and cotangent, rows padded to its
    16-row block with zeros (as its wrapper pads them)."""
    p = _inputs(20 + threshold)
    t = _tensors(p, torch.float32)
    h = _saved_h(t, ln, threshold)
    got = emulate(t, h, ln=ln, threshold=threshold, splits=2)
    pad = (-N) % JAX_BLOCK

    def rows(a):
        return jnp.asarray(np.pad(np.asarray(a), ((0, pad), (0, 0))))
    seed = jnp.asarray([SEED], jnp.int32)
    if ln:
        res = (rows(p["x"]), rows(h), jnp.asarray(p["gamma"]),
               jnp.asarray(p["beta"]), jnp.asarray(p["w1"]),
               jnp.asarray(p["w2"]), seed)
        want = jax_lnmlp_bwd(threshold, JAX_BLOCK, EPS, True, res,
                             rows(p["dout"]))[:7]
    else:
        res = (rows(p["x"]), rows(h), jnp.asarray(p["w1"]),
               jnp.asarray(p["b1"]), jnp.asarray(p["w2"]), seed)
        want = jax_fused_bwd(threshold, JAX_BLOCK, True, res,
                             rows(p["dout"]))[:5]
    want = [np.asarray(w)[:N] if i == 0 else np.asarray(w)
            for i, w in enumerate(want)]
    assert len(got) == len(want)
    for a, w in zip(got, want):
        assert tuple(a.shape) == w.shape
        assert _rel(w, a) < 2e-3


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("ln", [True, False], ids=["row2", "row7"])
def test_pass_emulation_bf16_inside_kernel_bounds(ln, threshold):
    """bf16 operands: the passes round y_c, df_c, dh_c and g_c where the
    plain version does, so they stay within the card's bound (2e-2 of
    each gradient's largest element) of it."""
    t = _tensors(_inputs(30 + threshold), torch.bfloat16)
    h = _saved_h(t, ln, threshold)
    got = emulate(t, h, ln=ln, threshold=threshold, splits=2)
    want = _plain(t, h, ln=ln, threshold=threshold)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) < 2e-2


def test_bf16_backward_operands_must_be_16_byte_aligned():
    """The bf16 backward passes read x, h, W1, W2 and dO through TMA: the
    wrappers refuse an operand that is not 16-byte aligned before any
    launch (the check runs on any device, so the CPU shows it); f32 runs
    the SIMT kernels, which take any alignment."""
    n, d, f = 5, 384, 1536  # a width the kernels take
    bf = dict(dtype=torch.bfloat16)
    x, dout = torch.zeros(n, d, **bf), torch.zeros(n, d, **bf)
    h, w1, w2 = (torch.zeros(n, f, **bf), torch.zeros(d, f, **bf),
                 torch.zeros(f, d, **bf))
    b1, gamma, beta = torch.zeros(f, **bf), torch.ones(d), torch.zeros(d)
    odd = torch.zeros(n * d + 1, **bf)[1:].view(n, d)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = (fused_mlp.bwd_launches, fused_mlp.core_bwd_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp._launch_bwd(x, h, gamma, beta, w1, w2, odd, eps=EPS,
                              seed=0, threshold=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp._launch_core_bwd(odd, h, w1, b1, w2, dout, seed=0,
                                   threshold=0)
    assert (fused_mlp.bwd_launches, fused_mlp.core_bwd_launches) == before
    odd32 = torch.zeros(N * D + 1)[1:].view(N, D)
    assert odd32.data_ptr() % 16
    _build.check_tma(odd32, odd32)  # f32: no TMA, no refusal
