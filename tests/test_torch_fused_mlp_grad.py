"""The port's fused LN->MLP->residual gradients against the JAX package's.

``jax.grad`` through ``fused_ln_mlp_residual`` (its Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU)
against ``torch.autograd`` through the port's ``autograd.Function`` (the
plain versions of the forward and backward kernels on CPU tensors), for
all seven gradients, on the same seeded numpy inputs and cotangent.
Tolerances, relative to the largest element of each gradient: f32 2e-3
(the JAX package's grad tolerance), bf16 2e-2 (bf16 operands and the
saved bf16 h; the two frameworks sum in different orders before the same
roundings). N = 50 rows is not a multiple of the JAX row block (16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed)
from pytorch_vit_paper_replication_tpu.ops.fused_mlp import (
    fused_ln_mlp_residual as jax_fused)
from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp

D, F = 64, 256
NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
CAST = ("x", "w1", "b1", "w2", "b2")
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _inputs(seed, n=50):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = dict(
        x=rng.standard_normal((n, D)).astype(f32),
        gamma=(1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        beta=(0.1 * rng.standard_normal(D)).astype(f32),
        w1=(0.2 * rng.standard_normal((D, F))).astype(f32),
        b1=(0.1 * rng.standard_normal(F)).astype(f32),
        w2=(0.1 * rng.standard_normal((F, D))).astype(f32),
        b2=(0.1 * rng.standard_normal(D)).astype(f32))
    ct = rng.standard_normal((n, D)).astype(f32)
    return p, ct


def _grads(p, ct, dtype, rate, key):
    """(jax grads, port grads) as f32 numpy lists in NAMES order."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    det = rate == 0.0

    def jloss(args):
        out = jax_fused(*args, dropout_rate=rate, dropout_rng=key,
                        deterministic=det)
        return (out.astype(jnp.float32) * jnp.asarray(ct)).sum()

    jargs = tuple(jnp.asarray(p[n]).astype(jdt) if n in CAST
                  else jnp.asarray(p[n]) for n in NAMES)
    want = jax.grad(jloss)(jargs)
    seed = int(np.asarray(derive_positional_seed(key))[0])
    targs = [torch.from_numpy(p[n]).to(tdt if n in CAST else torch.float32)
             .requires_grad_() for n in NAMES]
    out = fused_mlp.fused_ln_mlp_residual(
        *targs, dropout_rate=rate, seed=seed, deterministic=det)
    (out.float() * torch.from_numpy(ct)).sum().backward()
    got = [t.grad for t in targs]
    for t, g in zip(targs, got):
        assert g.dtype == t.dtype
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [g.float().numpy() for g in got])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_mlp_grads_match_jax(dtype, rate):
    p, ct = _inputs(0)
    want, got = _grads(p, ct, dtype, rate, jax.random.key(3))
    for name, w, g in zip(NAMES, want, got):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < TOL[dtype], f"d{name}: {err}"


@pytest.mark.parametrize("row", [0, 17, 36])
def test_fused_mlp_grad_masks_bit_identical(row):
    """Both dropout masks of one row, recovered by feeding ones: w1 = 0,
    b1 = 3 make h = 3 (g > 0) everywhere, w2 = b2 = 0, and a cotangent
    of ones on ``row`` only gives dW2[f, d] = keep0[row, f] * keep1[row,
    d] * const, so the zero pattern of dW2 is the outer product of the
    row's hidden (tag 0) and output (tag 1) keep masks. It must be the
    same bit for bit on both sides, and so must the zero pattern of db2
    (the row's output mask)."""
    p, ct = _inputs(1, n=37)
    p["w1"][:] = 0.0
    p["b1"][:] = 3.0
    p["w2"][:] = 0.0
    p["b2"][:] = 0.0
    ct[:] = 0.0
    ct[row] = 1.0
    want, got = _grads(p, ct, "float32", 0.1, jax.random.key(8))
    np.testing.assert_array_equal(got[5] == 0.0, want[5] == 0.0)
    np.testing.assert_array_equal(got[6] == 0.0, want[6] == 0.0)
    kept = (got[5] != 0.0).mean()
    assert 0.7 < kept < 0.9          # ~(1 - 26/256)^2 of the pairs


def test_fused_mlp_function_saves_h_and_counts_no_launch_on_cpu():
    p, _ = _inputs(2, n=9)
    targs = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    before = (fused_mlp.launches, fused_mlp.bwd_launches)
    out = fused_mlp.fused_ln_mlp_residual(**targs)
    fn = out.grad_fn.next_functions[0][0]     # under the reshape's view
    assert "_LnMlpFunction" in type(fn).__name__
    out.sum().backward()
    assert (fused_mlp.launches, fused_mlp.bwd_launches) == before
    with torch.no_grad():
        ref, h = fused_mlp.ln_mlp_residual_plain(
            *(targs[n] for n in NAMES), eps=1e-6, seed=0, threshold=0,
            save_h=True)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    assert h.shape == (9, F) and h.dtype == torch.float32
