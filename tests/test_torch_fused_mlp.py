"""The port's fused LN->MLP->residual against the JAX package's.

The JAX side runs its Pallas kernel exactly as its own tests do on the
CPU (interpret mode, auto-selected off-TPU); the port's wrapper runs its
kernel's plain PyTorch version on CPU tensors. Tolerances: f32 forward
1e-4 (the JAX package's own, tests/test_fused_mlp.py); bf16 2e-2 (a
bf16 ulp at |x| < 4, the two sides round the same f32 values to bf16
after summing in different orders).
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
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(seed, lead=(2, 25)):
    """Seeded numpy inputs; 50 rows is not a multiple of the JAX row
    block (16), so the JAX wrapper pads and the port must not care."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((*lead, D)).astype(f32),
        gamma=(1.0 + 0.1 * rng.standard_normal(D)).astype(f32),
        beta=(0.1 * rng.standard_normal(D)).astype(f32),
        w1=(0.1 * rng.standard_normal((D, F))).astype(f32),
        b1=(0.1 * rng.standard_normal(F)).astype(f32),
        w2=(0.1 * rng.standard_normal((F, D))).astype(f32),
        b2=(0.1 * rng.standard_normal(D)).astype(f32),
    )


def _run_both(p, dtype, rate, key):
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    cast = ("x", "w1", "b1", "w2", "b2")
    jargs = {k: jnp.asarray(v).astype(jdt) if k in cast else jnp.asarray(v)
             for k, v in p.items()}
    want = jax_fused(**jargs, dropout_rate=rate, dropout_rng=key,
                     deterministic=rate == 0.0)
    seed = int(np.asarray(derive_positional_seed(key))[0])
    targs = {k: torch.from_numpy(v).to(tdt) if k in cast
             else torch.from_numpy(v) for k, v in p.items()}
    got = fused_mlp.fused_ln_mlp_residual(
        **targs, dropout_rate=rate, seed=seed, deterministic=rate == 0.0)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_mlp_residual_matches_jax(dtype, rate):
    p = _inputs(0)
    want, got = _run_both(p, dtype, rate, jax.random.key(11))
    assert got.shape == p["x"].shape
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_fused_dropout_masks_match_jax_exactly():
    """x = 0, w2 = 0, b2 = 1 make the output keep2 * inv_keep, so the
    output-dropout (tag 1) keep mask is recovered bit for bit from both
    sides; the hidden mask (tag 0) is held by the full-forward test."""
    p = _inputs(1)
    p["w2"][:] = 0.0
    p["b2"][:] = 1.0
    p["x"][:] = 0.0
    want, got = _run_both(p, "float32", 0.1, jax.random.key(5))
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    assert 0.05 < (got == 0.0).mean() < 0.16


def test_fused_no_dropout_when_deterministic():
    p = _inputs(2, lead=(7,))
    a, b = _run_both(p, "float32", 0.0, jax.random.key(0))
    targs = {k: torch.from_numpy(v) for k, v in p.items()}
    c = fused_mlp.fused_ln_mlp_residual(**targs, dropout_rate=0.1,
                                        deterministic=True)
    np.testing.assert_array_equal(c.numpy(), b)
    np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)


def test_fused_plain_version_runs_on_cpu_without_a_launch():
    before = fused_mlp.launches
    p = _inputs(3, lead=(4,))
    fused_mlp.fused_ln_mlp_residual(
        **{k: torch.from_numpy(v) for k, v in p.items()})
    assert fused_mlp.launches == before


def test_fused_argument_checks():
    p = {k: torch.from_numpy(v) for k, v in _inputs(4, lead=(3,)).items()}
    with pytest.raises(ValueError, match="residual form"):
        fused_mlp.fused_ln_mlp_residual(
            **{**p, "w2": p["w2"][:, :32], "b2": p["b2"][:32]})
    with pytest.raises(ValueError, match="seed"):
        fused_mlp.fused_ln_mlp_residual(**p, dropout_rate=0.1,
                                        deterministic=False)
