"""The port's MLP core (no LN, no residual) against the JAX ``fused_mlp``.

The JAX side runs its Pallas kernels as its own tests do on the CPU
(interpret mode, auto-selected off-TPU), forward and ``jax.grad``; the
port's wrapper runs the kernels' plain PyTorch versions on CPU tensors
through ``_MlpFunction``. Same seeded numpy inputs and cotangent on both
sides. Tolerances: f32 forward 1e-4 and gradients 2e-3 relative to each
gradient's largest element (the JAX package's own); bf16 2e-2, as
``tests/test_torch_fused_mlp.py`` and ``test_torch_fused_mlp_grad.py``
hold the LN form (the two sides round the same f32 values to bf16 after
summing in different orders). 50 rows are not a multiple of the JAX row
block (16). The JAX kernel's output is ``[N, D]``, so ``D_out != D`` (which
the port's plain version takes) is held to the JAX positional mask alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed, positional_keep_u8 as jax_keep)
from pytorch_vit_paper_replication_tpu.ops.fused_mlp import (
    fused_mlp as jax_fused_mlp)
from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp

D, F = 64, 256
NAMES = ("x", "w1", "b1", "w2", "b2")
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _inputs(seed, n=50, d_out=D):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = dict(x=rng.standard_normal((n, D)).astype(f32),
             w1=(0.2 * rng.standard_normal((D, F))).astype(f32),
             b1=(0.1 * rng.standard_normal(F)).astype(f32),
             w2=(0.1 * rng.standard_normal((F, d_out))).astype(f32),
             b2=(0.1 * rng.standard_normal(d_out)).astype(f32))
    return p, rng.standard_normal((n, d_out)).astype(f32)


def _run(p, ct, dtype, rate, key):
    """(jax out, jax grads, port out, port grads), f32 numpy."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    det = rate == 0.0

    def jfwd(args):
        return jax_fused_mlp(*args, dropout_rate=rate, dropout_rng=key,
                             deterministic=det)

    jargs = tuple(jnp.asarray(p[n]).astype(jdt) for n in NAMES)
    want = jfwd(jargs)
    want_g = jax.grad(lambda a: (jfwd(a).astype(jnp.float32)
                                 * jnp.asarray(ct)).sum())(jargs)
    seed = int(np.asarray(derive_positional_seed(key))[0])
    targs = [torch.from_numpy(p[n]).to(tdt).requires_grad_() for n in NAMES]
    got = fused_mlp.fused_mlp(*targs, dropout_rate=rate, seed=seed,
                              deterministic=det)
    (got.float() * torch.from_numpy(ct)).sum().backward()
    for t in targs:
        assert t.grad.dtype == t.dtype
    return (np.asarray(want.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in want_g],
            got.detach().float().numpy(), [t.grad.float().numpy()
                                           for t in targs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_core_matches_jax_forward_and_grads(dtype, rate):
    p, ct = _inputs(0)
    want, want_g, got, got_g = _run(p, ct, dtype, rate, jax.random.key(3))
    assert got.shape == (50, D)
    np.testing.assert_allclose(got, want, atol=FWD_TOL[dtype],
                               rtol=FWD_TOL[dtype])
    for name, w, g in zip(NAMES, want_g, got_g):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < GRAD_TOL[dtype], f"d{name}: {err}"


@pytest.mark.parametrize("d_out", [D, 32])
def test_mlp_core_dropout_mask_bit_identical_to_jax(d_out):
    """x = 0, w1 = 0, b1 = 3 give g = gelu(3) on every hidden element; a
    one-hot w2 column block and b2 = 0 make out[r, j] = keep(r, c0 + j) *
    g * inv_keep, so the hidden mask (tag 0, flattened row, local hidden
    column) is read off column block c0 of every row. The zero pattern
    must equal the JAX positional mask bit for bit, on both sides (the
    JAX kernel only at D_out = D, the one output width it takes)."""
    key = jax.random.key(21)
    seed = int(np.asarray(derive_positional_seed(key))[0])
    rows = np.arange(50)[:, None]
    for c0 in range(0, F, d_out):
        p, _ = _inputs(1, d_out=d_out)
        p["x"][:] = 0.0
        p["w1"][:] = 0.0
        p["b1"][:] = 3.0
        p["w2"][:] = 0.0
        p["w2"][c0 + np.arange(d_out), np.arange(d_out)] = 1.0
        p["b2"][:] = 0.0
        tout = fused_mlp.fused_mlp(
            *(torch.from_numpy(p[n]) for n in NAMES), dropout_rate=0.1,
            seed=seed, deterministic=False).numpy()
        keep = np.asarray(jax_keep(
            jnp.int32(seed), jnp.int32(0), jnp.asarray(rows, jnp.int32),
            jnp.asarray(c0 + np.arange(d_out)[None, :], jnp.int32), 26))
        np.testing.assert_array_equal(tout != 0.0, keep)
        if d_out == D:
            jout = np.asarray(jax_fused_mlp(
                *(jnp.asarray(p[n]) for n in NAMES), dropout_rate=0.1,
                dropout_rng=key, deterministic=False))
            np.testing.assert_array_equal(jout != 0.0, keep)
        assert 0.05 < 1.0 - keep.mean() < 0.16


def test_mlp_core_leading_shape_and_cpu_counts_no_launch():
    p, _ = _inputs(2, n=12)
    before = (fused_mlp.core_launches, fused_mlp.core_bwd_launches)
    x = torch.from_numpy(p["x"]).reshape(3, 4, D).requires_grad_()
    w = [torch.from_numpy(p[n]).requires_grad_() for n in NAMES[1:]]
    out = fused_mlp.fused_mlp(x, *w)
    assert out.shape == (3, 4, D)
    out.sum().backward()
    assert (fused_mlp.core_launches, fused_mlp.core_bwd_launches) == before
    with torch.no_grad():
        ref, h = fused_mlp.mlp_core_plain(
            x.reshape(12, D), *w, seed=0, threshold=0, save_h=True)
    torch.testing.assert_close(out.detach().reshape(12, D), ref, rtol=0,
                               atol=0)
    assert h.shape == (12, F)
    with pytest.raises(ValueError, match="seed"):
        fused_mlp.fused_mlp(x, *w, dropout_rate=0.1, deterministic=False)
