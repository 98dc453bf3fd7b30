"""The port's dropout against the JAX package's.

The positional keep mask is integer math, so the port must match bit for
bit — including every 32-bit multiply that wraps — over random
(seed, bh, row, col) grids. The generator-driven dropout draws its uint8
bits from a ``torch.Generator`` where JAX uses threefry, so the two
streams differ: it is held to JAX's threshold/scale semantics exactly and
to the keep probability by statistics (bound: 6 standard deviations of a
binomial keep fraction, ~1e-9 false-failure odds).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu_torch.ops import attention as tatt
from pytorch_vit_paper_replication_tpu_torch.ops import dropout as tdrop

# The JAX package's ops/__init__ exports a ``dropout`` function that
# shadows the submodule attribute; load the module itself.
jdrop = importlib.import_module("pytorch_vit_paper_replication_tpu.ops.dropout")
jatt = importlib.import_module(
    "pytorch_vit_paper_replication_tpu.ops.attention")


def _grid(rng, n):
    seed = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(
        np.int32)
    bh = rng.integers(0, 2**16, size=n, dtype=np.int64).astype(np.int32)
    # Large coordinates make row*0x9E3779B1 etc. wrap mod 2**32 many times.
    row = rng.integers(0, 2**31, size=n, dtype=np.int64).astype(np.int32)
    col = rng.integers(0, 2**31, size=n, dtype=np.int64).astype(np.int32)
    return seed, bh, row, col


@pytest.mark.parametrize("threshold", [0, 1, 26, 128, 255])
def test_positional_keep_u8_bit_equal_random_grid(threshold):
    seed, bh, row, col = _grid(np.random.default_rng(threshold), 4096)
    want = np.asarray(jdrop.positional_keep_u8(
        jnp.asarray(seed), jnp.asarray(bh), jnp.asarray(row),
        jnp.asarray(col), threshold))
    got = tdrop.positional_keep_u8(
        torch.from_numpy(seed), torch.from_numpy(bh), torch.from_numpy(row),
        torch.from_numpy(col), threshold).numpy()
    np.testing.assert_array_equal(got, want)


def test_positional_keep_u8_bit_equal_broadcast_block():
    """The shapes the kernels use: one seed, one tag, a [rows, cols]
    block of global coordinates (fused-MLP hidden tile, tag 0/1)."""
    rng = np.random.default_rng(7)
    seed = int(rng.integers(-2**31, 2**31))
    rows = np.arange(1000, 1064, dtype=np.int32)[:, None]
    cols = np.arange(0, 3072, dtype=np.int32)[None, :]
    for tag in (0, 1):
        want = np.asarray(jdrop.positional_keep_u8(
            jnp.int32(seed), jnp.int32(tag), jnp.asarray(rows),
            jnp.asarray(cols), 26))
        got = tdrop.positional_keep_u8(
            seed, tag, torch.from_numpy(rows), torch.from_numpy(cols),
            26).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0.85 < got.mean() < 0.95   # ~1 - 26/256 kept


def test_avalanche_u32_bit_equal():
    x = np.random.default_rng(3).integers(0, 2**32, size=8192,
                                          dtype=np.uint64)
    x[:4] = [0, 1, 2**32 - 1, 2**31]
    want = np.asarray(jdrop.avalanche_u32(jnp.asarray(x, jnp.uint32)))
    got = tdrop.avalanche_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("rate", [0.0, 0.001, 0.05, 0.1, 0.3, 0.5, 0.9,
                                  0.998, 1.0])
def test_threshold_and_quantized_rate_equal(rate):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tdrop._threshold(rate) == jdrop._threshold(rate)
        assert tdrop.quantized_rate(rate) == jdrop.quantized_rate(rate)


def test_threshold_rejects_out_of_range():
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError):
            tdrop._threshold(bad)


def test_dropout_module_is_eval_identity_and_refuses_training():
    """Eval (or a rate quantizing to 0) is the identity; training-mode
    dropout refuses to run without an explicit generator."""
    mod = tdrop.Dropout(0.1).eval()
    x = torch.randn(3, 4)
    assert mod(x) is x
    assert tdrop.Dropout(0.0).train()(x) is x
    with pytest.raises(ValueError, match="generator"):
        mod.train()(x)


def _six_sigma(p, n):
    return 6.0 * (p * (1.0 - p) / n) ** 0.5


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_threshold_scale_and_keep_fraction(rate, dtype):
    """Survivors are x * (1 / (1 - t/256)) cast to x's dtype (JAX casts the
    scale first), dropped elements 0, and the keep fraction is within the
    statistical bound of 1 - quantized_rate on both sides."""
    n = 200_000
    x = torch.ones(n, dtype=dtype)
    gen = torch.Generator().manual_seed(int(rate * 100))
    out = tdrop.dropout(x, rate, gen)
    t = tdrop._threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - t / 256.0), dtype=dtype)
    assert out.dtype == dtype
    assert set(torch.unique(out).tolist()) == {0.0, float(scale)}
    p_keep = 1.0 - tdrop.quantized_rate(rate)
    keep = (out != 0).double().mean().item()
    assert abs(keep - p_keep) < _six_sigma(p_keep, n)
    jout = np.asarray(jdrop.dropout(jnp.ones(n, jnp.dtype(str(dtype)[6:])),
                                    rate, jax.random.key(1))
                      .astype(jnp.float32))
    assert set(np.unique(jout).tolist()) == {0.0, float(scale)}
    assert abs((jout != 0).mean() - p_keep) < _six_sigma(p_keep, n)


def test_dropout_rate_one_and_zero_and_reproducible():
    x = torch.randn(64)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(tdrop.dropout(x, 1.0, gen), torch.zeros(64))
    assert tdrop.dropout(x, 0.0, gen) is x
    a = tdrop.Dropout(0.1).train()(x, torch.Generator().manual_seed(5))
    b = tdrop.Dropout(0.1).train()(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, x)
    s1 = tdrop.derive_positional_seed(torch.Generator().manual_seed(2))
    s2 = tdrop.derive_positional_seed(torch.Generator().manual_seed(2))
    assert s1 == s2 and -2**31 <= s1 < 2**31 and isinstance(s1, int)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_attention_dropout_semantics_match_jax(dtype):
    """q = k = 0 give uniform weights 1/T; v = one-hot per key makes
    out[b, q, h, j] = dropped weight of key j. Survivors equal
    (1/T) / (1 - t/256) in f32 then cast (the port and JAX drop the f32
    weights before the cast), and the keep fraction is within the
    statistical bound on both sides."""
    b, t, h = 8, 32, 4
    q = np.zeros((b, t, h, t), np.float32)
    v = np.broadcast_to(np.eye(t, dtype=np.float32)[None, :, None, :],
                        (b, t, h, t)).copy()
    jout = np.asarray(jatt._xla_attention(
        *(jnp.asarray(a).astype(dtype) for a in (q, q, v)),
        dropout_rate=0.1, dropout_rng=jax.random.key(0),
        deterministic=False, softmax="exact").astype(jnp.float32))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    tout = tatt.dot_product_attention(
        tq, tq, torch.from_numpy(v).to(getattr(torch, dtype)), impl="xla",
        dropout_rate=0.1, seed=3, deterministic=False,
        softmax="exact").float().numpy()
    p_keep = 1.0 - tdrop.quantized_rate(0.1)
    for out in (jout, tout):
        vals = np.unique(out)
        assert len(vals) == 2 and vals[0] == 0.0
        assert abs((out != 0).mean() - p_keep) < _six_sigma(p_keep, out.size)
    np.testing.assert_array_equal(np.unique(tout), np.unique(jout))
