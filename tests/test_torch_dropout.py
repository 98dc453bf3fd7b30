"""The port's positional dropout hash against the JAX package's.

The keep mask is integer math, so the port must match bit for bit —
including every 32-bit multiply that wraps — over random
(seed, bh, row, col) grids.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu_torch.ops import dropout as tdrop

# The JAX package's ops/__init__ exports a ``dropout`` function that
# shadows the submodule attribute; load the module itself.
jdrop = importlib.import_module("pytorch_vit_paper_replication_tpu.ops.dropout")


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
    mod = tdrop.Dropout(0.1).eval()
    x = torch.randn(3, 4)
    assert mod(x) is x
    assert tdrop.Dropout(0.0).train()(x) is x
    with pytest.raises(NotImplementedError):
        mod.train()(x)
