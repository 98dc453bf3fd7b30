"""The port's 8-bit attention-probs storage against the JAX package's.

``ops/quant.py`` packs and unpacks bit for bit as the JAX module does, on
a grid over [0, 1] that holds 0, 1, the e4m3 subnormal edge (2^-6) and
its neighbours, every e4m3 subnormal, and u8 ties ((k + 1/2) / 255, which
round to even in both). ``_xla_attention`` with quantized storage
(``_QuantizedSoftmaxPV``, the port of JAX's ``_quantized_softmax_pv``)
matches JAX's forward (1e-4) and gradients (2e-3 of each gradient's
largest element) for each (probs, residual) pair, in f32; a 2-layer ViT
with u8 storage follows JAX's 5-step trajectory within the bounds of
``tests/test_torch_engine.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops import quant as jquant
from pytorch_vit_paper_replication_tpu.ops.attention import (
    _xla_attention as jax_xla)
from pytorch_vit_paper_replication_tpu_torch.ops import attention, quant
from test_torch_engine import RECIPE, _batches, _init, _jax_run, _port_run

FWD_TOL, GRAD_TOL = 1e-4, 2e-3
NARROW = ("fp8_e4m3", "fp8_e5m2", "u8")


def _grid() -> np.ndarray:
    rng = np.random.default_rng(0)
    edge = np.float32(2.0 ** -6)
    special = [0.0, 1.0, edge, np.nextafter(edge, np.float32(0)),
               np.nextafter(edge, np.float32(1)), 0.531494]
    return np.concatenate([
        np.array(special, np.float32),
        np.arange(1, 9, dtype=np.float32) * 2.0 ** -9,   # e4m3 subnormals
        (np.arange(255, dtype=np.float32) + 0.5) / 255,  # u8 ties
        np.linspace(0.0, 1.0, 4097, dtype=np.float32),
        rng.random(20000, dtype=np.float32),
        rng.random(2000, dtype=np.float32) * 2.0 ** -5,
    ]).astype(np.float32)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("name", NARROW + ("bf16",))
def test_quantize_bit_equal_to_jax(name):
    w = _grid()
    want = np.asarray(jquant.quantize_probs(jnp.asarray(w), name))
    got = quant.quantize_probs(torch.from_numpy(w), name)
    if name != "bf16":
        assert got.dtype == quant.storage_dtype(name)
    np.testing.assert_array_equal(
        _bits(got.view(torch.uint8).numpy() if name != "bf16"
              else got.view(torch.int16).numpy()),
        _bits(want))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NARROW)
def test_dequantize_equal_to_jax(name, out):
    """Every one of the 256 codes unpacks to JAX's value (NaN codes of the
    fp8 formats to NaN on both sides)."""
    codes = np.arange(256, dtype=np.uint8)
    jstore = jnp.asarray(codes).view(jquant.storage_dtype(name))
    want = np.asarray(jquant.dequantize_probs(
        jstore, name, jnp.dtype(out)).astype(jnp.float32))
    tstore = torch.from_numpy(codes).view(quant.storage_dtype(name))
    got = quant.dequantize_probs(tstore, name, getattr(torch, out))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_storage_sizes():
    for name in quant.PROBS_DTYPES:
        assert quant.storage_bits(name) == jquant.storage_bits(name)
        assert quant.probs_tensor_mb(32, 12, 197, name) == \
            jquant.probs_tensor_mb(32, 12, 197, name)
    assert quant.PROBS_DTYPES == jquant.PROBS_DTYPES


def _qkv(seed, b=2, t=64, h=2, dh=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32)
            for _ in range(4)]


PAIRS = [("fp8_e4m3", None), ("fp8_e5m2", None), ("u8", None),
         ("bf16", "u8"), ("bf16", "fp8_e4m3"), ("u8", "bf16"),
         ("fp8_e4m3", "u8"), ("bf16", None)]


@pytest.mark.parametrize("softmax", ["saturating", "exact"])
@pytest.mark.parametrize("pd,rd", PAIRS)
def test_xla_attention_quantized_matches_jax(pd, rd, softmax):
    """Forward and the q, k, v gradients of ``sum(out * ct)``, with a
    key-padding mask."""
    q, k, v, ct = _qkv(len(pd) + 3 * len(rd or ""))
    mask = np.random.default_rng(1).random((2, 1, 1, 64)) < 0.8
    mask[..., 0] = True
    kw = dict(deterministic=True, softmax=softmax, probs_dtype=pd,
              residual_dtype=rd)

    def jloss(args):
        out = jax_xla(*args, dropout_rate=0.0, dropout_rng=None,
                      mask=jnp.asarray(mask), **kw)
        return (out * jnp.asarray(ct)).sum(), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(a) for a in (q, k, v)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = attention._xla_attention(*targs, mask=torch.from_numpy(mask),
                                   **kw)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for name, w, t in zip("qkv", want_g, targs):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max() / np.abs(w).max()
        assert err < GRAD_TOL, (f"d{name}", err)


def test_quantized_storage_really_quantizes():
    """u8 storage moves the forward off the bf16-storage result (f32
    compute: bf16 storage is the f32 weights), by at most half a u8 step
    of the weights times |v|."""
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(5))
    exact = attention._xla_attention(q, k, v)
    u8 = attention._xla_attention(q, k, v, probs_dtype="u8")
    diff = (u8 - exact).abs().max().item()
    assert 0.0 < diff <= 64 * 0.5 / 255 * v.abs().max().item()


def test_quantized_with_dropout_warns_and_uses_bf16_storage():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(4, t=32))
    kw = dict(dropout_rate=0.5, seed=7, deterministic=False)
    attention._warn_once.cache_clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out_q = attention._xla_attention(q, k, v, probs_dtype="u8", **kw)
    assert any("does not compose with" in str(w.message) for w in caught)
    out_b = attention._xla_attention(q, k, v, probs_dtype="bf16", **kw)
    torch.testing.assert_close(out_q, out_b, atol=0.0, rtol=0.0)


def test_vit_u8_storage_follows_jax_trajectory():
    """A 2-layer ViT (f32, xla attention and MLP) with u8 probs storage:
    5 steps of the port against 5 of JAX from the same weights and
    batches; the bounds of tests/test_torch_engine.py."""
    steps = 5
    cfg, params = _init(mlp_impl="xla", attention_impl="xla",
                        attention_probs_dtype="u8")
    batches = _batches(n=steps)
    jm, jp, _ = _jax_run(cfg, params, batches, RECIPE, steps)
    tm, tp, _ = _port_run(cfg, params, batches, RECIPE, steps)
    for key in ("loss_sum", "grad_norm", "correct"):
        np.testing.assert_allclose([m[key] for m in tm],
                                   [m[key] for m in jm], rtol=5e-4,
                                   atol=5e-4, err_msg=key)
    from pytorch_vit_paper_replication_tpu_torch.convert import flatten_tree
    flat_j, flat_t, flat_0 = (flatten_tree(p) for p in (jp, tp, params))
    for key, t in flat_t.items():
        j, t0 = np.float64(flat_j[key]), np.float64(flat_0[key])
        if key.endswith("qkv/bias"):
            assert np.abs(t - j).max() < 2e-3, key
        else:
            move = max(np.linalg.norm(j - t0), 1e-4)
            assert np.linalg.norm(t - j) / move < 5e-3, key
