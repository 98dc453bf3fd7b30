"""The port's flash attention with masks and unequal key length, against
the JAX package's Pallas kernels.

The JAX side runs ``flash_attention`` in interpret mode (auto-selected off
the TPU, as its own tests run it); the port's wrapper runs the kernels'
plain versions on CPU tensors. Same seeded numpy inputs, mask and
cotangent on both sides, f32; tolerances: forward 1e-4, gradients 2e-3
relative to each gradient's largest element (the JAX package's own).
T = 200 is not a multiple of a port block (64) or of 8 rows past the JAX
block; the mask forms are those ``tests/test_ops.py`` holds JAX's kernel
to: the four batch/head modes, a q-broadcast per-head mask and a
key-broadcast (query-row) mask with fully masked rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.attention import (
    _xla_attention as jax_xla)
from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed)
from pytorch_vit_paper_replication_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from pytorch_vit_paper_replication_tpu_torch.ops import (
    attention, flash_attention as fa)

FWD_TOL, GRAD_TOL = 1e-4, 2e-3
B, H, DH = 2, 2, 16


def _inputs(seed, tq, tk=None, mask_shape=None, p=0.8):
    """q ``[B, Tq, H, Dh]``, k, v ``[B, Tk, H, Dh]``, a cotangent and a
    seeded bool mask whose key 0 always attends (no fully masked row)
    unless the mask is key-broadcast."""
    rng = np.random.default_rng(seed)
    tk = tq if tk is None else tk
    f32 = np.float32
    q = rng.standard_normal((B, tq, H, DH)).astype(f32)
    k, v = (rng.standard_normal((B, tk, H, DH)).astype(f32)
            for _ in range(2))
    ct = rng.standard_normal((B, tq, H, DH)).astype(f32)
    mask = None
    if mask_shape is not None:
        mask = rng.random(mask_shape) < p
        if mask_shape[-1] > 1:
            mask[..., 0] = True
    return q, k, v, ct, mask


def _both(q, k, v, ct, mask, rate=0.0, key=None):
    """Forward and ``grad`` of ``sum(out * ct)`` through both packages:
    ``(jax out, jax grads, port out, port grads)`` as f32 numpy."""
    det = rate == 0.0
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(args):
        out = jax_flash(*args, mask=jmask, dropout_rate=rate,
                        dropout_rng=key, deterministic=det)
        return (out * jnp.asarray(ct)).sum(), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(a) for a in (q, k, v)))
    seed = (int(np.asarray(derive_positional_seed(key))[0])
            if key is not None else None)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention(*targs, mask=tmask, dropout_rate=rate,
                             seed=seed, deterministic=det)
    (got * torch.from_numpy(ct)).sum().backward()
    return (np.asarray(want), [np.asarray(g) for g in want_g],
            got.detach().numpy(), [t.grad.numpy() for t in targs])


def _check(want, want_g, got, got_g):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    for name, w, g in zip(("dq", "dk", "dv"), want_g, got_g):
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < GRAD_TOL, f"{name}: {err}"


MASK_FORMS = {
    "key_padding": (B, 1, 1, 200),    # batch mode, q-broadcast
    "shared": (1, 1, 200, 200),       # one
    "per_head": (1, H, 200, 200),     # head
    "full": (B, H, 200, 200),         # full
    "q_bcast_per_head": (1, H, 1, 200),
    "key_bcast": (B, 1, 200, 1),      # materialized along Tk
}


@pytest.mark.parametrize("form", list(MASK_FORMS))
def test_flash_mask_forms_match_jax(form):
    """Forward and the three gradients for every mask form at T = 200."""
    shape = MASK_FORMS[form]
    _check(*_both(*_inputs(len(form), 200, mask_shape=shape)))


@pytest.mark.parametrize("form,mode", [
    ("key_padding", "batch"), ("shared", "one"), ("per_head", "head"),
    ("full", "full"), ("q_bcast_per_head", "head"), ("key_bcast", "batch")])
def test_normalize_mask_folds_like_jax(form, mode):
    """The fold: the mode, one row per group for a q-broadcast mask, the
    key axis materialized for a key-broadcast one, no batch or head axis
    materialized; the expanded mask equals the broadcast of the
    original."""
    shape = MASK_FORMS[form]
    mask = torch.from_numpy(np.random.default_rng(3).random(shape) < 0.5)
    folded = fa.normalize_mask(mask, B, H, 200, 200)
    assert folded.mode == mode
    assert folded.rows.shape == (shape[0] * shape[1], shape[2], 200)
    full = mask.expand(B, H, 200, 200).reshape(B * H, 200, 200)
    torch.testing.assert_close(folded.expand(B * H).expand(-1, 200, -1),
                               full)


@pytest.mark.parametrize("tk", [1, 64, 197, 577])
def test_mask_bits_are_little_endian_words(tk):
    """What the kernels read: key c of a row is bit c % 64 of its 64-bit
    word c // 64 (numpy's little-endian ``packbits``), keys past Tk 0."""
    rows = np.random.default_rng(tk).random((3, 5, tk)) < 0.5
    folded = fa.Mask(torch.from_numpy(rows), "full", 3)
    bits = folded.bits().numpy()
    words = -(-tk // 64)
    padded = np.zeros((3, 5, words * 64), bool)
    padded[..., :tk] = rows
    np.testing.assert_array_equal(
        bits, np.packbits(padded, axis=-1, bitorder="little"))
    w = bits.view("<u8")
    assert w.shape == (3, 5, words)
    c = np.arange(tk)
    np.testing.assert_array_equal(
        (w[..., c // 64] >> (c % 64).astype(np.uint64)) & 1, rows)
    assert folded.bits() is folded.bits()


def test_flash_mask_bad_shape_raises():
    q, k, v, _, _ = _inputs(6, 128)
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           mask=torch.ones(3, 1, 1, 128, dtype=torch.bool))


def test_flash_fully_masked_rows_zero_and_consistent():
    """A query row that attends to no key: zero output and zero dq in
    both packages, finite gradients, the other rows unchanged."""
    t = 128
    q, k, v, ct, _ = _inputs(15, t)
    mask = np.ones((1, 1, t, t), bool)
    mask[:, :, 5] = False
    want, want_g, got, got_g = _both(q, k, v, ct, mask)
    _check(want, want_g, got, got_g)
    assert not got[:, 5].any() and not want[:, 5].any()
    assert not got_g[0][:, 5].any()
    # The row contributes nothing to dk, dv: its cotangent is free.
    ct2 = ct.copy()
    ct2[:, 5] = 100.0
    _, _, _, got_g2 = _both(q, k, v, ct2, mask)
    for g, g2 in zip(got_g[1:], got_g2[1:]):
        np.testing.assert_allclose(g2, g, atol=1e-6, rtol=1e-6)
    lse = fa.flash_attention_plain(
        *(fa._fold_heads(torch.from_numpy(a)) for a in (q, k, v)), seed=0,
        threshold=0, mask=fa.normalize_mask(torch.from_numpy(mask), B, H, t,
                                            t))[1]
    assert (lse[:, 5] == -1e30).all()


@pytest.mark.parametrize("form", ["key_padding", "full"])
def test_flash_mask_with_dropout_matches_jax(form):
    """The keep bits stay the positional hash of (b*h, row, col) under a
    mask: the port and JAX agree within tolerance at rate 0.1."""
    shape = MASK_FORMS[form]
    out = _both(*_inputs(21, 200, mask_shape=shape), rate=0.1,
                key=jax.random.key(8))
    _check(*out)
    plain = _both(*_inputs(21, 200, mask_shape=shape))
    assert np.abs(plain[2] - out[2]).max() > 1e-2  # dropout applied


@pytest.mark.parametrize("tq,tk", [(40, 72), (72, 40)])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_unequal_key_length_matches_jax(tq, tk, masked):
    """Tq != Tk, forward and backward, with and without a full mask."""
    shape = (B, H, tq, tk) if masked else None
    _check(*_both(*_inputs(tq * tk, tq, tk, mask_shape=shape)))


def test_flash_unequal_key_length_with_dropout_matches_jax():
    _check(*_both(*_inputs(9, 40, 72), rate=0.1, key=jax.random.key(2)))


@pytest.mark.parametrize("form", ["key_padding", "full", "key_bcast"])
def test_dot_product_attention_auto_mask_equals_xla_on_cpu(form):
    """On the CPU ``auto`` takes the xla path, masked: the port's auto and
    xla calls agree, and the port's xla path agrees with JAX's (rows
    with no key are zero on both: the saturating softmax's epsilon)."""
    q, k, v, _, mask = _inputs(30, 200, mask_shape=MASK_FORMS[form])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    auto = attention.dot_product_attention(tq, tk, tv, mask=tmask)
    xla = attention.dot_product_attention(tq, tk, tv, mask=tmask,
                                          impl="xla")
    torch.testing.assert_close(auto, xla, atol=0.0, rtol=0.0)
    want = jax_xla(*(jnp.asarray(a) for a in (q, k, v)), dropout_rate=0.0,
                   dropout_rng=None, deterministic=True,
                   mask=jnp.asarray(mask))
    np.testing.assert_allclose(auto.numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
    # ... and the port's flash path (plain on the CPU) agrees with both
    # where a row attends to some key.
    flash = attention.dot_product_attention(tq, tk, tv, mask=tmask,
                                            impl="flash")
    np.testing.assert_allclose(flash.numpy(), np.asarray(want),
                               atol=FWD_TOL, rtol=FWD_TOL)
