"""The port's flash-attention forward against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode (auto-selected off
the TPU, as its own tests run it); the port's wrapper runs the kernel's
plain version (exact softmax in f32) on CPU tensors. f32 tolerance 1e-4
(the JAX package's own forward tolerance); bf16 outputs 1e-2 (one bf16
ulp at |out| < 2: both sides compute in f32 and round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops.dropout import (
    derive_positional_seed)
from pytorch_vit_paper_replication_tpu.ops.flash_attention import (
    flash_attention as jax_flash)
from pytorch_vit_paper_replication_tpu_torch.ops import flash_attention as fa


def _qkv(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32)
            for _ in range(3)]


def _both(q, k, v, dtype="float32", rate=0.0, key=None):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    det = rate == 0.0
    want = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                     dropout_rate=rate, dropout_rng=key, deterministic=det)
    seed = (int(np.asarray(derive_positional_seed(key))[0])
            if key is not None else None)
    got = fa.flash_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)),
                             dropout_rate=rate, seed=seed, deterministic=det)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("t", [37, 197])
def test_flash_forward_matches_jax_ragged(t, dh):
    """Ragged T (not a multiple of 8 or of any block): the JAX wrapper
    pads and masks the kv tail; the port must agree."""
    q, k, v = _qkv(t + dh, 2, t, 2, dh)
    want, got = _both(q, k, v)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dh", [32, 64])
def test_flash_dropout_matches_jax_same_seed(dh):
    q, k, v = _qkv(dh, 2, 45, 3, dh)
    want, got = _both(q, k, v, rate=0.1, key=jax.random.key(4))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    plain, _ = _both(q, k, v)
    assert np.abs(plain - got).max() > 1e-2   # dropout really applied


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(9, 2, 50, 2, 64)
    want, got = _both(q, k, v, dtype="bfloat16")
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


def test_flash_plain_lse_is_logsumexp():
    q, k, v = _qkv(1, 1, 20, 2, 32)
    tq = fa._fold_heads(torch.from_numpy(q))
    out, lse = fa.flash_attention_plain(tq, tq, tq, seed=0, threshold=0)
    s = (tq @ tq.transpose(1, 2)) * 32 ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)
    assert out.shape == tq.shape


def test_flash_refuses_mask_and_cpu_runs_no_launch():
    """Masks are ported (the refusal this test once pinned is gone): a
    masked call and an unmasked one on CPU tensors run the plain version,
    no kernel launch; an all-True mask gives the unmasked result, and a
    mask that does not broadcast is still refused."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 8, 1, 32))
    before = fa.launches
    masked = fa.flash_attention(q, k, v,
                                mask=torch.ones(1, 1, 8, 8, dtype=bool))
    plain = fa.flash_attention(q, k, v)
    assert fa.launches == before
    torch.testing.assert_close(masked, plain, atol=0.0, rtol=0.0)
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention(q, k, v, mask=torch.ones(1, 1, 8, 9, dtype=bool))


def test_bf16_kernel_operands_must_be_16_byte_aligned():
    """The bf16 forward and dk/dv kernels read q, k, v and dO through TMA:
    the wrappers refuse an operand that is not 16-byte aligned before any
    launch (the check runs on any device, so the CPU shows it); f32 runs
    the SIMT kernels, which take any alignment."""
    bh, t, dh = 2, 9, 32
    buf = torch.zeros(bh * t * dh + 1, dtype=torch.bfloat16)
    odd = buf[1:].view(bh, t, dh)           # 2 bytes past an aligned base
    ok = torch.zeros(bh, t, dh, dtype=torch.bfloat16)
    vec = torch.zeros(bh, t)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = (fa.launches, fa.dkv_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch(ok, ok, odd, seed=0, threshold=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch_bwd_dkv(ok, ok, ok, odd, vec, vec, seed=0, threshold=0)
    assert (fa.launches, fa.dkv_launches) == before
    odd32 = torch.zeros(bh * t * dh + 1)[1:].view(bh, t, dh)
    assert odd32.data_ptr() % 16
    fa._check_tma(odd32, odd32)            # f32: no TMA, no refusal


def test_bf16_dq_operands_must_be_16_byte_aligned():
    """The bf16 dq kernel reads q, k, v and dO through TMA too: an operand
    2 bytes past an aligned base raises before the launch, on any
    device."""
    bh, t, dh = 2, 9, 64
    odd = torch.zeros(bh * t * dh + 1, dtype=torch.bfloat16)[1:].view(
        bh, t, dh)
    ok = torch.zeros(bh, t, dh, dtype=torch.bfloat16)
    vec = torch.zeros(bh, t)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = fa.dq_launches
    for args in ((odd, ok, ok, ok), (ok, odd, ok, ok), (ok, ok, odd, ok),
                 (ok, ok, ok, odd)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._launch_bwd_dq(*args, vec, vec, seed=0, threshold=0)
    assert fa.dq_launches == before
