"""The port's attention dispatch and ``_xla_attention`` against JAX.

Same rounding points on both sides: logits stored and scaled in the
compute dtype, f32 softmax (saturating or exact), weights cast to the
compute dtype before P @ V. f32 tolerance 1e-4; bf16 2e-2 (bf16 logits
and weights; the two frameworks round the products at the same points
but accumulate in different orders).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.ops import attention as jatt
from pytorch_vit_paper_replication_tpu_torch.ops import attention as tatt


def _qkv(seed, b=2, t=21, h=3, dh=16, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal((b, t, h, dh))).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("softmax", ["saturating", "exact"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_xla_attention_matches_jax(softmax, dtype, tol):
    q, k, v = _qkv(0)
    want = jatt._xla_attention(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
        dropout_rate=0.0, dropout_rng=None, deterministic=True,
        softmax=softmax)
    got = tatt._xla_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        softmax=softmax)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_xla_attention_large_logits_saturating_vs_exact():
    """Logits above the saturating path's exact region (> ~96) differ
    between the two flavors — identically on both sides."""
    q, k, v = _qkv(1, scale=6.0)
    for softmax in ("saturating", "exact"):
        want = jatt._xla_attention(
            *(jnp.asarray(a) for a in (q, k, v)), dropout_rate=0.0,
            dropout_rng=None, deterministic=True, softmax=softmax)
        got = tatt._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  softmax=softmax)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_xla_attention_mask_and_fully_masked_row():
    q, k, v = _qkv(2, t=9)
    mask = np.random.default_rng(3).random((2, 1, 9, 9)) > 0.3
    mask[0, 0, 4, :] = False   # a fully-masked query row
    want = jatt._xla_attention(
        *(jnp.asarray(a) for a in (q, k, v)), dropout_rate=0.0,
        dropout_rng=None, deterministic=True, mask=jnp.asarray(mask))
    got = tatt._xla_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert np.all(got.numpy()[0, 4] == 0.0)


@pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
def test_dot_product_attention_dispatch_matches_jax(impl):
    q, k, v = _qkv(4, t=33, dh=32)
    want = jatt.dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), impl=impl)
    got = tatt.dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_flash_ok_only_on_cuda_and_large_logits():
    """auto's rule in the port: flash on a CUDA tensor from T = 197 (the
    H100 measurement, PERF.md section 5) with an instantiated head dim;
    never on the CPU. The JAX package keeps its TPU memory rule (flash
    only when the logits would not fit, T >= 512). A stand-in with
    ``is_cuda`` set holds the rule without a card."""
    q = torch.zeros(1, 600, 12, 64)
    assert not tatt._flash_ok(q)            # CPU tensor
    assert jatt._FLASH_MIN_SEQ == 512 and tatt._FLASH_MIN_SEQ == 197

    def on_card(t, dh):
        return types.SimpleNamespace(is_cuda=True, shape=(32, t, 12, dh))
    assert tatt._flash_ok(on_card(197, 64))
    assert tatt._flash_ok(on_card(577, 256))
    assert not tatt._flash_ok(on_card(196, 64))
    assert not tatt._flash_ok(on_card(257, 80))   # ViT-H/14: flash if asked


def test_unported_forms_raise():
    """No form is refused any more: 8-bit probs storage and sequence
    parallelism (refused before they were ported) run. A context on a
    mesh whose seq axis is 1 leaves the dispatch as it is; an unknown
    ``sp_impl`` is JAX's ValueError."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5))
    out = tatt.dot_product_attention(q, k, v, impl="xla", probs_dtype="u8")
    assert out.shape == q.shape and torch.isfinite(out).all()
    # Training-mode dropout on the xla path is ported: it needs a seed.
    with pytest.raises(ValueError, match="seed"):
        tatt.dot_product_attention(q, k, v, impl="xla", dropout_rate=0.1,
                                   deterministic=False)
    out = tatt.dot_product_attention(q, k, v, impl="xla", dropout_rate=0.1,
                                     seed=1, deterministic=False)
    assert out.shape == q.shape and torch.isfinite(out).all()
    from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
    from pytorch_vit_paper_replication_tpu_torch.parallel import mesh_layout
    one = mesh_layout(MeshConfig(data=2), 2)
    with tatt.sequence_parallel(one):
        inside = tatt.dot_product_attention(q, k, v, impl="xla")
    assert torch.equal(inside, tatt.dot_product_attention(q, k, v,
                                                          impl="xla"))
    with pytest.raises(ValueError, match="sp_impl"):
        with tatt.sequence_parallel(one, sp_impl="bogus"):
            pass
    with pytest.raises(ValueError):
        tatt.dot_product_attention(q, k, v, impl="bogus")
