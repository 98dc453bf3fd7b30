"""The port's MLP and flash plain versions at every preset width and head
dim, against the JAX package's Pallas kernels.

The CUDA kernels take any D and F (rows 1, 2, 6 and 7: multiples of 64
natively, others on operands zero-padded to the next multiple) and any
head dim up to 256 (rows 3-5: 32, 64, 128 and 256 natively, others on
zero-padded operands). Their plain versions, which the CPU runs, are held
here to the JAX functions (Pallas in interpret mode, as the JAX package's
own tests run them on the CPU) at the widths the ViT presets use beyond
S/16 and B/16: D in {192, 1024, 1280} (Ti/16, L/16, H/14) with F = 4 D,
at widths no preset has, (D, F) in {(200, 800), (100, 300)}, and at Dh in
{80, 256} (H/14's, and the widest kernel). Same seeded
numpy inputs and cotangent on both sides, f32; tolerances: forward 1e-4,
gradients 2e-3 relative to each gradient's largest element (the JAX
package's own). N = 33 rows is not a multiple of the JAX row block (16);
T = 17 is not a multiple of a flash block.

The padding itself is held on the plain versions: the flash forward and
backward of zero-padded operands with the true scale equal those of the
unpadded problem, and so do the MLP core's forward and backward on the
operands ``fused_mlp._pad_operands`` pads.
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
from pytorch_vit_paper_replication_tpu.ops.fused_mlp import (
    fused_ln_mlp_residual as jax_ln_mlp, fused_mlp as jax_mlp)
from pytorch_vit_paper_replication_tpu_torch.ops import (
    flash_attention as fa, fused_mlp)

FWD_TOL, GRAD_TOL = 1e-4, 2e-3
WIDTHS = [192, 1024, 1280]
LN_NAMES = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
CORE_NAMES = ("x", "w1", "b1", "w2", "b2")


def _mlp_inputs(d, seed, n=33, f=None):
    rng = np.random.default_rng(seed + d)
    f, f32 = (4 * d if f is None else f), np.float32
    p = dict(x=rng.standard_normal((n, d)).astype(f32),
             gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(f32),
             beta=(0.1 * rng.standard_normal(d)).astype(f32),
             w1=(rng.standard_normal((d, f)) / np.sqrt(d)).astype(f32),
             b1=(0.1 * rng.standard_normal(f)).astype(f32),
             w2=(rng.standard_normal((f, d)) / np.sqrt(f)).astype(f32),
             b2=(0.1 * rng.standard_normal(d)).astype(f32))
    return p, rng.standard_normal((n, d)).astype(f32)


def _both(jax_fn, port_fn, names, p, ct, rate, key):
    """Forward and ``grad`` of ``sum(out * ct)`` through both packages:
    ``(jax out, jax grads, port out, port grads)`` as f32 numpy."""
    det = rate == 0.0

    def jloss(args):
        out = jax_fn(*args, dropout_rate=rate, dropout_rng=key,
                     deterministic=det)
        return (out * jnp.asarray(ct)).sum(), out

    (_, want), want_g = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(p[n]) for n in names))
    seed = int(np.asarray(derive_positional_seed(key))[0])
    targs = [torch.from_numpy(p[n]).requires_grad_() for n in names]
    got = port_fn(*targs, dropout_rate=rate, seed=seed, deterministic=det)
    (got * torch.from_numpy(ct)).sum().backward()
    return (np.asarray(want), [np.asarray(g) for g in want_g],
            got.detach().numpy(), [t.grad.numpy() for t in targs])


def _check(want, want_g, got, got_g, names):
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    for name, w, g in zip(names, want_g, got_g):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err < GRAD_TOL, f"{name}: {err}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_ln_mlp_plain_matches_jax_at_preset_widths(d, rate):
    """Rows 1 and 2 (LN -> MLP -> residual and its seven gradients)."""
    p, ct = _mlp_inputs(d, 0)
    out = _both(jax_ln_mlp, fused_mlp.fused_ln_mlp_residual, LN_NAMES, p,
                ct, rate, jax.random.key(3))
    _check(*out, LN_NAMES)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d", WIDTHS)
def test_mlp_core_plain_matches_jax_at_preset_widths(d, rate):
    """Rows 6 and 7 (the MLP core and its five gradients)."""
    p, ct = _mlp_inputs(d, 1)
    out = _both(jax_mlp, fused_mlp.fused_mlp, CORE_NAMES, p, ct, rate,
                jax.random.key(4))
    _check(*out, CORE_NAMES)


# Widths off the kernels' multiple of 64: a 16-byte row pitch in bf16
# (200, 800) and none (100, 300).
OFF_64 = [(200, 800), (100, 300)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,f", OFF_64)
def test_ln_mlp_plain_matches_jax_off_64_widths(d, f, rate):
    """Rows 1 and 2 at widths no preset has."""
    p, ct = _mlp_inputs(d, 2, f=f)
    out = _both(jax_ln_mlp, fused_mlp.fused_ln_mlp_residual, LN_NAMES, p,
                ct, rate, jax.random.key(5))
    _check(*out, LN_NAMES)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("d,f", OFF_64)
def test_mlp_core_plain_matches_jax_off_64_widths(d, f, rate):
    """Rows 6 and 7 at widths no preset has."""
    p, ct = _mlp_inputs(d, 3, f=f)
    out = _both(jax_mlp, fused_mlp.fused_mlp, CORE_NAMES, p, ct, rate,
                jax.random.key(6))
    _check(*out, CORE_NAMES)


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("d,f", OFF_64)
def test_mlp_width_padding_is_exact(d, f, threshold):
    """The wrappers' zero padding to the kernels' widths, run through the
    core's plain versions: the padded hidden columns carry GELU(0) = 0 and
    the keep bits hash (row, column), so the forward, the saved h and the
    five gradients are the unpadded ones with zeros in every padded row
    and column (dx's too: the padded rows of W1 are zero)."""
    p, _ = _mlp_inputs(d, 4, f=f)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    dout = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (33, d)).astype(np.float32))
    kw = dict(seed=77, threshold=threshold)
    out, h = fused_mlp.mlp_core_plain(t["x"], t["w1"], t["b1"], t["w2"],
                                      t["b2"], save_h=True, **kw)
    grads = fused_mlp.mlp_core_bwd_plain(t["x"], h, t["w1"], t["b1"],
                                         t["w2"], dout, **kw)
    pp = fused_mlp._pad_operands(d, f, x2=t["x"], w1=t["w1"], b1=t["b1"],
                                 w2=t["w2"], b2=t["b2"], dout=dout)
    dp, fp = fused_mlp._padded(d), fused_mlp._padded(f)
    assert pp["x2"].shape == (33, dp) and pp["w1"].shape == (dp, fp)
    assert pp["w2"].shape == (fp, dp) and pp["b1"].shape == (fp,)
    out_p, h_p = fused_mlp.mlp_core_plain(
        pp["x2"], pp["w1"], pp["b1"], pp["w2"], pp["b2"], save_h=True, **kw)
    grads_p = fused_mlp.mlp_core_bwd_plain(
        pp["x2"], fused_mlp._pad_operands(d, f, h=h)["h"], pp["w1"],
        pp["b1"], pp["w2"], pp["dout"], **kw)
    for got, want in [(out_p, out), (h_p, h)] + list(zip(grads_p, grads)):
        assert got.shape != want.shape
        pad = []
        for have, size in zip(reversed(want.shape), reversed(got.shape)):
            pad += [0, size - have]
        torch.testing.assert_close(got, torch.nn.functional.pad(want, pad),
                                   atol=1e-6, rtol=1e-6)


def _qkv(dh, t=17, b=2, h=2, seed=5):
    rng = np.random.default_rng(seed + dh)
    return [rng.standard_normal((b, t, h, dh)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh", [80, 256])
def test_flash_plain_matches_jax_at_head_dims(dh, rate):
    """Rows 3-5 (forward, dq, dk, dv) at ViT-H/14's head dim and the
    widest kernel's."""
    q, k, v, ct = _qkv(dh)
    p = dict(q=q, k=k, v=v)
    out = _both(jax_flash, fa.flash_attention, ("q", "k", "v"), p, ct, rate,
                jax.random.key(6))
    _check(*out, ("dq", "dk", "dv"))


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("dh,width", [(80, 128), (48, 64), (8, 32)])
def test_flash_head_dim_padding_is_exact(dh, width, threshold):
    """The wrapper's padding, run through the plain versions: q, k, v and
    dO zero-padded on the last axis to the kernel's width, with the true
    scale ``Dh**-0.5``, give the unpadded out, lse, dq, dk and dv (the
    padded columns of dq, dk and dv come out zero), dropout included."""
    assert fa.kernel_width(dh) == width
    q, k, v, do = (torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
        4, 17, dh).contiguous() for a in _qkv(dh, seed=dh))
    kw = dict(seed=123, threshold=threshold)
    out, lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do * out).sum(-1)
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)

    pad = [fa.pad_head_dim(a, width) for a in (q, k, v, do)]
    assert all(a.shape[-1] == width for a in pad)
    kw["scale"] = dh ** -0.5
    out_p, lse_p = fa.flash_attention_plain(*pad[:3], **kw)
    got = fa.flash_attention_bwd_plain(*pad, lse_p, delta, **kw)
    torch.testing.assert_close(out_p[..., :dh], out, atol=1e-6, rtol=1e-6)
    assert not out_p[..., dh:].any()
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[..., :dh], w, atol=1e-6, rtol=1e-6)
        assert not g[..., dh:].any()


def test_flash_head_dim_above_256_raises():
    with pytest.raises(ValueError, match="up to 256"):
        fa.kernel_width(320)
