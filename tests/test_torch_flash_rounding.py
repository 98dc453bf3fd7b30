"""The bf16 tensor-core flash kernels' rounding, rehearsed on the CPU.

The bf16 forward, dq and dk/dv kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) multiply with wgmma, whose operands are
bf16: the forward rounds P to bf16 before ``P @ V`` (P of the running
max, inside the online softmax over 64-key blocks), dk/dv rounds
``P_drop`` and ``dS`` to bf16 before ``dV += P_drop^T dO`` and
``dK += dS^T Q``, dq rounds ``dS`` to bf16 before ``dQ += dS K``. Every sum is f32, and bf16 products are exact in f32,
so the logits and ``lse`` keep their f32 values. This file emulates those
rounding points in plain torch and holds the emulation to the plain
versions (``flash_attention_plain``, ``flash_attention_bwd_plain``,
whose products are f32) within the bounds the card's kernels are held
to: out 2e-2 abs + 2e-2 relative, lse 1e-4, each gradient 2e-2 of its
largest element. The same emulation with the rounding switched off must
equal the plain versions to f32 summation order (1e-5), so it computes
the same function.
"""

import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu_torch.ops import flash_attention as fa

BLOCK = 64  # keys per block of the forward's online softmax


def _to_bf16(x):
    return x.to(torch.bfloat16).float()


def _inputs(t, seed, n=4, bh=2 * 12, dh=64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, t, dh)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(n)]


def _keep(bh, t, seed, threshold):
    return fa._keep_mask(seed, bh, t, t, threshold, torch.device("cpu"))


def emulate_fwd(q, k, v, *, seed, threshold, rnd=_to_bf16):
    """The forward kernel's arithmetic: f32 logits, online softmax over
    64-key blocks, ``rnd(P_drop) @ V`` accumulated in f32."""
    bh, t, dh = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    keep = _keep(bh, t, seed, threshold) if threshold else None
    m = torch.full((bh, t, 1), -1e30)
    l = torch.zeros(bh, t, 1)
    acc = torch.zeros(bh, t, dh)
    for k0 in range(0, t, BLOCK):
        s = (qf @ kf[:, k0:k0 + BLOCK].transpose(1, 2)) * dh ** -0.5
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + BLOCK], p, 0.0)
        acc = acc * corr + rnd(p) @ vf[:, k0:k0 + BLOCK]
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / (l_safe * (1.0 - threshold / 256.0))
    return out, (m + torch.log(l_safe))[..., 0]


def emulate_dkv(q, k, v, dout, lse, delta, *, seed, threshold,
                rnd=_to_bf16):
    """The dk/dv kernel's arithmetic: f32 P and dS, then
    ``rnd(P_drop)^T dO`` and ``rnd(dS)^T Q`` accumulated in f32."""
    bh, t, dh = q.shape
    scale = dh ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp((qf @ kf.transpose(1, 2)) * scale - lse[..., None])
    dp = dof @ vf.transpose(1, 2)
    p_drop = p
    if threshold:
        keep = _keep(bh, t, seed, threshold)
        inv_keep = 256.0 / (256.0 - threshold)
        dp = torch.where(keep, dp * inv_keep, 0.0)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    return rnd(ds).transpose(1, 2) @ qf, rnd(p_drop).transpose(1, 2) @ dof


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("t", [17, 197])
def test_forward_rounding_inside_kernel_bounds(t, threshold):
    q, k, v = _inputs(t, seed=t + threshold, n=3)
    kw = dict(seed=77, threshold=threshold)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    # The emulation without rounding is the plain function (f32 out).
    exact, exact_lse = emulate_fwd(q, k, v, **kw, rnd=lambda x: x)
    ref32, _ = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    np.testing.assert_allclose(exact, ref32, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(exact_lse, ref_lse, atol=1e-5, rtol=1e-5)
    out, lse = emulate_fwd(q, k, v, **kw)
    assert (out - exact).abs().max() > 0  # the rounding is exercised
    got = out.to(torch.bfloat16).float()
    err = (got - ref.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), err.max()
    np.testing.assert_allclose(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("t", [17, 197])
def test_dkv_rounding_inside_kernel_bounds(t, threshold):
    q, k, v, do = _inputs(t, seed=100 + t + threshold)
    kw = dict(seed=4242, threshold=threshold)
    out, lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    _, want_dk, want_dv = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                                       delta, **kw)
    exact_dk, exact_dv = emulate_dkv(q, k, v, do, lse, delta, **kw,
                                     rnd=lambda x: x)
    _, dk32, dv32 = fa.flash_attention_bwd_plain(
        *(a.float() for a in (q, k, v, do)), lse, delta, **kw)
    assert _rel(exact_dk, dk32) < 1e-5 and _rel(exact_dv, dv32) < 1e-5
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, **kw)
    assert (dk - exact_dk).abs().max() > 0 and (dv - exact_dv).abs().max() > 0
    assert _rel(dk.to(torch.bfloat16), want_dk) < 2e-2
    assert _rel(dv.to(torch.bfloat16), want_dv) < 2e-2


def emulate_dq(q, k, v, dout, lse, delta, *, seed, threshold, rnd=_to_bf16):
    """The dq kernel's arithmetic: f32 P and dS per 64-key block, then
    ``rnd(dS) @ K`` accumulated in f32 block by block."""
    bh, t, dh = q.shape
    scale = dh ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    keep = _keep(bh, t, seed, threshold) if threshold else None
    dq = torch.zeros(bh, t, dh)
    for k0 in range(0, t, BLOCK):
        kb, vb = kf[:, k0:k0 + BLOCK], vf[:, k0:k0 + BLOCK]
        p = torch.exp((qf @ kb.transpose(1, 2)) * scale - lse[..., None])
        dp = dof @ vb.transpose(1, 2)
        if keep is not None:
            dp = torch.where(keep[:, :, k0:k0 + BLOCK],
                             dp * (256.0 / (256.0 - threshold)), 0.0)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + rnd(ds) @ kb
    return dq


@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("t", [1, 64, 197])
def test_dq_rounding_inside_kernel_bounds(t, threshold):
    """dS rounded to bf16 before ``dS @ K`` stays within 2e-2 of dq's
    largest element of the plain backward; without the rounding the
    emulation is the plain function to 1e-5. At T = 1 dS is zero but for
    rounding (one key: delta = dP'), so dq is noise on both sides and is
    held relative to dv's largest element, as on the card."""
    q, k, v, do = _inputs(t, seed=200 + t + threshold)
    kw = dict(seed=4243, threshold=threshold)
    out, lse = fa.flash_attention_plain(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    want_dq, _, want_dv = fa.flash_attention_bwd_plain(q, k, v, do, lse,
                                                       delta, **kw)
    dq32, _, dv32 = fa.flash_attention_bwd_plain(
        *(a.float() for a in (q, k, v, do)), lse, delta, **kw)
    scale = (want_dv if t == 1 else want_dq).float().abs().max()
    scale32 = (dv32 if t == 1 else dq32).abs().max()
    exact = emulate_dq(q, k, v, do, lse, delta, **kw, rnd=lambda x: x)
    assert (exact - dq32).abs().max() <= 1e-5 * scale32
    dq = emulate_dq(q, k, v, do, lse, delta, **kw)
    if t > 1:  # at T = 1 the noise dS has too few bits for bf16 to cut
        assert (dq - exact).abs().max() > 0  # the rounding is exercised
    err = (dq.to(torch.bfloat16).float() - want_dq.float()).abs().max()
    assert err <= 2e-2 * scale, (err, scale)
