"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test skips on a host without a CUDA device (the
decision is made inside the fixture). This file imports no JAX, so it
also runs on a card machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4; bf16 2e-2 (one bf16 ulp at |x| < 4 — kernel and
plain version sum in different orders before the same final rounding).
Gradients are compared relative to the largest element of each gradient:
f32 1e-4, bf16 2e-2 (a bf16 rounding of df or dh that falls the other
way in kernel and plain version moves that element by one ulp). The
backward kernels must also be bitwise deterministic.
"""

import shutil

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(a, b):
    """max |a - b| over max |b| (in f32)."""
    a, b = a.float(), b.float()
    assert torch.isfinite(a).all()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _mlp_args(dev, dtype, n, d=384, f=1536, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return dict(x2=r(n, d).to(dev, dtype), gamma=(1 + 0.1 * r(d)).to(dev),
                beta=(0.1 * r(d)).to(dev),
                w1=(r(d, f) / d ** 0.5).to(dev, dtype),
                b1=(0.1 * r(f)).to(dev, dtype),
                w2=(r(f, d) / f ** 0.5).to(dev, dtype),
                b2=(0.1 * r(d)).to(dev, dtype))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("n", [1, 100])
def test_fused_mlp_kernel_matches_plain(dev, dtype, threshold, n):
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    g = torch.Generator().manual_seed(n + threshold)
    d, f = 384, 1536
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    p = dict(x2=r(n, d).to(dev, dtype), gamma=(1 + 0.1 * r(d)).to(dev),
             beta=(0.1 * r(d)).to(dev), w1=(r(d, f) / d ** 0.5).to(dev, dtype),
             b1=(0.1 * r(f)).to(dev, dtype),
             w2=(r(f, d) / f ** 0.5).to(dev, dtype),
             b2=(0.1 * r(d)).to(dev, dtype))
    kw = dict(eps=1e-6, seed=-123, threshold=threshold)
    before = fused_mlp.launches
    with torch.inference_mode():
        out = fused_mlp._launch(**p, **kw)
        ref = fused_mlp.ln_mlp_residual_plain(**p, **kw)
    assert fused_mlp.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# Every edge of a 64-row wgmma tile and of a TMA box: one row, a ragged
# first tile, one short of / exactly / one past a tile, two tiles, B/16 at
# 224 px and at 384 px.
FLASH_T = [1, 17, 63, 64, 65, 128, 197, 577]


# Head dims: the four the kernels are built for, and ViT-H/14's 80 (run on
# operands zero-padded to 128).
FLASH_DH = [32, 64, 80, 128, 256]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", FLASH_DH)
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("t", FLASH_T)
def test_flash_kernel_matches_plain(dev, t, threshold, dh, dtype):
    """bf16: the wgmma + TMA kernel; f32: the SIMT kernel. One launch
    per call."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    g = torch.Generator().manual_seed(dh + t)
    q, k, v = [torch.randn(6, t, dh, generator=g).to(dev, dtype)
               for _ in range(3)]
    before = fa.launches
    with torch.inference_mode():
        out, lse = fa._launch(q, k, v, seed=9, threshold=threshold)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, seed=9,
                                                threshold=threshold)
    assert fa.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("n", [1, 100])
def test_fused_mlp_bwd_kernel_matches_plain(dev, dtype, threshold, n):
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, seed=n + threshold)
    kw = dict(eps=1e-6, seed=-77, threshold=threshold)
    _, h = fused_mlp._launch(**p, **kw, save_h=True)
    _, h_ref = fused_mlp.ln_mlp_residual_plain(**p, **kw, save_h=True)
    assert _rel(h, h_ref) < TOL[dtype]
    dout = torch.randn(p["x2"].shape, generator=torch.Generator().manual_seed(
        1)).to(dev, dtype)
    args = (p["x2"], h_ref, p["gamma"], p["beta"], p["w1"], p["w2"], dout)
    before = fused_mlp.bwd_launches
    got = fused_mlp._launch_bwd(*args, **kw)
    again = fused_mlp._launch_bwd(*args, **kw)
    want = fused_mlp.ln_mlp_residual_bwd_plain(*args, **kw)
    assert fused_mlp.bwd_launches == before + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)               # deterministic
        assert _rel(a, c) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", FLASH_DH)
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("t", FLASH_T)
def test_flash_bwd_kernels_match_plain(dev, t, threshold, dh, dtype):
    """dq and dk/dv (bf16: wgmma + TMA, two consumer warpgroups; f32:
    SIMT) against the plain
    backward, one launch per call, bitwise deterministic. At T = 1 the one
    key has P = 1 and dS = P (dP' - delta) is zero but for rounding (a kept
    key gives delta = dO . V / keep = dP', a dropped one zeroes both): dq
    and dk are rounding noise, held to the plain version relative to dv's
    largest element instead of their own."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    g = torch.Generator().manual_seed(dh + t)
    q, k, v, do = [torch.randn(6, t, dh, generator=g).to(dev, dtype)
                   for _ in range(4)]
    kw = dict(seed=11, threshold=threshold)
    out, lse = fa._launch(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    d0, k0 = fa.dq_launches, fa.dkv_launches
    dq = fa._launch_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa._launch_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert (fa.dq_launches, fa.dkv_launches) == (d0 + 1, k0 + 1)
    assert torch.equal(dq, fa._launch_bwd_dq(q, k, v, do, lse, delta, **kw))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), fa._launch_bwd_dkv(q, k, v, do, lse, delta, **kw)))
    want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, **kw)
    assert _rel(dv, want[2]) < TOL[dtype]
    scale = want[2].float().abs().max() if t == 1 else None
    for a, b in zip((dq, dk), want):
        if scale is None:
            assert _rel(a, b) < TOL[dtype]
        else:
            assert (a.float() - b.float()).abs().max() < TOL[dtype] * scale


def test_kernels_autograd_matches_plain(dev):
    """Both autograd Functions on CUDA tensors launch the backward kernels
    and agree with the same Functions on CPU tensors (plain versions);
    two backward passes are bitwise equal."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    p = _mlp_args(torch.device("cpu"), torch.float32, 40, seed=3)
    q, k, v = [torch.randn(2, 50, 3, 64, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3)]

    def grads(device):
        leaves = {n: t.to(device).requires_grad_() for n, t in p.items()}
        qkv = [a.to(device).requires_grad_() for a in (q, k, v)]
        x = leaves.pop("x2")
        out = fused_mlp.fused_ln_mlp_residual(
            x, **leaves, dropout_rate=0.1, seed=5, deterministic=False)
        att = fa.flash_attention(*qkv, dropout_rate=0.1, seed=6,
                                 deterministic=False)
        (out.square().sum() + att.square().sum()).backward()
        return [t.grad.cpu() for t in (x, *leaves.values(), *qkv)]

    b1, b2 = fused_mlp.bwd_launches, fa.dq_launches
    got, again = grads(dev), grads(dev)
    assert fused_mlp.bwd_launches == b1 + 2 and fa.dq_launches == b2 + 2
    want = grads(torch.device("cpu"))
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        assert _rel(a, c) < 1e-4


def test_model_on_cuda_matches_cpu_plain_path(dev):
    """A 2-layer f32 ViT with D = 384: on the card the MLP halves run the
    fused kernel and attention the flash kernel; on the CPU the same
    model runs the plain versions."""
    from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    cfg = ViTConfig(image_size=64, patch_size=16, num_layers=2, num_heads=6,
                    embedding_dim=384, mlp_size=1536, num_classes=10,
                    dtype="float32", attention_impl="flash")
    cpu = ViT(cfg).eval()
    cpu.load_state_dict(seeded_params(cfg, 1))
    gpu = ViT(cfg).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    k1, k2 = fused_mlp.launches, fa.launches
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(dev)).cpu()
    assert fused_mlp.launches - k1 == 2 and fa.launches - k2 == 2
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("preset", ["ViT-Ti/16", "ViT-S/16", "ViT-B/16",
                                    "ViT-L/16", "ViT-H/14"])
def test_every_preset_trains_fused_on_card(dev, preset):
    """One f32 encoder layer of each preset at full width, default
    ``mlp_impl="auto"`` and ``attention_impl="flash"`` (H/14's Dh = 80 on
    padded operands), forward and backward with dropout on the card
    against the same layer on the CPU through the plain versions
    (``mlp_impl="fused"`` there: ``auto`` picks the xla MLP on the CPU,
    whose dropout bits differ): the logits and every gradient within 1e-3
    of their largest element."""
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    full = PRESETS[preset]()
    cfg = full.replace(num_layers=1, image_size=4 * full.patch_size,
                       num_classes=10, dtype="float32",
                       attention_impl="flash", embedding_dropout=0.0)
    x = torch.randn(2, cfg.image_size, cfg.image_size, 3,
                    generator=torch.Generator().manual_seed(4))
    grads = []
    for device in (dev, torch.device("cpu")):
        model = ViT(cfg if device.type == "cuda" else
                    cfg.replace(mlp_impl="fused")).train()
        model.load_state_dict(seeded_params(cfg, 7))
        model.to(device)
        b1, b2 = fused_mlp.bwd_launches, fa.dkv_launches
        logits = model(x.to(device), torch.Generator().manual_seed(1))
        logits.square().sum().backward()
        if device.type == "cuda":
            assert (fused_mlp.bwd_launches - b1, fa.dkv_launches - b2) == (
                1, 1)
        grads.append([logits.detach().cpu()] + [
            p.grad.cpu() for p in model.parameters()])
    for a, c in zip(*grads):
        assert _rel(a, c) < 1e-3


def _split_qkv_bias(tree):
    """The qkv biases ``[3, H, Dh]`` split into their Q and V slices (kept
    as leaves) and their K slices, whose gradient is analytically zero
    (softmax is invariant to a row's shift ``q . b_k``): rounding noise on
    both sides, which the first Adam step turns into +-lr moves."""
    leaves, k_slices = {}, {}
    for name, v in tree.items():
        if name.endswith("qkv.bias"):
            leaves[name + "[q]"], leaves[name + "[v]"] = v[0], v[2]
            k_slices[name] = v[1]
        else:
            leaves[name] = v
    return leaves, k_slices


def test_train_step_on_cuda_matches_cpu_plain_path(dev):
    """One f32 training step (dropout on) of a 2-layer D = 384 ViT: the
    card runs the fused MLP and flash kernels forward and backward, the
    CPU the plain versions; same seeds, so the same positional masks.
    (The embedding dropout is off: its bits come from a generator on the
    tensor's device, and CPU and CUDA generators give different streams.)
    The loss, the gradient norm and the gradients the optimizer receives
    agree within 2e-3, the Q and V slices of the qkv bias included. The
    updated params agree in the form of tests/test_torch_engine.py's
    trajectory test: per-leaf drift under 0.5% of how far the leaf moved,
    global drift under 0.2%, and the K slices of the qkv bias within
    2 lr in absolute terms."""
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        TrainConfig, ViTConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    cfg = ViTConfig(image_size=64, patch_size=16, num_layers=2, num_heads=6,
                    embedding_dim=384, mlp_size=1536, num_classes=10,
                    dtype="float32", attention_impl="flash",
                    mlp_impl="fused", attn_dropout=0.1,
                    embedding_dropout=0.0)
    tcfg = TrainConfig(warmup_fraction=0.0)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((4, 64, 64, 3)).astype("float32"),
             "label": rng.integers(0, 10, 4)}
    p0 = seeded_params(cfg, 1)
    runs = []
    for device in (dev, torch.device("cpu")):
        m = ViT(cfg)
        m.load_state_dict(p0)
        m.to(device)
        st = engine.TrainState.create(
            model=m, seed=3, tx=optim.make_optimizer(tcfg, 10))
        grads, apply = {}, st.tx.apply

        def capture(params, g, opt_state, apply=apply, grads=grads):
            grads.update({k: v.detach().cpu().clone() for k, v in g.items()})
            return apply(params, g, opt_state)
        st.tx.apply = capture
        st, metrics = engine.make_train_step()(st, batch)
        after = {k: v.detach().cpu() for k, v in m.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads,
                     after))
    (mg, gg, pg), (mc, gc, pc) = runs
    assert abs(mg["loss_sum"] - mc["loss_sum"]) <= 1e-4 * abs(mc["loss_sum"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 2e-3 * mc["grad_norm"]
    diff = sum(float((gg[k] - gc[k]).double().square().sum()) for k in gc)
    ref = sum(float(gc[k].double().square().sum()) for k in gc)
    assert (diff / ref) ** 0.5 < 2e-3
    (g_card, _), (g_cpu, _) = _split_qkv_bias(gg), _split_qkv_bias(gc)
    for name in g_cpu:
        assert _rel(g_card[name], g_cpu[name]) < 2e-3, name
    (p_card, k_card), (p_cpu, k_cpu) = _split_qkv_bias(pg), _split_qkv_bias(pc)
    start, _ = _split_qkv_bias({k: p0[k].float() for k in pc})
    num = den = 0.0
    for name in p_cpu:
        drift = float((p_card[name] - p_cpu[name]).double().norm())
        move = float((p_cpu[name] - start[name]).double().norm())
        num, den = num + drift ** 2, den + move ** 2
        assert drift <= 5e-3 * move, name
    assert (num / den) ** 0.5 < 2e-3
    for name in k_cpu:
        diff_k = float((k_card[name] - k_cpu[name]).abs().max())
        assert diff_k <= 2 * tcfg.learning_rate, name


def test_remat_on_cuda_gives_identical_grads(dev):
    """Remat (torch.utils.checkpoint per block) with the fused MLP and
    flash kernels on the card: the recomputed forward relaunches the
    kernels with the same seeds, so the grads equal the no-remat ones
    bit for bit."""
    from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(4))
    grads, fwd = [], []
    for remat in (False, True):
        cfg = ViTConfig(image_size=64, patch_size=16, num_layers=2,
                        num_heads=6, embedding_dim=384, mlp_size=1536,
                        num_classes=10, attention_impl="flash",
                        attn_dropout=0.1, remat=remat)
        m = ViT(cfg)
        m.load_state_dict(seeded_params(cfg, 2))
        m.to(dev).train()
        before = fused_mlp.launches
        m(x.to(dev), torch.Generator().manual_seed(7)).square().sum() \
            .backward()
        fwd.append(fused_mlp.launches - before)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert fwd == [2, 4]          # remat recomputes each block's forward
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("n,d,f", [(1, 384, 1536), (100, 768, 1536),
                                   (70, 768, 3072)])
def test_fused_mlp_core_kernel_matches_plain(dev, dtype, threshold, n, d, f):
    """The MLP core forward (row 6), with and without the saved h, against
    its plain version; the hidden keep mask, recovered by feeding ones
    (x = 0, w1 = 0, b1 = 1, w2 = a one-hot column block), bit for bit."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, d, f, seed=n + threshold)
    args = (p["x2"], p["w1"], p["b1"], p["w2"], p["b2"])
    kw = dict(seed=-321, threshold=threshold)
    before = fused_mlp.core_launches
    out = fused_mlp._launch_core(*args, **kw)
    out_h, h = fused_mlp._launch_core(*args, **kw, save_h=True)
    assert fused_mlp.core_launches == before + 2
    ref, h_ref = fused_mlp.mlp_core_plain(*args, **kw, save_h=True)
    assert torch.equal(out, out_h)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert _rel(h, h_ref) < TOL[dtype]
    if threshold:
        ones = dict(x2=torch.zeros_like(p["x2"]),
                    w1=torch.zeros_like(p["w1"]),
                    b1=torch.ones_like(p["b1"]),
                    b2=torch.zeros_like(p["b2"]))
        for k in range(f // d):
            sel = torch.zeros_like(p["w2"])
            sel[k * d:(k + 1) * d] = torch.eye(d, dtype=dtype, device=dev)
            a = fused_mlp._launch_core(**ones, w2=sel, **kw) == 0
            b = fused_mlp.mlp_core_plain(**ones, w2=sel, **kw) == 0
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("n,d,f", [(1, 384, 1536), (100, 768, 1536)])
def test_fused_mlp_core_bwd_kernel_matches_plain(dev, dtype, threshold, n, d,
                                                 f):
    """The MLP core backward (row 7) against its plain version, each
    gradient relative to its largest element; two launches bitwise
    equal."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, d, f, seed=7 * n + threshold)
    kw = dict(seed=99, threshold=threshold)
    _, h = fused_mlp.mlp_core_plain(p["x2"], p["w1"], p["b1"], p["w2"],
                                    p["b2"], **kw, save_h=True)
    dout = torch.randn(n, d, generator=torch.Generator().manual_seed(2)).to(
        dev, dtype)
    args = (p["x2"], h, p["w1"], p["b1"], p["w2"], dout)
    before = fused_mlp.core_bwd_launches
    got = fused_mlp._launch_core_bwd(*args, **kw)
    again = fused_mlp._launch_core_bwd(*args, **kw)
    want = fused_mlp.mlp_core_bwd_plain(*args, **kw)
    assert fused_mlp.core_bwd_launches == before + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert _rel(a, c) < TOL[dtype]


def test_fused_mlp_core_autograd_matches_cpu(dev):
    """``fused_mlp`` through ``_MlpFunction`` on the card (kernels) and on
    the CPU (plain versions), f32 with hidden dropout: outputs and the
    five gradients agree within 1e-4 relative."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(torch.device("cpu"), torch.float32, 45, seed=5)
    names = ("x2", "w1", "b1", "w2", "b2")

    def run(device):
        leaves = [p[k].to(device).requires_grad_() for k in names]
        out = fused_mlp.fused_mlp(*leaves, dropout_rate=0.1, seed=8,
                                  deterministic=False)
        out.square().sum().backward()
        return out.detach().cpu(), [t.grad.cpu() for t in leaves]

    b0 = fused_mlp.core_bwd_launches
    got, got_g = run(dev)
    assert fused_mlp.core_bwd_launches == b0 + 1
    want, want_g = run(torch.device("cpu"))
    assert _rel(got, want) < 1e-4
    for a, c in zip(got_g, want_g):
        assert _rel(a, c) < 1e-4


def test_tp_blocks_on_card_match_single_process(dev):
    """Two gloo ranks sharing the card run the tensor-parallel MLPBlock
    (standalone) and TransformerEncoderBlock, f32, D = 384: every rank
    launches the MLP core kernels on its hidden half (1536 / 2), and the
    outputs, the input gradients and the assembled parameter gradients
    equal the single-process blocks on the card (which run the MLP core
    and the LN-MLP kernels on the full width) within 1e-4 of each
    tensor's largest element."""
    import torch_parallel_worker as worker
    from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.parallel import (sharding,
                                                                  spawn)
    fields = dict(image_size=32, patch_size=8, num_layers=1, num_heads=6,
                  embedding_dim=384, mlp_size=1536, num_classes=3,
                  dtype="float32", attn_dropout=0.0, mlp_dropout=0.0,
                  embedding_dropout=0.0)
    from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
    state = seeded_params(ViTConfig(**fields), 4)
    rng = np.random.default_rng(1)
    block = {k.split(".", 2)[2]: (v.numpy() + 0.05 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in state.items()
        if k.startswith("backbone.encoder_block_0.")}
    mlp = {k[len("mlp."):]: v for k, v in block.items()
           if k.startswith("mlp.")}
    x = rng.standard_normal((2, 50, 384)).astype(np.float32)
    ct = rng.standard_normal((2, 50, 384)).astype(np.float32)
    ranks = spawn(worker.tp_blocks, MeshConfig(data=1, model=2),
                  device="cuda", timeout_s=300, args=(fields, mlp, block, x,
                                                      ct))
    want = worker.single_blocks(fields, mlp, block, x, ct, dev)
    for name in ("mlp", "block"):
        for r in ranks:
            assert r["core_launches"] == (2, 2)
            out, _, dx = r[name]
            assert _rel(torch.from_numpy(out),
                        torch.from_numpy(want[name][0])) < 1e-4
            assert _rel(torch.from_numpy(dx),
                        torch.from_numpy(want[name][2])) < 1e-4
        full = sharding.assemble_state_dict([(r["coords"], {
            k: torch.from_numpy(v) for k, v in r[name][1].items()})
            for r in ranks])
        for k, g in want[name][1].items():
            assert _rel(full[k], torch.from_numpy(g)) < 1e-4, k


# Rows 2 and 7 at ragged row counts: one row, one short of and one past a
# 32-row pass tile, and B/16 at batch 32 (49 full 128-row GEMM tiles and a
# 32-row one), at every preset width (Ti 192, S 384, B 768, L 1024, H 1280)
# with F = 4 D, and at B/16's tensor-parallel halves.
MLP_BWD_N = [1, 31, 33, 32 * 197]
MLP_BWD_DF = [(192, 768), (384, 1536), (384, 3072), (768, 1536),
              (768, 3072), (1024, 4096), (1280, 5120)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("d,f", MLP_BWD_DF)
@pytest.mark.parametrize("n", MLP_BWD_N)
@pytest.mark.parametrize("ln", [True, False], ids=["row1", "row6"])
def test_mlp_fwd_kernels_every_width_match_plain(dev, ln, n, d, f,
                                                 threshold, dtype):
    """The fused-MLP forward (row 1, LN and residual) and the MLP core
    forward (row 6) at every preset width against their plain versions,
    with and without the saved h: out within TOL, h within one bf16 ulp of
    its magnitude (TOL relative), one launch per call."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, d, f, seed=3 * n + d + threshold)
    if ln:
        kw = dict(eps=1e-6, seed=-6, threshold=threshold)
        launch, plain, counter = (fused_mlp._launch,
                                  fused_mlp.ln_mlp_residual_plain, "launches")
        args = p
    else:
        kw = dict(seed=-6, threshold=threshold)
        launch, plain, counter = (fused_mlp._launch_core,
                                  fused_mlp.mlp_core_plain, "core_launches")
        args = {k: p[k] for k in ("x2", "w1", "b1", "w2", "b2")}
    before = getattr(fused_mlp, counter)
    with torch.inference_mode():
        out = launch(**args, **kw)
        out_h, h = launch(**args, **kw, save_h=True)
        ref, h_ref = plain(**args, **kw, save_h=True)
    assert getattr(fused_mlp, counter) == before + 2
    assert torch.equal(out, out_h)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert _rel(h, h_ref) < TOL[dtype]


# Widths off the kernels' multiple of 64 (run on zero-padded operands):
# rows of 16-byte pitch (200, 800), of none (100, 300), and a wide pair
# whose padded F is not 4 D (1000 -> 1024, 4000 -> 4032).
MLP_OFF64_DF = [(200, 800), (100, 300), (1000, 4000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("d,f", MLP_OFF64_DF)
@pytest.mark.parametrize("n", [1, 33])
@pytest.mark.parametrize("ln", [True, False], ids=["rows12", "rows67"])
def test_mlp_kernels_off_64_widths_match_plain(dev, ln, n, d, f, threshold,
                                               dtype):
    """Rows 1 and 2 (LN forms, the LN statistics over the true D) and rows
    6 and 7 at widths that are no multiple of 64: forward, saved h and
    every gradient against the plain versions at the true widths, each
    wrapper launching its kernel once per call, gradients bitwise equal
    over two launches and of the parameters' shapes."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, d, f, seed=n + d + threshold)
    dout = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(
        dev, dtype)
    if ln:
        kw = dict(eps=1e-6, seed=-8, threshold=threshold)
        args = p
        fwd, fwd_plain = fused_mlp._launch, fused_mlp.ln_mlp_residual_plain
        bwd, bwd_plain = (fused_mlp._launch_bwd,
                          fused_mlp.ln_mlp_residual_bwd_plain)
        counters = ("launches", "bwd_launches")
        bwd_args = lambda h: (p["x2"], h, p["gamma"], p["beta"],  # noqa
                              p["w1"], p["w2"], dout)
    else:
        kw = dict(seed=-8, threshold=threshold)
        args = {k: p[k] for k in ("x2", "w1", "b1", "w2", "b2")}
        fwd, fwd_plain = fused_mlp._launch_core, fused_mlp.mlp_core_plain
        bwd, bwd_plain = (fused_mlp._launch_core_bwd,
                          fused_mlp.mlp_core_bwd_plain)
        counters = ("core_launches", "core_bwd_launches")
        bwd_args = lambda h: (p["x2"], h, p["w1"], p["b1"],  # noqa
                              p["w2"], dout)
    before = [getattr(fused_mlp, c) for c in counters]
    with torch.inference_mode():
        out, h = fwd(**args, **kw, save_h=True)
        ref, h_ref = fwd_plain(**args, **kw, save_h=True)
        got = bwd(*bwd_args(h_ref), **kw)
        again = bwd(*bwd_args(h_ref), **kw)
        want = bwd_plain(*bwd_args(h_ref), **kw)
    assert [getattr(fused_mlp, c) for c in counters] == [before[0] + 1,
                                                          before[1] + 2]
    assert out.shape == (n, d) and h.shape == (n, f)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert _rel(h, h_ref) < TOL[dtype]
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert _rel(a, c) < TOL[dtype]


# The mask forms of JAX's _normalize_mask at B = 2, H = 3: key padding
# (batch mode, q-broadcast), shared (one), per head (head), full, per-head
# q-broadcast, and key-broadcast (query rows, some fully masked).
FLASH_MASKS = {"key_padding": (2, 1, 1, "k"), "shared": (1, 1, "q", "k"),
               "per_head": (1, 3, "q", "k"), "full": (2, 3, "q", "k"),
               "q_bcast_per_head": (1, 3, 1, "k"),
               "key_bcast": (2, 1, "q", 1)}


def _flash_case(dev, dtype, tq, tk, dh, form, seed):
    """q, k, v, dO for B = 2, H = 3 folded, and the folded mask of
    ``form`` (key 0 always attends but in the key-broadcast form)."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(6, tq, dh, generator=g).to(dev, dtype)
             for _ in range(2))
    k, v = (torch.randn(6, tk, dh, generator=g).to(dev, dtype)
            for _ in range(2))
    mask = None
    if form is not None:
        shape = [{"q": tq, "k": tk}.get(x, x) for x in FLASH_MASKS[form]]
        m = torch.rand(*shape, generator=g) < 0.7
        if shape[-1] > 1:
            m[..., 0] = True
        mask = fa.normalize_mask(m.to(dev), 2, 3, tq, tk)
    return q, k, v, do, mask


def _flash_fwd_bwd_vs_plain(dev, dtype, tq, tk, dh, form, threshold,
                            seed=0):
    """The forward, dq and dk/dv kernels against the plain versions (out,
    lse, each gradient); one launch each per call, the backward bitwise
    deterministic. Returns (out, dq) for the callers' own checks."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    q, k, v, do, mask = _flash_case(dev, dtype, tq, tk, dh, form,
                                    seed + tq + 7 * tk + dh)
    kw = dict(seed=13, threshold=threshold, mask=mask)
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    with torch.inference_mode():
        out, lse = fa._launch(q, k, v, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
        delta = (do.float() * ref.float()).sum(-1)
        dq = fa._launch_bwd_dq(q, k, v, do, ref_lse, delta, **kw)
        dk, dv = fa._launch_bwd_dkv(q, k, v, do, ref_lse, delta, **kw)
        assert torch.equal(dq, fa._launch_bwd_dq(q, k, v, do, ref_lse,
                                                 delta, **kw))
        assert all(torch.equal(a, b) for a, b in zip(
            (dk, dv), fa._launch_bwd_dkv(q, k, v, do, ref_lse, delta, **kw)))
        want = fa.flash_attention_bwd_plain(q, k, v, do, ref_lse, delta,
                                            **kw)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        counts[0] + 1, counts[1] + 2, counts[2] + 2)
    assert out.shape == q.shape and lse.shape == (6, tq)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    for a, b in zip((dq, dk, dv), want):
        assert a.shape == b.shape
        assert _rel(a, b) < TOL[dtype]
    return out, dq, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 80, 256])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("form", list(FLASH_MASKS))
def test_flash_mask_forms_kernels_match_plain(dev, form, threshold, dh,
                                              dtype):
    """Rows 3-5 with every mask form at T = 197 (bf16: the wgmma kernels,
    the Dh = 256 work split included; f32: SIMT): within the flash bounds
    of the plain versions, dropout keep bits composed with the mask; rows
    that attend to no key have out and dq exactly 0 and lse -1e30."""
    out, dq, mask = _flash_fwd_bwd_vs_plain(dev, dtype, 197, 197, dh, form,
                                            threshold)
    dead = ~mask.expand(6).expand(-1, 197, -1).any(-1)   # [BH, Tq]
    if form == "key_bcast":
        assert dead.any()
    assert not out[dead].any() and not dq[dead].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [32, 64, 256])
@pytest.mark.parametrize("form", [None, "full", "key_padding"])
@pytest.mark.parametrize("tq,tk", [(197, 577), (577, 197), (40, 72),
                                   (72, 40), (1, 65), (65, 3), (17, 16)])
def test_flash_unequal_lengths_kernels_match_plain(dev, tq, tk, form, dh,
                                                   dtype):
    """Rows 3-5 with Tq != Tk (the q and k tails on both axes, the narrow
    16-row tail step), unmasked and masked, dropout on. (Tk = 1 would
    make dq and dk rounding noise, see test_flash_bwd_kernels_match_plain;
    Tk = 3 keeps them real.)"""
    _flash_fwd_bwd_vs_plain(dev, dtype, tq, tk, dh, form, 26)


def test_masked_attention_on_card_launches_flash(dev):
    """``dot_product_attention(mask=..., impl="auto")`` at T = 197 on the
    card launches the flash kernels (forward and backward), never the xla
    path, and agrees with the xla path where a row attends to some key."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        attention, flash_attention as fa)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 197, 3, 64, generator=g).to(
        dev, torch.bfloat16).requires_grad_() for _ in range(3))
    mask = (torch.rand(2, 1, 1, 197, generator=g) < 0.8).to(dev)
    mask[..., 0] = True
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = attention.dot_product_attention(q, k, v, mask=mask)
    out.float().square().sum().backward()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    with torch.no_grad():
        ref = attention.dot_product_attention(q, k, v, mask=mask,
                                              impl="xla")
    assert _rel(out, ref) < 2e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("threshold", [0, 26])
@pytest.mark.parametrize("d,f", MLP_BWD_DF)
@pytest.mark.parametrize("n", MLP_BWD_N)
@pytest.mark.parametrize("ln", [True, False], ids=["row2", "row7"])
def test_mlp_bwd_kernels_ragged_match_plain(dev, ln, n, d, f, threshold,
                                            dtype):
    """The fused-MLP backward (row 2, with LN) and the MLP core backward
    (row 7) against their plain versions, each gradient relative to its
    largest element (bf16 2e-2, f32 1e-4); two launches bitwise equal."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    p = _mlp_args(dev, dtype, n, d, f, seed=n + d + threshold)
    dout = torch.randn(n, d, generator=torch.Generator().manual_seed(n)).to(
        dev, dtype)
    if ln:
        kw = dict(eps=1e-6, seed=-5, threshold=threshold)
        _, h = fused_mlp.ln_mlp_residual_plain(**p, **kw, save_h=True)
        args = (p["x2"], h, p["gamma"], p["beta"], p["w1"], p["w2"], dout)
        launch, plain = (fused_mlp._launch_bwd,
                         fused_mlp.ln_mlp_residual_bwd_plain)
        counter = "bwd_launches"
    else:
        kw = dict(seed=-5, threshold=threshold)
        _, h = fused_mlp.mlp_core_plain(p["x2"], p["w1"], p["b1"], p["w2"],
                                        p["b2"], **kw, save_h=True)
        args = (p["x2"], h, p["w1"], p["b1"], p["w2"], dout)
        launch, plain = (fused_mlp._launch_core_bwd,
                         fused_mlp.mlp_core_bwd_plain)
        counter = "core_bwd_launches"
    before = getattr(fused_mlp, counter)
    got = launch(*args, **kw)
    again = launch(*args, **kw)
    want = plain(*args, **kw)
    assert getattr(fused_mlp, counter) == before + 2
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert _rel(a, c) < TOL[dtype]


@pytest.mark.parametrize("form,m,n,k,splits", [
    ("nt", 64, 128, 64, 1),       # one tile, one stage
    ("nt", 200, 192, 256, 1),     # ragged m and n, a 4-stage ring
    ("nt", 1, 128, 768, 1),       # one row (dg at N = 1)
    ("nt", 300, 384, 3072, 1),    # dy's form: many laps of the ring
    ("tn", 128, 128, 64, 1),      # MN-major A and B, one tile
    ("tn", 192, 320, 200, 1),     # ragged k, m and n
    ("tn", 64, 64, 1, 1),         # one reduction row
    ("tn", 768, 256, 6304, 2),    # the weight gradients' form, split
    ("tn", 384, 128, 788, 3),     # three splits, the last one shorter
])
def test_wgmma_gemm_matches_matmul(dev, form, m, n, k, splits):
    """The bf16 wgmma GEMM of the MLP backward on its own against
    ``torch.matmul`` of the same bf16 operands in f32: its shared-memory
    descriptors (K-major A and B, MN-major A and B), the ring and the
    zero-filled ragged edges. Products of bf16 values are exact in f32, so
    only the summation order differs (1e-5 of the largest element)."""
    from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
    g = torch.Generator().manual_seed(m + n + k)
    shapes = ((m, k), (n, k)) if form == "nt" else ((k, m), (k, n))
    a, b = (torch.randn(*s_, generator=g).to(dev, torch.bfloat16)
            for s_ in shapes)
    want = (a.float() @ b.float().T if form == "nt"
            else a.float().T @ b.float())
    got = fused_mlp._launch_gemm(a, b, form, splits)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    assert torch.equal(got, fused_mlp._launch_gemm(a, b, form, splits))


def test_bf16_tma_operands_must_be_aligned_on_card(dev):
    """The bf16 dq, MLP backward and GEMM kernels read their operands
    through TMA: an operand 2 bytes past an aligned base raises before any
    launch, and no counter moves."""
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    bf = torch.bfloat16

    def odd(*shape):
        n = int(np.prod(shape))
        t = torch.zeros(n + 1, dtype=bf, device=dev)[1:].view(*shape)
        assert t.data_ptr() % 16
        return t

    n, d, f = 40, 384, 1536
    p = _mlp_args(dev, bf, n, d, f)
    h = torch.zeros(n, f, dtype=bf, device=dev)
    counts = (fused_mlp.bwd_launches, fused_mlp.core_bwd_launches,
              fa.dq_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp._launch_bwd(p["x2"], h, p["gamma"], p["beta"], p["w1"],
                              p["w2"], odd(n, d), eps=1e-6, seed=0,
                              threshold=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp._launch_core_bwd(odd(n, d), h, p["w1"], p["b1"], p["w2"],
                                   p["x2"], seed=0, threshold=0)
    q = torch.zeros(2, 9, 64, dtype=bf, device=dev)
    vec = torch.zeros(2, 9, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._launch_bwd_dq(q, odd(2, 9, 64), q, q, vec, vec, seed=0,
                          threshold=0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_mlp._launch_gemm(odd(64, 64), q.new_zeros(64, 64), "tn")
    assert counts == (fused_mlp.bwd_launches, fused_mlp.core_bwd_launches,
                      fa.dq_launches)


def test_pinned_prefetch_yields_the_batches_on_the_card(dev):
    """``prefetch_to_device`` on the card: every batch arrives as device
    tensors equal to its numpy batch, in order, while the consumer keeps
    the card busy (so copies and reuse of the pinned buffers overlap it)."""
    from pytorch_vit_paper_replication_tpu_torch.data import (
        prefetch_to_device)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.standard_normal((8, 32, 32, 3)).astype(
                    np.float32),
                "label": rng.integers(0, 10, 8).astype(np.int32)}
               for _ in range(12)]
    for size in (1, 2, 3):
        got = []
        for b in prefetch_to_device(iter(batches), size=size, device=dev):
            torch.cuda._sleep(2_000_000)
            assert all(t.is_cuda for t in b.values())
            got.append({k: (t * 1).cpu().numpy() for k, t in b.items()})
        assert len(got) == len(batches)
        for g, w in zip(got, batches):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_pinned_buffer_reused_only_after_its_copy_completed(dev):
    """A pinned buffer set whose copy is still queued (behind a spin
    kernel) is rewritten only after that copy's event completes: the
    device copy reads the old contents."""
    from pytorch_vit_paper_replication_tpu_torch.data.image_folder import (
        _pinned_copy)
    host = {"image": torch.zeros((4, 64, 64, 3), pin_memory=True)}
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)
        on_card = host["image"].to(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record(side)
    free = [(event, host)]
    assert not event.query()
    out = _pinned_copy({"image": np.ones((4, 64, 64, 3), np.float32)}, free)
    assert event.query() and free == []
    assert out["image"] is host["image"] and bool((out["image"] == 1).all())
    torch.cuda.synchronize()
    assert bool((on_card == 0).all())


def test_train_cli_epoch_on_card_matches_cpu(dev, tmp_path):
    """One Ti/16 epoch through the train CLI (f32, the fused MLP and
    flash kernels, dropout off) on the card against the same epoch with
    ``--device cpu``, within chip_smoke's card-vs-CPU step bound (2e-3
    relative on the loss)."""
    from pytorch_vit_paper_replication_tpu_torch import train
    from pytorch_vit_paper_replication_tpu_torch.convert import (
        load_params_npz)
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_synthetic_image_folder)
    tr, te = make_synthetic_image_folder(tmp_path / "ds", train_per_class=8,
                                         test_per_class=2, image_size=32)
    argv = ["--train-dir", str(tr), "--test-dir", str(te), "--preset",
            "ViT-Ti/16", "--image-size", "32", "--patch-size", "16",
            "--dtype", "float32", "--batch-size", "8", "--epochs", "1",
            "--attention", "flash", "--mlp-impl", "fused", "--dropout", "0",
            "--seed", "3", "--num-workers", "1"]
    res = {d: train.main(argv + ["--device", d, "--checkpoint-dir",
                                 str(tmp_path / d)])
           for d in ("cuda", "cpu")}
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(res["cuda"][key], res["cpu"][key],
                                   rtol=2e-3, err_msg=key)
    card = load_params_npz(tmp_path / "cuda" / "final" / "params.npz")
    cpu = load_params_npz(tmp_path / "cpu" / "final" / "params.npz")
    num = sum(float((card[k].double() - cpu[k].double()).square().sum())
              for k in cpu)
    den = sum(float(cpu[k].double().square().sum()) for k in cpu)
    assert (num / den) ** 0.5 < 2e-3


def _small_state(dev, *, attention="xla", mlp="xla", dtype="float32",
                 image_size=32):
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        TrainConfig, ViTConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    cfg = ViTConfig(image_size=image_size, patch_size=16, num_layers=1,
                    num_heads=2, embedding_dim=128, mlp_size=256,
                    num_classes=3, dtype=dtype, attention_impl=attention,
                    mlp_impl=mlp)
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, 0))
    model.to(dev)
    return cfg, engine.TrainState.create(
        model=model, seed=0, tx=optim.make_optimizer(TrainConfig(), 10))


def test_async_save_snapshots_before_a_queued_update(dev, tmp_path):
    """save() behind a queued spin kernel returns while the card is still
    busy, and an in-place update queued after it reaches neither the params
    nor the Adam moments of the saved step: the compute stream waits on
    the snapshot copy's completion event."""
    from pytorch_vit_paper_replication_tpu_torch.checkpoint import (
        Checkpointer)
    _, state = _small_state(dev)
    _, fresh = _small_state(dev)
    ck = Checkpointer(tmp_path / "ck")
    state.step = 1
    ck.save(state)          # allocates the pinned buffers
    ck.wait()
    params = dict(state.model.named_parameters())
    for m in (state.opt_state.mu, state.opt_state.nu):
        for v in m.values():
            v.fill_(0.25)
    want = {k: v.detach().clone() for k, v in params.items()}
    torch.cuda.synchronize()
    torch.cuda._sleep(300_000_000)
    spun = torch.cuda.Event()
    spun.record()
    state.step = 2
    assert ck.save(state)
    assert not spun.query(), "save() waited for the card"
    with torch.no_grad():
        torch._foreach_add_(list(params.values()), 1.0)
        torch._foreach_add_(list(state.opt_state.mu.values()), 1.0)
    ck.wait()
    ck.restore(fresh, 2)
    got = dict(fresh.model.named_parameters())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for v in fresh.opt_state.mu.values():
        assert bool((v == 0.25).all())
    for k, v in params.items():
        assert torch.equal(v, want[k] + 1.0), k


def test_profile_window_names_the_kernels(dev, tmp_path):
    """A ProfileController window over step 2 of a bf16 flash + fused-MLP
    run at T = 197 writes a torch.profiler trace naming the hand-written
    kernels of rows 1-5."""
    import json

    from pytorch_vit_paper_replication_tpu_torch import engine
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        ProfileController, StepTelemetry, TelemetryRegistry)
    _, state = _small_state(dev, attention="flash", mlp="fused",
                            dtype="bfloat16", image_size=224)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((8, 224, 224, 3)).astype(
        np.float32), "label": rng.integers(0, 3, 8)}
    reg = TelemetryRegistry()
    ctrl = ProfileController(tmp_path / "prof", steps=(2, 2), registry=reg)
    tel = StepTelemetry(registry=reg, sample_every=1, profiler=ctrl)
    engine.train(state, lambda: iter([batch] * 3), lambda: iter([]),
                 epochs=1, telemetry=tel, verbose=False)
    ctrl.close()
    traces = list((tmp_path / "prof").glob("capture_000_step2_*/trace.json"))
    assert len(traces) == 1
    names = {e.get("name", "") for e in json.loads(
        traces[0].read_text())["traceEvents"] if e.get("cat") == "kernel"}
    for key in ("ln_rows_pre", "gemm_bf16", "rows_post", "flash_fwd_wgmma",
                "flash_bwd_dq_wg2", "flash_bwd_dkv_wg2"):
        assert any(key in n for n in names), (key, sorted(names)[:20])
    assert reg.snapshot()["counters"]["profiler_captures_total"] == 1


def test_memory_gauges_read_the_allocator(dev):
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        TelemetryRegistry, memory_report, sample_device_memory)
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    reg = TelemetryRegistry()
    seen = sample_device_memory(reg)
    gauges = reg.snapshot()["gauges"]
    assert seen["mem_dev0_bytes_in_use"] == torch.cuda.memory_allocated(0)
    assert seen["mem_dev0_bytes_in_use"] >= keep.numel()
    assert gauges["mem_dev0_bytes_peak"] == torch.cuda.max_memory_allocated(0)
    assert gauges["mem_dev0_bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert gauges["mem_live_arrays"] > 0
    assert gauges["mem_live_bytes"] == seen["mem_dev0_bytes_in_use"]
    report = memory_report()["devices"]["cuda:0"]
    assert report["bytes_in_use"] >= keep.numel()


def test_frozen_backbone_step_on_card_matches_cpu(dev):
    """Three ``--freeze-backbone`` steps (f32, flash + fused MLP kernels at
    T = 17) on the card against the same steps on the CPU: loss and
    grad_norm within 2e-3; the backbone unchanged bit for bit on the card
    while the backward still runs through it (rows 2, 4 and 5 launch
    once per block a step: grad_norm covers every gradient); Adam state
    for the head only."""
    from pytorch_vit_paper_replication_tpu_torch import engine, optim
    from pytorch_vit_paper_replication_tpu_torch.configs import (
        TrainConfig, ViTConfig)
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    cfg = ViTConfig(image_size=64, patch_size=16, num_layers=2, num_heads=2,
                    embedding_dim=128, mlp_size=256, num_classes=3,
                    dtype="float32", attention_impl="flash",
                    mlp_impl="fused", attn_dropout=0.0, mlp_dropout=0.0,
                    embedding_dropout=0.0)
    init = seeded_params(cfg, 1)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.standard_normal((8, 64, 64, 3)).astype(
                    np.float32), "label": rng.integers(0, 3, 8)}
               for _ in range(3)]
    tcfg = TrainConfig(learning_rate=1e-2, warmup_fraction=0.0,
                       freeze_backbone=True)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = ViT(cfg)
        model.load_state_dict(init)
        model.to(d)
        state = engine.TrainState.create(
            model=model, seed=0, tx=optim.make_optimizer(
                tcfg, 3, trainable_label_fn=optim.head_only_label_fn))
        assert set(state.opt_state.mu) == {"head.kernel", "head.bias"}
        step = engine.make_train_step()
        before = (fused_mlp.bwd_launches, fa.dq_launches, fa.dkv_launches)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        after = (fused_mlp.bwd_launches, fa.dq_launches, fa.dkv_launches)
        if d.type == "cuda":
            assert [a - b for a, b in zip(after, before)] == [6, 6, 6]
        out[d.type] = (metrics, {k: v.detach().cpu() for k, v in
                                 state.model.state_dict().items()})
    for key in ("loss_sum", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in out["cuda"][0]],
                                   [m[key] for m in out["cpu"][0]],
                                   rtol=2e-3, err_msg=key)
    for k, v in init.items():
        if k.startswith("backbone."):
            assert torch.equal(out["cuda"][1][k], v), k
        else:
            assert not torch.equal(out["cuda"][1][k], v), k


def test_batch_infer_probs_equal_predict_batch_on_card(dev, tmp_path):
    """``OfflineEngine`` on every visible card (bf16, flash at T = 197 and
    the fused MLP): its ``probs`` sink rows give ``predict_batch``'s labels
    and probabilities bit for bit on the same rungs, and
    ``softmax(logits sink)`` on the card equals the ``probs`` sink."""
    from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    from pytorch_vit_paper_replication_tpu_torch.data import ArrayDataset
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        predict_batch)
    from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
        OfflineEngine)
    cfg = ViTConfig(image_size=224, patch_size=16, num_layers=2, num_heads=4,
                    embedding_dim=256, mlp_size=1024, num_classes=10,
                    dtype="bfloat16")
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, 0))
    model.to(dev).eval()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((21, 224, 224, 3)).astype(np.float32)
    ds = ArrayDataset(images, np.zeros(21, np.int64))
    ladder = (1, 8)
    sinks = {}
    for head in ("probs", "logits"):
        eng = OfflineEngine(model, head=head, image_size=224, buckets=ladder)
        assert eng.devices[0].type == "cuda"
        before = (fused_mlp.launches, fa.launches)
        eng.run(ds, tmp_path / head, batch_size=8)
        assert fused_mlp.launches > before[0] and fa.launches > before[1]
        sinks[head] = np.load(tmp_path / head / "outputs.npy")
    preds = predict_batch(model, list(images), buckets=ladder)
    for (label, prob), row in zip(preds, sinks["probs"]):
        assert label == int(row.argmax()) and prob == float(row.max())
    soft = torch.softmax(torch.from_numpy(sinks["logits"]).to(dev), dim=-1)
    assert np.array_equal(soft.cpu().numpy(), sinks["probs"])


# ------------------------------------------------------------ the scan
# scan_scores: M on both query tiles (8 and 64) and their edges, a ragged
# row tile, K off the 16-byte vector loads (7) and on them (24, 768).
SCAN_M = [1, 5, 8, 9, 64, 70]
SCAN_NK = [(1000, 768), (333, 7), (130, 24)]


@pytest.mark.parametrize("n,k", SCAN_NK)
@pytest.mark.parametrize("m", SCAN_M)
def test_scan_scores_kernel_matches_plain(dev, m, n, k):
    from pytorch_vit_paper_replication_tpu_torch.ops import scan_scores
    g = torch.Generator().manual_seed(m * 1000 + n + k)
    q = torch.randn(m, k, generator=g).to(dev)
    db = torch.randn(n, k, generator=g).to(dev)
    before = scan_scores.launches
    out = scan_scores.scan_scores(q, db)
    assert scan_scores.launches == before + 1
    ref = scan_scores.scan_scores_plain(q, db)
    # Both f32, summed in other orders: within 1e-5 of the largest score.
    assert _rel(out, ref) < 1e-5


def test_scan_scores_rows_do_not_depend_on_m_or_tf32(dev):
    """A query's scores are the same bits alone, in a padded batch of 8
    and in a batch of 70 (both query tiles), with TF32 on or off."""
    from pytorch_vit_paper_replication_tpu_torch.ops.scan_scores import (
        scan_scores)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(70, 768, generator=g).to(dev)
    db = (torch.randn(5000, 768, generator=g) + 2.0).to(dev)
    full = scan_scores(q, db)
    for m in (1, 5, 8, 9, 64):
        assert torch.equal(scan_scores(q[:m].contiguous(), db), full[:m])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(scan_scores(q, db), full)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _clustered_db(rows, dim, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((64, dim)).astype(np.float32) * 4.0
    return (centers[rng.integers(0, 64, rows)]
            + rng.standard_normal((rows, dim)).astype(np.float32))


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_sharded_scan_on_card_matches_cpu(dev, metric):
    from pytorch_vit_paper_replication_tpu_torch.search import (
        ShardedScanner)
    db = _clustered_db(20000, 768, 0)
    q = db[:13] + 0.1 * np.random.default_rng(1).standard_normal(
        (13, 768)).astype(np.float32)
    norms = np.linalg.norm(db, axis=1)
    kw = dict(k_max=20, metric=metric, norms=norms)
    card = ShardedScanner(db, devices=[dev], **kw).scan(q, 20)
    cpu = ShardedScanner(db, devices=["cpu"], **kw).scan(q, 20)
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)


def test_scan_ties_and_padded_tail_on_card(dev):
    """Duplicated rows tie exactly on the card too and resolve to the
    lowest row id (the reference argsort's order); a padded batch equals
    each query scanned alone, bit for bit (rungs 8 and 1)."""
    from pytorch_vit_paper_replication_tpu_torch.search import (
        ShardedScanner, reference_topk)
    rng = np.random.default_rng(2)
    base = rng.standard_normal((4000, 768)).astype(np.float32)
    db = np.concatenate([base, base[:1600]])
    q = base[:5]
    scanner = ShardedScanner(db, k_max=8, devices=[dev],
                             query_buckets=(1, 8))
    scores, ids = scanner.scan(q, 8)
    ref_s, ref_i = reference_topk(db, q, 8)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5)
    assert (ids[:, 0] == np.arange(5)).all()
    assert (ids[:, 1] == 4000 + np.arange(5)).all()
    for j in range(5):
        s1, i1 = scanner.scan(q[j], 8)
        np.testing.assert_array_equal(s1[0], scores[j])
        np.testing.assert_array_equal(i1[0], ids[j])


# ------------------------------------------------------------ the fleet
def _fleet_export(root, preset, seed, image_size=224):
    from PIL import Image

    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_state
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)
    model = ViT(PRESETS[preset](num_classes=3, image_size=image_size))
    model.load_state_dict(seeded_state(model, seed))
    out = save_inference_export(root / f"{preset.replace('/', '')}_{seed}",
                                model, transform_spec={"normalize": False})
    classes = root / "classes.txt"
    classes.write_text("pizza\nsteak\nsushi\n")
    rng = np.random.default_rng(seed)
    probes = []
    for i in range(6):
        p = root / f"probe{i}.png"
        if not p.exists():
            Image.fromarray(rng.integers(0, 256, (80, 72, 3), np.uint8)
                            ).save(p)
        probes.append(p)
    return out, classes, probes


def _fleet_ask(address, lines, timeout=120.0):
    import socket
    with socket.create_connection(address, timeout=timeout) as sock:
        sock.settimeout(timeout)
        rfile = sock.makefile("r", encoding="utf-8")
        out = []
        for line in lines:
            sock.sendall((line + "\n").encode())
            out.append(rfile.readline().rstrip("\n"))
        return out


def _lone_probs(export, preset, classes, probes, dev):
    """``::probs`` replies an in-process engine on the card gives for lone
    requests (bucket 1), and the kernels' launches in them."""
    import json

    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa, fused_mlp)
    from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine
    from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import (
        _answer)
    eng = InferenceEngine.from_checkpoint(
        export, preset=preset, class_names=["pizza", "steak", "sushi"],
        device=dev, buckets=(1, 4), use_manifest=False)
    try:
        before = (fused_mlp.launches, fa.launches)
        replies = [_answer(f"::probs {p}", eng, None) for p in probes]
        launched = (fused_mlp.launches - before[0], fa.launches - before[1])
    finally:
        eng.close()
    assert all("probs" in json.loads(r) for r in replies)
    return replies, launched


def test_two_replicas_on_card_behind_router_equal_in_process(dev, tmp_path):
    """Two port serve-CLI replicas on the one card (CUDA_VISIBLE_DEVICES
    from partition_devices(1, 2)) behind the router: routed ``::probs``
    replies equal an in-process engine's on the card bit for bit, and
    that engine launched the MLP and flash kernels in every block."""
    import functools

    from pytorch_vit_paper_replication_tpu_torch.serve.fleet import (
        FleetRouter, ReplicaManager, ReplicaSpec, build_serve_command,
        partition_devices)
    from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
        TelemetryRegistry)
    export, classes, probes = _fleet_export(tmp_path, "ViT-Ti/16", 3)
    want, launched = _lone_probs(export, "ViT-Ti/16", classes, probes, dev)
    assert launched == (12 * len(probes), 12 * len(probes))
    reg = TelemetryRegistry()
    manager = ReplicaManager(
        [ReplicaSpec(rid=f"r{i}", checkpoint=str(export), devices=part)
         for i, part in enumerate(partition_devices(1, 2))],
        command_factory=functools.partial(
            build_serve_command, classes_file=str(classes),
            preset="ViT-Ti/16", buckets="1,4",
            extra=["--no-manifest", "--sync-warmup"]),
        health_interval_s=0.25, stale_after_s=30.0, registry=reg)
    router = FleetRouter(manager, registry=reg)
    with manager, router:
        manager.start()
        assert manager.wait_ready(300.0), manager.stderr_tail("r0")
        router.start()
        got = _fleet_ask(router.address, [f"::probs {p}" for p in probes])
        direct = [manager.request(r, f"::probs {probes[0]}",
                                  timeout_s=60.0) for r in ("r0", "r1")]
    assert got == want
    assert direct == [want[0], want[0]]


def test_cascade_on_card_threshold_zero_and_inf(dev, tmp_path):
    """A ViT-Ti/16 student and a ViT-S/16 teacher replica on the card
    behind the cascade: threshold 0 answers the student's in-process
    replies bit for bit, infinity the teacher's."""
    import functools

    from pytorch_vit_paper_replication_tpu_torch.serve.cascade import (
        CascadeRouter)
    from pytorch_vit_paper_replication_tpu_torch.serve.fleet import (
        ReplicaManager, ReplicaSpec, build_serve_command)
    from pytorch_vit_paper_replication_tpu_torch.telemetry.registry import (
        TelemetryRegistry)
    tiers = {"student": ("ViT-Ti/16", 4), "teacher": ("ViT-S/16", 5)}
    exports, want = {}, {}
    for tier, (preset, seed) in tiers.items():
        exports[tier], classes, probes = _fleet_export(tmp_path, preset, seed)
        want[tier], _ = _lone_probs(exports[tier], preset, classes, probes,
                                    dev)

    def command(spec):
        return build_serve_command(
            spec, classes_file=str(classes), preset=tiers[spec.model][0],
            buckets="1,4", extra=["--no-manifest", "--sync-warmup"])

    reg = TelemetryRegistry()
    manager = ReplicaManager(
        [ReplicaSpec(rid=tier[0], checkpoint=str(exports[tier]),
                     model=tier) for tier in tiers],
        command_factory=command, health_interval_s=0.25,
        stale_after_s=30.0, registry=reg)
    router = CascadeRouter(manager, threshold=0.0, registry=reg)
    with manager, router:
        manager.start()
        assert manager.wait_ready(300.0), manager.stderr_tail("s")
        router.start()
        lines = [f"::probs {p}" for p in probes]
        at_zero = _fleet_ask(router.address, lines)
        router.threshold = float("inf")
        at_inf = _fleet_ask(router.address, lines)
        counters = router.counters()
    assert at_zero == want["student"] and at_inf == want["teacher"]
    assert counters["escalated"] == len(probes)
    assert counters["served_student"] == len(probes)


def test_mesh_train_cli_on_the_card(dev, tmp_path):
    """The train CLI on dp 2 x pp 2, four gloo ranks sharing the card:
    ViT-Ti/16 at 224 px (T = 197), bf16, auto, one epoch of 3 steps with
    --grad-accum 2 and an eval. Every rank launches its stage's 6 layers'
    LN-MLP and flash kernels, forward and backward, in each of its 2
    microbatches, never the MLP core; the ranks agree; the one-card
    --eval-only scores the mesh run's final/ export as the run's own eval
    did (bf16, 2e-2 relative)."""
    from pytorch_vit_paper_replication_tpu_torch import train
    from pytorch_vit_paper_replication_tpu_torch.data import (
        make_synthetic_image_folder)
    train_dir, test_dir = make_synthetic_image_folder(
        tmp_path / "ds", train_per_class=8, test_per_class=2,
        image_size=224)
    ck = tmp_path / "ck"
    common = ["--test-dir", str(test_dir), "--preset", "ViT-Ti/16",
              "--image-size", "224", "--batch-size", "8", "--seed", "0"]
    res = train.main(["--train-dir", str(train_dir), *common, "--epochs",
                      "1", "--grad-accum", "2", "--mesh-data", "2",
                      "--mesh-pipe", "2", "--checkpoint-dir", str(ck)])
    fwd, bwd = 6 * 2 * (3 + 1), 6 * 2 * 3
    want = {"fused_ln_mlp_residual": fwd, "fused_ln_mlp_residual_bwd": bwd,
            "fused_mlp_core": 0, "fused_mlp_core_bwd": 0,
            "flash_attention": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}
    assert res["rank_launches"] == [want] * 4
    assert all(r == res["rank_results"][0] for r in res["rank_results"])
    assert np.isfinite(res["train_loss"] + res["test_loss"]).all()
    for d in ck.iterdir():
        if d.name.isdigit():
            shutil.rmtree(d)
    one_card = train.main([*common, "--eval-only", "--checkpoint-dir",
                           str(ck)])
    np.testing.assert_allclose(one_card["test_loss"], res["test_loss"],
                               rtol=2e-2)


@pytest.mark.parametrize("impl,sizes", [("ring", (1, 2, 2)),
                                        ("ulysses", (2, 1, 2))])
def test_sequence_parallel_attention_on_card_matches_flash(dev, impl, sizes):
    """Ring on seq 2 x model 2 (heads sharded) and Ulysses on data 2 x seq
    2, four gloo ranks sharing the card, f32, attention dropout: the
    output and dq, dk, dv of B/16's attention shape (T = 196, 12 heads,
    Dh 64) within 1e-4 of the flash kernel's on the whole batch with the
    same seed, and the keep masks (q = k = 0, v the identity, T = 128)
    the flash kernel's bit for bit."""
    import torch_parallel_worker as worker
    from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
    from pytorch_vit_paper_replication_tpu_torch.ops.flash_attention import (
        flash_attention)
    from pytorch_vit_paper_replication_tpu_torch.parallel import spawn
    rng = np.random.default_rng(4)
    b, t, h, d = 4, 196, 12, 64
    q, k, v, ct = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))
    te = 128
    z = np.zeros((2, te, 2, te), np.float32)
    eye = np.broadcast_to(np.eye(te, dtype=np.float32)[None, :, None, :],
                          z.shape).copy()
    heads = sizes[1] > 1
    seed, rate = 1234, 0.1
    cases = [dict(q=q, k=k, v=v, ct=ct, rate=rate, seed=seed, heads=heads),
             dict(q=z, k=z, v=eye, ct=np.ones_like(z), rate=rate, seed=seed,
                  heads=heads)]
    data, model, seq = sizes
    ranks = spawn(worker.sp_attention, MeshConfig(data=data, model=model,
                                                  seq=seq),
                  device="cuda", timeout_s=300, args=(impl, cases))
    for i, shape in enumerate(((b, t, h, d), z.shape)):
        out, grads = worker.assemble_sp(ranks, i, shape)
        args = [torch.from_numpy(cases[i][n]).to(dev).requires_grad_()
                for n in "qkv"]
        ref = flash_attention(*args, dropout_rate=rate, seed=seed,
                              deterministic=False)
        if i == 1:
            np.testing.assert_array_equal(out > 0,
                                          ref.detach().cpu().numpy() > 0)
            continue
        (ref * torch.from_numpy(ct).to(dev)).sum().backward()
        assert _rel(torch.from_numpy(out), ref.detach().cpu()) < 1e-4
        for g, a in zip(grads, args):
            assert _rel(torch.from_numpy(g), a.grad.cpu()) < 1e-4
