"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: every test skips on a host without a CUDA device (the
decision is made inside the fixture). This file imports no JAX, so it
also runs on a card machine without it::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4; bf16 2e-2 (one bf16 ulp at |x| < 4 — kernel and
plain version sum in different orders before the same final rounding).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dh", [32, 64, 128, 256])
@pytest.mark.parametrize("threshold", [0, 26])
def test_flash_kernel_matches_plain(dev, dh, threshold):
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    g = torch.Generator().manual_seed(dh)
    q, k, v = [torch.randn(6, 137, dh, generator=g).to(dev, torch.bfloat16)
               for _ in range(3)]
    with torch.inference_mode():
        out, lse = fa._launch(q, k, v, seed=9, threshold=threshold)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, seed=9,
                                                threshold=threshold)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


def test_kernels_refuse_autograd_inputs(dev):
    from pytorch_vit_paper_replication_tpu_torch.ops import (
        flash_attention as fa)
    q = torch.randn(1, 8, 1, 32, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        fa.flash_attention(q, q, q)


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
