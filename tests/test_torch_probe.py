"""The port's linear probe (``probe.py``) against the JAX package's.

Same backbone weights (JAX's init, converted) and seeded batches, f32.
Tolerances: features within 1e-5 (both backbones run the same ops in f32,
summed in other orders); the fit from JAX's initial head within 1e-4 of
JAX's after 50 full-batch AdamW steps (f32 Adam steps amplify rounding
differences of the gradients); evaluation within 1e-6. The initial head
itself is drawn differently (a ``torch.Generator`` against
``jax.random.normal``, ROADMAP Queue 3), so the CLI comparison hands the
port JAX's draw.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu import probe as jprobe
from pytorch_vit_paper_replication_tpu.configs import PRESETS as JPRESETS
from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.models import (
    ViTFeatureExtractor as JFeat)
from pytorch_vit_paper_replication_tpu_torch import probe
from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
from pytorch_vit_paper_replication_tpu_torch.convert import params_from_flax
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder)
from pytorch_vit_paper_replication_tpu_torch.models import (
    ViTFeatureExtractor)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
             embedding_dim=32, mlp_size=64, num_classes=1, dtype="float32",
             attention_impl="xla", mlp_impl="xla")


def _batches(n=3, b=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 3, b).astype(np.int32)}
            for _ in range(n)]


def _backbones(pool):
    cfg = dict(SMALL, pool=pool)
    jm = JFeat(JCfg(**cfg))
    params = jax.device_get(jm.init(jax.random.key(2), jnp.zeros(
        (1, 32, 32, 3)))["params"])
    model = ViTFeatureExtractor(ViTConfig(**cfg))
    model.load_state_dict(params_from_flax(params))
    return jm, params, model


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_extract_features_matches_jax(pool):
    jm, params, model = _backbones(pool)
    batches = _batches()
    jf, jy = jprobe.extract_features(jm, params, batches)
    tf, ty = probe.extract_features(model, batches)
    assert tf.dtype == torch.float32 and tuple(tf.shape) == jf.shape
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ty.numpy(), jy)


def _features(n=40, d=16, c=3, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, c, n).astype(np.int32))


def _jax_initial_head(d, c, seed):
    """JAX ``train_linear_probe``'s start: 0.01 N(0, 1) from key(seed)."""
    return {"kernel": np.array(jax.random.normal(
                jax.random.key(seed), (d, c), jnp.float32) * 0.01),
            "bias": np.zeros((c,), np.float32)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_fit_from_jax_initial_head_matches_jax(weight_decay):
    x, y = _features()
    want = jprobe.train_linear_probe(x, y, 3, epochs=50, learning_rate=5e-2,
                                     weight_decay=weight_decay, seed=3)
    start = {k: torch.from_numpy(v)
             for k, v in _jax_initial_head(16, 3, 3).items()}
    got = probe.fit_linear_probe(x, y, start, epochs=50, learning_rate=5e-2,
                                 weight_decay=weight_decay)
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        assert np.abs(np.asarray(want[k]) - start[k].numpy()).max() > 1e-2


def test_evaluate_probe_matches_jax():
    x, y = _features()
    head = _jax_initial_head(16, 3, 0)
    head["kernel"] = head["kernel"] * 300.0
    want = jprobe.evaluate_probe(head, x, y)
    got = probe.evaluate_probe({k: torch.from_numpy(v)
                                for k, v in head.items()}, x, y)
    assert got["acc"] == pytest.approx(want["acc"], abs=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)


def test_train_linear_probe_seeded_on_named_device():
    """The port's own draw is seeded (two runs equal) and the fit runs on
    the device it is given; without one it asks for the card."""
    x, y = _features()
    a = probe.train_linear_probe(x, y, 3, epochs=5, seed=1, device="cpu")
    b = probe.train_linear_probe(x, y, 3, epochs=5, seed=1, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["kernel"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.train_linear_probe(x, y, 3, epochs=1)


@pytest.fixture(scope="module")
def probe_data(tmp_path_factory):
    """A synthetic image folder and a seeded torchvision-layout ViT-Ti/16
    state dict at 32 px."""
    root = tmp_path_factory.mktemp("probe")
    train, test = make_synthetic_image_folder(
        root / "ds", train_per_class=6, test_per_class=2, image_size=32)
    spec = importlib.util.spec_from_file_location(
        "make_torch_vit", REPO / "tools" / "make_torch_vit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.manual_seed(1)
    sd = mod.TorchViT(JPRESETS["ViT-Ti/16"](num_classes=1000, image_size=32)
                      ).state_dict()
    pth = root / "ti16_32.pth"
    torch.save(sd, pth)
    return train, test, pth


def test_probe_cli_matches_jax_cli(probe_data, monkeypatch):
    """``probe --pretrained`` end to end (pretrained transform, both
    splits' features, 100 AdamW steps, evaluation) against the JAX CLI,
    the port's initial head patched to JAX's draw: accuracies equal, test
    loss within 1e-4."""
    train, test, pth = probe_data
    argv = ["--train-dir", str(train), "--test-dir", str(test), "--preset",
            "ViT-Ti/16", "--image-size", "32", "--pretrained", str(pth),
            "--batch-size", "8", "--probe-epochs", "100"]
    want = jprobe.main(argv)

    def jax_head(dim, num_classes, *, seed=0, device=None):
        return {k: torch.from_numpy(v).to(device) for k, v in
                _jax_initial_head(dim, num_classes, seed).items()}
    monkeypatch.setattr(probe, "init_probe_head", jax_head)
    got = probe.main(argv + ["--device", "cpu"])
    assert got["train_acc"] == want["train_acc"]
    assert got["test_acc"] == want["test_acc"]
    assert got["test_loss"] == pytest.approx(want["test_loss"], abs=1e-4)


def test_probe_cli_checkpoint_random_backbone_and_refusals(
        probe_data, tmp_path, capsys):
    """--checkpoint reads the backbone keys of the port's params.npz (the
    same tensors as --pretrained of the weights it was made from); no
    weights probes
    a random backbone with the JAX CLI's warning; --compile-cache-dir is
    refused."""
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.models import ViT
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        save_inference_export)
    from pytorch_vit_paper_replication_tpu_torch.transfer import (
        init_from_pretrained)
    train, test, pth = probe_data
    cfg = PRESETS["ViT-Ti/16"](num_classes=3, image_size=32)
    model = ViT(cfg)
    model.load_state_dict(init_from_pretrained(cfg, pth))
    export = save_inference_export(tmp_path / "export", model)
    import argparse
    probe_cfg = PRESETS["ViT-Ti/16"](num_classes=1, image_size=32)
    via = {src: probe._backbone_state(argparse.Namespace(**{
        "checkpoint": None, "pretrained": None, src: str(path)}), probe_cfg)
        for src, path in (("checkpoint", export), ("pretrained", pth))}
    assert set(via["checkpoint"]) == set(via["pretrained"])
    for k, v in via["pretrained"].items():
        assert torch.equal(via["checkpoint"][k], v), k
    common = ["--train-dir", str(train), "--test-dir", str(test), "--preset",
              "ViT-Ti/16", "--image-size", "32", "--batch-size", "8",
              "--probe-epochs", "20", "--device", "cpu"]
    from_ckpt = probe.main(common + ["--checkpoint", str(export)])
    assert 0.0 <= from_ckpt["test_acc"] <= 1.0
    assert np.isfinite(from_ckpt["test_loss"])
    capsys.readouterr()
    rand = probe.main(common)
    assert "probing a RANDOM backbone" in capsys.readouterr().out
    assert np.isfinite(rand["test_loss"])
    with pytest.raises(SystemExit, match="not yet ported"):
        probe.main(common + ["--compile-cache-dir", "cc"])
