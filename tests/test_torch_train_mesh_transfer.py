"""The port's train CLI on a mesh against the JAX CLI: distillation and a
frozen pretrained backbone (the harness, data and bounds of
test_torch_train_mesh.py, which holds the other cases)."""

import json

import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.configs import PRESETS as JPRESETS
from pytorch_vit_paper_replication_tpu_torch.convert import (
    load_params_npz, params_to_flax)
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder, pack_image_folder)

from test_torch_cli import _rows, free_tmp_path  # noqa: F401
from test_torch_train_mesh import COMMON, _folder, against_jax, jax_init


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_synthetic_image_folder(
        tmp_path_factory.mktemp("torch_mesh_transfer") / "ds",
        train_per_class=8, test_per_class=2, image_size=32)


@pytest.fixture(scope="module")
def distill_pack(folder, tmp_path_factory):
    """The folder packed at 40 px and a sealed teacher logits sink over
    its train split (``tests/test_torch_distill.py``'s)."""
    from test_torch_distill import _write_sink
    root = tmp_path_factory.mktemp("torch_mesh_distill")
    ptrain = pack_image_folder(folder[0], root / "train", pack_size=40,
                               images_per_shard=5, shuffle_seed=0)
    ptest = pack_image_folder(folder[1], root / "test", pack_size=40)
    n = len(json.loads((ptrain / "index.json").read_text())["labels"])
    logits = 3.0 * np.random.default_rng(11).standard_normal((n, 3))
    return ptrain, ptest, _write_sink(root / "sink", logits)


def test_distill_dp2_matches_jax_cli(distill_pack, tmp_path, monkeypatch):
    """--distill-from on dp 2: the teacher rows sharded with the batch;
    the port's rows add teacher_agree (JAX prints it only)."""
    ptrain, ptest, sink = distill_pack
    argv = ["--dataset", "packed", "--train-dir", str(ptrain), "--test-dir",
            str(ptest), "--preset", "ViT-Ti/16", *COMMON, "--no-augment",
            "--epochs", "2", "--mesh-data", "2", "--distill-from",
            str(sink), "--distill-t", "2", "--distill-alpha", "0.7"]
    against_jax(argv, tmp_path, monkeypatch, init=jax_init("ViT-Ti/16"),
                port_extra={"teacher_agree"})
    rows = _rows(tmp_path / "port.jsonl")
    assert all(0.0 <= r["teacher_agree"] <= 1.0 for r in rows)


@pytest.fixture(scope="module")
def pretrained_s16(tmp_path_factory):
    """A seeded torchvision-layout ViT-S/16 state dict written for 32 px,
    as a ``.pth`` (``tools/make_torch_vit.py``'s model)."""
    from test_torch_cli import REPO
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_vit", REPO / "tools" / "make_torch_vit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.manual_seed(0)
    sd = mod.TorchViT(JPRESETS["ViT-S/16"](num_classes=1000, image_size=32,
                                           patch_size=16)).state_dict()
    path = tmp_path_factory.mktemp("pretrained_s16") / "vit_s16_32.pth"
    torch.save(sd, path)
    return path


def test_pretrained_freeze_backbone_dp2_tp2_matches_jax_cli(
        folder, pretrained_s16, tmp_path, monkeypatch):
    """--pretrained --freeze-backbone on dp 2 x tp 2 at 48 px: the head
    trains from zero on the tensor-parallel backbone, which ends equal to
    the converted weights bit for bit."""
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.transfer import (
        init_from_pretrained)
    argv = _folder(folder, "ViT-S/16") + [
        "--image-size", "48", "--epochs", "2",
        "--pretrained", str(pretrained_s16), "--freeze-backbone",
        "--mesh-data", "2", "--mesh-model", "2"]
    cfg = PRESETS["ViT-S/16"](num_classes=3, image_size=48, patch_size=16,
                              dtype="float32")
    start = init_from_pretrained(cfg, pretrained_s16)
    against_jax(argv, tmp_path, monkeypatch, start=params_to_flax(start))
    final = load_params_npz(tmp_path / "port" / "final" / "params.npz")
    for k, v in start.items():
        if k.startswith("backbone."):
            assert torch.equal(final[k], v), k
        else:
            assert not torch.equal(final[k], v), k
