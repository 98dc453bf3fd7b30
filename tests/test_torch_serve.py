"""The port's serving path on the CPU against itself and the JAX package.

A ViT-Ti/16 at 32 px (f32) is initialized by JAX from a seed, converted,
and written as the port's export (``params.npz`` + ``transform.json`` +
``model_meta.json``). The CPU engine then serves it: the ``::probs`` row
must equal the port's ``predict_image`` bit for bit (same ops, same batch
shape) and JAX's ``predict_image`` within 1e-4 (f32 forward tolerance);
the features/tokens heads must match JAX's ``ViTFeatureExtractor``.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pytorch_vit_paper_replication_tpu.configs import vit_ti16 as jvit_ti16
from pytorch_vit_paper_replication_tpu.data.transforms import (
    eval_transform as jax_eval_transform)
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.models import (
    ViTFeatureExtractor as JFeat)
from pytorch_vit_paper_replication_tpu.predictions import (
    predict_image as jax_predict_image)
from pytorch_vit_paper_replication_tpu_torch import configs as tcfg
from pytorch_vit_paper_replication_tpu_torch.convert import params_from_flax
from pytorch_vit_paper_replication_tpu_torch.models import ViT
from pytorch_vit_paper_replication_tpu_torch.predictions import (
    predict_image, save_inference_export)
from pytorch_vit_paper_replication_tpu_torch.serve import InferenceEngine
from pytorch_vit_paper_replication_tpu_torch.serve.__main__ import _answer

REPO = Path(__file__).resolve().parent.parent
CLASSES = ["pizza", "steak", "sushi"]
F32 = {"dtype": "float32"}


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """(export_dir, image paths, jax model, jax params)."""
    root = tmp_path_factory.mktemp("torch_serve")
    jm = JViT(jvit_ti16(num_classes=3, image_size=32, dtype="float32",
                        attention_impl="xla"))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32) for x in leaves])
    tm = ViT(tcfg.vit_ti16(num_classes=3, image_size=32, **F32))
    tm.load_state_dict(params_from_flax(params))
    out = save_inference_export(root / "export", tm)
    paths = []
    for i in range(4):
        p = root / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
                        ).save(p)
        paths.append(p)
    return out, paths, jm, params


@pytest.fixture(scope="module")
def engine(export):
    eng = InferenceEngine.from_checkpoint(
        export[0], preset="ViT-Ti/16", class_names=CLASSES, device="cpu",
        config_overrides=F32, buckets=(1, 4), max_wait_us=1000)
    yield eng
    eng.close()


def test_probs_row_bit_identical_to_predict_image_and_close_to_jax(
        export, engine):
    _, paths, jm, params = export
    reply = json.loads(_answer(f"::probs {paths[0]}", engine, None))
    got = np.asarray(reply["probs"], np.float32)
    _, _, mine = predict_image(engine.model, paths[0], CLASSES,
                               transform=engine.transform)
    np.testing.assert_array_equal(got, mine)
    assert reply["label"] == CLASSES[int(mine.argmax())]
    _, _, theirs = jax_predict_image(jm, params, paths[0], CLASSES,
                                     transform=jax_eval_transform(32))
    np.testing.assert_allclose(got, theirs, atol=1e-4, rtol=1e-4)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_features_and_tokens_heads_match_jax_backbone(export, engine):
    _, paths, jm, params = export
    feats = engine.submit(paths[1], head="features").result(timeout=60)
    toks = engine.submit(paths[1], head="tokens").result(timeout=60)
    x = np.asarray(engine.transform(Image.open(paths[1])))[None]
    want = np.asarray(JFeat(jm.config).apply(
        {"params": params["backbone"]}, jnp.asarray(x)))[0]
    assert toks.shape == (5, 192) and feats.shape == (192,)
    np.testing.assert_allclose(toks, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(feats, want[0], atol=1e-4, rtol=1e-4)


def test_engine_snapshot_manifest_and_every_request_answered(export,
                                                             engine):
    export_dir, paths, _, _ = export
    futs = [engine.submit(p) for p in paths * 3]
    results = [f.result(timeout=60) for f in futs]
    assert len(results) == 12 and all(r.label in CLASSES for r in results)
    snap = engine.snapshot()
    assert snap["device"] == "cpu" and snap["warm_rungs"] == [1, 4]
    assert snap["served_heads"] == ["probs", "features", "tokens"]
    assert snap["model_tier"] == "ViT-Ti/16"
    assert len(snap["checkpoint_fingerprint"]) == 16
    manifest = json.loads((export_dir / "warmup.json").read_text())
    assert manifest["buckets"] == [1, 4] and manifest["image_size"] == 32


def test_cli_control_lines(engine):
    assert _answer("::head features", engine, None) == \
        "::head\tok\tfeatures"
    assert "ERROR" in _answer("::head nope", engine, None)
    for line in ("::search 3 /x.png", "::metrics", "::req k=2 /x.png"):
        reply = _answer(line, engine, None)
        assert "\tERROR\tNotImplementedError:" in reply
        assert "not yet ported" in reply


def test_pipe_mode_cli_replies_well_formed(export):
    export_dir, paths, _, _ = export
    lines = [str(paths[0]), "::stats", "::head features", str(paths[1]),
             f"::req head=probs tier=batch {paths[2]}", "::metrics",
             "/no/such/image.png"]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_vit_paper_replication_tpu_torch.serve",
         "--checkpoint", str(export_dir), "--preset", "ViT-Ti/16",
         "--classes", *CLASSES, "--device", "cpu", "--buckets", "1,4",
         "--sync-warmup", "--no-manifest"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert len(out) == len(lines)
    path0, label, prob = out[0].split("\t")
    assert path0 == str(paths[0]) and label in CLASSES
    assert 0.0 < float(prob) <= 1.0
    assert json.loads(out[1])["buckets"] == [1, 4]
    assert out[2] == "::head\tok\tfeatures"
    p1, head, row = out[3].split("\t")
    assert head == "features" and len(json.loads(row)) == 192
    assert out[4].split("\t")[1] in CLASSES
    assert "not yet ported" in out[5]
    assert out[6].startswith("/no/such/image.png\tERROR\t")


def test_import_whole_port_pulls_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytorch_vit_paper_replication_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'flax'"
        " or m.startswith('pytorch_vit_paper_replication_tpu.')"
        " or m == 'pytorch_vit_paper_replication_tpu']\n"
        "print(len([m for m in sys.modules if m.startswith(pkg.__name__)]))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_entry_point_without_device_raises_without_a_card(export):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    tm = ViT(tcfg.ViTConfig(image_size=32, patch_size=16, num_layers=1,
                            num_heads=2, embedding_dim=32, mlp_size=64,
                            num_classes=3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tm, image_size=32, warmup=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine.from_checkpoint(export[0], preset="ViT-Ti/16",
                                        class_names=CLASSES)
