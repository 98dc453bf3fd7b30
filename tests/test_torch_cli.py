"""The port's ``train`` and ``predict`` CLIs against the JAX package's.

Same synthetic folder (24 train images, batch 8, drop_last: 3 steps an
epoch), ViT-Ti/16 at 32 px, f32, ``--attention xla --mlp-impl xla
--dropout 0``, seed 7, one decode worker, two epochs. The port's
``train.initial_params`` is patched to the JAX CLI's own init (Flax
``model.init`` with ``key(seed)``), converted: the port cannot reproduce
Flax's RNG. Per-epoch losses agree within ``tests/test_torch_engine.py``'s
trajectory bound (rtol 5e-4), the final params within its drift bounds
(0.5% per leaf, 0.2% global; the qkv bias within 2e-3 absolute) and the
JSONL rows carry the same keys.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.configs import PRESETS as JPRESETS
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.train import main as jax_train_main
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.checkpoint import Checkpointer
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, load_params_npz, params_from_flax, params_to_flax)
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_fake_cifar10, make_synthetic_image_folder, pack_image_folder)
from pytorch_vit_paper_replication_tpu_torch.predictions import (
    load_inference_checkpoint, predict_image)

REPO = Path(__file__).resolve().parent.parent
# JSONL keys of the JAX CLI that the port does not write, with the reason.
PORT_OMITS = {
    "compile_cache_hits": "the port has no persistent compilation cache "
                          "(eager PyTorch; ROADMAP Queue 1 item 9)",
    "compile_cache_misses": "as compile_cache_hits",
    "tel_mfu": "the port computes MFU against the card's own bf16 peak "
               "(telemetry/flops.py) and has none for the CPU, where the "
               "JAX CLI divides by a TPU peak",
}
MODEL = ["--preset", "ViT-Ti/16", "--image-size", "32", "--patch-size", "16",
         "--dtype", "float32", "--batch-size", "8", "--num-workers", "1"]


@pytest.fixture(autouse=True)
def free_tmp_path(tmp_path):
    """Delete the test's files as it ends: a CLI run writes hundreds of MB
    of checkpoints, and the suite's runs together would fill a small
    disk."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these steps are tiny, and under a parallel
    test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_synthetic_image_folder(
        tmp_path_factory.mktemp("torch_cli") / "ds", train_per_class=8,
        test_per_class=2, image_size=32)


@pytest.fixture(scope="module")
def trained(folder, tmp_path_factory):
    """One epoch (seed 5, default dropout) with a checkpoint dir and the
    metrics JSONL: ``(checkpoint_dir, results)``."""
    ck = tmp_path_factory.mktemp("torch_cli_run") / "ckpt"
    res = ttrain.main(_cpu(_common(folder, "5")) + [
        "--epochs", "1", "--checkpoint-dir", str(ck),
        "--metrics-jsonl", str(ck / "m.jsonl")])
    return ck, res


def _common(folder, seed="7"):
    train, test = folder
    return ["--train-dir", str(train), "--test-dir", str(test), *MODEL,
            "--seed", seed]


def _cpu(argv):
    return argv + ["--device", "cpu"]


def _jax_init(seed: int, num_classes: int = 3, **overrides):
    cfg = JPRESETS["ViT-Ti/16"](num_classes=num_classes, image_size=32,
                                patch_size=16, dtype="float32", **overrides)
    params = JViT(cfg).init(jax.random.key(seed),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.device_get(params)


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_train_cli_matches_jax_cli(folder, tmp_path, monkeypatch):
    init = _jax_init(7)
    monkeypatch.setattr(ttrain, "initial_params",
                        lambda cfg, seed: params_from_flax(init))
    argv = _common(folder) + ["--attention", "xla", "--mlp-impl", "xla",
                              "--dropout", "0", "--epochs", "2"]
    jres = jax_train_main(argv + [
        "--checkpoint-dir", str(tmp_path / "jax"),
        "--metrics-jsonl", str(tmp_path / "jax.jsonl")])
    tres = ttrain.main(_cpu(argv) + [
        "--checkpoint-dir", str(tmp_path / "port"),
        "--metrics-jsonl", str(tmp_path / "port.jsonl")])
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=5e-4,
                                   err_msg=key)
    for key in ("train_acc", "test_acc"):
        assert tres[key] == jres[key], key
    jrows, trows = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path /
                                                       "port.jsonl")
    assert [set(r) for r in trows] == [set(r) - set(PORT_OMITS)
                                       for r in jrows]
    for tr, jr in zip(trows, jrows):
        assert (tr["step"], tr["epoch"]) == (jr["step"], jr["epoch"])
        np.testing.assert_allclose(tr["lr"], jr["lr"], rtol=1e-6)
        np.testing.assert_allclose(tr["grad_norm"], jr["grad_norm"],
                                   rtol=5e-4)
    # Final params: the port's export against JAX's final/ export.
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    try:
        jfinal = jax.device_get(ckptr.restore(tmp_path / "jax" / "final"))
    finally:
        ckptr.close()
    flat_j = flatten_tree(jfinal)
    flat_t = flatten_tree(params_to_flax(
        load_params_npz(tmp_path / "port" / "final" / "params.npz")))
    flat_0 = flatten_tree(init)
    assert set(flat_j) == set(flat_t)
    num = den = 0.0
    for key, t in flat_t.items():
        j, t0, t = (np.float64(x) for x in (flat_j[key], flat_0[key], t))
        num += np.linalg.norm(t - j) ** 2
        den += np.linalg.norm(j - t0) ** 2
        if key.endswith("qkv/bias"):
            assert np.abs(t - j).max() < 2e-3, key
        else:
            move = max(np.linalg.norm(j - t0), 1e-4)
            assert np.linalg.norm(t - j) / move < 5e-3, key
    assert (num / den) ** 0.5 < 2e-3
    for name in ("transform.json", "model_meta.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text()), name


def test_mid_epoch_resume_matches_uninterrupted(folder, tmp_path):
    """Train with step-interval checkpoints, delete everything after the
    mid-epoch step-4 save (1 of epoch 2's 3 batches trained) and the final
    export, rerun the same command: the resumed run reaches step 6 with
    params bit-identical to the uninterrupted run's (default dropout
    on)."""
    ck = tmp_path / "B"
    argv = _cpu(_common(folder) + ["--epochs", "2"]) + [
        "--checkpoint-dir", str(ck), "--checkpoint-every-steps", "2",
        "--keep-checkpoints", "20"]
    ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 4)):
            shutil.rmtree(d)
    assert Checkpointer(ck).latest_step() == 4
    ttrain.main(argv)
    assert Checkpointer(ck).latest_step() == 6
    b = load_params_npz(ck / "final" / "params.npz")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_eval_only_matches_final_metrics(folder, trained):
    ck, res = trained
    last = _rows(ck / "m.jsonl")[-1]
    eval_argv = _cpu(["--test-dir", str(folder[1]), *MODEL, "--seed", "5",
                      "--eval-only", "--checkpoint-dir", str(ck)])
    ev = ttrain.main(eval_argv)
    assert ev["train_loss"] == []
    assert ev["test_loss"][0] == res["test_loss"][-1] == last["test_loss"]
    assert ev["test_acc"][0] == res["test_acc"][-1] == last["test_acc"]
    # Without step checkpoints eval-only scores the final/ export.
    for d in ck.iterdir():
        if d.is_dir() and d.name.isdigit():
            shutil.rmtree(d)
    ev2 = ttrain.main(eval_argv)
    assert ev2["test_loss"][0] == res["test_loss"][-1]
    with pytest.raises(SystemExit, match="checkpoint-dir"):
        ttrain.main(_cpu(["--test-dir", str(folder[1]), *MODEL,
                          "--eval-only"]))


def test_resume_schedule_horizon_guard(folder, tmp_path):
    ck = tmp_path / "ck"
    base = _cpu(_common(folder)) + ["--checkpoint-dir", str(ck),
                                    "--attention", "xla", "--mlp-impl",
                                    "xla", "--dropout", "0"]
    ttrain.main(base + ["--epochs", "1"])
    with pytest.raises(SystemExit, match="extend-schedule"):
        ttrain.main(base + ["--epochs", "2"])
    assert json.loads((ck / "run_meta.json").read_text())["epochs"] == 1
    res = ttrain.main(base + ["--epochs", "2", "--extend-schedule"])
    assert len(res["train_loss"]) == 1
    assert Checkpointer(ck).latest_step() == 6
    assert json.loads((ck / "run_meta.json").read_text())["epochs"] == 2
    # A same-horizon resume of a finished run trains nothing.
    assert ttrain.main(base + ["--epochs", "2"])["train_loss"] == []


@pytest.mark.parametrize("extra,item", [
    (["--elastic", "2"], 7), (["--multihost"], 7),
    (["--compile-cache-dir", "cc"], 9)])
def test_unported_flags_exit_nonzero(folder, extra, item):
    with pytest.raises(SystemExit, match=f"not yet ported \\(ROADMAP Queue "
                                         f"1 item {item}\\)"):
        ttrain.main(_cpu(_common(folder)) + extra)


def test_rng_impl_is_refused(folder):
    with pytest.raises(SystemExit, match="rng-impl"):
        ttrain.main(_cpu(_common(folder)) + ["--rng-impl", "threefry2x32"])


def test_cuda_is_the_default_and_raises_without_a_card(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid")
    from pytorch_vit_paper_replication_tpu_torch import predict
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_common(folder) + ["--epochs", "1"])
    img = next(Path(folder[1]).rglob("*.jpg"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main([str(img), "--checkpoint", str(tmp_path),
                      "--classes", "pizza", "steak", "sushi",
                      "--preset", "ViT-Ti/16"])


def test_predict_cli_prints_predict_image(folder, trained):
    """``python -m ...predict`` as a user runs it on a trained run's
    directory: the printed label and probability are predict_image's on
    the same export."""
    ck, _ = trained
    images = sorted(Path(folder[1]).rglob("*.jpg"))[:3]
    proc = subprocess.run(
        [sys.executable, "-m",
         "pytorch_vit_paper_replication_tpu_torch.predict",
         *map(str, images), "--checkpoint", str(ck), "--classes", "pizza",
         "steak", "sushi", "--preset", "ViT-Ti/16", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    model, transform, spec = load_inference_checkpoint(
        ck, "ViT-Ti/16", 3, device="cpu")
    assert spec["image_size"] == 32 and spec["normalize"] is False
    for img, line in zip(images, lines):
        label, prob, _ = predict_image(model, img, ["pizza", "steak",
                                                    "sushi"], transform)
        assert line == f"{img}: {label} ({prob:.3f})"
    assert len(lines) == len(images)


@pytest.fixture(scope="module")
def packed(folder, tmp_path_factory):
    """The synthetic folder packed at 40 px (train in a seeded record
    order, 5 records a shard)."""
    root = tmp_path_factory.mktemp("torch_cli_packs")
    return (pack_image_folder(folder[0], root / "train", pack_size=40,
                              images_per_shard=5, shuffle_seed=0),
            pack_image_folder(folder[1], root / "test", pack_size=40))


def _packed(packed, seed="7"):
    return ["--dataset", "packed", "--train-dir", str(packed[0]),
            "--test-dir", str(packed[1]), *MODEL, "--seed", seed]


def _against_jax(argv, tmp_path, monkeypatch, telemetry=False,
                 num_classes=3, init=None, port_extra=()):
    """The JAX CLI and the port's on ``argv`` (the port's init patched to
    JAX's, ``init`` a Flax tree or the ViT-Ti/16 one): losses within rtol
    5e-4, accuracies equal, JSONL keys equal apart from ``port_extra``
    (keys the port's metrics rows add) (and with ``telemetry``, the
    telemetry rows' events and keys), the same transform.json and (where
    JAX writes one) model_meta.json."""
    init = params_from_flax(init if init is not None
                            else _jax_init(7, num_classes))
    monkeypatch.setattr(ttrain, "initial_params", lambda cfg, seed: init)
    runs = {}
    for name, fn, extra in (("jax", jax_train_main, []),
                            ("port", ttrain.main, ["--device", "cpu"])):
        obs = (["--telemetry-jsonl", str(tmp_path / f"{name}_tel.jsonl"),
                "--telemetry-every", "1"] if telemetry else [])
        runs[name] = fn(argv + extra + obs + [
            "--checkpoint-dir", str(tmp_path / name),
            "--metrics-jsonl", str(tmp_path / f"{name}.jsonl")])
    jres, tres = runs["jax"], runs["port"]
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(tres[key], jres[key], rtol=5e-4,
                                   err_msg=key)
    for key in ("train_acc", "test_acc"):
        assert tres[key] == jres[key], key
    names = ["", "_tel"] if telemetry else [""]
    for suffix in names:
        jrows = _rows(tmp_path / f"jax{suffix}.jsonl")
        trows = _rows(tmp_path / f"port{suffix}.jsonl")
        assert [set(r) - set(port_extra) for r in trows] == [
            set(r) - set(PORT_OMITS) for r in jrows], suffix
        assert [r.get("event") for r in trows] == [r.get("event")
                                                   for r in jrows]
    for name in ("transform.json", "model_meta.json"):
        if not (tmp_path / "jax" / name).is_file():
            assert not (tmp_path / "port" / name).exists(), name
            continue
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text()), name
    return tres


def test_packed_cli_matches_jax_cli(packed, tmp_path, monkeypatch):
    """``--dataset packed`` with the default augmentation (one decode
    thread: the same draws in both packages), the windowed shuffle and
    readahead, telemetry rows every step."""
    argv = _packed(packed) + ["--attention", "xla", "--mlp-impl", "xla",
                              "--dropout", "0", "--epochs", "2",
                              "--shuffle-window", "12", "--readahead", "2"]
    _against_jax(argv, tmp_path, monkeypatch, telemetry=True)
    spec = json.loads((tmp_path / "port" / "transform.json").read_text())
    assert spec["pretrained"] is True and spec["resize_size"] == 40


def test_cifar10_cli_matches_jax_cli(tmp_path, monkeypatch):
    root = make_fake_cifar10(tmp_path / "cifar", per_batch=8)
    argv = ["--dataset", "cifar10", "--data-root", str(root), *MODEL,
            "--seed", "7", "--attention", "xla", "--mlp-impl", "xla",
            "--dropout", "0", "--epochs", "1"]
    res = _against_jax(argv, tmp_path, monkeypatch, num_classes=10)
    assert len(res["train_loss"]) == 1


def test_packed_and_cifar_refusals(packed, tmp_path):
    with pytest.raises(SystemExit, match="exceeds the shards' pack size 40"):
        ttrain.main(_cpu(_packed(packed)) + ["--image-size", "48"])
    with pytest.raises(SystemExit, match="--augment \\(RandomResizedCrop"):
        ttrain.main(_cpu(["--dataset", "cifar10", "--synthetic", *MODEL,
                          "--augment"]))
    with pytest.raises(SystemExit, match="--data-root required"):
        ttrain.main(_cpu(["--dataset", "cifar10", *MODEL]))
    with pytest.raises(SystemExit, match="pack_image_folder outputs"):
        ttrain.main(_cpu(["--dataset", "packed", *MODEL]))
    with pytest.raises(SystemExit, match="--profile-steps expects"):
        ttrain.main(_cpu(_packed(packed)) + ["--profile-steps", "3"])


def test_packed_resume_from_an_async_save_matches_uninterrupted(
        packed, tmp_path):
    """Async saves every 2 steps (the default), everything after the
    mid-epoch step-4 save and the final export deleted, the command rerun:
    the final params equal the uninterrupted run's bit for bit
    (``--no-augment``: a resumed epoch never makes the skipped batches'
    augmentation draws)."""
    ck = tmp_path / "ck"
    argv = _cpu(_packed(packed)) + [
        "--no-augment", "--epochs", "2", "--checkpoint-dir", str(ck),
        "--checkpoint-every-steps", "2", "--keep-checkpoints", "20"]
    ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 4)):
            shutil.rmtree(d)
    assert Checkpointer(ck).latest_step() == 4
    ttrain.main(argv)
    b = load_params_npz(ck / "final" / "params.npz")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_telemetry_profile_and_watchdog_flags_run(packed, tmp_path):
    """--telemetry-jsonl, --profile-steps, --profile-dir, --watchdog-s on
    the CPU: step rows every step, a torch.profiler trace of the window (in
    epoch 2) and of epoch 1, no postmortem, and the run's own results
    unchanged."""
    base = _cpu(_packed(packed)) + ["--epochs", "2", "--dropout", "0",
                                    "--attention", "xla", "--mlp-impl",
                                    "xla"]
    plain = ttrain.main(base)
    run = tmp_path / "run"
    res = ttrain.main(base + [
        "--checkpoint-dir", str(run), "--telemetry-jsonl",
        str(run / "tel.jsonl"), "--telemetry-every", "1", "--watchdog-s",
        "300", "--profile-steps", "4:5", "--profile-dir", str(run / "pd"),
        "--sync-checkpoints"])
    assert res == plain
    rows = _rows(run / "tel.jsonl")
    assert [r["event"] for r in rows] == 2 * (["step"] * 3 + [
        "span", "span", "epoch_summary"])
    assert (run / "pd" / "trace.json").is_file()
    assert list((run / "profiles").glob("capture_000_step4_flag/trace.json"))
    assert not (run / "postmortem.txt").exists()


# --- transfer learning and TinyVGG ------------------------------------------
@pytest.fixture(scope="module")
def pretrained_pth(tmp_path_factory):
    """A seeded torchvision-layout ViT-Ti/16 state dict written for 32 px
    (1000 classes, stock torch.nn layers), as a ``.pth``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_vit", REPO / "tools" / "make_torch_vit.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.manual_seed(0)
    sd = mod.TorchViT(JPRESETS["ViT-Ti/16"](num_classes=1000, image_size=32,
                                            patch_size=16)).state_dict()
    path = tmp_path_factory.mktemp("pretrained") / "vit_ti16_32.pth"
    torch.save(sd, path)
    return path


def test_pretrained_freeze_backbone_cli_matches_jax_cli(
        folder, pretrained_pth, tmp_path, monkeypatch):
    """``--pretrained PTH --freeze-backbone`` at 48 px (the 2x2 position
    grid interpolated to 3x3, the pretrained transform with ImageNet
    normalization) against the JAX CLI: losses rtol 5e-4, the same JSONL
    keys, transform.json and model_meta.json; the final backbone equals the
    converted weights bit for bit and the head moved from zero."""
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.transfer import (
        init_from_pretrained)
    argv = _common(folder) + ["--image-size", "48", "--attention", "xla",
                              "--mlp-impl", "xla", "--dropout", "0",
                              "--epochs", "2", "--lr", "1e-2",
                              "--pretrained", str(pretrained_pth),
                              "--freeze-backbone"]
    _against_jax(argv, tmp_path, monkeypatch)
    spec = json.loads((tmp_path / "port" / "transform.json").read_text())
    assert spec == {"image_size": 48, "pretrained": True, "normalize": True}
    final = load_params_npz(tmp_path / "port" / "final" / "params.npz")
    cfg = PRESETS["ViT-Ti/16"](num_classes=3, image_size=48, patch_size=16,
                               dtype="float32")
    start = init_from_pretrained(cfg, pretrained_pth)
    for k, v in start.items():
        if k.startswith("backbone."):
            assert torch.equal(final[k], v), k
        else:
            assert not torch.equal(final[k], v), k


def test_frozen_run_resume_matches_uninterrupted(folder, pretrained_pth,
                                                 tmp_path):
    """A frozen-backbone run resumed from its mid-epoch step-4 save equals
    the uninterrupted run bit for bit (the optimizer is built with the
    head-only label function before the restore); resuming it without
    --freeze-backbone is refused."""
    ck = tmp_path / "ck"
    argv = _cpu(_common(folder) + ["--epochs", "2"]) + [
        "--pretrained", str(pretrained_pth), "--freeze-backbone",
        "--checkpoint-dir", str(ck), "--checkpoint-every-steps", "2",
        "--keep-checkpoints", "20"]
    ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 4)):
            shutil.rmtree(d)
    with pytest.raises(ValueError, match="same --freeze-backbone"):
        ttrain.main([x for x in argv if x != "--freeze-backbone"])
    ttrain.main(argv)
    b = load_params_npz(ck / "final" / "params.npz")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_tinyvgg_cli_matches_jax_cli(folder, tmp_path, monkeypatch):
    """``--model tinyvgg`` against the JAX CLI from JAX's init: losses
    rtol 5e-4, the same JSONL keys and transform.json, no model_meta.json
    in either."""
    from pytorch_vit_paper_replication_tpu.models import TinyVGG as JTiny
    init = jax.device_get(JTiny(hidden_units=8, num_classes=3).init(
        jax.random.key(7), jnp.zeros((1, 32, 32, 3)))["params"])
    argv = _common(folder) + ["--model", "tinyvgg", "--hidden-units", "8",
                              "--epochs", "2", "--lr", "1e-2"]
    _against_jax(argv, tmp_path, monkeypatch, init=init)
    assert not (tmp_path / "port" / "model_meta.json").exists()


@pytest.mark.parametrize("extra", [["--pretrained", "w.pth"],
                                   ["--freeze-backbone"]])
def test_tinyvgg_refuses_transfer_flags(folder, extra):
    with pytest.raises(SystemExit, match="apply to ViT only"):
        ttrain.main(_cpu(_common(folder)) + ["--model", "tinyvgg"] + extra)


def test_metrics_port_and_ship_to_carry_jax_instrument_names(
        folder, tmp_path, monkeypatch):
    """``--metrics-port 0 --ship-to`` on the port's train CLI and on
    JAX's, one epoch each: ``/metrics`` answers while the run is on, and
    the frames (role ``train``, the last one sent at exit) carry the same
    ``tel_`` / ``shipper_`` instrument names as JAX's frames."""
    import urllib.request

    from pytorch_vit_paper_replication_tpu.telemetry import (
        shipper as jship)
    from pytorch_vit_paper_replication_tpu_torch import (
        telemetry as ttelemetry)
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        shipper as tship)

    with pytest.raises(SystemExit, match="--ship-to: expected HOST:PORT"):
        ttrain.main(_cpu(_common(folder)) + ["--ship-to", "nohost"])
    scraped = []
    real = ttelemetry.start_metrics_http

    def start_and_scrape(*a, **k):
        srv = real(*a, **k)
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            scraped.append(r.read().decode())
        return srv

    monkeypatch.setattr(ttelemetry, "start_metrics_http", start_and_scrape)
    argv = _common(folder) + ["--attention", "xla", "--mlp-impl", "xla",
                              "--epochs", "1"]
    frames = {}
    for name, fn, sink_mod, extra in (
            ("jax", jax_train_main, jship, []),
            ("port", ttrain.main, tship, ["--device", "cpu"])):
        with sink_mod.FrameSink() as sink:
            fn(argv + extra + ["--metrics-port", "0", "--ship-to",
                               f"127.0.0.1:{sink.port}",
                               "--ship-interval-s", "30",
                               "--worker-id", f"{name}-0"])
            frames[name] = list(sink.frames)
    assert len(scraped) == 1 and "# TYPE vit_" in scraped[0]

    def names(frame):
        snap = frame["snapshot"]
        return sorted(k for kind in ("counters", "gauges", "histograms")
                      for k in snap[kind]
                      if k.startswith(("tel_", "shipper_"))
                      and k not in PORT_OMITS)

    assert [f["role"] for f in frames["port"]] == ["train"] * len(
        frames["port"]) and len(frames["port"]) >= 2
    assert frames["port"][-1]["worker_id"] == "port-0"
    assert set(frames["port"][-1]) == set(frames["jax"][-1])
    assert names(frames["port"][-1]) == names(frames["jax"][-1])
    assert frames["port"][-1]["snapshot"]["counters"][
        "tel_steps_total"] >= 3
