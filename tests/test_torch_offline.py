"""The port's offline batch inference (``serve/offline.py``,
``tools/batch_infer.py``) against the JAX package's.

A 15-record pack of the synthetic image folder at 40 px (the port's
``data.pack``, byte-equal to JAX's), read through each package's array
eval transform at 32 px, ladder (1, 4, 8), batch 8: the last loader batch
of 7 runs padded. The same tiny ViT weights (JAX's init, converted), f32,
one device each (JAX's engine given one of the test mesh's CPU devices).

* ``shard_ladder`` equals JAX's for 1-8 devices;
* ``progress.json`` equals JAX's byte for byte but for the completed sink's
  sha256; ``outputs.npy`` has JAX's header bytes and rows within 1e-6
  (probs) / 1e-5 (features, logits) — the two frameworks round the same
  f32 sums in other orders, so the row bytes, and the sha256, differ;
  ``preds.jsonl`` has JAX's indices and labels, probs within 1e-6;
* on the port alone: ``probs`` rows equal ``predict_batch``'s bit for bit
  (same rungs), ``softmax(logits) == probs`` bit for bit, and a SIGKILLed
  and resumed ``tools.batch_infer`` leaves a sink whose sha256 equals an
  unkilled run's.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.data.imagenet import (
    PackedShardDataset as JPacked)
from pytorch_vit_paper_replication_tpu.data.imagenet import (
    eval_center_transform as j_eval_center)
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.serve import offline as joffline
from pytorch_vit_paper_replication_tpu_torch.configs import ViTConfig
from pytorch_vit_paper_replication_tpu_torch.convert import params_from_flax
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder, pack_image_folder)
from pytorch_vit_paper_replication_tpu_torch.data.imagenet import (
    PackedShardDataset, eval_center_transform)
from pytorch_vit_paper_replication_tpu_torch.models import ViT
from pytorch_vit_paper_replication_tpu_torch.predictions import (
    predict_batch, save_inference_export)
from pytorch_vit_paper_replication_tpu_torch.serve import offline
from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
    PROGRESS_MANIFEST, NpySink, OfflineEngine, PredsJsonl, load_progress,
    shard_ladder, sink_sha256, validate_progress, write_progress)
from pytorch_vit_paper_replication_tpu_torch.tools import batch_infer

REPO = Path(__file__).resolve().parent.parent
TINY = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
            embedding_dim=32, mlp_size=64, num_classes=3, dtype="float32",
            attention_impl="xla", mlp_impl="xla")
LADDER = (1, 4, 8)
CLASSES = ["pizza", "steak", "sushi"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("offline")
    train, _ = make_synthetic_image_folder(root / "ds", train_per_class=5,
                                           test_per_class=1, image_size=40)
    return pack_image_folder(train, root / "pack", pack_size=40,
                             images_per_shard=6, shuffle_seed=0)


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's model on the same weights)."""
    jm = JViT(JCfg(**TINY))
    params = jax.device_get(jm.init(jax.random.key(0), jnp.zeros(
        (1, 32, 32, 3)))["params"])
    model = ViT(ViTConfig(**TINY))
    model.load_state_dict(params_from_flax(params))
    return jm, params, model.eval()


def _dataset(pack):
    return PackedShardDataset(pack, eval_center_transform(32,
                                                          normalize=False),
                              startup_readahead=False)


@pytest.mark.parametrize("ndev", range(1, 9))
def test_shard_ladder_equals_jax(ndev):
    for ladder in [(1, 8, 32, 128, 256), (1, 4, 8), (3,), (5, 7, 9, 100)]:
        assert shard_ladder(ladder, ndev) == joffline.shard_ladder(ladder,
                                                                  ndev)
    for bad in ((), (0,), (-2,)):
        with pytest.raises(ValueError):
            shard_ladder(bad, ndev)


def test_progress_manifest_contracts(tmp_path):
    base = {"fingerprint": "fp", "head": "probs", "total_records": 13,
            "out_dim": 3, "batch_size": 8, "ladder": [8],
            "sink": "outputs.npy", "records_done": 8, "rows_written": 8,
            "preds_bytes": None}
    write_progress(tmp_path, base)
    (tmp_path / "j").mkdir()
    joffline.write_progress(tmp_path / "j", base)
    assert (tmp_path / PROGRESS_MANIFEST).read_bytes() == \
        (tmp_path / "j" / PROGRESS_MANIFEST).read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j",
                                                          PROGRESS_MANIFEST]
    manifest = load_progress(tmp_path)
    want = dict(fingerprint="fp", head="probs", total_records=13, out_dim=3,
                batch_size=8, ladder=[8])
    assert validate_progress(manifest, **want) == 8
    for kw in ({"fingerprint": "other"}, {"head": "features"},
               {"total_records": 14}, {"out_dim": 4}, {"batch_size": 4},
               {"ladder": [4, 8]}):
        with pytest.raises(ValueError, match="mismatch"):
            validate_progress(manifest, **{**want, **kw})
    with pytest.raises(ValueError, match="row_shape mismatch"):
        validate_progress(manifest, **want, row_shape=(4, 3))
    with pytest.raises(ValueError, match="outside"):
        validate_progress({**manifest, "records_done": 99}, **want)
    (tmp_path / PROGRESS_MANIFEST).write_text("{not json")
    with pytest.raises(ValueError, match="delete"):
        load_progress(tmp_path)
    (tmp_path / PROGRESS_MANIFEST).write_text("[1]")
    with pytest.raises(ValueError, match="JSON object"):
        load_progress(tmp_path)
    assert load_progress(tmp_path / "nowhere") is None


def test_sinks_refuse_mismatched_resume(tmp_path):
    sink = NpySink(tmp_path / "o.npy", rows=4, dim=3)
    sink.write(0, np.ones((2, 3), np.float32))
    sink.close()
    with pytest.raises(ValueError, match="delete"):
        NpySink(tmp_path / "o.npy", rows=4, dim=5, resume=True)
    again = NpySink(tmp_path / "o.npy", rows=4, dim=3, resume=True)
    again.close()
    np.testing.assert_array_equal(np.load(tmp_path / "o.npy")[:2],
                                  np.ones((2, 3), np.float32))
    with pytest.raises(ValueError, match="missing"):
        PredsJsonl(tmp_path / "p.jsonl", resume_bytes=500)
    p = PredsJsonl(tmp_path / "p.jsonl", class_names=CLASSES, resume_bytes=0)
    p.write(5, np.asarray([[0.2, 0.7, 0.1]], np.float32))
    assert p.flush() > 0
    p.close()
    assert json.loads((tmp_path / "p.jsonl").read_text()) == {
        "index": 5, "label": "steak", "prob": 0.7}


@pytest.mark.parametrize("head", ["probs", "features", "logits"])
def test_manifest_and_sink_match_jax(models, pack, tmp_path, head):
    jm, params, model = models
    jeng = joffline.OfflineEngine(jm, params, head=head, image_size=32,
                                  buckets=LADDER, class_names=CLASSES,
                                  devices=jax.devices()[:1])
    jds = JPacked(pack, j_eval_center(32, normalize=False),
                  startup_readahead=False)
    kw = dict(batch_size=8, checkpoint_every_records=8, preds_jsonl=True)
    jsum = jeng.run(jds, tmp_path / "jax", log_every_s=0, **kw)
    eng = OfflineEngine(model, head=head, image_size=32, buckets=LADDER,
                        class_names=CLASSES, devices=["cpu"])
    tsum = eng.run(_dataset(pack), tmp_path / "port", **kw)
    for key in ("records", "processed", "checkpoints", "devices", "ladder",
                "batch_size", "head", "out_dim"):
        assert tsum[key] == jsum[key], key

    def manifest(name):
        text = (tmp_path / name / PROGRESS_MANIFEST).read_text()
        return re.sub(r'"sink_sha256": "[0-9a-f]{64}"', '"sink_sha256": ""',
                      text)
    assert manifest("port") == manifest("jax")
    want = (tmp_path / "jax" / "outputs.npy").read_bytes()
    got = (tmp_path / "port" / "outputs.npy").read_bytes()
    assert len(got) == len(want) and got[:128] == want[:128]
    tol = 1e-6 if head == "probs" else 1e-5
    np.testing.assert_allclose(np.load(tmp_path / "port" / "outputs.npy"),
                               np.load(tmp_path / "jax" / "outputs.npy"),
                               rtol=tol, atol=tol)
    assert load_progress(tmp_path / "port")["sink_sha256"] == sink_sha256(
        tmp_path / "port" / "outputs.npy")
    if head == "probs":
        jrows = [json.loads(x) for x in
                 (tmp_path / "jax" / "preds.jsonl").read_text().splitlines()]
        trows = [json.loads(x) for x in
                 (tmp_path / "port" / "preds.jsonl").read_text().splitlines()]
        assert [(r["index"], r["label"]) for r in trows] == \
            [(r["index"], r["label"]) for r in jrows]
        np.testing.assert_allclose([r["prob"] for r in trows],
                                   [r["prob"] for r in jrows], atol=1.1e-6)
    else:
        assert not (tmp_path / "port" / "preds.jsonl").exists()


def test_probs_equal_predict_batch_and_softmax_of_logits(models, pack,
                                                         tmp_path):
    """The ``probs`` sink rows, run through the same rungs, equal
    ``predict_batch``'s labels and probabilities and ``forward_probs`` of
    the same padded chunks bit for bit; ``softmax(logits sink)`` equals the
    ``probs`` sink bit for bit; the features head is the pooled backbone
    output."""
    from pytorch_vit_paper_replication_tpu_torch.predictions import (
        forward_probs)
    from pytorch_vit_paper_replication_tpu_torch.serve.bucketing import (
        pad_rows_to_bucket, plan_buckets)
    _, _, model = models
    ds = _dataset(pack)
    sinks = {}
    for head in ("probs", "logits", "features"):
        eng = OfflineEngine(model, head=head, image_size=32, buckets=LADDER,
                            devices=["cpu"])
        eng.run(ds, tmp_path / head, batch_size=8)
        sinks[head] = np.load(tmp_path / head / "outputs.npy")
    rows = np.stack([ds[i][0] for i in range(len(ds))])
    for (label, prob), row in zip(
            predict_batch(model, list(rows), CLASSES, buckets=LADDER),
            sinks["probs"]):
        assert label == CLASSES[int(row.argmax())]
        assert prob == float(row.max())
    # The loader batches (8 + 7) through the same rung plan.
    want, pos = [], 0
    for n in (8, 7):
        for bucket in plan_buckets(n, LADDER):
            take = min(bucket, len(rows) - pos)
            padded, _ = pad_rows_to_bucket(rows[pos:pos + take], bucket)
            with torch.inference_mode():
                want.append(forward_probs(model, torch.from_numpy(
                    padded)).numpy()[:take])
            pos += take
    assert np.array_equal(np.concatenate(want), sinks["probs"])
    soft = torch.softmax(torch.from_numpy(sinks["logits"]), dim=-1).numpy()
    assert np.array_equal(soft, sinks["probs"])
    with torch.inference_mode():
        tokens = model.backbone(torch.from_numpy(rows[:8]))
    np.testing.assert_allclose(sinks["features"][:8], tokens[:, 0].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_two_replicas_split_rows_in_device_order(models, pack, tmp_path):
    """Two replicas: the ladder rounds to even rungs, each chunk's halves
    go to the replicas in order, and the rows equal one replica's."""
    _, _, model = models
    one = OfflineEngine(model, head="logits", image_size=32, buckets=LADDER,
                        devices=["cpu"])
    two = OfflineEngine(model, head="logits", image_size=32, buckets=LADDER,
                        devices=["cpu", "cpu"])
    assert two.ladder == (2, 4, 8)
    a = one.run(_dataset(pack), tmp_path / "one", batch_size=8)
    b = two.run(_dataset(pack), tmp_path / "two", batch_size=8)
    assert (a["devices"], b["devices"]) == (1, 2)
    np.testing.assert_allclose(np.load(tmp_path / "two" / "outputs.npy"),
                               np.load(tmp_path / "one" / "outputs.npy"),
                               rtol=1e-6, atol=1e-6)


def test_resume_and_refusals_in_process(models, pack, tmp_path):
    """The bi_* instruments on the process registry; a run whose manifest
    was rolled back to its first checkpoint and whose tail rows were
    scribbled over resumes there and finishes with the unkilled run's
    bytes; a finished job returns at once; another
    job's output dir is refused; unknown heads are refused."""
    from pytorch_vit_paper_replication_tpu_torch.telemetry import (
        get_registry)
    _, _, model = models
    eng = OfflineEngine(model, head="probs", image_size=32, buckets=LADDER,
                        devices=["cpu"])
    kw = dict(batch_size=8, checkpoint_every_records=8, preds_jsonl=True)
    get_registry().reset()
    eng.run(_dataset(pack), tmp_path / "clean", **kw)
    snap = get_registry().snapshot()
    assert snap["counters"]["bi_records_total"] == 15
    assert snap["counters"]["bi_batches_total"] == 2
    assert snap["counters"]["bi_checkpoints_total"] == 2
    assert snap["gauges"]["bi_devices"] == 1
    assert snap["gauges"]["bi_progress_pct"] == 100.0
    out = tmp_path / "resumed"
    eng.run(_dataset(pack), out, **kw)
    man = load_progress(out)
    sink = np.lib.format.open_memmap(out / "outputs.npy", mode="r+")
    sink[8:] = 7.0
    sink.flush()
    del sink
    write_progress(out, {k: v for k, v in man.items()
                         if k not in ("version", "sink_sha256")}
                   | {"records_done": 8, "rows_written": 8,
                      "preds_bytes": len(b"".join(
                          (out / "preds.jsonl").read_bytes()
                          .splitlines(keepends=True)[:8]))})
    summary = eng.run(_dataset(pack), out, **kw)
    assert summary["resumed_from"] == 8 and summary["processed"] == 7
    for name in ("outputs.npy", "preds.jsonl", PROGRESS_MANIFEST):
        assert (out / name).read_bytes() == \
            (tmp_path / "clean" / name).read_bytes(), name
    assert eng.run(_dataset(pack), out, **kw)["already_complete"]
    other = OfflineEngine(model, head="logits", image_size=32,
                          buckets=LADDER, devices=["cpu"])
    with pytest.raises(ValueError, match="head mismatch"):
        other.run(_dataset(pack), out, **kw)
    with pytest.raises(ValueError, match="unknown head"):
        OfflineEngine(model, head="tokens", devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            OfflineEngine(model, image_size=32)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A ViT-Ti/16 export at 32 px (seeded weights) and a 96-record pack."""
    from pytorch_vit_paper_replication_tpu_torch.configs import PRESETS
    from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
    root = tmp_path_factory.mktemp("bi_job")
    cfg = PRESETS["ViT-Ti/16"](num_classes=3, image_size=32)
    model = ViT(cfg)
    model.load_state_dict(seeded_params(cfg, 0))
    export = save_inference_export(root / "export", model,
                                   transform_spec={"normalize": False})
    train, _ = make_synthetic_image_folder(root / "ds", train_per_class=32,
                                           test_per_class=1, image_size=32)
    pack = pack_image_folder(train, root / "pack", pack_size=32,
                             images_per_shard=40)
    (root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    return export, pack, root / "classes.txt"


# ``tools.batch_infer.main`` on ``argv[2:]`` with every chunk's dispatch
# delayed ``argv[1]`` seconds, so a kill lands mid-sweep.
PACED_BATCH_INFER = """
import sys, time
from pytorch_vit_paper_replication_tpu_torch.serve.offline import OfflineEngine
from pytorch_vit_paper_replication_tpu_torch.tools import batch_infer
pause, dispatch = float(sys.argv[1]), OfflineEngine.dispatch
def paced(self, x):
    time.sleep(pause)
    return dispatch(self, x)
OfflineEngine.dispatch = paced
batch_infer.main(sys.argv[2:])
"""


def _args(job, out):
    export, pack, classes = job
    return [str(pack), "--checkpoint", str(export), "--classes-file",
            str(classes), "--preset", "ViT-Ti/16", "--out", str(out),
            "--batch-size", "16", "--buckets", "1", "8", "16",
            "--checkpoint-every-records", "16", "--checkpoint-every-s",
            "0.01", "--device", "cpu", "--preds-jsonl"]


def _cmd(job, out):
    return [sys.executable, "-m",
            "pytorch_vit_paper_replication_tpu_torch.tools.batch_infer",
            *_args(job, out)]


def test_kill_resume_subprocess_byte_identical(job, tmp_path):
    """``tools.batch_infer``, its dispatch paced by ``PACED_BATCH_INFER``,
    SIGKILLed once its manifest records at least 32 records, then the same command rerun: it resumes
    at the manifest's offset and its sink (and predictions mirror) equal
    an unkilled run's byte for byte."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    clean = tmp_path / "clean"
    subprocess.run(_cmd(job, clean), env=env, check=True,
                   capture_output=True, timeout=300, cwd=REPO)
    killed = tmp_path / "killed"
    victim = subprocess.Popen([sys.executable, "-c", PACED_BATCH_INFER,
                               "0.3", *_args(job, killed)], env=env, cwd=REPO,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    killed_at = None
    deadline = time.monotonic() + 240
    try:
        while time.monotonic() < deadline and killed_at is None:
            assert victim.poll() is None, "victim finished before the kill"
            try:
                done = json.loads((killed / PROGRESS_MANIFEST).read_text())[
                    "records_done"]
            except (OSError, json.JSONDecodeError, KeyError):
                done = 0
            if done >= 32:
                killed_at = done
            else:
                time.sleep(0.02)
        assert killed_at is not None, "no progress to kill at"
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(timeout=30)
    assert killed_at < 96
    resumed = subprocess.run(_cmd(job, killed), env=env, check=True,
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO)
    summary = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert summary["resumed_from"] >= killed_at and summary["records"] == 96
    assert sink_sha256(killed / "outputs.npy") == \
        sink_sha256(clean / "outputs.npy")
    assert (killed / "preds.jsonl").read_bytes() == \
        (clean / "preds.jsonl").read_bytes()


def test_batch_infer_cli_heads_summary_and_refusals(job, tmp_path, capsys):
    """The CLI in-process on the CPU: each head's sink shape and
    summary.json, --sha256 equals the manifest's seal; refused flags;
    --ship-to's frames."""
    export, pack, classes = job
    base = [str(pack), "--checkpoint", str(export), "--classes-file",
            str(classes), "--preset", "ViT-Ti/16", "--device", "cpu",
            "--buckets", "1", "8", "16"]
    shapes = {"probs": (96, 3), "logits": (96, 3), "features": (96, 192)}
    for head, shape in shapes.items():
        out = tmp_path / head
        s = batch_infer.main(base + ["--out", str(out), "--head", head,
                                     "--sha256"])
        assert np.load(out / "outputs.npy").shape == shape
        assert s["sink_sha256"] == load_progress(out)["sink_sha256"]
        assert json.loads((out / "summary.json").read_text())["head"] == head
        assert s["device"] == ["cpu"] and s["images_per_sec"] > 0
    assert batch_infer.main(base + ["--out", str(tmp_path / "probs"),
                                    "--head", "probs"])["already_complete"]
    fresh = batch_infer.main(base + ["--out", str(tmp_path / "probs"),
                                     "--fresh", "--limit", "20"])
    assert fresh["records"] == 20 and fresh["resumed_from"] == 0
    for extra, msg in ((["--compile-cache-dir", "cc"], "not yet ported"),
                       (["--ship-to", "nohost"], "--ship-to: expected")):
        with pytest.raises(SystemExit, match=msg):
            batch_infer.main(base + ["--out", str(tmp_path / "x")] + extra)
    # --ship-to: bi_* frames of role batch_infer, the last at exit.
    from pytorch_vit_paper_replication_tpu_torch.telemetry.shipper import (
        FrameSink)
    with FrameSink() as sink:
        batch_infer.main(base + ["--out", str(tmp_path / "shipped"),
                                 "--limit", "16", "--ship-to",
                                 f"127.0.0.1:{sink.port}",
                                 "--worker-id", "bi-0"])
        frames = list(sink.frames)
    assert frames and {f["role"] for f in frames} == {"batch_infer"}
    assert frames[-1]["worker_id"] == "bi-0"
    assert frames[-1]["snapshot"]["counters"]["bi_records_total"] >= 16
    with pytest.raises(SystemExit, match="--classes-file or --num-classes"):
        batch_infer.main([str(pack), "--checkpoint", str(export), "--out",
                          str(tmp_path / "y"), "--device", "cpu"])
    assert offline.OFFLINE_HEADS == joffline.OFFLINE_HEADS
