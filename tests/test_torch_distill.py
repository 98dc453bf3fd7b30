"""The port's distillation path on the CPU against the JAX package.

The teacher sink is a sealed ``--head logits`` batch-job directory (the
port's ``NpySink`` + manifest with its sha256; both packages read the same
files). Tolerances: the distill CLI run equals JAX's ``train.main`` on the
same sink within rtol 5e-4 in the losses (the CLI tolerance of
``test_torch_cli.py``); ``--distill-alpha 0`` and a mid-epoch resume are
bit for bit; the sink loader's rows and ``pseudo_label_pack``'s
``index.json`` are byte-equal to JAX's.
"""

import hashlib
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu.distill import recipe as jrecipe
from pytorch_vit_paper_replication_tpu.distill.sink import (
    load_distill_sink as jax_load_distill_sink)
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.checkpoint import Checkpointer
from pytorch_vit_paper_replication_tpu_torch.convert import load_params_npz
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder, pack_image_folder)
from pytorch_vit_paper_replication_tpu_torch.distill import (
    load_distill_sink, recipe)
from pytorch_vit_paper_replication_tpu_torch.serve.offline import (
    NpySink, sink_sha256, write_progress)
from pytorch_vit_paper_replication_tpu_torch.telemetry import get_registry
from test_torch_cli import (MODEL, _against_jax, _rows,  # noqa: F401
                            free_tmp_path)

DISTILL = ["--distill-t", "2", "--distill-alpha", "0.7"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_sink(out_dir, rows, *, head="logits", seal=True,
                records_done=None):
    """A batch-job sink directory holding ``rows`` (the JAX package's
    ``tests/test_cascade.py`` fixture, written with the port's sink)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    n, c = rows.shape
    sink = NpySink(out_dir / "outputs.npy", rows=n, dim=c)
    sink.write(0, rows.astype(np.float32))
    sink.close()
    done = n if records_done is None else records_done
    payload = {"fingerprint": "fp-test", "head": head, "total_records": n,
               "out_dim": c, "batch_size": n, "ladder": [n],
               "sink": "outputs.npy", "records_done": done,
               "rows_written": done}
    if seal:
        payload["sink_sha256"] = sink_sha256(out_dir / "outputs.npy")
    write_progress(out_dir, payload)
    return out_dir


def _reseal(out_dir, rows):
    """Replace the sink file by ``rows`` and seal the manifest over it."""
    np.save(out_dir / "outputs.npy", rows)
    m = json.loads((out_dir / "progress.json").read_text())
    m["sink_sha256"] = sink_sha256(out_dir / "outputs.npy")
    write_progress(out_dir, {k: v for k, v in m.items() if k != "version"})


ROWS = np.random.default_rng(3).normal(size=(16, 3)).astype(np.float32)


def _torn(d):
    m = np.lib.format.open_memmap(d / "outputs.npy", mode="r+")
    m[3, 1] += 1.0
    m.flush()
    del m


# (case, how the sink dir is made, n_records, n_classes, message)
REFUSALS = {
    "wrong_pack": (lambda d: _write_sink(d, ROWS), 17, 3, "wrong pack"),
    "label_space": (lambda d: _write_sink(d, ROWS), 16, 4, "label space"),
    "probs_head": (lambda d: _write_sink(d, ROWS, head="probs"), 16, 3,
                   "--head logits"),
    "incomplete": (lambda d: _write_sink(d, ROWS, records_done=8,
                                         seal=False), 16, 3, "incomplete"),
    "unsealed": (lambda d: _write_sink(d, ROWS, seal=False), 16, 3,
                 "sink_sha256"),
    "torn": (lambda d: _torn(_write_sink(d, ROWS)), 16, 3,
             "sha256 mismatch"),
    "no_manifest": (lambda d: d.mkdir(), 16, 3, "progress.json"),
    "missing_file": (lambda d: (_write_sink(d, ROWS) / "outputs.npy"
                                ).unlink(), 16, 3, "is missing"),
    "wrong_shape": (lambda d: _reseal(_write_sink(d, ROWS),
                                      ROWS.reshape(8, 6)), 16, 3,
                    "sink shape"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_load_distill_sink_refuses_what_jax_refuses(tmp_path, case):
    make, n_records, n_classes, msg = REFUSALS[case]
    make(tmp_path / case)
    for fn in (jax_load_distill_sink, load_distill_sink):
        with pytest.raises(SystemExit, match=msg.replace("-", "\\-")):
            fn(tmp_path / case, n_records=n_records, n_classes=n_classes)


def test_load_distill_sink_happy_path_equals_jax(tmp_path):
    good = _write_sink(tmp_path / "good", ROWS)
    rows, manifest = load_distill_sink(good, n_records=16, n_classes=3)
    jrows, jmanifest = jax_load_distill_sink(good, n_records=16,
                                             n_classes=3)
    assert isinstance(rows, np.memmap) and not rows.flags.writeable
    np.testing.assert_array_equal(np.asarray(rows), ROWS)
    np.testing.assert_array_equal(np.asarray(rows), np.asarray(jrows))
    assert manifest == jmanifest and manifest["head"] == "logits"


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A 32 px synthetic folder packed at 40 px (24 train records in a
    seeded order, 5 a shard) and a sealed teacher sink over its train
    split: ``(train, test, sink)``."""
    root = tmp_path_factory.mktemp("torch_distill")
    train, test = make_synthetic_image_folder(
        root / "ds", train_per_class=8, test_per_class=2, image_size=32)
    ptrain = pack_image_folder(train, root / "train", pack_size=40,
                               images_per_shard=5, shuffle_seed=0)
    ptest = pack_image_folder(test, root / "test", pack_size=40)
    n = len(json.loads((ptrain / "index.json").read_text())["labels"])
    logits = 3.0 * np.random.default_rng(11).standard_normal((n, 3))
    return ptrain, ptest, _write_sink(root / "sink", logits)


def _argv(pack, *extra):
    return ["--dataset", "packed", "--train-dir", str(pack[0]),
            "--test-dir", str(pack[1]), *MODEL, "--seed", "7",
            "--no-augment", *extra]


def test_pseudo_label_pack_index_byte_equal_to_jax(pack, tmp_path):
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        shutil.copytree(pack[0], dirs[name])
    assert jrecipe.pseudo_label_pack(dirs["jax"], pack[2]) is True
    assert recipe.pseudo_label_pack(dirs["port"], pack[2]) is True
    got = (dirs["port"] / "index.json").read_bytes()
    assert got == (dirs["jax"] / "index.json").read_bytes()
    labels = json.loads(got)["labels"]
    assert labels == np.load(pack[2] / "outputs.npy").argmax(1).tolist()
    # Idempotent; a features sink and a sink of another length refused.
    assert recipe.pseudo_label_pack(dirs["port"], pack[2]) is False
    shutil.copytree(pack[0], tmp_path / "again")
    feats = _write_sink(tmp_path / "feats", ROWS, head="features")
    other = _write_sink(tmp_path / "other", ROWS)
    for sink, msg in ((feats, "head is 'features'"),
                      (other, "dump the teacher over THIS pack")):
        for fn in (jrecipe.pseudo_label_pack, recipe.pseudo_label_pack):
            with pytest.raises(SystemExit, match=msg):
                fn(tmp_path / "again", sink)


def test_student_train_argv_is_jax_argv_on_the_port_cli():
    args = ("pack", "sink", "student")
    kw = dict(preset="ViT-Ti/16", image_size=224, epochs=2, t=2.0,
              alpha=0.7, python="python3")
    mine = recipe.student_train_argv(*args, **kw)
    theirs = jrecipe.student_train_argv(*args, **kw)
    assert mine[2] == "pytorch_vit_paper_replication_tpu_torch.train"
    assert mine[:2] + mine[3:] == theirs[:2] + theirs[3:]
    assert ttrain.build_parser().parse_args(mine[3:]).distill_alpha == 0.7
    assert recipe.student_train_argv(*args)[0] == sys.executable


def test_distill_cli_matches_jax_cli(pack, tmp_path, monkeypatch):
    """``--distill-from`` through both CLIs on the same sealed sink (the
    port's init patched to JAX's): losses rtol 5e-4, accuracies equal;
    the port's metrics rows carry ``teacher_agree`` (JAX prints it in the
    epoch line only) and the ``distill_*`` gauges are on the registry."""
    get_registry().reset()
    argv = _argv(pack, "--attention", "xla", "--mlp-impl", "xla",
                 "--dropout", "0", "--epochs", "2", "--distill-from",
                 str(pack[2]), *DISTILL)
    _against_jax(argv, tmp_path, monkeypatch, port_extra={"teacher_agree"})
    rows = _rows(tmp_path / "port.jsonl")
    assert all(0.0 <= r["teacher_agree"] <= 1.0 for r in rows)
    gauges = get_registry().snapshot()["gauges"]
    assert gauges["distill_alpha"] == 0.7 and gauges["distill_t"] == 2.0
    assert gauges["distill_teacher_agree_frac"] == pytest.approx(
        rows[-1]["teacher_agree"], abs=1e-6)
    assert gauges["distill_loss"] == pytest.approx(rows[-1]["train_loss"],
                                                   abs=1e-6)
    meta = json.loads((tmp_path / "port" / "run_meta.json").read_text())
    assert (meta["distill_alpha"], meta["distill_t"]) == (0.7, 2.0)


def _sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_distill_alpha_zero_equals_ordinary_run_bit_for_bit(pack, tmp_path):
    base = _argv(pack, "--epochs", "2", "--device", "cpu")
    plain = ttrain.main(base + ["--checkpoint-dir", str(tmp_path / "a")])
    kd = ttrain.main(base + ["--checkpoint-dir", str(tmp_path / "b"),
                             "--distill-from", str(pack[2]),
                             "--distill-alpha", "0"])
    assert kd == plain
    assert _sha(tmp_path / "a" / "final" / "params.npz") == \
        _sha(tmp_path / "b" / "final" / "params.npz")


def test_distill_mid_epoch_resume_matches_uninterrupted(pack, tmp_path):
    """The teacher rows follow the records through a mid-epoch resume: the
    step-4 save (1 of epoch 2's 3 batches trained) resumed gives the
    uninterrupted run's params bit for bit (default dropout on)."""
    ck = tmp_path / "ck"
    argv = _argv(pack, "--epochs", "2", "--device", "cpu",
                 "--distill-from", str(pack[2]), *DISTILL,
                 "--checkpoint-dir", str(ck), "--checkpoint-every-steps",
                 "2", "--keep-checkpoints", "20")
    ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 4)):
            shutil.rmtree(d)
    assert Checkpointer(ck).latest_step() == 4
    ttrain.main(argv)
    b = load_params_npz(ck / "final" / "params.npz")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_distill_refusals_in_the_cli(pack, tmp_path):
    base = _argv(pack, "--device", "cpu", "--epochs", "1")
    with pytest.raises(SystemExit, match="--eval-only"):
        ttrain.main(base + ["--distill-from", str(pack[2]), "--eval-only",
                            "--checkpoint-dir", str(tmp_path / "e")])
    feats = _write_sink(tmp_path / "feats", ROWS, head="features")
    with pytest.raises(SystemExit, match="--head logits"):
        ttrain.main(base + ["--distill-from", str(feats)])
    with pytest.raises(SystemExit, match="wrong pack"):
        ttrain.main(base + ["--distill-from", str(_write_sink(
            tmp_path / "short", ROWS))])
