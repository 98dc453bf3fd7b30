"""The port's train CLI on a mesh: resume, --eval-only, the NaN guard, a
failing and a stalled rank (the JAX CLI comparisons are in
test_torch_train_mesh.py).

Runs are Ti/16 at 32 px, f32, on dp 2 x pp 2 (four gloo rank processes),
the synthetic folder of that file, default dropout. A mesh resume and
``--eval-only`` are held to the uninterrupted run bit for bit; the one-card
CLI reads the mesh run's checkpoint and ``final/`` export (the one-card
format). The NaN guard is JAX's ``tests/test_pipeline.py::
test_pipeline_composes_with_nan_guard`` on the same mesh, with the
pipeline test's bounds for the step after it (rtol 1e-5, atol 1e-6, the
qkv bias 5e-3).
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from pytorch_vit_paper_replication_tpu import engine as jengine
from pytorch_vit_paper_replication_tpu import parallel as jparallel
from pytorch_vit_paper_replication_tpu.configs import MeshConfig as JMeshCfg
from pytorch_vit_paper_replication_tpu.configs import TrainConfig as JTrain
from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.optim import make_optimizer as jopt
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.checkpoint import Checkpointer
from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, load_params_npz, params_from_flax)
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder)
from pytorch_vit_paper_replication_tpu_torch.parallel import spawn

from test_torch_cli import REPO, _rows, free_tmp_path  # noqa: F401
from test_torch_parallel import (MICRO, PIPE, SPAWN_TIMEOUT_S,
                                 _assert_params_close, _pipe_batch,
                                 _pipe_params)

MESH = ["--mesh-data", "2", "--mesh-pipe", "2"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_synthetic_image_folder(
        tmp_path_factory.mktemp("torch_mesh_runs") / "ds", train_per_class=8,
        test_per_class=2, image_size=32)


def _argv(folder, *extra):
    return ["--train-dir", str(folder[0]), "--test-dir", str(folder[1]),
            "--preset", "ViT-Ti/16", "--image-size", "32", "--patch-size",
            "16", "--dtype", "float32", "--batch-size", "8",
            "--num-workers", "1", "--seed", "7", "--device", "cpu", *extra]


def test_mid_group_resume_matches_uninterrupted(folder, tmp_path):
    """--grad-accum 2 with a checkpoint every micro-step: everything after
    step 5 (epoch 2's second batch, the first micro-step of a group) and
    final/ deleted, the command rerun. The resumed run continues the
    accumulation group and ends with the uninterrupted run's params and
    last eval bit for bit. The checkpoint is the one-card format."""
    ck = tmp_path / "ck"
    argv = _argv(folder, *MESH, "--epochs", "2", "--grad-accum", "2",
                 "--checkpoint-dir", str(ck), "--checkpoint-every-steps",
                 "1", "--keep-checkpoints", "20")
    first = ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    payload = Checkpointer(ck).load_payload(5)
    assert payload["opt_state"]["mini_step"] == 1
    assert set(payload["opt_state"]["acc"]) == set(payload["params"]) == \
        set(a)
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 5)):
            shutil.rmtree(d)
    assert Checkpointer(ck).latest_step() == 5
    again = ttrain.main(argv)
    assert Checkpointer(ck).latest_step() == 6
    b = load_params_npz(ck / "final" / "params.npz")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert again["test_loss"] == first["test_loss"][-1:]
    assert again["test_acc"] == first["test_acc"][-1:]


def test_eval_only_on_the_mesh_matches_final_metrics(folder, tmp_path):
    """--eval-only on the mesh, from the latest checkpoint and from the
    final/ export, equals the run's last eval bit for bit; the one-card
    CLI scores the same export (its own summation order: rtol 1e-5)."""
    ck = tmp_path / "ck"
    res = ttrain.main(_argv(folder, *MESH, "--epochs", "1",
                            "--checkpoint-dir", str(ck), "--metrics-jsonl",
                            str(ck / "m.jsonl")))
    last = _rows(ck / "m.jsonl")[-1]
    ev_argv = ["--test-dir", str(folder[1])] + _argv(folder)[4:] + [
        "--eval-only", "--checkpoint-dir", str(ck)]
    ev = ttrain.main(ev_argv + MESH)
    assert ev["test_loss"][0] == res["test_loss"][-1] == last["test_loss"]
    assert ev["test_acc"][0] == res["test_acc"][-1] == last["test_acc"]
    one_card = ttrain.main(ev_argv)
    np.testing.assert_allclose(one_card["test_loss"], ev["test_loss"],
                               rtol=1e-5)
    for d in ck.iterdir():
        if d.is_dir() and d.name.isdigit():
            shutil.rmtree(d)
    ev2 = ttrain.main(ev_argv + MESH)
    assert ev2["test_loss"] == ev["test_loss"]
    assert ev2["test_acc"] == ev["test_acc"]
    np.testing.assert_allclose(ttrain.main(ev_argv)["test_loss"],
                               ev["test_loss"], rtol=1e-5)


def test_nan_guard_skips_a_poisoned_batch_on_every_rank():
    """A NaN in one image of data shard 0 (dp 2 x pp 2): every rank skips
    the step (skipped = 1, zeroed sums, params unchanged), as JAX's
    pipeline does; the clean step after it applies on every rank and
    equals JAX's within the pipeline test's bounds."""
    params = _pipe_params()
    bad = _pipe_batch(0)
    bad["image"] = bad["image"].copy()
    bad["image"][0, 0, 0, 0] = np.nan
    good = _pipe_batch(4)
    cfg = JCfg(**PIPE)
    mesh = jparallel.make_mesh(JMeshCfg(data=2, pipe=2),
                               devices=jax.devices()[:4])
    train = dict(warmup_fraction=0.0)
    st = jparallel.shard_train_state(jengine.TrainState.create(
        apply_fn=jparallel.make_pipeline_apply(cfg, mesh,
                                               num_microbatches=MICRO),
        params=jparallel.stack_block_params(params, cfg.num_layers),
        tx=jopt(JTrain(**train), 5,
                decay_mask_fn=jparallel.pipeline_decay_mask),
        rng=jax.random.key(2)), mesh)
    step = jparallel.make_parallel_train_step(st, mesh, nan_guard=True)
    jskipped = []
    for b in (bad, good):
        st, m = step(st, jparallel.shard_batch(jax.tree.map(jnp.asarray, b),
                                               mesh))
        jskipped.append(float(m["skipped"]))
    assert jskipped == [1.0, 0.0]
    want = params_from_flax(jparallel.unstack_block_params(
        jax.device_get(st.params)))
    ranks = spawn(worker.pipeline_steps, MeshConfig(data=2, pipe=2),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=(PIPE, flatten_tree(params), [bad, good], 5, train,
                        MICRO, 2, 1, True))
    for r in ranks:
        skipped, clean = r["metrics"]
        assert skipped["skipped"] == 1.0 and clean["skipped"] == 0.0
        assert skipped["loss_sum"] == skipped["count"] == 0.0
        assert np.isfinite(clean["loss_sum"]) and clean["count"] == 8.0
    start = {k: v.numpy() for k, v in params_from_flax(params).items()}
    after_bad, after_good = ranks[0]["params"]
    for k, v in start.items():
        np.testing.assert_array_equal(after_bad[k], v, err_msg=k)
    _assert_params_close(after_good, {k: v.numpy() for k, v in want.items()})


FAILING = '''\
import sys

from pytorch_vit_paper_replication_tpu_torch import train

real = train.run


def failing(args, mesh=None, init=None):
    if mesh is not None and mesh.rank == 1:
        raise RuntimeError("deliberate failure on rank 1")
    return real(args, mesh=mesh, init=init)


# Module level: the spawned ranks import this script as their main module.
train.run = failing

if __name__ == "__main__":
    train.main(sys.argv[1:])
'''


def test_a_failing_rank_fails_the_cli_with_its_traceback(folder, tmp_path):
    """The train CLI (a script that makes rank 1 raise) exits non-zero and
    prints rank 1's traceback; the other ranks are ended, not left
    waiting in a collective."""
    script = tmp_path / "failing_rank.py"
    script.write_text(FAILING)
    proc = subprocess.run(
        [sys.executable, str(script), *_argv(folder, *MESH, "--epochs", "1")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert "rank 1 failed" in proc.stderr
    assert "Traceback" in proc.stderr
    assert "deliberate failure on rank 1" in proc.stderr


STALLING = '''\
import sys
import time

import torch.distributed as dist

from pytorch_vit_paper_replication_tpu_torch import engine, train

real = engine.train


def stalling(*args, **kwargs):
    if dist.is_initialized() and dist.get_rank() == 1:
        time.sleep(600)
    return real(*args, **kwargs)


# Module level: the spawned ranks import this script as their main module.
engine.train = stalling

if __name__ == "__main__":
    train.main(sys.argv[1:])
'''


def test_a_stalled_rank_fails_the_cli_through_its_watchdog(folder,
                                                           tmp_path):
    """Rank 1 never takes a step, so no rank does: the watchdogs
    (--watchdog-s 1, ten times that before the first beat) write their
    postmortems (rank r > 0 beside rank 0's path) and end their ranks,
    and the CLI exits non-zero long before the collectives' timeout."""
    script = tmp_path / "stalling_rank.py"
    script.write_text(STALLING)
    proc = subprocess.run(
        [sys.executable, str(script), *_argv(folder, *MESH, "--epochs", "1",
                                             "--watchdog-s", "1",
                                             "--checkpoint-dir",
                                             str(tmp_path / "ck"))],
        capture_output=True, text=True, timeout=240, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert ": watchdog stall, postmortem" in proc.stderr
    assert f"exited with code {ttrain.STALL_EXIT_CODE}" in proc.stderr
    dumps = {p.name for p in (tmp_path / "ck").glob("postmortem*.txt")}
    assert dumps and dumps <= {"postmortem.txt"} | {
        f"postmortem.rank{r}.txt" for r in range(1, 4)}
