"""The port's checkpoints: bit-exact round trips, rotation with pins, the
integrity digest, and the params export.

Saves are asynchronous by default: an async save equals a sync one byte for
byte, an in-place update after ``save()`` never reaches the saved step, a
slowed writer commits only at ``wait()``, saves are one at a time, a
writer error surfaces at the next ``save``/``wait``, and a process killed
mid-save leaves only a ``.tmp-*`` directory.

The step format is the port's own (``<dir>/<step>/state.pt``, no Orbax);
what it shares with the JAX package is the ``integrity.json`` manifest,
its flock, its digest walk and the pin list, so a pin written by the JAX
package's ``pin_step`` (the deploy controller's path) protects a port step
from rotation, and the reverse.
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu import checkpoint as jckpt
from pytorch_vit_paper_replication_tpu.utils import digest as jdigest
from pytorch_vit_paper_replication_tpu_torch import engine, optim
from pytorch_vit_paper_replication_tpu_torch.checkpoint import (
    CheckpointCorruptError, Checkpointer, load_model, pinned_steps,
    save_model)
from pytorch_vit_paper_replication_tpu_torch.configs import (
    TrainConfig, ViTConfig)
from pytorch_vit_paper_replication_tpu_torch.convert import seeded_params
from pytorch_vit_paper_replication_tpu_torch.models import ViT

CFG = ViTConfig(image_size=16, patch_size=8, num_layers=1, num_heads=2,
                embedding_dim=32, mlp_size=64, num_classes=3,
                dtype="float32")


def _state(seed=0, accum=1):
    model = ViT(CFG)
    model.load_state_dict(seeded_params(CFG, seed))
    return engine.TrainState.create(
        model=model, seed=seed,
        tx=optim.make_optimizer(TrainConfig(), 10, grad_accum_steps=accum))


def _batch(i):
    rng = np.random.default_rng(i)
    return {"image": rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
            "label": rng.integers(0, 3, 4)}


def _trained(steps, accum=1, seed=0):
    state = _state(seed, accum)
    step = engine.make_train_step()
    for i in range(steps):
        state, _ = step(state, _batch(i))
    return state


def _assert_state_equal(a, b):
    assert a.step == b.step and a.seed == b.seed
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.opt_state, b.opt_state
    assert (oa.count, oa.mini_step) == (ob.count, ob.mini_step)
    for name in ("mu", "nu", "acc"):
        da, db = getattr(oa, name), getattr(ob, name)
        assert set(da) == set(db), name
        for k in da:
            assert torch.equal(da[k], db[k]), (name, k)


@pytest.mark.parametrize("accum", [1, 2])
def test_round_trip_is_bit_exact(tmp_path, accum):
    state = _trained(3, accum=accum, seed=4)
    ck = Checkpointer(tmp_path / "ck")
    assert ck.save(state)
    assert ck.latest_step() == 3 and ck.verify(3)
    fresh = ck.restore(_state(seed=9, accum=accum))
    _assert_state_equal(fresh, state)
    if accum == 2:
        assert fresh.opt_state.mini_step == 1
        assert any(v.abs().sum() > 0 for v in fresh.opt_state.acc.values())
    # The restored state trains on exactly as the original.
    step = engine.make_train_step()
    state, m1 = step(state, _batch(7))
    fresh, m2 = step(fresh, _batch(7))
    assert float(m1["loss_sum"]) == float(m2["loss_sum"])
    _assert_state_equal(fresh, state)


def test_save_of_a_committed_step_needs_force(tmp_path):
    state = _trained(1)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    assert not ck.save(state)
    assert ck.save(state, force=True)
    assert ck.all_steps() == [1]


def test_interrupted_save_is_never_picked(tmp_path):
    state = _trained(2)
    ck = Checkpointer(tmp_path)
    ck.save(state)
    ck.wait()  # saves are async: durable once wait() returns
    torn = tmp_path / ".tmp-5-99999"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"half a checkpoint")
    assert Checkpointer(tmp_path).latest_step() == 2
    assert not torn.exists()


def test_rotation_keeps_newest_and_pinned(tmp_path):
    state = _state()
    ck = Checkpointer(tmp_path, max_to_keep=2)
    state.step = 1
    ck.save(state)
    assert ck.pin_step(1)
    for s in (2, 3, 4):
        state.step = s
        ck.save(state)
    assert ck.all_steps() == [1, 3, 4]
    assert pinned_steps(tmp_path) == [1]
    manifest = json.loads((tmp_path / "integrity.json").read_text())
    assert sorted(manifest["steps"]) == ["1", "3", "4"]
    assert manifest["pins"] == [1]
    ck.unpin_step(1)
    state.step = 5
    ck.save(state)
    assert ck.all_steps() == [4, 5]


def test_pins_interoperate_with_the_jax_package(tmp_path):
    """The deploy controller pins through the JAX package's ``pin_step``;
    the port's rotation must honour it, and the JAX reader sees the
    port's pins and digests."""
    state = _state()
    ck = Checkpointer(tmp_path, max_to_keep=1)
    state.step = 1
    ck.save(state)
    ck.wait()
    assert jckpt.pin_step(tmp_path, 1)
    state.step = 2
    ck.save(state)
    assert ck.all_steps() == [1, 2]
    ck.pin_step(2)
    assert jckpt.pinned_steps(tmp_path) == [1, 2]
    recorded = json.loads((tmp_path / "integrity.json").read_text())
    assert recorded["steps"]["2"] == jdigest.digest_dir(tmp_path / "2")


def test_flipped_byte_is_refused_and_fallback_restores_previous(tmp_path):
    state = _trained(2)
    ck = Checkpointer(tmp_path, max_to_keep=5)
    ck.save(state)
    good = _state(seed=3)
    ck.restore(good)
    state, _ = engine.make_train_step()(state, _batch(9))
    ck.save(state)
    ck.wait()
    payload = tmp_path / "3" / "state.pt"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    payload.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="restore\\(step=2\\)"):
        ck.restore(_state())
    restored = ck.restore_latest_verified(_state(seed=5))
    _assert_state_equal(restored, good)


def test_save_model_load_model_round_trip(tmp_path):
    state = _trained(1)
    params = state.model.state_dict()
    path = save_model(params, tmp_path, "final.pth")
    assert path == (tmp_path / "final").absolute()
    assert (path / "params.npz").is_file()
    loaded = load_model(path, params)
    assert set(loaded) == set(params)
    for k in params:
        assert torch.equal(loaded[k], params[k]), k
    small = dict(params)
    small.pop(next(iter(small)))
    with pytest.raises(ValueError, match="does not match"):
        load_model(path, small)


# --------------------------------------------------------- async saves
def _files(path):
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("accum", [1, 2])
def test_async_save_equals_sync_save(tmp_path, accum):
    state = _trained(3, accum=accum, seed=2)
    sync = Checkpointer(tmp_path / "sync", async_save=False)
    asyn = Checkpointer(tmp_path / "async")
    assert sync.save(state) and asyn.save(state)
    asyn.wait()
    assert _files(tmp_path / "sync" / "3") == _files(tmp_path / "async" / "3")
    manifests = [json.loads((tmp_path / d / "integrity.json").read_text())
                 for d in ("sync", "async")]
    assert manifests[0]["steps"] == manifests[1]["steps"]
    _assert_state_equal(asyn.restore(_state(seed=8, accum=accum)), state)


def test_update_right_after_save_does_not_reach_the_saved_step(tmp_path):
    state = _trained(2)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
        for v in state.opt_state.mu.values():
            v.mul_(-3.0)
    state.step = 99
    restored = ck.restore(_state(seed=6))
    assert restored.step == 2
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in restored.opt_state.mu.items():
        assert torch.equal(v, mu[k]), k


@pytest.fixture
def gated_writer(monkeypatch):
    """The writer blocks on an Event before each payload write."""
    from pytorch_vit_paper_replication_tpu_torch import checkpoint
    gate, started = threading.Event(), threading.Event()
    real = checkpoint._write_payload

    def slowed(path, payload):
        started.set()
        assert gate.wait(60)
        real(path, payload)
    monkeypatch.setattr(checkpoint, "_write_payload", slowed)
    return gate, started


def test_save_returns_before_the_step_is_committed(tmp_path, gated_writer):
    gate, started = gated_writer
    state = _trained(1)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    assert started.wait(30)
    assert ck._committed() == [] and not (tmp_path / "1").exists()
    assert [p.name for p in tmp_path.glob(".tmp-1-*")]
    gate.set()
    ck.wait()
    assert ck._committed() == [1] and ck.verify(1)


def test_second_save_waits_for_the_first(tmp_path, gated_writer):
    gate, started = gated_writer
    state = _trained(1)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    assert started.wait(30)
    second = threading.Thread(target=lambda: ck.save(_trained(2)))
    second.start()
    second.join(0.3)
    assert second.is_alive() and ck._committed() == []
    gate.set()
    second.join(30)
    assert not second.is_alive()
    assert ck.all_steps() == [1, 2]


@pytest.mark.parametrize("surfaces_at", ["save", "wait"])
def test_writer_error_is_raised_at_the_next_save_or_wait(
        tmp_path, monkeypatch, surfaces_at):
    from pytorch_vit_paper_replication_tpu_torch import checkpoint

    def broken(path, payload):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(checkpoint, "_write_payload", broken)
    state = _trained(1)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)            # returns before the write fails
    with pytest.raises(OSError, match="No space left"):
        if surfaces_at == "save":
            state.step = 2
            ck.save(state)
        else:
            ck.wait()
    ck.wait()                        # raised once, then cleared
    monkeypatch.undo()
    state.step = 3
    assert ck.save(state) and ck.all_steps() == [3]


KILLED_SAVE = """
import os, sys, time
sys.path.insert(0, {tests!r})
import test_torch_checkpoint as t
from pytorch_vit_paper_replication_tpu_torch import checkpoint
state = t._trained(1)
ck = checkpoint.Checkpointer({root!r})
ck.save(state)
ck.wait()
real = checkpoint._write_payload
def stalled(path, payload):
    real(path, payload)          # the bytes are written, never committed
    print("writing", flush=True)
    time.sleep(600)
checkpoint._write_payload = stalled
state, _ = t.engine.make_train_step()(state, t._batch(5))
ck.save(state)
time.sleep(600)
"""


def test_killed_during_an_async_save_restores_the_previous_step(tmp_path):
    """A process killed while its async save of step 2 is being written
    leaves only a ``.tmp-*`` directory beside step 1; a new Checkpointer
    removes it and restores step 1 bit for bit."""
    root = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-c", KILLED_SAVE.format(
            tests=str(Path(__file__).parent), root=str(root))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()
        assert line.strip() == "writing", proc.stderr.read()[-2000:]
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()
        proc.stderr.close()
    names = sorted(p.name for p in root.iterdir())
    assert "1" in names and "2" not in names
    assert any(n.startswith(".tmp-2-") for n in names)
    ck = Checkpointer(root)
    assert not list(root.glob(".tmp-*")) and ck.all_steps() == [1]
    _assert_state_equal(ck.restore(_state(seed=3)), _trained(1))
