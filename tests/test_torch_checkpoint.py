"""The port's checkpoints: bit-exact round trips, rotation with pins, the
integrity digest, and the params export.

The step format is the port's own (``<dir>/<step>/state.pt``, no Orbax);
what it shares with the JAX package is the ``integrity.json`` manifest,
its flock, its digest walk and the pin list, so a pin written by the JAX
package's ``pin_step`` (the deploy controller's path) protects a port step
from rotation, and the reverse.
"""

import json

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
