"""TensorBoard scalars: the port's train CLI against the JAX package's.

Both CLIs run ``test_torch_cli.py``'s comparison (Ti/16 at 32 px, f32,
xla paths, dropout 0, the port's init patched to JAX's) with
``--tensorboard-dir``; tensorboard's own event reader reads both
directories. The tags are equal (less the JSONL keys the port does not
write, ``test_torch_cli.PORT_OMITS``), each tag's steps are equal, and
each value is within that test's rtol 5e-4, except the wall-clock tags
(``images_per_sec``, ``time_to_first_step``), whose values no two runs
share. On a mesh, rank 0 alone writes events; without tensorboardX the
flag fails at its import, as JAX's does.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

from pytorch_vit_paper_replication_tpu.train import main as jax_train_main
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.convert import params_from_flax
from pytorch_vit_paper_replication_tpu_torch.metrics import MetricsLogger

from test_torch_cli import (PORT_OMITS, _common, _cpu, _jax_init,  # noqa
                            folder, free_tmp_path, one_thread)

WALL_CLOCK = {"images_per_sec", "time_to_first_step"}


def _scalars(directory: Path) -> dict:
    acc = EventAccumulator(str(directory))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tensorboard_scalars_match_jax_cli(folder, tmp_path, monkeypatch):
    init = _jax_init(7)
    monkeypatch.setattr(ttrain, "initial_params",
                        lambda cfg, seed: params_from_flax(init))
    argv = _common(folder) + ["--attention", "xla", "--mlp-impl", "xla",
                              "--dropout", "0", "--epochs", "2"]
    jax_train_main(argv + ["--tensorboard-dir", str(tmp_path / "jax")])
    ttrain.main(_cpu(argv) + ["--tensorboard-dir", str(tmp_path / "port")])
    want, got = _scalars(tmp_path / "jax"), _scalars(tmp_path / "port")
    assert set(got) == set(want) - set(PORT_OMITS)
    assert {"train_loss", "test_loss", "grad_norm", "lr"} <= set(got)
    for tag, events in got.items():
        assert [s for s, _ in events] == [s for s, _ in want[tag]], tag
        if tag not in WALL_CLOCK:
            np.testing.assert_allclose([v for _, v in events],
                                       [v for _, v in want[tag]],
                                       rtol=5e-4, err_msg=tag)


def test_mesh_rank0_alone_writes_events(folder, tmp_path):
    """dp 2 on two gloo ranks: one events file, with the run's steps."""
    tb = tmp_path / "tb"
    res = ttrain.main(_cpu(_common(folder)) + [
        "--epochs", "1", "--mesh-data", "2", "--tensorboard-dir", str(tb)])
    assert len(list(tb.iterdir())) == 1
    got = _scalars(tb)
    assert [v for _, v in got["test_loss"]] == pytest.approx(
        res["test_loss"], rel=1e-6)
    assert [s for s, _ in got["train_loss"]] == [3]


def test_without_tensorboardx_the_logger_fails_at_import(tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError):
        MetricsLogger(tb_dir=tmp_path / "tb")
    MetricsLogger(tmp_path / "m.jsonl").close()     # no tb_dir: no import
