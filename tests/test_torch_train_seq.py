"""Training on a sequence-parallel mesh: the port's parallel step and eval
step, and its train CLI, against the JAX package's, on the CPU.

The steps: JAX's ``tests/test_parallel.py`` seq cases (its gap config, 16
tokens; one train step from a fresh state and the eval step) with
``make_parallel_train_step``/``make_parallel_eval_step`` on the virtual
devices, against the port's on gloo ranks of the same mesh, from the same
Flax init: data 2 x seq 4 and data 2 x model 2 x seq 2, ring (JAX's two
heads) and Ulysses (four heads, so the heads divide), and ring with the
CLS pool where the token count divides (24 px: 10 tokens on seq 2).
Dropout is off: the port's generator streams cannot reproduce JAX's.
Bounds: the losses and
the gradient norm rtol 1e-4 (JAX's test), the correct counts equal, the
params after the step JAX's pipeline bounds (rtol 1e-5, atol 1e-6; the
qkv bias, whose K slice has a zero gradient that Adam turns into
lr-sized noise, atol 5e-3). Every rank holds the same metrics.

The CLI: ``--mesh-data 2 --mesh-seq 2 --sp-impl ring|ulysses``, S/16 (six
heads) with ``--pool gap`` at 32 px (four tokens), through
``test_torch_train_mesh.against_jax`` (its bounds); the ``--pool cls``
refusal with JAX's ValueError; ``--eval-only`` of the seq mesh's export
on the mesh (bit for bit) and on one device (rtol 1e-5); a resume on the
seq mesh from a mid-epoch checkpoint (rank 0 scatters the slices to
every seq rank) equal to the uninterrupted run bit for bit.
"""

import shutil

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
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.optim import make_optimizer as jopt
from pytorch_vit_paper_replication_tpu.train import main as jax_train_main
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.checkpoint import Checkpointer
from pytorch_vit_paper_replication_tpu_torch.configs import MeshConfig
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, load_params_npz, params_from_flax)
from pytorch_vit_paper_replication_tpu_torch.engine import step_generator
from pytorch_vit_paper_replication_tpu_torch.parallel import spawn

from test_torch_cli import free_tmp_path  # noqa: F401
from test_torch_parallel import SPAWN_TIMEOUT_S, _assert_params_close
from test_torch_train_mesh import (_folder, against_jax, folder,  # noqa: F401
                                   jax_init, jax_mesh_of_the_argv)

# JAX tests/test_parallel.py::_gap_config, dropout off.
GAP = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
           embedding_dim=32, mlp_size=64, num_classes=3, dtype="float32",
           attention_impl="xla", pool="gap", attn_dropout=0.0,
           mlp_dropout=0.0, embedding_dropout=0.0)
RECIPE = dict(warmup_fraction=0.1)
TOTAL = 10
STEPS = {   # name: (sp_impl, (data, model, seq), config fields)
    "ring_data2_seq4": ("ring", (2, 1, 4), {}),
    "ring_data2_model2_seq2": ("ring", (2, 2, 2), {}),
    "ulysses_data2_seq4": ("ulysses", (2, 1, 4), {"num_heads": 4}),
    "ulysses_data2_model2_seq2": ("ulysses", (2, 2, 2), {"num_heads": 4}),
    # The CLS token on a seq mesh: 9 patches + CLS = 10 tokens on seq 2,
    # the token on rank 0's piece.
    "ring_cls_data2_seq2": ("ring", (2, 1, 2), {"pool": "cls",
                                                "image_size": 24}),
}


def _batch(size=32):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    images = (labels[:, None, None, None] / 3.0 + 0.1 * rng.standard_normal(
        (8, size, size, 3))).astype(np.float32)
    return {"image": images, "label": labels}


def _jax_steps(cfg, params, batch, sp_impl, sizes):
    """JAX's eval step on the initial state, then one train step."""
    data, model, seq = sizes
    mesh = jparallel.make_mesh(JMeshCfg(data=data, model=model, seq=seq),
                               devices=jax.devices()[:data * model * seq])
    jparallel.validate_mesh_for_config(cfg, mesh)

    def state():
        st = jengine.TrainState.create(
            apply_fn=JViT(cfg).apply, params=params,
            tx=jopt(JTrain(**RECIPE), TOTAL), rng=jax.random.key(0))
        return jparallel.shard_train_state(st, mesh)
    jb = jparallel.shard_batch(jax.tree.map(jnp.asarray, batch), mesh)
    st = state()
    ev = jparallel.make_parallel_eval_step(st, mesh, sp_impl=sp_impl)(st, jb)
    st = state()
    st, m = jparallel.make_parallel_train_step(st, mesh, sp_impl=sp_impl)(
        st, jb)
    return ({k: float(v) for k, v in ev.items()},
            {k: float(v) for k, v in m.items()},
            params_from_flax(jax.device_get(st.params)))


@pytest.mark.parametrize("name", sorted(STEPS))
def test_seq_parallel_steps_match_jax(name):
    sp_impl, sizes, extra = STEPS[name]
    fields = dict(GAP, **extra)
    cfg = JCfg(**fields)
    size = cfg.image_size
    params = jax.device_get(JViT(cfg).init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)))["params"])
    batch = _batch(size)
    ev, m, after = _jax_steps(cfg, params, batch, sp_impl, sizes)
    data, model, seq = sizes
    ranks = spawn(worker.seq_steps, MeshConfig(data=data, model=model,
                                               seq=seq),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=(fields, flatten_tree(params), batch, TOTAL, RECIPE,
                        0, sp_impl))
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["eval"] == ranks[0]["eval"]
    got = ranks[0]
    for key in ("loss_sum", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], m[key], rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["eval"]["loss_sum"], ev["loss_sum"],
                               rtol=1e-4)
    assert got["eval"]["correct"] == ev["correct"]
    assert got["metrics"]["correct"] == m["correct"]
    _assert_params_close(got["params"], {k: v.numpy()
                                         for k, v in after.items()})


def test_seq_dropout_seeds():
    """On a seq axis the attention seeds are every rank's, equal to the
    one-rank model's draw (data row 0); the MLP seeds differ per (data,
    seq) coordinate; the embedding seed per data row."""
    ranks = spawn(worker.seq_steps, MeshConfig(data=2, seq=2), device="cpu",
                  timeout_s=SPAWN_TIMEOUT_S,
                  args=(GAP, flatten_tree(jax.device_get(JViT(JCfg(
                      **GAP)).init(jax.random.key(0), jnp.zeros(
                          (1, 32, 32, 3)))["params"])), _batch(), TOTAL,
                        RECIPE, 0, "ring"))
    one = torch.randint(-2**31, 2**31, (1 + 2 * GAP["num_layers"],),
                        generator=step_generator(0, 0)).tolist()
    seeds = {(r["coords"]["data"], r["coords"]["seq"]): r["seeds"][0]
             for r in ranks}
    for s in seeds.values():
        assert s[1::2] == one[1::2]
    mlp = [tuple(s[2::2]) for s in seeds.values()]
    assert len(set(mlp)) == 4
    assert seeds[(0, 0)][0] == seeds[(0, 1)][0] != seeds[(1, 0)][0]


def _seq_argv(folder, impl):
    return _folder(folder, "ViT-S/16") + [
        "--pool", "gap", "--mesh-data", "2", "--mesh-seq", "2",
        "--sp-impl", impl]


def test_ring_cli_matches_jax_cli(folder, tmp_path, monkeypatch):
    """One epoch of S/16 on data 2 x seq 2 with ring attention."""
    against_jax(_seq_argv(folder, "ring") + ["--epochs", "1"], tmp_path,
                monkeypatch, init=jax_init("ViT-S/16", pool="gap"))


def test_ulysses_cli_matches_jax_cli_and_its_export_scores(
        folder, tmp_path, monkeypatch):
    """One epoch with Ulysses; then its export through ``--eval-only`` on
    the seq mesh (the run's last eval, bit for bit) and on one device."""
    argv = _seq_argv(folder, "ulysses") + ["--epochs", "1"]
    res = against_jax(argv, tmp_path, monkeypatch,
                      init=jax_init("ViT-S/16", pool="gap"))
    ev_argv = ["--test-dir", str(folder[1])] + argv[4:] + [
        "--device", "cpu", "--eval-only", "--checkpoint-dir",
        str(tmp_path / "port")]
    mesh_ev = ttrain.main(ev_argv)
    assert mesh_ev["test_loss"][0] == res["test_loss"][-1]
    assert mesh_ev["test_acc"][0] == res["test_acc"][-1]
    one = ttrain.main(ev_argv + ["--mesh-data", "1", "--mesh-seq", "1"])
    np.testing.assert_allclose(one["test_loss"], mesh_ev["test_loss"],
                               rtol=1e-5)
    assert one["test_acc"] == mesh_ev["test_acc"]


def test_cls_pool_on_seq_mesh_fails_with_jax_message(folder, monkeypatch):
    """CLS pooling gives 5 tokens at 32 px: both CLIs refuse with JAX's
    ValueError and its pool='gap' hint before any rank starts."""
    jax_mesh_of_the_argv(monkeypatch)
    argv = _folder(folder) + ["--epochs", "1", "--mesh-data", "2",
                              "--mesh-seq", "2"]
    with pytest.raises(ValueError, match="gap") as want:
        jax_train_main(argv)
    with pytest.raises(ValueError) as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_resume_on_seq_mesh_matches_uninterrupted(folder, tmp_path):
    """Ti/16 with --pool gap on data 2 x seq 2, ring, dropout 0.1 (the
    later --dropout wins), a checkpoint every step: everything after step
    1 and final/ deleted, the command rerun. The resumed run ends with the uninterrupted run's
    params and last eval bit for bit."""
    ck = tmp_path / "ck"
    argv = _folder(folder) + [
        "--device", "cpu", "--pool", "gap", "--mesh-data", "2",
        "--mesh-seq", "2", "--epochs", "1", "--dropout", "0.1",
        "--checkpoint-dir", str(ck), "--checkpoint-every-steps", "1",
        "--keep-checkpoints", "10"]
    first = ttrain.main(argv)
    a = load_params_npz(ck / "final" / "params.npz")
    for d in ck.iterdir():
        if d.is_dir() and (d.name == "final"
                           or (d.name.isdigit() and int(d.name) > 1)):
            shutil.rmtree(d)
    assert Checkpointer(ck).latest_step() == 1
    again = ttrain.main(argv)
    b = load_params_npz(ck / "final" / "params.npz")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert again["test_loss"] == first["test_loss"]
    assert again["test_acc"] == first["test_acc"]
