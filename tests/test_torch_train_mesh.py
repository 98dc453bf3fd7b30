"""The port's train CLI on a dp x tp x pp mesh against the JAX CLI on the
same mesh.

The same argv goes through JAX ``train.main`` on the conftest's virtual
CPU devices (its ``parallel.make_mesh`` handed the first D x M x P of the
eight, so the mesh is the port's) and through the port's ``train.main``
with ``--device cpu``, whose launcher starts D x M x P gloo rank
processes. The synthetic folder of ``tests/test_torch_cli.py`` (24 train
images, batch 8: 3 steps an epoch), 32 px, f32, ``--attention xla
--mlp-impl xla --dropout 0``, seed 7, one decode worker. The launcher
makes the initial weights once, so the port starts from JAX's init
(``train.initial_params`` patched in this process; ``--pretrained``
converts the same file in both). Ti/16 has 3 heads, which a model axis of
2 does not divide, so the tensor-parallel cases run S/16 (6 heads).
Bounds are ``test_torch_cli.py``'s: losses and ``grad_norm`` rtol 5e-4,
accuracies equal, the JSONL keys and events equal, the final params
within 0.5% of each leaf's move (0.2% globally; the qkv bias within 2e-3
absolute).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from pytorch_vit_paper_replication_tpu import parallel as jparallel
from pytorch_vit_paper_replication_tpu.configs import PRESETS as JPRESETS
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.train import main as jax_train_main
from pytorch_vit_paper_replication_tpu_torch import train as ttrain
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, load_params_npz, params_from_flax, params_to_flax)
from pytorch_vit_paper_replication_tpu_torch.data import (
    make_synthetic_image_folder)

from test_torch_cli import PORT_OMITS, _rows, free_tmp_path  # noqa: F401

COMMON = ["--image-size", "32", "--patch-size", "16", "--dtype", "float32",
          "--batch-size", "8", "--num-workers", "1", "--seed", "7",
          "--attention", "xla", "--mlp-impl", "xla", "--dropout", "0"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return make_synthetic_image_folder(
        tmp_path_factory.mktemp("torch_mesh") / "ds", train_per_class=8,
        test_per_class=2, image_size=32)


def jax_mesh_of_the_argv(monkeypatch):
    """JAX's CLI builds its mesh over every virtual device; hand it the
    first data x model x seq x pipe of them, as many as the port's
    ranks."""
    real = jparallel.make_mesh

    def first_devices(config=None, devices=None):
        n = (max(1, config.data) * max(1, config.model)
             * max(1, config.seq) * max(1, config.pipe))
        return real(config, devices=jax.devices()[:n])

    monkeypatch.setattr(jparallel, "make_mesh", first_devices)


def jax_init(preset: str, seed: int = 7, num_classes: int = 3,
             **overrides):
    cfg = JPRESETS[preset](num_classes=num_classes, image_size=32,
                           patch_size=16, dtype="float32", **overrides)
    return jax.device_get(JViT(cfg).init(
        jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"])


def against_jax(argv, tmp_path, monkeypatch, *, init=None, start=None,
                port_extra=(), telemetry=False):
    """Both CLIs on ``argv``: the bounds of the module docstring.
    ``init`` (a Flax tree) patches the port's ``initial_params``;
    ``start`` is the run's starting params (default ``init``) for the
    final-params bound; ``telemetry`` adds ``--telemetry-jsonl`` (a row
    every step) to both and holds the rows' events and keys to JAX's.
    Returns the port's results."""
    jax_mesh_of_the_argv(monkeypatch)
    if init is not None:
        converted = params_from_flax(init)
        monkeypatch.setattr(ttrain, "initial_params",
                            lambda model, seed: converted)
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
    jrows, trows = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path /
                                                       "port.jsonl")
    assert [set(r) - set(port_extra) for r in trows] == [
        set(r) - set(PORT_OMITS) for r in jrows]
    for tr, jr in zip(trows, jrows):
        assert (tr["step"], tr["epoch"]) == (jr["step"], jr["epoch"])
        np.testing.assert_allclose(tr["lr"], jr["lr"], rtol=1e-6)
        np.testing.assert_allclose(tr["grad_norm"], jr["grad_norm"],
                                   rtol=5e-4)
    if telemetry:
        jrows = _rows(tmp_path / "jax_tel.jsonl")
        trows = _rows(tmp_path / "port_tel.jsonl")
        assert [r.get("event") for r in trows] == [r.get("event")
                                                   for r in jrows]
        assert [set(r) for r in trows] == [set(r) - set(PORT_OMITS)
                                           for r in jrows]
        # Rank 0's rows count the global batch, as JAX's do.
        assert [r["tel_images"] for r in trows if "tel_images" in r] == \
            [r["tel_images"] for r in jrows if "tel_images" in r]
    for name in ("transform.json", "model_meta.json"):
        if not (tmp_path / "jax" / name).is_file():
            assert not (tmp_path / "port" / name).exists(), name
            continue
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text()), name
    # The final/ exports: both in the standard layout, within the bounds.
    ckptr = ocp.StandardCheckpointer()
    try:
        jfinal = jax.device_get(ckptr.restore(tmp_path / "jax" / "final"))
    finally:
        ckptr.close()
    flat_j = flatten_tree(jfinal)
    flat_t = flatten_tree(params_to_flax(
        load_params_npz(tmp_path / "port" / "final" / "params.npz")))
    flat_0 = flatten_tree(start if start is not None else init)
    assert set(flat_j) == set(flat_t) == set(flat_0)
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
    # Every rank holds the same global metrics and reported its kernel
    # counters (the CPU runs no kernel).
    assert all(r == tres["rank_results"][0] for r in tres["rank_results"])
    assert tres["rank_results"][0]["test_loss"] == tres["test_loss"]
    assert len(tres["rank_launches"]) == np.prod(
        [int(argv[argv.index(f) + 1]) if f in argv else 1
         for f in ("--mesh-data", "--mesh-model", "--mesh-seq",
                   "--mesh-pipe")])
    return tres


def _folder(folder, preset="ViT-Ti/16"):
    return ["--train-dir", str(folder[0]), "--test-dir", str(folder[1]),
            "--preset", preset, *COMMON]


def test_dp2_tp2_pp2_matches_jax_cli(folder, tmp_path, monkeypatch):
    """S/16 on dp 2 x tp 2 x pp 2 (8 ranks, 2 microbatches), two epochs."""
    against_jax(_folder(folder, "ViT-S/16") + [
        "--epochs", "2", "--mesh-data", "2", "--mesh-model", "2",
        "--mesh-pipe", "2"], tmp_path, monkeypatch,
        init=jax_init("ViT-S/16"))


def test_dp2_pp2_grad_accum_matches_jax_cli(folder, tmp_path, monkeypatch):
    """Ti/16 on dp 2 x pp 2 with --grad-accum 2 over two 3-step epochs:
    the second epoch opens inside an accumulation group."""
    against_jax(_folder(folder) + [
        "--epochs", "2", "--mesh-data", "2", "--mesh-pipe", "2",
        "--grad-accum", "2"], tmp_path, monkeypatch, init=jax_init(
            "ViT-Ti/16"))


def test_tinyvgg_dp2_matches_jax_cli(folder, tmp_path, monkeypatch):
    """--model tinyvgg --mesh-data 2: data parallelism for a model with
    no pipeline or tensor-parallel layout; rank 0's telemetry rows are
    JAX's, counting the global batch."""
    from pytorch_vit_paper_replication_tpu.models import TinyVGG as JTiny
    init = jax.device_get(JTiny(hidden_units=8, num_classes=3).init(
        jax.random.key(7), jnp.zeros((1, 32, 32, 3)))["params"])
    argv = _folder(folder) + ["--model", "tinyvgg", "--hidden-units", "8",
                              "--epochs", "2", "--lr", "1e-2",
                              "--mesh-data", "2"]
    against_jax(argv, tmp_path, monkeypatch, init=init, telemetry=True)
    assert not (tmp_path / "port" / "model_meta.json").exists()


# --------------------------------------------------------------- refusals
# The mesh checks the JAX CLI makes, with its messages: (argv beyond the
# folder's, the exception type).
REFUSALS = {
    "indivisible_batch": (["--batch-size", "7", "--mesh-data", "2"],
                          SystemExit),
    "tinyvgg_model_axis": (["--model", "tinyvgg", "--mesh-model", "2"],
                           SystemExit),
    "tinyvgg_pipe": (["--model", "tinyvgg", "--mesh-data", "1",
                      "--mesh-pipe", "2"], SystemExit),
    "microbatches": (["--mesh-data", "2", "--mesh-pipe", "2",
                      "--pipe-microbatches", "3"], SystemExit),
    "heads_over_model_axis": (["--mesh-data", "1", "--mesh-model", "2"],
                              ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_mesh_refusals_match_jax_cli(folder, monkeypatch, case):
    extra, exc = REFUSALS[case]
    jax_mesh_of_the_argv(monkeypatch)
    argv = _folder(folder) + ["--epochs", "1"] + extra
    with pytest.raises(exc) as want:
        jax_train_main(argv)
    with pytest.raises(exc) as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("device,cards,flags,want", [
    ("cuda", 4, [], (4, 1, 1)),
    ("cuda", 4, ["--mesh-model", "2"], (2, 2, 1)),
    ("cuda", 8, ["--mesh-model", "2", "--mesh-pipe", "2"], (2, 2, 2)),
    ("cuda", 1, ["--mesh-pipe", "2"], (1, 1, 2)),
    ("cuda", 1, [], None),
    ("cpu", 4, [], None),
    ("cpu", 4, ["--mesh-pipe", "2"], (1, 1, 2)),
    ("cuda", 4, ["--mesh-data", "1"], None),
])
def test_mesh_data_minus_one_is_every_remaining_card(monkeypatch, device,
                                                     cards, flags, want):
    """--mesh-data -1 (the default) is the card count over model x pipe
    under --device cuda, at least 1, and 1 on the CPU; a world of one is
    the one-device run (no launcher)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = ttrain.build_parser().parse_args(["--device", device, *flags])
    got = ttrain.mesh_request(args)
    assert (None if got is None else (got.data, got.model, got.pipe)) == want
    with pytest.raises(SystemExit, match="--mesh-data must be"):
        ttrain.mesh_request(ttrain.build_parser().parse_args(
            ["--mesh-data", "0"]))
