"""The port's training step and loop against the JAX package's.

Trajectory parity is the gate of the training slice: the JAX
``make_optimizer`` + ``jax.jit(make_train_step())`` and the port's
``make_optimizer`` + ``make_train_step()`` start from the same weights
(``convert.params_from_flax``) and take the same seeded batches for 20
steps, dropout off, f32, for every ``mlp_impl`` x ``attention_impl``
(JAX's Pallas kernels in interpret mode; the port's plain versions). The
final params are compared in the JAX layout (``convert.params_to_flax``).

Tolerances. ``tests/test_recipe_parity.py`` (JAX against a torch
reference model) allows loss rtol 5e-3, per-leaf drift 5% of how far the
leaf moved, global drift 2%, and bounds the qkv bias (whose gradient is
degenerate: softmax shift invariance) in absolute terms at 0.02. The port
computes the same function with the same rounding points, so the bounds
here are 10x tighter: loss rtol 5e-4, per-leaf drift 0.5%, global 0.2%,
qkv bias 2e-3 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_vit_paper_replication_tpu import engine as jengine
from pytorch_vit_paper_replication_tpu import optim as joptim
from pytorch_vit_paper_replication_tpu.configs import TrainConfig as JTrain
from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu_torch import engine, optim
from pytorch_vit_paper_replication_tpu_torch.configs import (
    TrainConfig, ViTConfig)
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, params_from_flax, params_to_flax)
from pytorch_vit_paper_replication_tpu_torch.models import ViT

SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
             embedding_dim=64, mlp_size=256, num_classes=5,
             dtype="float32", mlp_dropout=0.0, embedding_dropout=0.0,
             attn_dropout=0.0)
STEPS, BATCH = 20, 8


def _init(**kw):
    cfg = {**SMALL, **kw}
    params = JViT(JCfg(**cfg)).init(jax.random.key(0),
                                    jnp.zeros((1, 32, 32, 3)))["params"]
    return cfg, jax.device_get(params)


def _batches(seed=7, n=STEPS, b=BATCH):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, 32, 32, 3)).astype(
                np.float32),
             "label": rng.integers(0, 5, b).astype(np.int32)}
            for _ in range(n)]


def _jax_run(cfg, params, batches, tcfg, total, step_kw=None, accum=1):
    tx = joptim.make_optimizer(JTrain(**tcfg), total,
                               grad_accum_steps=accum)
    state = jengine.TrainState.create(
        apply_fn=JViT(JCfg(**cfg)).apply,
        params=jax.tree.map(jnp.asarray, params), tx=tx,
        rng=jax.random.key(0))
    step = jax.jit(jengine.make_train_step(**(step_kw or {})))
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in jax.device_get(m).items()})
    return out, jax.device_get(state.params), state


def _port_state(cfg, params, tcfg, total, accum=1):
    model = ViT(ViTConfig(**cfg))
    model.load_state_dict(params_from_flax(params))
    return engine.TrainState.create(
        model=model, seed=0,
        tx=optim.make_optimizer(TrainConfig(**tcfg), total,
                                grad_accum_steps=accum))


def _port_run(cfg, params, batches, tcfg, total, step_kw=None, accum=1):
    state = _port_state(cfg, params, tcfg, total, accum)
    step = engine.make_train_step(**(step_kw or {}))
    out = []
    for b in batches:
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return out, params_to_flax(state.model.state_dict()), state


def _assert_params_close(got, want, rtol, atol):
    """Leafwise closeness of two Flax trees; the qkv bias, whose K slice
    has an analytically zero gradient that Adam normalizes from rounding
    noise into lr-sized steps, is bounded in absolute terms (2e-3)."""
    got = flatten_tree(got)
    for key, v in flatten_tree(want).items():
        if key.endswith("qkv/bias"):
            assert np.abs(got[key] - v).max() < 2e-3, key
        else:
            np.testing.assert_allclose(got[key], v, rtol=rtol, atol=atol,
                                       err_msg=key)


RECIPE = dict(batch_size=BATCH, learning_rate=1e-3, weight_decay=0.03,
              warmup_fraction=0.05, grad_clip_norm=1.0)


@pytest.mark.parametrize("mlp_impl", ["xla", "fused"])
@pytest.mark.parametrize("attention_impl", ["xla", "flash"])
def test_trajectory_matches_jax(mlp_impl, attention_impl):
    cfg, params = _init(mlp_impl=mlp_impl, attention_impl=attention_impl)
    batches = _batches()
    jm, jp, _ = _jax_run(cfg, params, batches, RECIPE, STEPS)
    tm, tp, state = _port_run(cfg, params, batches, RECIPE, STEPS)
    assert state.step == STEPS and state.opt_state.count == STEPS
    for key in ("loss_sum", "grad_norm", "correct"):
        np.testing.assert_allclose([m[key] for m in tm],
                                   [m[key] for m in jm], rtol=5e-4,
                                   atol=5e-4, err_msg=key)
    flat_j, flat_t = flatten_tree(jp), flatten_tree(tp)
    flat_0 = flatten_tree(params)
    assert set(flat_j) == set(flat_t)
    num = den = 0.0
    for key, t in flat_t.items():
        j, t0 = np.float64(flat_j[key]), np.float64(flat_0[key])
        t = np.float64(t)
        num += np.linalg.norm(t - j) ** 2
        den += np.linalg.norm(j - t0) ** 2
        if key.endswith("qkv/bias"):
            assert np.abs(t - j).max() < 2e-3, key
        else:
            move = max(np.linalg.norm(j - t0), 1e-4)
            assert np.linalg.norm(t - j) / move < 5e-3, key
    assert (num / den) ** 0.5 < 2e-3


def test_grad_accumulation_equals_one_big_batch():
    """Two micro-batches of 4 with grad_accum_steps = 2 give the same
    update as one batch of 8 (dropout off; the mean of the two batch-mean
    gradients is the batch-8 mean gradient)."""
    cfg, params = _init(mlp_impl="fused")
    big = _batches(n=3, b=8)
    small = [{k: v[i * 4:(i + 1) * 4] for k, v in b.items()}
             for b in big for i in range(2)]
    one, p_one, s_one = _port_run(cfg, params, big, RECIPE, 3)
    acc, p_acc, s_acc = _port_run(cfg, params, small, RECIPE, 3, accum=2)
    assert s_one.opt_state.count == s_acc.opt_state.count == 3
    assert s_acc.step == 6
    _assert_params_close(p_acc, p_one, rtol=1e-4, atol=1e-6)


def test_grad_accumulation_matches_jax_multisteps():
    cfg, params = _init()
    batches = _batches(n=4)
    _, jp, _ = _jax_run(cfg, params, batches, RECIPE, 2, accum=2)
    _, tp, _ = _port_run(cfg, params, batches, RECIPE, 2, accum=2)
    # atol 5e-5: Adam turns a near-zero gradient element's rounding noise
    # into up to an lr-sized (1e-3) step. The largest reading beyond rtol,
    # on the patch-conv kernel, is 1.0e-5 (|diff| 1.3e-5); 5e-5 leaves 5x.
    _assert_params_close(tp, jp, rtol=1e-4, atol=5e-5)


def test_nan_guard_skips_bad_batch_and_leaves_state():
    cfg, params = _init()
    batches = _batches(n=3)
    bad = dict(batches[1], image=np.full_like(batches[1]["image"], np.nan))
    state = _port_state(cfg, params, RECIPE, 10)
    step = engine.make_train_step(nan_guard=True)
    state, m0 = step(state, batches[0])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    count = state.opt_state.count
    state, m1 = step(state, bad)
    assert float(m1["skipped"]) == 1.0 and float(m0["skipped"]) == 0.0
    assert all(float(v) == 0.0 for k, v in m1.items() if k != "skipped")
    assert state.step == 2 and state.opt_state.count == count
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.opt_state.mu.items():
        assert torch.equal(v, mu[k]), k
    # The JAX guard agrees: the same three batches, same skipped flags.
    jm, _, jstate = _jax_run(cfg, params, [batches[0], bad, batches[2]],
                             RECIPE, 10, step_kw=dict(nan_guard=True))
    state, m2 = step(state, batches[2])
    assert [m["skipped"] for m in jm] == [0.0, 1.0, 0.0]
    np.testing.assert_allclose(float(m2["loss_sum"]), jm[2]["loss_sum"],
                               rtol=5e-4)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 7)).astype(np.float32) * 3
    teacher = rng.standard_normal((6, 7)).astype(np.float32) * 3
    labels = rng.integers(0, 7, 6)
    tl, tt, ty = (torch.from_numpy(logits), torch.from_numpy(teacher),
                  torch.from_numpy(labels))
    jl, jt, jy = (jnp.asarray(logits), jnp.asarray(teacher),
                  jnp.asarray(labels.astype(np.int32)))
    np.testing.assert_allclose(
        float(engine.cross_entropy_loss(tl, ty, smoothing)),
        float(jengine.cross_entropy_loss(jl, jy, smoothing)), rtol=1e-6)
    for alpha, t in ((0.0, 1.0), (0.7, 2.0), (1.0, 4.0)):
        np.testing.assert_allclose(
            float(engine.distill_loss(tl, tt, ty, t=t, alpha=alpha,
                                      label_smoothing=smoothing)),
            float(jengine.distill_loss(jl, jt, jy, t=t, alpha=alpha,
                                       label_smoothing=smoothing)),
            rtol=1e-5)


def test_distill_step_matches_jax():
    cfg, params = _init()
    rng = np.random.default_rng(4)
    batches = [dict(b, teacher_logits=rng.standard_normal(
        (BATCH, 5)).astype(np.float32)) for b in _batches(n=3)]
    kw = dict(distill_alpha=0.5, distill_t=2.0, label_smoothing=0.1)
    jm, _, _ = _jax_run(cfg, params, batches, RECIPE, 3, step_kw=kw)
    tm, _, _ = _port_run(cfg, params, batches, RECIPE, 3, step_kw=kw)
    for key in ("loss_sum", "teacher_agree", "grad_norm"):
        np.testing.assert_allclose([m[key] for m in tm],
                                   [m[key] for m in jm], rtol=5e-4,
                                   err_msg=key)


def test_eval_and_train_loop_match_jax():
    """``evaluate`` (example-weighted, masked) and the ``train`` results
    dict against the JAX loop on the same batches."""
    cfg, params = _init()
    batches = _batches(n=3)
    evals = [dict(b, mask=np.array([1] * 6 + [0] * 2, np.float32))
             for b in _batches(seed=9, n=2)]
    tx = joptim.make_optimizer(JTrain(**RECIPE), 6)
    jstate = jengine.TrainState.create(
        apply_fn=JViT(JCfg(**cfg)).apply,
        params=jax.tree.map(jnp.asarray, params), tx=tx,
        rng=jax.random.key(0))
    jstate, jres = jengine.train(
        jstate, lambda: iter([{k: jnp.asarray(v) for k, v in b.items()}
                              for b in batches]),
        lambda: iter([{k: jnp.asarray(v) for k, v in b.items()}
                      for b in evals]), epochs=2, verbose=False)
    state = _port_state(cfg, params, RECIPE, 6)
    state, res = engine.train(state, lambda: iter(batches),
                              lambda: iter(evals), epochs=2, verbose=False)
    assert set(res) == set(jres)
    for key in res:
        np.testing.assert_allclose(res[key], jres[key], rtol=5e-4,
                                   atol=1e-6, err_msg=key)
    ev = engine.evaluate(state, lambda: iter(evals))
    assert ev["count"] == 12.0


def test_train_stop_check_and_unported_hooks_raise():
    cfg, params = _init()
    state = _port_state(cfg, params, RECIPE, 6)
    seen = []
    state, res = engine.train(
        state, lambda: iter(_batches(n=3)), lambda: iter([]), epochs=2,
        verbose=False, stop_check=lambda s: seen.append(s) or s == 2)
    assert seen == [1, 2] and state.step == 2 and res["train_loss"] == []
    for kw in (dict(telemetry=object()), dict(profile_dir="x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine.train(state, list, list, epochs=1, **kw)


def test_train_logs_and_checkpoints(tmp_path):
    """``logger`` and ``checkpointer`` (ported): one JSONL row per epoch with
    the JAX loop's keys, a save every ``checkpoint_every_steps`` and at the
    final epoch."""
    import json

    from pytorch_vit_paper_replication_tpu_torch.checkpoint import (
        Checkpointer)
    from pytorch_vit_paper_replication_tpu_torch.metrics import MetricsLogger

    cfg, params = _init()
    state = _port_state(cfg, params, RECIPE, 6)
    ck = Checkpointer(tmp_path / "ck", max_to_keep=10)
    with MetricsLogger(tmp_path / "m.jsonl") as logger:
        state, res = engine.train(
            state, lambda: iter(_batches(n=3)), lambda: iter(_batches(n=1)),
            epochs=2, verbose=False, logger=logger, checkpointer=ck,
            checkpoint_every_steps=2, lr_schedule=lambda s: 1e-3 * s)
    rows = [json.loads(x) for x in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [(r["step"], r["epoch"]) for r in rows] == [(3, 1), (6, 2)]
    assert set(rows[0]) == {"time", "step", "epoch", "train_loss",
                            "train_acc", "test_loss", "test_acc",
                            "images_per_sec", "grad_norm", "lr",
                            "time_to_first_step"}
    assert "time_to_first_step" not in rows[1]
    assert rows[1]["lr"] == 1e-3 * 6
    np.testing.assert_allclose([r["train_loss"] for r in rows],
                               res["train_loss"])
    assert ck.all_steps() == [2, 3, 4, 6]
