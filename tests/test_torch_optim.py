"""The port's training recipe against the JAX package's optax chain.

On a toy parameter tree with seeded gradients: the learning-rate schedule
equals optax's at every step (with and without warmup); clip -> coupled
L2 on ndim > 1 -> Adam -> schedule give the same parameters after each
update (f32, 1e-6 relative: the same arithmetic in another order);
``head_only_label_fn`` freezes the backbone with no Adam state; and
``grad_accum_steps`` follows ``optax.MultiSteps``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_vit_paper_replication_tpu import optim as joptim
from pytorch_vit_paper_replication_tpu.configs import TrainConfig as JTrain
from pytorch_vit_paper_replication_tpu_torch import optim as toptim
from pytorch_vit_paper_replication_tpu_torch.configs import TrainConfig
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, params_from_flax)


def test_train_config_mirrors_jax():
    import dataclasses
    assert {f.name: f.default for f in dataclasses.fields(TrainConfig)} == \
        {f.name: f.default for f in dataclasses.fields(JTrain)}


@pytest.mark.parametrize("warmup,total", [(0.05, 100), (0.0, 100),
                                          (0.05, 7), (0.2, 33)])
def test_lr_schedule_equals_optax_every_step(warmup, total):
    cfg = TrainConfig(learning_rate=3e-3, warmup_fraction=warmup)
    want = joptim.make_lr_schedule(JTrain(learning_rate=3e-3,
                                          warmup_fraction=warmup), total)
    got = toptim.make_lr_schedule(cfg, total)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def _tree(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"backbone": {"dense": {"kernel": f(6, 5), "bias": f(5)},
                         "norm": {"scale": f(5)}},
            "head": {"kernel": f(5, 3), "bias": f(3)}}


def _run_both(cfg_kw, steps, grad_scale, label_fn=None, accum=1):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [jax.tree.map(lambda p: grad_scale * rng.standard_normal(
        p.shape).astype(np.float32), params) for _ in range(steps)]
    jcfg, tcfg = JTrain(**cfg_kw), TrainConfig(**cfg_kw)
    jtx = joptim.make_optimizer(jcfg, 10, trainable_label_fn=label_fn,
                                grad_accum_steps=accum)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jtx.init(jp)
    tx = toptim.make_optimizer(tcfg, 10, trainable_label_fn=label_fn,
                               grad_accum_steps=accum)
    tp = params_from_flax(params)
    tst = tx.init(tp)
    for g in grads:
        upd, jst = jtx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        tx.apply(tp, params_from_flax(g), tst)
    return flatten_tree(jax.device_get(jp), sep="."), tp, tst


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])   # below / above clip
def test_recipe_updates_match_optax(grad_scale):
    want, got, st = _run_both(dict(learning_rate=1e-2, weight_decay=0.3,
                                   warmup_fraction=0.2), 6, grad_scale)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert st.count == 6


def test_global_norm_matches_optax_on_b16_leaves():
    """The clip's and the ``grad_norm`` metric's norm at B/16 leaf sizes
    (fc1 kernel 768 x 3072, qkv kernel 768 x 3 x 12 x 64). PyTorch's f32
    norm on the CPU is off by up to 4e-5 relative here; optax's is not."""
    rng = np.random.default_rng(0)
    leaves = [(rng.standard_normal(s) * 1e-3).astype(np.float32)
              for s in ((768, 3072), (768, 3, 12, 64), (768,))]
    truth = np.sqrt(sum(np.square(a.astype(np.float64)).sum()
                        for a in leaves))
    got = toptim.global_norm([torch.tensor(a) for a in leaves])
    assert got.dtype == torch.float32
    want = float(optax.global_norm([jnp.asarray(a) for a in leaves]))
    assert abs(float(got) - truth) <= 1e-6 * truth
    assert abs(float(got) - want) <= 1e-6 * truth


def test_decay_mask_is_ndim_gt_1():
    mask = toptim.decay_mask(params_from_flax(_tree(
        np.random.default_rng(1))))
    assert mask == {"backbone.dense.kernel": True,
                    "backbone.dense.bias": False,
                    "backbone.norm.scale": False, "head.kernel": True,
                    "head.bias": False}


def test_frozen_backbone_no_update_no_state():
    start = params_from_flax(_tree(np.random.default_rng(0)))
    want, got, st = _run_both(dict(learning_rate=1e-2, warmup_fraction=0.0),
                              3, 1.0, label_fn=joptim.head_only_label_fn)
    assert set(st.mu) == {"head.kernel", "head.bias"}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        moved = not torch.equal(got[name], start[name])
        assert moved == name.startswith("head."), name
    assert toptim.head_only_label_fn(("head", "kernel")) == "train"
    assert toptim.head_only_label_fn(("backbone", "x")) == "frozen"


def test_grad_accumulation_matches_optax_multisteps():
    want, got, st = _run_both(dict(learning_rate=1e-2, warmup_fraction=0.0),
                              6, 1.0, accum=3)
    assert st.count == 2 and st.mini_step == 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_apply_with_the_callers_norm_equals_its_own():
    """``apply(..., norm_fn=)`` (a sharded step's clip norm) updates exactly
    as ``apply`` computing the norm itself, above the clip too; with
    accumulation ``norm_fn`` gets the accumulated mean, on the k-th
    micro-step only."""
    rng = np.random.default_rng(3)
    params = params_from_flax(_tree(rng))
    grads = [{k: torch.from_numpy(10.0 * rng.standard_normal(
        tuple(v.shape)).astype(np.float32)) for k, v in params.items()}
        for _ in range(2)]
    for accum in (1, 2):
        out, seen = [], []

        def caller_norm(gs):
            seen.append({k: v.clone() for k, v in gs.items()})
            return toptim.global_norm(gs.values())

        for norm_fn in (None, caller_norm):
            tx = toptim.make_optimizer(TrainConfig(weight_decay=0.3), 10,
                                       grad_accum_steps=accum)
            p = {k: v.clone() for k, v in params.items()}
            state = tx.init(p)
            for g in grads[:accum]:
                tx.apply(p, g, state, norm_fn=norm_fn)
            out.append(p)
        assert all(torch.equal(out[0][k], out[1][k]) for k in params)
        assert len(seen) == 1
        want = grads[0] if accum == 1 else {
            k: grads[0][k] + (grads[1][k] - grads[0][k]) / 2 for k in params}
        assert all(torch.equal(seen[0][k], want[k]) for k in params)
