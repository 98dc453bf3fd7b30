"""The port's data x tensor x pipeline parallel path against the JAX
package's, on the CPU.

Rank processes run on gloo through ``parallel.spawn`` (one process per
rank, ``FileStore`` rendezvous, so parallel test workers cannot collide on
ports); their workers live in ``tests/torch_parallel_worker.py``, which
imports no JAX. The JAX references run on the conftest's 8 virtual CPU
devices: ``MLPBlock``/``TransformerEncoderBlock`` with ``tp_axis="model"``
under ``shard_map`` (as ``tests/test_fused_mlp.py`` runs the manual-TP
core), and ``make_pipeline_apply`` + ``make_parallel_train_step`` on a
dp=2 x tp=2 x pp=2 mesh with per-channel perturbed biases (as
``tests/test_pipeline.py`` runs it). Tolerances are those tests': block
forward 1e-4; pipeline logits rtol 1e-4 / atol 1e-5, losses rtol 1e-5,
params after two steps rtol 1e-5 / atol 1e-6 (the qkv bias, whose K slice
has an analytically zero gradient that Adam turns into lr-sized noise,
atol 5e-3). Gradients of the tensor-parallel blocks are held to
``jax.grad`` of the unsharded block within 2e-3 of each gradient's largest
element (the JAX package's grad tolerance). Dropout is off where the two
frameworks are compared: the port's seeds cannot reproduce JAX's
``fold_in`` stream; the seeds' layout is tested on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as worker
from pytorch_vit_paper_replication_tpu import engine as jengine
from pytorch_vit_paper_replication_tpu import parallel as jparallel
from pytorch_vit_paper_replication_tpu.configs import MeshConfig as JMeshCfg
from pytorch_vit_paper_replication_tpu.configs import TrainConfig as JTrain
from pytorch_vit_paper_replication_tpu.configs import ViTConfig as JCfg
from pytorch_vit_paper_replication_tpu.models import ViT as JViT
from pytorch_vit_paper_replication_tpu.models.vit import (
    MLPBlock as JMLPBlock, TransformerEncoderBlock as JBlock)
from pytorch_vit_paper_replication_tpu.optim import make_optimizer as jopt
from pytorch_vit_paper_replication_tpu_torch import engine, optim
from pytorch_vit_paper_replication_tpu_torch.configs import (
    MeshConfig, TrainConfig, ViTConfig)
from pytorch_vit_paper_replication_tpu_torch.convert import (
    flatten_tree, params_from_flax, params_to_flax, rank_local_params)
from pytorch_vit_paper_replication_tpu_torch.models import ViT
from pytorch_vit_paper_replication_tpu_torch.parallel import (
    mesh_layout, pipeline, sharding, spawn)

SPAWN_TIMEOUT_S = 120
# tests/test_pipeline.py's config, dropout off.
PIPE = dict(image_size=32, patch_size=8, num_layers=4, num_heads=2,
            embedding_dim=32, mlp_size=64, num_classes=3, dtype="float32",
            attention_impl="xla", attn_dropout=0.0, mlp_dropout=0.0,
            embedding_dropout=0.0)
BLOCK = dict(PIPE, num_heads=4, embedding_dim=64, mlp_size=256)
RECIPE = dict(warmup_fraction=0.1)
STEPS, TOTAL, MICRO, SEED = 2, 10, 2, 2


def _perturbed(tree, rng):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


# ------------------------------------------------------ tensor-parallel blocks
@pytest.fixture(scope="module", params=["xla", "fused"])
def blocks(request):
    """JAX blocks (shard_map over 2 devices and unsharded, with jax.grad)
    and the port's tp=2 blocks (2 gloo ranks), same weights and input."""
    impl = request.param
    cfg = JCfg(**BLOCK, mlp_impl=impl)
    local = cfg.replace(num_heads=2, mlp_size=128,
                        head_dim_override=cfg.head_dim)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 17, 64)).astype(np.float32)
    mesh = JMesh(np.array(jax.devices()[:2]), ("model",))
    ref = {}
    for name, cls in (("mlp", JMLPBlock), ("block", JBlock)):
        params = _perturbed(jax.jit(cls(cfg).init)(
            jax.random.key(1), jnp.asarray(x))["params"], rng)
        specs = jparallel.tree_pspecs(params)
        fed = jax.tree_util.tree_map_with_path(
            lambda p, a: a / 2.0 if jax.tree_util.keystr(p).endswith(
                ("['out']['bias']", "['fc2']['bias']")) else a, params)
        fn = jax.jit(shard_map(
            lambda p, xx, c=cls: c(local, tp_axis="model").apply(
                {"params": p}, xx),
            mesh=mesh, in_specs=(specs, P()), out_specs=P(),
            check_vma=False))
        out = np.asarray(fn(fed, jnp.asarray(x)))
        gp, gx = jax.jit(jax.grad(
            lambda p, xx: (cls(cfg).apply({"params": p}, xx) * ct).sum(),
            argnums=(0, 1)))(params, jnp.asarray(x))
        ref[name] = (out, {k.replace("/", "."): np.asarray(v) for k, v in
                           flatten_tree(gp).items()}, np.asarray(gx),
                     {k: np.asarray(v) for k, v in
                      params_from_flax(params).items()})
    fields = {**BLOCK, "mlp_impl": impl}
    got = spawn(worker.tp_blocks, MeshConfig(data=1, model=2),
                device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                args=(fields, ref["mlp"][3], ref["block"][3], x, ct))
    return ref, got


@pytest.mark.parametrize("name", ["mlp", "block"])
def test_tp_block_matches_jax_shard_map(blocks, name):
    """Forward of the tp=2 block equals JAX's shard_map'd manual-TP block
    on every rank; the input gradient and the assembled parameter
    gradients equal jax.grad of the unsharded block."""
    ref, got = blocks
    want_out, want_g, want_dx, _ = ref[name]
    for r in got:
        out, _, dx = r[name]
        np.testing.assert_allclose(out, want_out, atol=1e-4, rtol=1e-4)
        assert np.abs(dx - want_dx).max() <= 2e-3 * np.abs(want_dx).max()
        assert r["core_launches"] == (0, 0)      # CPU: plain versions only
    full = sharding.assemble_state_dict(
        [(r["coords"], {k: torch.from_numpy(v) for k, v in r[name][1].items()})
         for r in got])
    assert set(full) == set(want_g)
    for k, w in want_g.items():
        err = np.abs(full[k].numpy() - w).max()
        assert err <= 2e-3 * np.abs(w).max(), k


# ------------------------------------------------------ dp x tp x pp pipeline
def _pipe_params():
    """JAX ViT params with per-channel perturbed biases (a uniform shift
    would hide a double-counted replicated bias behind LayerNorm)."""
    params = jax.jit(JViT(JCfg(**PIPE)).init)(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.02 * jnp.arange(a.shape[-1]) / max(1, a.shape[-1])
        if jax.tree_util.keystr(p).endswith("['bias']") else a, params))


def _pipe_batch(seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    images = (labels[:, None, None, None] / 3.0 + 0.1 * rng.standard_normal(
        (8, 32, 32, 3))).astype(np.float32)
    return {"image": images, "label": labels}


@pytest.fixture(scope="module")
def jax_pipeline():
    """JAX make_pipeline_apply on dp=2 x tp=2 x pp=2: logits and a 2-step
    trajectory (the form of tests/test_pipeline.py)."""
    params, batch = _pipe_params(), _pipe_batch()
    cfg = JCfg(**PIPE)
    mesh = jparallel.make_mesh(JMeshCfg(data=2, model=2, pipe=2))
    jparallel.validate_pipeline(cfg, mesh, MICRO, 8)
    apply_fn = jparallel.make_pipeline_apply(cfg, mesh,
                                             num_microbatches=MICRO)
    pp = jparallel.stack_block_params(params, cfg.num_layers)
    logits = np.asarray(jax.jit(apply_fn, static_argnums=2)(
        {"params": pp}, batch["image"], False))
    tx = jopt(JTrain(**RECIPE), TOTAL,
              decay_mask_fn=jparallel.pipeline_decay_mask)
    st = jengine.TrainState.create(apply_fn=apply_fn, params=pp, tx=tx,
                                   rng=jax.random.key(SEED))
    st = jparallel.shard_train_state(st, mesh)
    step = jparallel.make_parallel_train_step(st, mesh)
    pbatch = jparallel.shard_batch(
        jax.tree.map(jnp.asarray, batch), mesh)
    losses = []
    for _ in range(STEPS):
        st, m = step(st, pbatch)
        losses.append(float(m["loss_sum"]))
    final = jparallel.unstack_block_params(jax.device_get(st.params))
    return {"params": params, "stacked": pp, "logits": logits,
            "losses": losses, "final": params_from_flax(final)}


@pytest.fixture(scope="module")
def port_pipeline(jax_pipeline):
    """The port's path on 8 gloo ranks (mlp_impl="fused": the MLP core in
    every tensor-parallel block), fed the JAX pipeline-stacked tree, and
    the port's single-process run of the same steps."""
    batch = _pipe_batch()
    rng = np.random.default_rng(5)
    norm_tree = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params_from_flax(jax_pipeline["params"]).items()}
    fields = {**PIPE, "mlp_impl": "fused"}
    ranks = spawn(worker.pipeline_train, MeshConfig(data=2, model=2, pipe=2),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=(fields, flatten_tree(jax_pipeline["stacked"]),
                        batch, STEPS, TOTAL, RECIPE, MICRO, SEED, norm_tree))
    model = ViT(ViTConfig(**fields))
    model.load_state_dict(params_from_flax(jax_pipeline["params"]))
    state = engine.TrainState.create(
        model=model, seed=SEED,
        tx=optim.make_optimizer(TrainConfig(**RECIPE), TOTAL))
    with torch.no_grad():
        single_logits = model.eval()(torch.from_numpy(batch["image"]))
    step = engine.make_train_step()
    single = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        single.append({k: float(v) for k, v in m.items()})
    single_eval = engine.make_eval_step()(state, batch)
    return {"ranks": ranks, "norm_tree": norm_tree,
            "single": {"logits": single_logits.numpy(), "metrics": single,
                       "eval": {k: float(v) for k, v in single_eval.items()},
                       "final": model.state_dict()}}


def _assert_params_close(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g, w = np.asarray(got[key]), np.asarray(w)
        atol = 5e-3 if key.endswith("qkv.bias") else 1e-6
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=key)


def test_pipeline_forward_matches_jax(jax_pipeline, port_pipeline):
    """Deterministic pipelined logits (each data rank's last stage, in
    data order) equal JAX make_pipeline_apply's and the single-process
    port's; only last-stage ranks return logits."""
    ranks = port_pipeline["ranks"]
    last = [r for r in ranks if r["coords"]["pipe"] == 1]
    assert all(r["logits"] is None for r in ranks if r not in last)
    for tp_rank in (0, 1):
        got = np.concatenate([r["logits"] for r in sorted(
            last, key=lambda r: r["coords"]["data"])
            if r["coords"]["model"] == tp_rank])
        np.testing.assert_allclose(got, jax_pipeline["logits"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got, port_pipeline["single"]["logits"],
                                   rtol=1e-4, atol=1e-5)


def test_pipeline_trajectory_matches_jax(jax_pipeline, port_pipeline):
    """Two optimizer steps through the GPipe schedule, TP blocks and the
    data all-reduce: every rank reports JAX's global losses, and the
    gathered params equal JAX's after the steps."""
    for r in port_pipeline["ranks"]:
        np.testing.assert_allclose([m["loss_sum"] for m in r["metrics"]],
                                   jax_pipeline["losses"], rtol=1e-5)
        assert [m["count"] for m in r["metrics"]] == [8.0] * STEPS
    got = port_pipeline["ranks"][0]["params"]
    _assert_params_close(got, {k: v.numpy() for k, v in
                               jax_pipeline["final"].items()})


def test_pipeline_trajectory_matches_single_process(port_pipeline):
    """The same steps through the port's single-process engine: losses,
    gradient norms, the eval pass and the final params agree."""
    single = port_pipeline["single"]
    for r in port_pipeline["ranks"]:
        for got, want in zip(r["metrics"], single["metrics"]):
            for key in ("loss_sum", "grad_norm"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
            assert got["correct"] == want["correct"]
        for key in ("loss_sum", "correct", "count"):
            np.testing.assert_allclose(r["eval"][key], single["eval"][key],
                                       rtol=1e-5)
    _assert_params_close(port_pipeline["ranks"][0]["params"],
                         {k: v.numpy() for k, v in single["final"].items()})


def test_sharded_clip_norm_matches_optax(port_pipeline):
    """Every rank's clip norm over its shards equals optax.global_norm of
    the whole tree (sharded leaves summed over model and pipe, the other
    block leaves over pipe, the embedding and tail once)."""
    want = float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in port_pipeline["norm_tree"].items()}))
    for r in port_pipeline["ranks"]:
        np.testing.assert_allclose(r["norm"], want, rtol=1e-6)


def test_dropout_seeds_per_data_rank_and_microbatch(port_pipeline):
    """Equal on every rank of a data shard (its tensor-parallel group and
    its pipeline stages), distinct across data ranks and microbatches."""
    by_data = {}
    for r in port_pipeline["ranks"]:
        seeds = np.asarray(r["seeds"])
        assert seeds.shape == (MICRO, 1 + 2 * PIPE["num_layers"])
        prev = by_data.setdefault(r["coords"]["data"], seeds)
        np.testing.assert_array_equal(seeds, prev)
    flat = np.concatenate([s.reshape(-1) for s in by_data.values()])
    assert len(by_data) == 2 and len(set(flat.tolist())) == flat.size


def test_rank_holds_only_its_stage_and_slices(port_pipeline):
    """A stage holds its two layers' blocks plus the replicated embedding
    and tail."""
    for r in port_pipeline["ranks"]:
        layers = {sharding.block_index(n) for n in r["local_names"]} - {None}
        s = r["coords"]["pipe"]
        assert layers == {2 * s, 2 * s + 1}
        assert "head.kernel" in r["local_names"]
        assert "backbone.patch_embedding.pos_embedding" in r["local_names"]


def test_pipeline_grad_accum_matches_jax():
    """Two micro-steps of a --grad-accum 2 group on dp 2 x tp 2 x pp 2:
    the first applies no update, the second equals JAX's accumulated
    pipeline update (the counterpart of JAX's
    test_pipeline_composes_with_grad_accum, with its bounds)."""
    params = _pipe_params()
    batches = [_pipe_batch(0), _pipe_batch(9)]
    cfg = JCfg(**PIPE)
    mesh = jparallel.make_mesh(JMeshCfg(data=2, model=2, pipe=2))
    apply_fn = jparallel.make_pipeline_apply(cfg, mesh,
                                             num_microbatches=MICRO)
    stacked = jparallel.stack_block_params(params, cfg.num_layers)
    tx = jopt(JTrain(**RECIPE), TOTAL, grad_accum_steps=2,
              decay_mask_fn=jparallel.pipeline_decay_mask)
    st = jparallel.shard_train_state(jengine.TrainState.create(
        apply_fn=apply_fn, params=stacked, tx=tx, rng=jax.random.key(SEED)),
        mesh)
    step = jparallel.make_parallel_train_step(st, mesh)
    for b in batches:
        st, _ = step(st, jparallel.shard_batch(
            jax.tree.map(jnp.asarray, b), mesh))
    want = params_from_flax(jparallel.unstack_block_params(
        jax.device_get(st.params)))
    ranks = spawn(worker.pipeline_steps, MeshConfig(data=2, model=2, pipe=2),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S,
                  args=({**PIPE, "mlp_impl": "fused"}, flatten_tree(stacked),
                        batches, TOTAL, RECIPE, MICRO, SEED, 2, False))
    start = {k: v.numpy() for k, v in params_from_flax(params).items()}
    first, second = ranks[0]["params"]
    for k, v in start.items():
        np.testing.assert_array_equal(first[k], v, err_msg=k)
    _assert_params_close(second, {k: v.numpy() for k, v in want.items()})
    assert all(r["mini_step"] == 0 for r in ranks)


# --------------------------------------------------------------- pure rules
def test_sharding_specs_match_jax():
    """``pspec_for_path`` over the port's state_dict names equals JAX
    ``tree_pspecs`` over the Flax tree, standard and pipeline-stacked."""
    params = _pipe_params()
    for tree in (params, jparallel.stack_block_params(params, 4)):
        want = {
            jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                jparallel.tree_pspecs(tree),
                is_leaf=lambda x: isinstance(x, P))}
        names = {jax.tree_util.keystr(p): ".".join(
            str(k.key) for k in p) for p, _ in
            jax.tree_util.tree_leaves_with_path(tree)}
        assert set(names) == set(want)
        for path, spec in want.items():
            assert sharding.pspec_for_path(names[path]) == spec, path
    assert sharding.REPLICATED_PARTIAL_SUM_BIASES == \
        jparallel.sharding.REPLICATED_PARTIAL_SUM_BIASES
    assert [(pat, spec) for pat, spec in sharding.TP_RULES] == [
        (pat, tuple(spec)) for pat, spec in jparallel.TP_RULES]


def test_validate_messages_match_jax():
    """validate_pipeline / validate_tp_divisibility raise JAX's errors on
    the same layouts; sequence parallelism is refused as not ported."""
    cases = [
        (JMeshCfg(data=2, pipe=4), MeshConfig(data=2, pipe=4),
         dict(PIPE, num_layers=3), 2),
        (JMeshCfg(data=2, pipe=4), MeshConfig(data=2, pipe=4), PIPE, 3),
        (JMeshCfg(data=1, seq=2, pipe=4), MeshConfig(data=1, seq=2, pipe=4),
         PIPE, 2),
        (JMeshCfg(data=1, model=4, pipe=2), MeshConfig(data=1, model=4,
                                                      pipe=2), PIPE, 2),
        (JMeshCfg(data=2, model=4), MeshConfig(data=2, model=4),
         dict(PIPE, num_heads=4, mlp_size=66), 2),
    ]
    for jcfg, tcfg_, fields, micro in cases:
        jmesh = jparallel.make_mesh(jcfg)
        tmesh = mesh_layout(tcfg_, 8)
        for jfn, tfn in ((lambda: jparallel.validate_pipeline(
                              JCfg(**fields), jmesh, micro, 8),
                          lambda: pipeline.validate_pipeline(
                              ViTConfig(**fields), tmesh, micro, 8)),
                         (lambda: jparallel.validate_tp_divisibility(
                              JCfg(**fields), jmesh),
                          lambda: sharding.validate_tp_divisibility(
                              ViTConfig(**fields), tmesh))):
            try:
                jfn()
                want = None
            except ValueError as e:
                want = str(e)
            if want is None:
                tfn()
            else:
                with pytest.raises(ValueError) as got:
                    tfn()
                assert str(got.value) == want
    with pytest.raises(NotImplementedError, match="sequence"):
        sharding.validate_mesh_for_config(
            ViTConfig(**PIPE), mesh_layout(MeshConfig(data=4, seq=2), 8))


def test_layouts_and_rank_local_params():
    """stack/unstack invert each other and match JAX's stacked tree; the
    rank-local slices of the JAX standard and stacked trees agree, and
    assembling every rank's slices gives the full state_dict back."""
    params = _pipe_params()
    flat = params_from_flax(params)
    stacked = pipeline.stack_block_params(flat, 4)
    jstacked = params_from_flax(jparallel.stack_block_params(params, 4))
    assert set(stacked) == set(jstacked)
    for k in stacked:
        torch.testing.assert_close(stacked[k], jstacked[k], rtol=0, atol=0)
    back = pipeline.unstack_block_params(stacked)
    assert all(torch.equal(back[k], flat[k]) for k in flat)
    config = MeshConfig(data=2, model=2, pipe=2)
    parts = []
    for rank in range(8):
        mesh = mesh_layout(config, 8, rank)
        a = rank_local_params(params, mesh)
        b = rank_local_params(jparallel.stack_block_params(params, 4), mesh)
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
        parts.append((mesh.coords, a))
    full = sharding.assemble_state_dict(parts)
    assert set(full) == set(flat)
    assert all(torch.equal(full[k], flat[k]) for k in flat)
    assert params_to_flax(full).keys() == params.keys()


def test_spawn_reports_a_failing_rank_and_a_hang():
    """A rank that raises fails the run with its traceback; ranks that
    hang fail it with TimeoutError within the timeout."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(worker.fail_on_rank, MeshConfig(data=2), device="cpu",
              timeout_s=60, args=(1,))
    with pytest.raises(TimeoutError):
        spawn(worker.hang, MeshConfig(data=2), device="cpu", timeout_s=4)


@pytest.mark.parametrize("sizes", [dict(data=2, model=2, pipe=2),
                                   dict(data=-1, model=2),
                                   dict(data=1, model=4, pipe=2)])
def test_mesh_layout_matches_jax_mesh(sizes):
    """Rank r's coordinates are where JAX's make_mesh puts device r (the
    row-major layout over AXES), and MeshConfig sizes agree."""
    jmesh = jparallel.make_mesh(JMeshCfg(**sizes))
    assert JMeshCfg(**sizes).axis_sizes(8) == MeshConfig(**sizes).axis_sizes(8)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        where = dict(zip(jmesh.axis_names,
                         (int(i[0]) for i in np.nonzero(ids == rank))))
        layout = mesh_layout(MeshConfig(**sizes), 8, rank)
        assert layout.coords == where
        assert layout.rank_at(**where) == rank


def test_backend_is_chosen_from_the_layout(monkeypatch):
    """NCCL only when every rank gets a card of its own; gloo on the CPU
    and when ranks share cards; spawn runs on the card unless asked for
    the CPU, with no CPU fallback; its world is the mesh's product."""
    from pytorch_vit_paper_replication_tpu_torch.parallel.mesh import (
        backend_for)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for("cuda", 4) == "nccl"
    assert backend_for("cuda", 8) == "gloo"
    assert backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn(worker.hang, MeshConfig(data=2), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        spawn(worker.hang, MeshConfig(data=2))
    with pytest.raises(ValueError, match="data >= 1"):
        spawn(worker.hang, MeshConfig(data=-1, model=2), device="cpu")
