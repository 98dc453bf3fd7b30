"""Rank workers for the port's parallel tests.

``parallel.spawn`` runs these in one process per rank; they import the port
and ``torch`` only (no JAX), so the card's machine runs them too
(``tests/test_torch_cuda.py``). Inputs arrive as numpy arrays, results go
back as numpy arrays and floats; the tests compare them with the JAX
package and with the port's single-process run.
"""

from __future__ import annotations

import numpy as np
import torch

from pytorch_vit_paper_replication_tpu_torch import engine, optim
from pytorch_vit_paper_replication_tpu_torch.configs import (TrainConfig,
                                                             ViTConfig)
from pytorch_vit_paper_replication_tpu_torch.convert import rank_local_params
from pytorch_vit_paper_replication_tpu_torch.models.vit import (
    MLPBlock, TransformerEncoderBlock)
from pytorch_vit_paper_replication_tpu_torch.ops import fused_mlp
from pytorch_vit_paper_replication_tpu_torch.parallel import (api, pipeline,
                                                              sharding)


def _np(tensors):
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def run_block(block, params, x, ct, device):
    """Forward and backward of ``block`` (train mode, dropout off by the
    config) on ``x`` with cotangent ``ct``: ``(out, local grads, dx)``."""
    block.load_state_dict({k: torch.from_numpy(v) for k, v in
                           params.items()})
    block.to(device).train()
    xt = torch.from_numpy(x).to(device).requires_grad_()
    out = block(xt)
    (out.float() * torch.from_numpy(ct).to(device)).sum().backward()
    grads = {n: p.grad for n, p in block.named_parameters()}
    return out.detach().float().cpu().numpy(), _np(grads), \
        xt.grad.float().cpu().numpy()


def tp_blocks(mesh, cfg_fields, mlp_params, block_params, x, ct):
    """The tensor-parallel ``MLPBlock`` (standalone, no residual) and
    ``TransformerEncoderBlock`` over the mesh's ``model`` group, built
    from a head-local config and loaded with this rank's slices of the
    full params. Returns the outputs, the input gradients and the local
    parameter gradients of both, with this rank's coordinates."""
    cfg = ViTConfig(**cfg_fields)
    tp = mesh.shape["model"]
    local = cfg.replace(num_heads=cfg.num_heads // tp,
                        mlp_size=cfg.mlp_size // tp,
                        head_dim_override=cfg.head_dim)
    group = mesh.groups["model"]
    out = {"coords": dict(mesh.coords)}
    blocks = {"mlp": (MLPBlock(local, tp=group), mlp_params),
              "block": (TransformerEncoderBlock(local, tp=group),
                        block_params)}
    before = fused_mlp.core_launches, fused_mlp.core_bwd_launches
    for name, (block, full) in blocks.items():
        params = sharding.shard_state_dict(
            {k: torch.from_numpy(v) for k, v in full.items()}, mesh)
        out[name] = run_block(block, _np(params), x, ct, mesh.device)
    out["core_launches"] = (fused_mlp.core_launches - before[0],
                            fused_mlp.core_bwd_launches - before[1])
    return out


def single_blocks(cfg_fields, mlp_params, block_params, x, ct, device):
    """The same two blocks without tensor parallelism, in this process."""
    cfg = ViTConfig(**cfg_fields)
    return {"mlp": run_block(MLPBlock(cfg), mlp_params, x, ct, device),
            "block": run_block(TransformerEncoderBlock(cfg), block_params,
                               x, ct, device)}


def pipeline_train(mesh, cfg_fields, params, batch, steps, total_steps,
                   train_fields, num_microbatches, seed, norm_tree):
    """The slice's path on one rank: ``make_pipeline_apply``, the rank's
    slices of ``params`` (a JAX tree or a full ``state_dict``, numpy),
    ``shard_train_state``, the eval forward of ``batch``, ``steps``
    parallel train steps on it, one eval step; then the full params
    gathered from every rank, the sharded clip norm of ``norm_tree``
    (a full gradient-shaped dict), and this rank's dropout seeds."""
    cfg = ViTConfig(**cfg_fields)
    dev = mesh.device
    model = pipeline.make_pipeline_apply(cfg, mesh,
                                         num_microbatches=num_microbatches)
    model.load_state_dict(rank_local_params(params, mesh))
    tx = optim.make_optimizer(TrainConfig(**train_fields), total_steps)
    state = api.shard_train_state(
        engine.TrainState.create(model=model, tx=tx, seed=seed), mesh)
    local = api.shard_batch(batch, mesh)
    logits = model(torch.from_numpy(local["image"]).to(dev))
    step = api.make_parallel_train_step(state, mesh)
    eval_step = api.make_parallel_eval_step(state, mesh)
    metrics = []
    for _ in range(steps):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    ev = {k: float(v) for k, v in eval_step(state, local).items()}
    full = sharding.gather_state_dict(dict(model.named_parameters()), mesh)
    norm = optim.sharded_global_norm(sharding.shard_state_dict(
        {k: torch.from_numpy(v).to(dev) for k, v in norm_tree.items()},
        mesh), mesh)
    seeds = pipeline.dropout_seeds(engine.step_generator(seed, 0), mesh,
                                   cfg.num_layers, num_microbatches)
    return {"coords": dict(mesh.coords),
            "logits": None if logits is None else logits.cpu().numpy(),
            "metrics": metrics, "eval": ev,
            "params": _np(full) if mesh.rank == 0 else None,
            "norm": float(norm), "seeds": seeds,
            "local_names": sorted(n for n, _ in model.named_parameters())}


def fail_on_rank(mesh, rank):
    """Raises on ``rank``; the others wait in a collective."""
    if mesh.rank == rank:
        raise ValueError(f"deliberate failure on rank {rank}")
    torch.distributed.barrier()


def hang(mesh):
    """Never returns."""
    import time
    while True:
        time.sleep(1)


def pipeline_steps(mesh, cfg_fields, params, batches, total_steps,
                   train_fields, num_microbatches, seed, grad_accum,
                   nan_guard):
    """The parallel train step over ``batches`` (global batches, one step
    each) with ``grad_accum`` micro-steps per update and the NaN guard on
    or off: every step's metrics on every rank, and on rank 0 the full
    params after each step (gathered)."""
    cfg = ViTConfig(**cfg_fields)
    model = pipeline.make_pipeline_apply(cfg, mesh,
                                         num_microbatches=num_microbatches)
    model.load_state_dict(rank_local_params(params, mesh))
    tx = optim.make_optimizer(TrainConfig(**train_fields), total_steps,
                              grad_accum_steps=grad_accum)
    state = api.shard_train_state(
        engine.TrainState.create(model=model, tx=tx, seed=seed), mesh)
    step = api.make_parallel_train_step(state, mesh, nan_guard=nan_guard)
    metrics, after = [], []
    for batch in batches:
        state, m = step(state, api.shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
        full = sharding.gather_state_dict(dict(model.named_parameters()),
                                          mesh)
        after.append(None if full is None else _np(full))
    return {"coords": dict(mesh.coords), "metrics": metrics,
            "params": after, "mini_step": state.opt_state.mini_step}


# ------------------------------------------------------ sequence parallelism
def _shard(x, mesh, heads: bool):
    """This rank's shard of a global ``[B, T, H, Dh]`` array: its data rows,
    its piece of the tokens, and with ``heads`` its model slice of the
    heads."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    t = t.chunk(mesh.shape["data"], 0)[mesh.coords["data"]]
    t = t.chunk(mesh.shape["seq"], 1)[mesh.coords["seq"]]
    if heads:
        t = t.chunk(mesh.shape["model"], 2)[mesh.coords["model"]]
    return t.contiguous()


def _attention_case(mesh, fn, case):
    """``fn(q, k, v)`` on the rank's shards of the case's global arrays,
    then the backward of ``(out * ct).sum()``: the rank's output and its
    dq, dk, dv."""
    heads = case.get("heads", False)
    dev = mesh.device
    qkv = [_shard(case[n], mesh, heads).to(dev).requires_grad_()
           for n in "qkv"]
    out = fn(*qkv)
    (out.float() * _shard(case["ct"], mesh, heads).to(dev)).sum().backward()
    return {"out": out.detach().float().cpu().numpy(),
            "grads": [a.grad.float().cpu().numpy() for a in qkv]}


def sp_attention(mesh, impl, cases):
    """Ring (``impl="ring"``) or Ulysses attention of each case (global
    ``q``, ``k``, ``v``, ``ct``; ``rate``/``seed`` of attention dropout;
    ``heads``: heads sharded over ``model``) through
    ``make_ring_attention``/``make_ulysses_attention``; ValueError messages
    are returned in place of a result."""
    from pytorch_vit_paper_replication_tpu_torch.parallel import (
        make_ring_attention, make_ulysses_attention)
    make = make_ring_attention if impl == "ring" else make_ulysses_attention
    results = []
    for case in cases:
        rate = case.get("rate", 0.0)
        fn = make(mesh, head_axis="model" if case.get("heads") else None,
                  dropout_rate=rate, dropout_seed=case.get("seed"),
                  deterministic=rate == 0.0)
        try:
            results.append(_attention_case(mesh, fn, case))
        except ValueError as e:
            results.append({"error": str(e)})
    return {"coords": dict(mesh.coords), "cases": results}


def sp_dispatch(mesh, sp_impl, cases):
    """``ops.attention.dot_product_attention`` inside ``sequence_parallel``
    for each case (as :func:`sp_attention`, plus ``mask``: a global mask
    ``[B, ...]`` whose batch rows the rank keeps): the rank's output,
    grads and the warnings the call raised."""
    import warnings

    from pytorch_vit_paper_replication_tpu_torch.ops.attention import (
        dot_product_attention, sequence_parallel)
    results = []
    for case in cases:
        mask = case.get("mask")
        if mask is not None:
            mask = torch.from_numpy(mask).chunk(
                mesh.shape["data"], 0)[mesh.coords["data"]].to(mesh.device)
        rate = case.get("rate", 0.0)

        def fn(q, k, v):
            return dot_product_attention(
                q, k, v, impl=case.get("impl", "auto"), mask=mask,
                dropout_rate=rate, seed=case.get("seed"),
                deterministic=rate == 0.0,
                heads_already_local=case.get("heads", False))
        with sequence_parallel(mesh, sp_impl=sp_impl), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = _attention_case(mesh, fn, case)
        res["warnings"] = [str(w.message) for w in caught]
        results.append(res)
    return {"coords": dict(mesh.coords), "cases": results}


def seq_steps(mesh, cfg_fields, params, batch, total_steps, train_fields,
              seed, sp_impl):
    """The parallel eval step on ``params``, then one parallel train step
    on ``batch`` with ``sp_impl`` on a seq mesh: the metrics of both on
    every rank, the gathered params after the step on rank 0, and the
    rank's dropout seeds of that step."""
    cfg = ViTConfig(**cfg_fields)
    model = pipeline.make_pipeline_apply(cfg, mesh, num_microbatches=1)
    model.load_state_dict(rank_local_params(params, mesh))
    tx = optim.make_optimizer(TrainConfig(**train_fields), total_steps)
    state = api.shard_train_state(
        engine.TrainState.create(model=model, tx=tx, seed=seed), mesh)
    local = api.shard_batch(batch, mesh)
    ev = api.make_parallel_eval_step(state, mesh, sp_impl=sp_impl)(state,
                                                                   local)
    step = api.make_parallel_train_step(state, mesh, sp_impl=sp_impl)
    state, m = step(state, local)
    full = sharding.gather_state_dict(dict(model.named_parameters()), mesh)
    return {"coords": dict(mesh.coords),
            "eval": {k: float(v) for k, v in ev.items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "params": _np(full) if mesh.rank == 0 else None,
            "seeds": pipeline.dropout_seeds(engine.step_generator(seed, 0),
                                            mesh, cfg.num_layers, 1)}


def assemble_sp(ranks, i, shape):
    """The global output and ``[dq, dk, dv]`` of case ``i`` from every
    rank's shard (the inverse of :func:`_shard`; the mesh sizes are read
    from the coordinates; the heads are taken as sharded over ``model``
    when a rank's shard holds fewer than ``shape[2]``)."""
    sizes = {a: 1 + max(r["coords"][a] for r in ranks)
             for a in ("data", "model", "seq")}
    b, t, h = shape[:3]
    tl = t // sizes["seq"]
    out = np.zeros(shape, np.float32)
    grads = [np.zeros(shape, np.float32) for _ in range(3)]
    for r in ranks:
        c, res = r["coords"], r["cases"][i]
        rows = slice(c["data"] * b // sizes["data"],
                     (c["data"] + 1) * b // sizes["data"])
        toks = slice(c["seq"] * tl, (c["seq"] + 1) * tl)
        hl = res["out"].shape[2]
        heads = slice(c["model"] * hl, (c["model"] + 1) * hl) if hl < h \
            else slice(None)
        out[rows, toks, heads] = res["out"]
        for g, part in zip(grads, res["grads"]):
            g[rows, toks, heads] = part
    return out, grads
