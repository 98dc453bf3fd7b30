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
