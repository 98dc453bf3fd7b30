"""The distributed train and eval steps (the port of the JAX package's
``parallel/api.py``).

Usage, on every rank (``spawn`` starts the ranks and passes each its
mesh)::

    model = make_pipeline_apply(cfg, mesh, num_microbatches=M)
    model.load_state_dict(convert.rank_local_params(params, mesh))
    state = shard_train_state(TrainState.create(model=model, tx=tx,
                                                seed=seed), mesh)
    step = make_parallel_train_step(state, mesh)
    for batch in batches:                  # global batches, as in JAX
        state, metrics = step(state, shard_batch(batch, mesh))

What GSPMD inserts in the JAX package is explicit here: the tensor-parallel
all-reduces inside the blocks, the pipeline's point-to-point transfers,
then per step one all-reduce of the replicated embedding/tail gradients
over ``pipe`` (only the first and last stage compute them), one of every
gradient over ``data``, the clip norm over the whole unsharded gradient
(:func:`..optim.sharded_global_norm`), and the metrics summed over
``data`` and ``pipe`` so every rank returns the global ones. The optimizer
updates the local shards; its moments are elementwise, so they are the
single-device moments' slices.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..engine import TrainState, _to, cross_entropy_loss, step_generator
from ..optim import sharded_global_norm
from .collectives import all_reduce
from .pipeline import PipelineViT, dropout_seeds
from .sharding import block_index


def shard_batch(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """The rank's ``data`` slice of a global batch: rows ``[i * b / dp,
    (i + 1) * b / dp)`` of every key, as JAX's ``P("data")`` places them."""
    dp, i = mesh.shape["data"], mesh.coords["data"]
    out = {}
    for key, val in batch.items():
        n = len(val)
        if n % dp:
            raise ValueError(f"batch[{key!r}] has {n} rows, not divisible "
                             f"by the data axis size {dp}")
        out[key] = val[i * n // dp:(i + 1) * n // dp]
    return out


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """The rank's train state: the rank-local model (a
    :class:`.pipeline.PipelineViT` holding its slices) and its optimizer
    state on ``mesh.device``. The parallel step hands the optimizer the
    clip norm of the whole unsharded gradient; it takes no gradient
    accumulation (``grad_accum_steps > 1`` raises)."""
    model = state.model
    if not isinstance(model, PipelineViT) or model.mesh is not mesh:
        raise ValueError("shard_train_state needs the model of "
                         "make_pipeline_apply(cfg, mesh, ...) with the rank's "
                         "slices loaded")
    if state.tx.accum > 1:
        raise NotImplementedError("the parallel train step takes no "
                                  "gradient accumulation (grad_accum_steps "
                                  f"= {state.tx.accum})")
    model.to(mesh.device)
    opt = state.opt_state
    for moments in (opt.mu, opt.nu, opt.acc):
        for name, t in moments.items():
            moments[name] = t.to(mesh.device)
    return TrainState(model=model, tx=state.tx, opt_state=opt,
                      seed=state.seed, step=state.step)


def _reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(flat, group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _sync_grads(model: PipelineViT, mesh) -> Dict[str, torch.Tensor]:
    """Every parameter's full-batch gradient on this rank: the replicated
    embedding and tail summed over ``pipe`` (zeros where a stage did not
    compute them), then everything summed over ``data``."""
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[name] = p.grad
    if mesh.shape["pipe"] > 1:
        _reduce_flat([g for n, g in grads.items() if block_index(n) is None],
                     mesh.groups["pipe"])
    if mesh.shape["data"] > 1:
        _reduce_flat(list(grads.values()), mesh.groups["data"])
    return grads


def _global_metrics(metrics: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, torch.Tensor]:
    """Sums over ``pipe`` (only the last stage has nonzero metrics) and
    ``data``."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    for axis in ("pipe", "data"):
        if mesh.shape[axis] > 1:
            vals = all_reduce(vals, mesh.groups[axis])
    return dict(zip(keys, vals))


def make_parallel_train_step(state: TrainState, mesh, *,
                             label_smoothing: float = 0.0):
    """The train step ``(state, local batch) -> (state, metrics)`` on every
    rank: ``loss_sum``, ``correct``, ``count`` of the global batch and
    ``grad_norm`` (the unclipped global norm), equal on every rank."""
    model = state.model
    cfg = model.config
    dev = mesh.device
    dp = mesh.shape["data"]

    def train_step(state: TrainState, batch):
        model.train()
        b = _to(batch, dev)
        n_local = b["label"].shape[0]
        n_global = float(n_local * dp)
        for p in model.parameters():
            p.grad = None
        gen = step_generator(state.seed, state.step)
        seeds = dropout_seeds(gen, mesh, cfg.num_layers,
                              model.num_microbatches)

        def loss_fn(logits, labels):
            # The microbatch's share of the global-batch mean.
            return cross_entropy_loss(logits, labels, label_smoothing) * (
                labels.shape[0] / n_global)

        out = model.forward_backward(b["image"], b["label"], seeds, loss_fn)
        zero = torch.zeros((), device=dev)
        metrics = {"loss_sum": zero, "correct": zero, "count": zero}
        if out is not None:
            logits = torch.cat([o[0] for o in out])
            metrics = {
                "loss_sum": torch.stack([o[1] for o in out]).sum() * n_global,
                "correct": (logits.argmax(-1) == b["label"]).sum().float(),
                "count": torch.tensor(float(n_local), device=dev)}
        metrics = _global_metrics(metrics, mesh)
        grads = _sync_grads(model, mesh)
        metrics["grad_norm"] = sharded_global_norm(grads, mesh)
        trainable = state.opt_state.mu
        clip_norm = (metrics["grad_norm"] if len(trainable) == len(grads)
                     else sharded_global_norm(
                         {n: grads[n] for n in trainable}, mesh))
        state.tx.apply(dict(model.named_parameters()), grads,
                       state.opt_state, norm=clip_norm)
        for p in model.parameters():
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_parallel_eval_step(state: TrainState, mesh):
    """The eval step ``(state, local batch) -> metrics``: ``loss_sum``,
    ``correct`` and ``count`` over the global batch's ``mask = 1`` rows,
    equal on every rank."""
    model = state.model
    dev = mesh.device

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.eval()
        b = _to(batch, dev)
        logits = model(b["image"])
        zero = torch.zeros((), device=dev)
        metrics = {"loss_sum": zero, "correct": zero, "count": zero}
        if logits is not None:
            labels = b["label"]
            losses = torch.nn.functional.cross_entropy(
                logits.float(), labels, reduction="none")
            mask = b.get("mask")
            mask = torch.ones_like(losses) if mask is None else mask.float()
            metrics = {"loss_sum": (losses * mask).sum(),
                       "correct": ((logits.argmax(-1) == labels)
                                   * mask).sum(),
                       "count": mask.sum()}
        return _global_metrics(metrics, mesh)

    return eval_step
