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
over ``pipe`` (only the first and last stage compute them), one over
``seq`` of every gradient upstream of the pooled all-reduce (embedding,
blocks, ``encoder_norm``: each seq rank holds a partial sum from its
tokens; the head's is whole on every seq rank and is not summed), one of
every gradient over ``data``, the clip norm over the whole unsharded
gradient (:func:`..optim.sharded_global_norm`; after the seq sum every seq
rank holds the same gradient, so no leaf counts twice), and the metrics
summed over ``data`` and ``pipe`` (never ``seq``: every seq rank computes
the same logits) so every rank returns the global ones. The optimizer
updates the local shards; its moments and its accumulator are elementwise,
so they are the single-device ones' slices.

On a ``seq`` axis > 1 both steps run the model inside
:func:`..ops.attention.sequence_parallel` with ``sp_impl`` (``"ring"`` or
``"ulysses"``), JAX's ``_with_seq_parallel``.

The step is JAX's ``engine.make_train_step`` on a mesh: label smoothing,
the NaN guard (one nonfinite flag reduced over every rank, so all ranks
skip the same step), the distillation objective (``teacher_logits`` is a
batch key like any other: sharded over ``data``, split per microbatch,
read by the loss on the last stage) and gradient accumulation (the
optimizer's ``optax.MultiSteps`` counterpart: each rank accumulates its
local shards; on the k-th micro-step the clip takes the sharded norm of
the accumulated mean). A model other than the pipelined ViT (TinyVGG)
trains on a data-only mesh: its full params on every rank, gradients
summed over ``data``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional

import torch

from ..engine import (TrainState, _to, cross_entropy_loss, distill_loss,
                      step_generator)
from ..ops.attention import sequence_parallel
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


def _data_only(mesh) -> bool:
    return all(mesh.shape[a] == 1 for a in ("model", "seq", "pipe"))


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """The rank's train state: the rank-local model (a
    :class:`.pipeline.PipelineViT` holding its slices, or on a data-only
    mesh any model holding the full params) and its optimizer state on
    ``mesh.device``."""
    model = state.model
    pipelined = isinstance(model, PipelineViT) and model.mesh is mesh
    if not pipelined and (isinstance(model, PipelineViT)
                          or not _data_only(mesh)):
        raise ValueError("shard_train_state needs the model of "
                         "make_pipeline_apply(cfg, mesh, ...) with the rank's "
                         "slices loaded (any model on a data-only mesh)")
    model.to(mesh.device)
    opt = state.opt_state
    for moments in (opt.mu, opt.nu, opt.acc):
        for name, t in moments.items():
            moments[name] = t.to(mesh.device)
    return TrainState(model=model, tx=state.tx, opt_state=opt,
                      seed=state.seed, step=state.step)


def _seq_parallel(mesh, sp_impl: str):
    """The sequence-parallel context on a ``seq`` axis > 1, else none."""
    if mesh.shape["seq"] > 1:
        return sequence_parallel(mesh, sp_impl=sp_impl)
    return contextlib.nullcontext()


def _reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = all_reduce(flat, group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _sync_grads(model, mesh) -> Dict[str, torch.Tensor]:
    """Every parameter's full-batch gradient on this rank: the replicated
    embedding and tail summed over ``pipe`` (zeros where a stage did not
    compute them), everything but the head summed over ``seq`` (each seq
    rank's share of its tokens), then everything summed over ``data``."""
    grads = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads[name] = p.grad
    if mesh.shape["pipe"] > 1:
        _reduce_flat([g for n, g in grads.items() if block_index(n) is None],
                     mesh.groups["pipe"])
    if mesh.shape["seq"] > 1:
        _reduce_flat([g for n, g in grads.items()
                      if not n.startswith("head.")], mesh.groups["seq"])
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
                             label_smoothing: float = 0.0,
                             nan_guard: bool = False,
                             sp_impl: str = "ring",
                             distill_alpha: Optional[float] = None,
                             distill_t: float = 1.0):
    """The train step ``(state, local batch) -> (state, metrics)`` on every
    rank: ``loss_sum``, ``correct``, ``count`` of the global batch and
    ``grad_norm`` (the unclipped global norm of this micro-step's
    gradient), plus ``teacher_agree`` when distilling and ``skipped`` with
    ``nan_guard``, equal on every rank. The keyword arguments are
    :func:`..engine.make_train_step`'s: a skipped step applies no update
    (params, optimizer state, accumulator and schedule position stay),
    adds zeros to the sums and still advances ``state.step``.
    ``sp_impl`` picks the sequence-parallel strategy on a ``seq`` axis > 1
    (``"ring"`` or ``"ulysses"``)."""
    model = state.model
    dev = mesh.device
    dp = mesh.shape["data"]
    pipelined = isinstance(model, PipelineViT)
    distill = distill_alpha is not None

    def objective(logits, rows):
        if distill:
            return distill_loss(logits, rows["teacher_logits"], rows["label"],
                                t=distill_t, alpha=distill_alpha,
                                label_smoothing=label_smoothing)
        return cross_entropy_loss(logits, rows["label"], label_smoothing)

    def train_step(state: TrainState, batch):
        model.train()
        b = _to(batch, dev)
        n_local = b["label"].shape[0]
        n_global = float(n_local * dp)
        for p in model.parameters():
            p.grad = None
        gen = step_generator(state.seed, state.step)
        targets = {k: b[k] for k in ("label", "teacher_logits") if k in b}

        def loss_fn(logits, rows):
            # The microbatch's share of the global-batch mean.
            return objective(logits, rows) * (rows["label"].shape[0]
                                              / n_global)

        if pipelined:
            seeds = dropout_seeds(gen, mesh, model.config.num_layers,
                                  model.num_microbatches)
            with _seq_parallel(mesh, sp_impl):
                out = model.forward_backward(b["image"], targets, seeds,
                                             loss_fn)
        else:
            logits = model(b["image"], gen)
            loss = loss_fn(logits, targets)
            loss.backward()
            out = [(logits.detach(), loss.detach())]
        zero = torch.zeros((), device=dev)
        metrics = {"loss_sum": zero, "correct": zero, "count": zero}
        if distill:
            metrics["teacher_agree"] = zero
        if out is not None:
            logits = torch.cat([o[0] for o in out])
            metrics = {
                "loss_sum": torch.stack([o[1] for o in out]).sum() * n_global,
                "correct": (logits.argmax(-1) == b["label"]).sum().float(),
                "count": torch.tensor(float(n_local), device=dev)}
            if distill:
                metrics["teacher_agree"] = (
                    logits.argmax(-1) == b["teacher_logits"].argmax(-1)
                ).sum().float()
        metrics = _global_metrics(metrics, mesh)
        grads = _sync_grads(model, mesh)
        metrics["grad_norm"] = sharded_global_norm(grads, mesh)
        ok = True
        if nan_guard:
            # One flag over every rank: each sees the same global loss and
            # norm, and the reduction makes the skip one decision anyway.
            bad = ~(torch.isfinite(metrics["loss_sum"])
                    & torch.isfinite(metrics["grad_norm"]))
            ok = not bool(all_reduce(bad.float(), None))
            metrics = {k: v if ok else torch.zeros_like(v)
                       for k, v in metrics.items()}
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0, device=dev)
        if ok:
            norm = metrics["grad_norm"]
            whole = (state.tx.accum == 1
                     and len(state.opt_state.mu) == len(grads))
            state.tx.apply(dict(model.named_parameters()), grads,
                           state.opt_state,
                           norm_fn=(lambda gs: norm) if whole else
                           (lambda gs: sharded_global_norm(gs, mesh)))
        for p in model.parameters():
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_parallel_eval_step(state: TrainState, mesh, *,
                            sp_impl: str = "ring"):
    """The eval step ``(state, local batch) -> metrics``: ``loss_sum``,
    ``correct`` and ``count`` over the global batch's ``mask = 1`` rows,
    equal on every rank. ``sp_impl``: as in the train step."""
    model = state.model
    dev = mesh.device

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model.eval()
        b = _to(batch, dev)
        with torch.no_grad(), _seq_parallel(mesh, sp_impl):
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
