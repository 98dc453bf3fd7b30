"""Training engine: the train/eval steps and the epoch loop (port of the
JAX ``engine.py``).

* :func:`make_train_step` returns ``(state, batch) -> (state, metrics)``:
  forward in training mode with dropout seeds drawn from a generator seeded
  by ``(state.seed, state.step)`` (the counterpart of JAX's
  ``fold_in(state.rng, step)``), backward through the hand-written kernels'
  ``autograd.Function``s on CUDA, then one :class:`..optim.RecipeOptimizer`
  update. Metrics stay on the device as running sums (``loss_sum``,
  ``correct``, ``count``, ``grad_norm`` = the global norm of the raw
  gradient before clipping) and are fetched once per epoch.
* Accuracy and loss are example-weighted; eval uses the masked metrics of
  padded batches.
* :func:`train` returns the reference ``engine.train`` results dict.

The step updates ``state`` in place (PyTorch params are mutable) and returns
it. Batches are dicts of numpy arrays or tensors: ``image`` ``[B, H, W, C]``
float, ``label`` ``[B]`` int, optionally ``mask`` (eval) and
``teacher_logits`` (distillation); the step moves them to the model's
device.

:func:`train` logs per-epoch rows to a :class:`..metrics.MetricsLogger`,
saves through a :class:`..checkpoint.Checkpointer`, records step spans
through a :class:`..telemetry.StepTelemetry` (with its watchdog and
profiler capture windows) and traces its first epoch with
``profile_dir``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .optim import OptState, RecipeOptimizer, global_norm

Batch = Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    """Model, optimizer and its state, the dropout seed and the step."""

    model: nn.Module
    tx: RecipeOptimizer
    opt_state: OptState
    seed: int
    step: int = 0

    @classmethod
    def create(cls, *, model: nn.Module, tx: RecipeOptimizer,
               seed: int) -> "TrainState":
        return cls(model=model, tx=tx,
                   opt_state=tx.init(dict(model.named_parameters())),
                   seed=int(seed))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step: seeded from ``(seed, step)``."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, step]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy in f32; label smoothing with optax's
    ``smooth_labels`` (``(1 - a) * onehot + a / C``)."""
    logits = logits.float()
    if label_smoothing > 0.0:
        c = logits.shape[-1]
        target = (F.one_hot(labels, c).float() * (1.0 - label_smoothing)
                  + label_smoothing / c)
        losses = -(target * F.log_softmax(logits, -1)).sum(-1)
    else:
        losses = F.cross_entropy(logits, labels, reduction="none")
    return losses.mean()


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 labels: torch.Tensor, *, t: float = 1.0, alpha: float = 0.5,
                 label_smoothing: float = 0.0) -> torch.Tensor:
    """Hinton distillation in f32: ``(1 - alpha) * CE + alpha * t^2 *
    KL(softmax(teacher / t) || softmax(student / t))``; ``alpha = 0`` is
    the plain CE, ``alpha = 1`` the soft term alone."""
    t, alpha = float(t), float(alpha)
    if alpha == 0.0:
        return cross_entropy_loss(student_logits, labels, label_smoothing)
    log_s = F.log_softmax(student_logits.float() / t, -1)
    log_t = F.log_softmax(teacher_logits.float() / t, -1)
    soft = (t * t) * (log_t.exp() * (log_t - log_s)).sum(-1).mean()
    if alpha == 1.0:
        return soft
    hard = cross_entropy_loss(student_logits, labels, label_smoothing)
    return (1.0 - alpha) * hard + alpha * soft


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to(batch: Batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v) for k, v in batch.items()}
    out["label"] = out["label"].long()
    return {k: v.to(dev, non_blocking=True) for k, v in out.items()}


def make_train_step(label_smoothing: float = 0.0, nan_guard: bool = False,
                    distill_alpha: Optional[float] = None,
                    distill_t: float = 1.0):
    """Build the train step ``(state, batch) -> (state, metrics)``.

    ``distill_alpha`` (not None) trains on :func:`distill_loss` against
    ``batch["teacher_logits"]`` and adds ``teacher_agree`` to the metrics.
    ``nan_guard``: a step whose loss or gradient norm is nonfinite applies
    no update (params, optimizer state and schedule position stay), adds
    zeros to the sums and reports ``skipped = 1``; ``state.step`` still
    advances.
    """

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        model = state.model
        model.train()
        b = _to(batch, _device(model))
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        logits = model(b["image"], step_generator(state.seed, state.step))
        if distill_alpha is not None:
            loss = distill_loss(logits, b["teacher_logits"], b["label"],
                                t=distill_t, alpha=distill_alpha,
                                label_smoothing=label_smoothing)
        else:
            loss = cross_entropy_loss(logits, b["label"], label_smoothing)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        logits = logits.detach()
        n = float(b["label"].shape[0])
        metrics = {
            "loss_sum": loss.detach() * n,
            "correct": (logits.argmax(-1) == b["label"]).sum().float(),
            "count": torch.tensor(n, device=logits.device),
            "grad_norm": global_norm(grads.values()),
        }
        if distill_alpha is not None:
            metrics["teacher_agree"] = (
                logits.argmax(-1) == b["teacher_logits"].argmax(-1)
            ).sum().float()
        ok = True
        if nan_guard:
            # Host sync: whether to apply the update is decided on the
            # host, so the step waits here for the loss and the norm.
            ok = bool(torch.isfinite(loss) & torch.isfinite(
                metrics["grad_norm"]))
            metrics = {k: v if ok else torch.zeros_like(v)
                       for k, v in metrics.items()}
            metrics["skipped"] = torch.tensor(0.0 if ok else 1.0,
                                              device=logits.device)
        if ok:
            state.tx.apply(params, grads, state.opt_state)
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step():
    """Build the eval step ``(state, batch) -> metrics``: plain CE (no
    label smoothing), example-weighted over the ``mask = 1`` rows."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        model.eval()
        b = _to(batch, _device(model))
        with torch.inference_mode():
            logits = model(b["image"]).float()
            labels = b["label"]
            losses = F.cross_entropy(logits, labels, reduction="none")
            mask = b.get("mask")
            mask = (torch.ones_like(losses) if mask is None
                    else mask.float())
            return {"loss_sum": (losses * mask).sum(),
                    "correct": ((logits.argmax(-1) == labels) * mask).sum(),
                    "count": mask.sum()}

    return eval_step


def _accumulate(total: Optional[Dict], m: Dict) -> Dict:
    if total is None:
        return dict(m)
    return {k: total[k] + m[k] for k in total}


def _finalize(total: Dict[str, torch.Tensor],
              steps: int = 0) -> Dict[str, float]:
    """One device fetch, then example-weighted means; a summed
    ``grad_norm`` becomes a mean over applied (non-skipped) steps."""
    keys = list(total)
    vals = dict(zip(keys, torch.stack([total[k].float()
                                       for k in keys]).tolist()))
    n = max(vals["count"], 1.0)
    out = {"loss": vals["loss_sum"] / n, "acc": vals["correct"] / n,
           "count": n, "skipped": vals.get("skipped", 0.0)}
    if steps and "grad_norm" in vals:
        out["grad_norm"] = vals["grad_norm"] / max(steps - out["skipped"],
                                                   1.0)
    if "teacher_agree" in vals:
        out["teacher_agree"] = vals["teacher_agree"] / n
    return out


_EMPTY = {"loss": 0.0, "acc": 0.0, "count": 0.0, "skipped": 0.0}


def evaluate(state: TrainState, eval_batches: Callable[[], Iterable[Batch]],
             *, eval_step: Optional[Callable] = None,
             on_batch: Optional[Callable[[], None]] = None
             ) -> Dict[str, float]:
    """One pass over ``eval_batches``: example-weighted loss/accuracy.
    ``on_batch()`` is called after each batch (the watchdog's heartbeat,
    so a long eval pass reads as progress, not a stall)."""
    eval_step = eval_step or make_eval_step()
    total = None
    for batch in eval_batches():
        total = _accumulate(total, eval_step(state, batch))
        if on_batch is not None:
            on_batch()
    return _finalize(total) if total else dict(_EMPTY)


def train(state: TrainState, train_batches: Callable[[], Iterable[Batch]],
          eval_batches: Callable[[], Iterable[Batch]], *, epochs: int,
          train_step: Optional[Callable] = None,
          eval_step: Optional[Callable] = None, logger=None,
          checkpointer=None, verbose: bool = True,
          profile_dir: Optional[str] = None, start_epoch: int = 0,
          checkpoint_every_steps: int = 0,
          checkpoint_every_epochs: int = 1,
          lr_schedule: Optional[Callable[[int], float]] = None,
          telemetry=None,
          stop_check: Optional[Callable[[int], bool]] = None,
          batch_shards: int = 1) -> Tuple[TrainState, Dict[str, list]]:
    """The epoch loop (reference ``engine.train``): per epoch the train
    steps, then one eval pass; returns ``(state, {"train_loss", "train_acc",
    "test_loss", "test_acc"})``.

    ``logger`` (a :class:`..metrics.MetricsLogger`) gets one row per epoch
    with the JAX loop's keys: ``step``, ``epoch``, ``train_loss``,
    ``train_acc``, ``test_loss``, ``test_acc``, ``images_per_sec``, plus
    ``grad_norm``, ``skipped_steps`` (when the nan-guard skipped any),
    ``lr`` (with ``lr_schedule``, a ``micro_step -> lr`` callable: the
    end-of-epoch learning rate), ``teacher_agree`` (distillation: the
    share of train examples whose argmax is the teacher's; the JAX loop
    prints it but logs no such key) and ``time_to_first_step`` on the first
    epoch (process start to the first step applied, with a one-off
    device barrier). ``checkpointer`` (a :class:`..checkpoint.
    Checkpointer`) saves every ``checkpoint_every_steps`` micro-steps (0 =
    off) and every ``checkpoint_every_epochs`` epochs; the final epoch
    always saves. Mid-epoch resume is the loader's job
    (``DataLoader.epoch`` / ``skip_next_batches``), never this loop's.
    ``stop_check(global_step)`` is called after every step; True stops at
    that step without the partial epoch's eval. ``start_epoch`` continues
    the printed and logged epoch numbers.

    ``telemetry`` (a :class:`..telemetry.StepTelemetry`) splits every
    step into data-wait (blocked on the batch iterator) and dispatch +
    device seconds, waits on the card every ``telemetry.sample_every``
    steps so the split is honest, records the checkpoint and eval spans,
    beats its watchdog on every step, span and eval batch, opens its
    profiler's capture windows before a step's dispatch, and closes each
    epoch with a goodput summary row. ``profile_dir`` traces the first
    epoch with ``torch.profiler`` (``metrics.profile_trace``). With
    neither, their only cost is two clock reads a step. On a mesh each
    batch is a rank's ``data`` slice: ``batch_shards`` (the data axis
    size) makes telemetry count the global batch's images."""
    from .compile_cache import seconds_since_process_start
    from .metrics import block_until_ready, profile_trace

    train_step = train_step or make_train_step()
    eval_step = eval_step or make_eval_step()
    results = {"train_loss": [], "train_acc": [], "test_loss": [],
               "test_acc": []}
    global_step = state.step
    time_to_first_step = None
    for epoch in range(epochs):
        t0 = time.perf_counter()
        epoch_no = start_epoch + epoch + 1
        total, steps, stopped = None, 0, False
        with profile_trace(profile_dir or "",
                           enabled=profile_dir is not None and epoch == 0):
            batches = iter(train_batches())
            while True:
                t_wait = time.perf_counter()
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                t_step = time.perf_counter()
                if telemetry is not None:
                    # Opens an armed capture window before the dispatch.
                    telemetry.step_begin(global_step + 1)
                state, metrics = train_step(state, batch)
                blocked = False
                if telemetry is not None and telemetry.should_block():
                    # Sampled honesty barrier: the launches return before
                    # the card finishes, so only a step that waits for it
                    # measures it.
                    block_until_ready(metrics["loss_sum"])
                    blocked = True
                if time_to_first_step is None:
                    block_until_ready(metrics["loss_sum"])
                    blocked = True
                    time_to_first_step = seconds_since_process_start()
                    if verbose:
                        print(f"time_to_first_step: "
                              f"{time_to_first_step:.2f}s (process start "
                              f"-> first train step applied)")
                total = _accumulate(total, metrics)
                steps += 1
                global_step += 1
                if telemetry is not None:
                    telemetry.step(
                        data_wait_s=t_step - t_wait,
                        exec_s=time.perf_counter() - t_step,
                        images=int(batch["label"].shape[0]) * batch_shards,
                        step=global_step, epoch=epoch_no, blocked=blocked)
                if (checkpoint_every_steps and checkpointer is not None
                        and global_step % checkpoint_every_steps == 0):
                    _save(checkpointer, state, telemetry)
                if stop_check is not None and stop_check(global_step):
                    stopped = True
                    break
        if stopped:
            break
        train_m = _finalize(total, steps) if total else dict(_EMPTY)
        train_time = time.perf_counter() - t0
        if train_m["skipped"] and verbose:
            print(f"[warn] nan-guard skipped {int(train_m['skipped'])} "
                  f"nonfinite update(s) this epoch")
        t_ev = time.perf_counter()
        eval_m = evaluate(
            state, eval_batches, eval_step=eval_step,
            on_batch=telemetry.heartbeat if telemetry is not None else None)
        if telemetry is not None:
            telemetry.span("eval", time.perf_counter() - t_ev)
        results["train_loss"].append(train_m["loss"])
        results["train_acc"].append(train_m["acc"])
        results["test_loss"].append(eval_m["loss"])
        results["test_acc"].append(eval_m["acc"])
        img_per_sec = train_m["count"] / max(train_time, 1e-9)
        if "teacher_agree" in train_m:
            # Distillation: the blended loss and the student's agreement
            # with the teacher's argmax, on the process registry.
            from .telemetry import get_registry
            reg = get_registry()
            reg.gauge("distill_loss", round(train_m["loss"], 6))
            reg.gauge("distill_teacher_agree_frac",
                      round(train_m["teacher_agree"], 6))
        if verbose:
            agree = (f" | teacher_agree: {train_m['teacher_agree']:.4f}"
                     if "teacher_agree" in train_m else "")
            print(f"Epoch: {epoch_no} | "
                  f"train_loss: {train_m['loss']:.4f} | "
                  f"train_acc: {train_m['acc']:.4f} | "
                  f"test_loss: {eval_m['loss']:.4f} | "
                  f"test_acc: {eval_m['acc']:.4f} | "
                  f"img/s: {img_per_sec:.1f}{agree}")
        if logger is not None:
            extra = {}
            if "teacher_agree" in train_m:
                extra["teacher_agree"] = train_m["teacher_agree"]
            if "grad_norm" in train_m:
                extra["grad_norm"] = train_m["grad_norm"]
            if train_m["skipped"]:
                extra["skipped_steps"] = train_m["skipped"]
            if lr_schedule is not None:
                extra["lr"] = float(lr_schedule(state.step))
            if epoch == 0 and time_to_first_step is not None:
                extra["time_to_first_step"] = round(time_to_first_step, 3)
            logger.log(step=state.step, epoch=epoch_no,
                       train_loss=train_m["loss"], train_acc=train_m["acc"],
                       test_loss=eval_m["loss"], test_acc=eval_m["acc"],
                       images_per_sec=img_per_sec, **extra)
        if checkpointer is not None and (
                epoch_no % max(1, checkpoint_every_epochs) == 0
                or epoch == epochs - 1):
            _save(checkpointer, state, telemetry)
        if telemetry is not None:
            telemetry.epoch_end(epoch=epoch_no, step=global_step)
    if checkpointer is not None:
        checkpointer.wait()
    return state, results


def _save(checkpointer, state: TrainState, telemetry) -> None:
    """One checkpoint save; with telemetry, the host's blocked seconds as a
    ``checkpoint`` span (an async save blocks for its snapshot, and for
    the previous save if that is still being written)."""
    t_ck = time.perf_counter()
    checkpointer.save(state)
    if telemetry is not None:
        telemetry.span("checkpoint", time.perf_counter() - t_ck)
