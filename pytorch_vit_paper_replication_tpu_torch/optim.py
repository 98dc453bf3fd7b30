"""The ViT paper training recipe as one optimizer (port of JAX ``optim.py``).

The JAX package builds it as an optax chain; here it is one object with the
same order of operations, on the port's named parameters (``state_dict``
names, the Flax paths joined with dots):

1. ``optax.MultiSteps`` (``grad_accum_steps > 1``): the gradient is
   averaged over k micro-steps (Welford mean, as optax) and one update is
   applied on the k-th; the schedule and Adam count *applied* updates only.
2. clip by global norm, optax's formula: ``g * max_norm / norm`` when
   ``norm >= max_norm`` (no ``+1e-6`` as ``clip_grad_norm_`` adds);
3. coupled L2: ``g + weight_decay * p`` on the ``ndim > 1`` params
   (torch ``Adam(weight_decay=...)`` semantics, not AdamW);
4. Adam (``eps = 1e-8`` outside the square root, bias-corrected);
5. ``-lr(count)`` from :func:`make_lr_schedule`.

Frozen params (``trainable_label_fn`` returns ``"frozen"``) get no update and
no Adam state. All state is f32 on the params' device; the update runs as
``torch._foreach_*`` ops, the counterpart of the JAX chain being XLA code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .configs import TrainConfig

ADAM_EPS = 1e-8


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule`` at ``count``, in float32 as optax
    evaluates it (the warmup's first values are dominated by that
    rounding: ``(init - end) * 1 + end`` cancels)."""
    f32 = np.float32
    frac = f32(1.0) - f32(min(max(count, 0), steps)) / f32(steps)
    return float((f32(init) - f32(end)) * frac + f32(end))


def make_lr_schedule(cfg: TrainConfig,
                     total_steps: int) -> Callable[[int], float]:
    """Linear warmup (factor 1e-6 -> 1) then linear decay (1 -> 0):
    ``optax.join_schedules`` of two linear schedules, step for step;
    ``warmup_fraction = 0`` is decay only."""
    warmup_steps = int(cfg.warmup_fraction * total_steps)
    decay_steps = max(1, total_steps - warmup_steps)
    lr = cfg.learning_rate

    def schedule(count: int) -> float:
        if warmup_steps and count < warmup_steps:
            return _linear(lr * 1e-6, lr, warmup_steps, count)
        return _linear(lr, 0.0, decay_steps, count - warmup_steps)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all elements of ``tensors``, as
    an f32 scalar. Each leaf's norm comes out in f64: PyTorch's f32 norm on
    the CPU accumulates serially and is off by ~4e-5 relative at 2.4M
    elements (one B/16 fc1 kernel), where XLA's reduction is exact to f32."""
    norms = torch._foreach_norm([t.float() for t in tensors], 2,
                                dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def sharded_global_norm(grads: Mapping[str, torch.Tensor],
                        mesh) -> torch.Tensor:
    """:func:`global_norm` of the whole unsharded gradient, from one rank's
    local gradients on a dp x tp x pp ``mesh`` (collective over its
    ``model`` and ``pipe`` groups). Squares are summed in f64: a leaf
    sharded over ``model`` (its TP rule names the axis) is summed over
    ``model`` and ``pipe``; the other encoder-block leaves (LayerNorms, the
    replicated out/fc2 biases) over ``pipe`` only, as each stage owns its
    layers; the replicated embedding and tail count once. A per-rank norm
    would clip each shard by a different factor."""
    from .parallel.collectives import all_reduce
    from .parallel.sharding import block_index, pspec_for_path

    names = list(grads)
    sq = torch.stack(torch._foreach_norm(
        [grads[n].float() for n in names], 2, dtype=torch.float64)).square()
    kinds = torch.tensor([0 if block_index(n) is None else
                          2 if "model" in pspec_for_path(n) else 1
                          for n in names], device=sq.device)
    once, staged, sharded = (sq[kinds == k].sum() for k in range(3))
    if mesh.shape["model"] > 1:
        sharded = all_reduce(sharded, mesh.groups["model"])
    staged = staged + sharded
    if mesh.shape["pipe"] > 1:
        staged = all_reduce(staged, mesh.groups["pipe"])
    return torch.sqrt(once + staged).float()


def decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True for params that receive weight decay: ``ndim > 1``. The
    port's pipeline keeps one module per layer (no stacked ``[L]`` axis),
    so this rule also holds there, where the JAX package needs
    ``pipeline_decay_mask``; a tensor-parallel slice has its full
    parameter's ``ndim``."""
    return {name: p.ndim > 1 for name, p in params.items()}


def head_only_label_fn(path: tuple) -> str:
    """Freeze everything except the classifier head (``head.*``)."""
    return "train" if path and path[0] == "head" else "frozen"


@dataclasses.dataclass
class OptState:
    """Adam moments and the MultiSteps accumulator of the trainable params;
    ``count`` is the number of applied updates (Adam's and the schedule's
    step), ``mini_step`` the position inside an accumulation group."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]
    mini_step: int = 0


class RecipeOptimizer:
    """The recipe's transformation; ``init`` makes its state for a set of
    named params, ``apply`` updates them in place from their gradients."""

    def __init__(self, cfg: TrainConfig, total_steps: int, *,
                 trainable_label_fn: Optional[Callable[[tuple], str]] = None,
                 grad_accum_steps: int = 1):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, total_steps)
        self.label_fn = trainable_label_fn
        self.accum = max(1, int(grad_accum_steps))

    def trainable(self, name: str) -> bool:
        return (self.label_fn is None
                or self.label_fn(tuple(name.split("."))) == "train")

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        train = {n: p for n, p in params.items() if self.trainable(n)}

        def zeros():
            return {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in train.items()}
        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc=zeros() if self.accum > 1 else {})

    @torch.no_grad()
    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor], state: OptState, *,
              norm_fn: Optional[Callable[[Dict[str, torch.Tensor]],
                                         torch.Tensor]] = None) -> bool:
        """One (micro-)step; returns whether params were updated.
        ``norm_fn(named gradients)`` gives the clip's norm of the trainable
        gradient the update applies (with accumulation the accumulated
        mean, on the k-th micro-step only): a sharded step passes the norm
        of the unsharded gradient (:func:`sharded_global_norm`); default
        :func:`global_norm`."""
        names = list(state.mu)
        gs = [grads[n].float() for n in names]
        if self.accum > 1:
            acc = [state.acc[n] for n in names]
            # Welford mean, optax.MultiSteps: acc + (g - acc) / (n + 1).
            delta = torch._foreach_sub(gs, acc)
            torch._foreach_div_(delta, state.mini_step + 1)
            torch._foreach_add_(acc, delta)
            if state.mini_step < self.accum - 1:
                state.mini_step += 1
                return False
            gs = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state.mini_step = 0
        cfg = self.cfg
        norm = (global_norm(gs) if norm_fn is None
                else norm_fn(dict(zip(names, gs))))
        clipped = [torch.where(norm < cfg.grad_clip_norm, g,
                               g / norm * cfg.grad_clip_norm) for g in gs]
        mask = decay_mask({n: params[n] for n in names})
        decay = [i for i, n in enumerate(names) if mask[n]]
        if decay and cfg.weight_decay:
            torch._foreach_add_([clipped[i] for i in decay],
                                [params[names[i]].float() for i in decay],
                                alpha=cfg.weight_decay)
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, cfg.beta1)
        torch._foreach_add_(mu, clipped, alpha=1.0 - cfg.beta1)
        torch._foreach_mul_(nu, cfg.beta2)
        torch._foreach_addcmul_(nu, clipped, clipped, value=1.0 - cfg.beta2)
        lr = self.schedule(state.count)
        state.count += 1
        bc1 = 1.0 - cfg.beta1 ** state.count
        bc2 = 1.0 - cfg.beta2 ** state.count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_([params[n] for n in names], upd)
        return True


def make_optimizer(cfg: TrainConfig, total_steps: int, *,
                   trainable_label_fn: Optional[Callable[[tuple], str]] = None,
                   grad_accum_steps: int = 1) -> RecipeOptimizer:
    """The full training-recipe transformation (see the module docstring).
    ``total_steps`` counts optimizer *updates*: with accumulation, divide
    the micro-step count by ``grad_accum_steps``."""
    return RecipeOptimizer(cfg, total_steps,
                           trainable_label_fn=trainable_label_fn,
                           grad_accum_steps=grad_accum_steps)
