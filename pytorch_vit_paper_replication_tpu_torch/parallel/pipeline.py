"""Pipeline parallelism — GPipe microbatching of the ViT encoder stack,
composed with tensor and data parallelism.

The counterpart of the JAX package's ``parallel/pipeline.py``. The
``num_layers`` encoder blocks are split into ``pipe`` stages of ``L / pipe``
contiguous layers; each rank holds its stage's blocks (one module per layer,
named as in the standard model, so ``state_dict`` names are unchanged) and
runs a GPipe schedule with explicit point-to-point transfers: the forward
of all ``M`` microbatches (stage ``s`` receives each activation from stage
``s - 1`` and sends its output to ``s + 1``), then the backward in reverse
order (activation gradients flow back the same way). JAX computes the
schedule as ``M + S - 1`` ticks with ``ppermute``; the order of work per
stage is the same, the bubble is not modelled here.

With a ``model`` axis > 1 every block is built from a head-local config
(``num_heads / tp`` heads, ``mlp_size / tp`` hidden, ``head_dim_override``)
and runs Megatron tensor parallelism over the mesh's ``model`` group
(``models/vit.py``, ``tp``). The patch embedding and the tail (final
LayerNorm, pooling, head — JAX ``apply_tail``) are replicated on every
stage as in JAX; stage 0 runs the embedding and the last stage the tail,
and the step all-reduces their gradients over ``pipe`` so every stage holds
the same (:mod:`.api`).

Dropout: one seed per (data rank, microbatch) for the embedding and per
(data rank, global layer, microbatch) for each block's attention and MLP,
drawn from the step's generator (:func:`dropout_seeds`): equal on every
rank of a tensor-parallel group (its tensors are replicated and must be
dropped alike), distinct across data ranks and microbatches. The bits
cannot match JAX's ``fold_in`` stream. Remat checkpoints each block with
``torch.utils.checkpoint`` and the same seeds, so the recomputation
drops the same elements.

Layouts: :func:`stack_block_params` / :func:`unstack_block_params` convert
a ``state_dict`` between the standard layout and the JAX pipeline layout
(``encoder_blocks.*`` with a leading ``[L]`` axis), so JAX pipeline trees
convert too (:func:`..convert.rank_local_params`).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs import ViTConfig
from ..models.vit import (Dense, LayerNorm, PatchEmbedding,
                          TransformerEncoderBlock, _dtype, pool_tokens)
from .collectives import recv, send
from .sharding import (BLOCKS_KEY, block_index, stage_layers,
                       validate_mesh_for_config, validate_tp_divisibility)

_PREFIX = "backbone.encoder_block_"


def stack_block_params(state: Mapping[str, torch.Tensor],
                       num_layers: int) -> Dict[str, torch.Tensor]:
    """Standard layout -> pipeline layout: every
    ``backbone.encoder_block_{i}.<leaf>`` becomes one
    ``encoder_blocks.<leaf>`` with a leading ``[L]`` layer axis."""
    out, blocks = {}, {}
    for name, t in state.items():
        i = block_index(name)
        if i is None:
            out[name] = t
        else:
            leaf = name.split(".", 2)[2]
            blocks.setdefault(leaf, [None] * num_layers)[i] = t
    for leaf, ts in blocks.items():
        out[f"{BLOCKS_KEY}.{leaf}"] = torch.stack(ts)
    return out


def unstack_block_params(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_block_params`."""
    out = {}
    for name, t in state.items():
        if name.startswith(BLOCKS_KEY + "."):
            leaf = name[len(BLOCKS_KEY) + 1:]
            for i in range(t.shape[0]):
                out[f"{_PREFIX}{i}.{leaf}"] = t[i]
        else:
            out[name] = t
    return out


def validate_pipeline(cfg, mesh, num_microbatches: int,
                      batch_size: int) -> None:
    """Divisibility/compat checks, with the JAX package's messages."""
    stages = mesh.shape.get("pipe", 1)
    if stages <= 1:
        return
    if mesh.shape.get("seq", 1) != 1:
        raise ValueError(
            "pipeline parallelism does not compose with sequence "
            "parallelism (inside the pipeline's shard_map the ring's "
            "collectives would nest; shard long sequences with --mesh-seq "
            "without --mesh-pipe)")
    if mesh.shape.get("model", 1) > 1:
        validate_tp_divisibility(cfg, mesh)
    if cfg.num_layers % stages != 0:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by the pipe axis "
            f"size {stages}")
    per_shard = batch_size // mesh.shape.get("data", 1)
    if num_microbatches < 1 or per_shard % num_microbatches != 0:
        raise ValueError(
            f"per-data-shard batch {per_shard} not divisible by "
            f"num_microbatches={num_microbatches}")


def dropout_seeds(gen: torch.Generator, mesh, num_layers: int,
                  num_microbatches: int) -> List[List[int]]:
    """This rank's int32 dropout seeds, ``[M][1 + 2 L]``: per microbatch
    the embedding seed, then (attention, MLP) per global layer. Every rank
    draws the same ``[data, M, 1 + 2 L]`` block from ``gen`` and keeps its
    data row."""
    seeds = torch.randint(-2**31, 2**31, (mesh.shape["data"],
                                          num_microbatches,
                                          1 + 2 * num_layers),
                          generator=gen)
    return seeds[mesh.coords["data"]].tolist()


class PipelineViT(nn.Module):
    """The rank-local ViT of a dp x tp x pp mesh: the replicated patch
    embedding and tail, and this stage's tensor-parallel encoder blocks.
    Parameter names are the standard model's (a subset of its blocks);
    load the rank's slices with :func:`..parallel.sharding.shard_state_dict`
    or :func:`..convert.rank_local_params`."""

    def __init__(self, cfg: ViTConfig, mesh, num_microbatches: int):
        super().__init__()
        tp = mesh.shape["model"]
        self.config = cfg
        self.mesh = mesh
        self.num_microbatches = num_microbatches
        self.layers = stage_layers(cfg.num_layers, mesh)
        self.stage = mesh.coords["pipe"]
        self.stages = mesh.shape["pipe"]
        block_cfg = cfg
        if tp > 1:
            block_cfg = cfg.replace(num_heads=cfg.num_heads // tp,
                                    mlp_size=cfg.mlp_size // tp,
                                    head_dim_override=cfg.head_dim)
        group = mesh.groups["model"] if tp > 1 else None
        self.backbone = nn.Module()
        self.backbone.patch_embedding = PatchEmbedding(cfg)
        for i in self.layers:
            self.backbone.add_module(f"encoder_block_{i}",
                                     TransformerEncoderBlock(block_cfg,
                                                             tp=group))
        self.backbone.encoder_norm = LayerNorm(cfg.embedding_dim,
                                               cfg.ln_epsilon, _dtype(cfg))
        self.head = Dense((cfg.embedding_dim,), (cfg.num_classes,),
                          torch.float32)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def _stage(self, x: torch.Tensor, seeds: Sequence[Optional[int]],
               remat: bool) -> torch.Tensor:
        """This stage's work on one microbatch: images -> embedding on the
        first stage, the stage's blocks, the tail -> logits on the last."""
        cfg = self.config
        if self.first:
            x = self.backbone.patch_embedding(x, seeds[0])
        for i in self.layers:
            block = getattr(self.backbone, f"encoder_block_{i}")
            block_seeds = seeds[1 + 2 * i:3 + 2 * i]
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, block_seeds, use_reentrant=False)
            else:
                x = block(x, block_seeds)
        if self.last:
            tokens = self.backbone.encoder_norm(x)
            return self.head(pool_tokens(cfg, tokens).float())
        return x

    def _activation(self, mb: int):
        cfg = self.config
        return (mb, cfg.seq_len, cfg.embedding_dim), _dtype(cfg)

    def forward(self, images: torch.Tensor) -> Optional[torch.Tensor]:
        """The pipelined forward without gradients (eval): the logits on
        the last stage, None on the others."""
        dev = self.mesh.device
        m_count = self.num_microbatches
        mb = images.shape[0] // m_count
        shape, dtype = self._activation(mb)
        none = [None] * (1 + 2 * self.config.num_layers)
        logits = []
        with torch.no_grad():
            for m in range(m_count):
                x = images[m * mb:(m + 1) * mb] if self.first else recv(
                    shape, dtype, dev, self.mesh.rank_at(pipe=self.stage - 1))
                out = self._stage(x, none, remat=False)
                if self.last:
                    logits.append(out)
                else:
                    send(out, self.mesh.rank_at(pipe=self.stage + 1))
        return torch.cat(logits) if self.last else None

    def forward_backward(self, images: torch.Tensor,
                         targets: Mapping[str, torch.Tensor],
                         seeds: Sequence[Sequence[int]], loss_fn
                         ) -> Optional[List[torch.Tensor]]:
        """One GPipe pass in training mode: the forward of every
        microbatch, then the backward in reverse order, accumulating into
        the parameters' ``.grad``. ``targets`` holds the rows the loss
        reads (``label``, and ``teacher_logits`` when distilling), split
        per microbatch like the images; ``loss_fn(logits, rows)`` gives a
        microbatch's loss to differentiate, on the last stage only.
        Returns the detached per-microbatch ``(logits, loss)`` pairs on the
        last stage, None on the others."""
        dev = self.mesh.device
        m_count = self.num_microbatches
        mb = images.shape[0] // m_count
        shape, dtype = self._activation(mb)
        remat = self.config.remat and torch.is_grad_enabled()
        prev = self.mesh.rank_at(pipe=self.stage - 1) if not self.first \
            else None
        nxt = self.mesh.rank_at(pipe=self.stage + 1) if not self.last \
            else None
        saved = []
        for m in range(m_count):
            rows = slice(m * mb, (m + 1) * mb)
            if self.first:
                x = images[rows]
            else:
                x = recv(shape, dtype, dev, prev).requires_grad_()
            out = self._stage(x, seeds[m], remat)
            if self.last:
                out = (out, loss_fn(out, {k: v[rows]
                                          for k, v in targets.items()}))
            else:
                send(out, nxt)
            saved.append((x, out))
        results = []
        for m in reversed(range(m_count)):
            x, out = saved[m]
            if self.last:
                out[1].backward()
                results.append((out[0].detach(), out[1].detach()))
            else:
                out.backward(recv(out.shape, out.dtype, dev, nxt))
            if not self.first:
                send(x.grad, prev)
        return results[::-1] if self.last else None


def make_pipeline_apply(cfg: ViTConfig, mesh, *,
                        num_microbatches: int) -> PipelineViT:
    """The rank-local pipelined model for ``mesh`` (the counterpart of the
    JAX function of this name, whose ``apply_fn`` it replaces): parameters
    uninitialized until the rank's slices are loaded, on ``mesh.device``."""
    if cfg.num_layers % mesh.shape["pipe"]:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by the pipe axis "
            f"size {mesh.shape['pipe']}")
    validate_mesh_for_config(cfg, mesh)
    return PipelineViT(cfg, mesh, num_microbatches).to(mesh.device)
