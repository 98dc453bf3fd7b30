"""Parameter sharding rules — Megatron tensor parallelism and pipeline
stages over the port's ``state_dict`` names.

The counterpart of the JAX package's ``parallel/sharding.py``: the same
rules, matched on the trailing names of a parameter (``state_dict`` names
are the Flax paths joined with dots), with a partition spec written as a
tuple of axis names or ``None`` per dimension (JAX's ``PartitionSpec`` as
a tuple; ``()`` is replicated):

* the QKV projection is sharded over heads, the out projection over its
  input heads (each rank computes its heads' attention; the partial sums
  are all-reduced into the residual stream);
* MLP fc1 is sharded over the hidden width, fc2 over its input rows (one
  all-reduce after fc2);
* LayerNorms, the embeddings and the head are replicated.

Nothing is sharded over ``seq``: sequence parallelism shards activations
(the token axis), and every rank of a ``seq`` group holds the same
slices, so a gather reads the ranks at data and seq coordinate 0 and a
scatter sends each seq rank the slices of its model and pipe coordinates.

Pipeline stages own ``L / pipe`` contiguous encoder blocks. In the JAX
package's stacked layout (``encoder_blocks.*`` with a leading ``[L]``
axis) that axis is sharded over ``pipe`` and each TP rule moves one axis
right; the port keeps one module per layer (``backbone.encoder_block_i``),
so a stage simply holds its blocks (:func:`stage_layers`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

BLOCKS_KEY = "encoder_blocks"
_BLOCK = re.compile(r"^backbone\.encoder_block_(\d+)\.")

# Biases that stay REPLICATED over 'model' while their matmul outputs are
# per-rank partial sums (their rules below are ()). The port adds them once,
# after the all-reduce (models/vit.py), so their gradients are the same on
# every tensor-parallel rank. Keep in lockstep with TP_RULES.
REPLICATED_PARTIAL_SUM_BIASES: Tuple[Tuple[str, ...], ...] = (
    ("out", "bias"), ("fc2", "bias"))

# (trailing names) -> partition spec. First match wins.
TP_RULES: Tuple[Tuple[Tuple[str, ...], tuple], ...] = (
    (("qkv", "kernel"), (None, None, "model", None)),  # [D, 3, H, Dh]
    (("qkv", "bias"), (None, "model", None)),          # [3, H, Dh]
    (("out", "kernel"), ("model", None, None)),        # [H, Dh, D]
    (("out", "bias"), ()),                             # [D]
    (("fc1", "kernel"), (None, "model")),              # [D, mlp]
    (("fc1", "bias"), ("model",)),                     # [mlp]
    (("fc2", "kernel"), ("model", None)),              # [mlp, D]
    (("fc2", "bias"), ()),                             # [D]
)


def pspec_for_path(name: str) -> tuple:
    """Partition spec of one parameter: stacked blocks (``encoder_blocks``)
    shard their leading layer axis over ``pipe`` with the TP rule shifted
    one axis right; else the TP rule if the trailing names match; else
    replicated."""
    names = tuple(name.split("."))
    if BLOCKS_KEY in names:
        for pattern, spec in TP_RULES:
            if names[-len(pattern):] == pattern:
                return ("pipe", *spec)
        return ("pipe",)
    for pattern, spec in TP_RULES:
        if names[-len(pattern):] == pattern:
            return spec
    return ()


def block_index(name: str) -> Optional[int]:
    """The encoder layer of a standard-layout name, None outside the
    blocks."""
    m = _BLOCK.match(name)
    return int(m.group(1)) if m else None


def stage_layers(num_layers: int, mesh) -> range:
    """The contiguous global layers of this rank's pipeline stage."""
    per = num_layers // mesh.shape["pipe"]
    s = mesh.coords["pipe"]
    return range(s * per, (s + 1) * per)


def _num_layers(state: Mapping[str, torch.Tensor]) -> int:
    return 1 + max((block_index(n) for n in state
                    if block_index(n) is not None), default=-1)


def shard_state_dict(full: Mapping[str, torch.Tensor],
                     mesh) -> Dict[str, torch.Tensor]:
    """The rank-local slices of a standard-layout ``state_dict`` (every
    layer present): this stage's blocks, each TP-sharded dimension cut to
    this rank's ``model`` slice, the rest replicated. Tensors are copies."""
    layers = stage_layers(_num_layers(full), mesh)
    tp, ti = mesh.shape["model"], mesh.coords["model"]
    out = {}
    for name, t in full.items():
        layer = block_index(name)
        if layer is not None and layer not in layers:
            continue
        for dim, axis in enumerate(pspec_for_path(name)):
            if axis == "model":
                t = t.chunk(tp, dim)[ti]
        out[name] = t.clone()
    return out


def assemble_state_dict(parts: Sequence[Tuple[Dict[str, int],
                                              Mapping[str, torch.Tensor]]],
                        ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`: ``parts`` holds every
    rank's ``(coords, local state_dict)``; returns the full standard-layout
    ``state_dict`` (each leaf from data rank 0, TP slices concatenated in
    ``model`` order)."""
    full: Dict[str, torch.Tensor] = {}
    pieces: Dict[str, Dict[int, torch.Tensor]] = {}
    for coords, local in parts:
        if coords["data"] != 0 or coords["seq"] != 0:
            continue
        for name, t in local.items():
            pieces.setdefault(name, {})[coords["model"]] = t
    for name, by_model in pieces.items():
        spec = pspec_for_path(name)
        if "model" in spec:
            full[name] = torch.cat([by_model[i] for i in sorted(by_model)],
                                   dim=spec.index("model"))
        else:
            full[name] = by_model[min(by_model)]
    return full


def _holders(mesh) -> list:
    """The ranks whose local states together hold the whole state: data
    (and seq) coordinate 0, rank 0 first."""
    return [r for r in range(mesh.world)
            if mesh.layout_of(r).coords["data"] == 0
            and mesh.layout_of(r).coords["seq"] == 0]


def gather_to_rank0(groups: Mapping[str, Mapping[str, torch.Tensor]],
                    mesh) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
    """Collective over every rank: each group of ``groups`` (named
    ``state_dict``-like maps of the rank's local tensors: params, Adam
    moments, ...) as the full standard-layout map on rank 0 (CPU
    tensors), None on the other ranks. Only the ranks at data coordinate 0
    send, each its slices once, point to point to rank 0."""
    import torch.distributed as dist

    # Copies: on the CPU .cpu() would alias the live tensors.
    local = {g: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}
             for g, d in groups.items()}
    holders = _holders(mesh)
    if mesh.rank != 0:
        if mesh.rank in holders:
            dist.send_object_list([local], dst=0)
        return None
    parts = [(dict(mesh.coords), local)]
    for r in holders[1:]:
        box = [None]
        dist.recv_object_list(box, src=r)
        parts.append((mesh.layout_of(r).coords, box[0]))
    return {g: assemble_state_dict([(c, p[g]) for c, p in parts])
            for g in local}


def scatter_from_rank0(full, mesh) -> Dict[str, Dict[str, torch.Tensor]]:
    """Collective over every rank, the inverse of :func:`gather_to_rank0`:
    rank 0 passes each group's full standard-layout map (the other ranks
    pass None) and every rank returns its slices of each group
    (:func:`shard_state_dict`, CPU tensors), sent point to point. Rank 0
    may pass an exception instead: every rank raises it."""
    import torch.distributed as dist

    if mesh.rank == 0:
        for r in range(1, mesh.world):
            part = full if isinstance(full, BaseException) else {
                g: shard_state_dict(d, mesh.layout_of(r))
                for g, d in full.items()}
            dist.send_object_list([part], dst=r)
        mine = full if isinstance(full, BaseException) else {
            g: shard_state_dict(d, mesh) for g, d in full.items()}
    else:
        box = [None]
        dist.recv_object_list(box, src=0)
        mine = box[0]
    if isinstance(mine, BaseException):
        raise mine
    return mine


def gather_state_dict(local: Mapping[str, torch.Tensor],
                      mesh) -> Optional[Dict[str, torch.Tensor]]:
    """Collective over every rank: the full standard-layout ``state_dict``
    (CPU tensors) on rank 0 from each rank's local one, None on the other
    ranks (:func:`gather_to_rank0`)."""
    full = gather_to_rank0({"params": local}, mesh)
    return None if full is None else full["params"]


def validate_tp_divisibility(config, mesh) -> None:
    """TP requires heads and mlp hidden divisible by the model-axis size."""
    tp = mesh.shape["model"]
    if tp == 1:
        return
    if config.num_heads % tp != 0:
        raise ValueError(
            f"num_heads={config.num_heads} not divisible by model-axis "
            f"size {tp}")
    if config.mlp_size % tp != 0:
        raise ValueError(
            f"mlp_size={config.mlp_size} not divisible by model-axis "
            f"size {tp}")


def validate_sp_divisibility(config, mesh) -> None:
    """Sequence parallelism shards the token axis: seq_len % seq-axis must
    be 0.

    ViT's CLS token makes the default sequence odd (197 for 224/16); the
    error suggests ``pool="gap"``, which drops it (196 = 4·49 patches).
    """
    sp = mesh.shape.get("seq", 1)
    if sp == 1:
        return
    if config.seq_len % sp != 0:
        hint = (" (pool='gap' would drop the CLS token, giving "
                f"{config.num_patches} tokens)" if config.pool == "cls"
                else "")
        raise ValueError(
            f"seq_len={config.seq_len} not divisible by seq-axis size "
            f"{sp}{hint}")


def validate_mesh_for_config(config, mesh) -> None:
    """All mesh-vs-architecture divisibility checks in one call."""
    validate_tp_divisibility(config, mesh)
    validate_sp_divisibility(config, mesh)
