"""Ulysses-style all-to-all sequence parallelism (the port of the JAX
package's ``parallel/ulysses.py``).

The second sequence-parallel strategy beside the ring: one tiled
all-to-all (:func:`.collectives.all_to_all`) re-shards Q, K and V (stacked,
one exchange) from token-sharded to head-sharded, so each rank holds the
whole sequence for ``H / n`` of its heads and computes ordinary attention
over it; a second all-to-all restores token sharding. Two collectives per
attention call against the ring's ``n - 1`` shifts, at the cost of
``O(T^2 H / n)`` attention memory (the ring keeps ``O(T T_local)``).

=====================  =======================  ======================
                       ring                     ulysses (this module)
=====================  =======================  ======================
collectives            n - 1 shifts (neighbor)  2 all_to_alls
attention memory       O(T_local · T)           O(T² · H/n) materialized
divisibility           T % n == 0               T % n == 0 AND H % n == 0
composes with TP       heads untouched          splits the LOCAL heads
=====================  =======================  ======================

Dropout uses the ring's and the flash kernel's positional-hash mask on
global coordinates (after the exchange this rank owns heads ``h_off +
seq_idx · H/n + arange(H/n)``), so for one seed the dropped weights are
the same bits on ring, Ulysses and unsharded flash attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.dropout import positional_keep_u8
from .collectives import all_to_all
from .ring_attention import (_NEG_INF, _bh_ids, _block_update, _finish,
                             make_sp_attention)


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, axis_name: str = "seq", *,
                           dropout_threshold: int = 0,
                           dropout_seed: Optional[int] = None,
                           data_axis: Optional[str] = None,
                           head_axis: Optional[str] = None) -> torch.Tensor:
    """All-to-all sequence-parallel self-attention (module docstring).

    ``q, k, v``: the rank's token shard ``[B, T_local, H, Dh]``; ``H`` must
    divide by the axis size. The keyword arguments are
    :func:`.ring_attention.ring_self_attention`'s. Returns the rank's rows
    of the output ``[B, T_local, H, Dh]`` in ``q``'s dtype."""
    n = mesh.shape[axis_name]
    b, _, h, d = q.shape
    if h % n != 0:
        raise ValueError(
            f"ulysses needs heads ({h}) divisible by the '{axis_name}' "
            f"axis size ({n}); use ring attention otherwise")
    group = mesh.groups.get(axis_name)
    h_after = h // n
    scale = d ** -0.5
    dev = q.device

    # Token-sharded -> head-sharded: the head axis split n ways, the token
    # axis gathered in source rank order (global order).
    g = torch.stack([q, k, v])
    if n > 1:
        g = all_to_all(g, group, split_axis=3, concat_axis=2)
    qg, kg, vg = g[0].float(), g[1].float(), g[2].float()  # [B, T, H/n, Dh]
    t = qg.shape[1]

    keep = None
    if dropout_threshold:
        if dropout_seed is None:
            raise ValueError("ulysses attention dropout needs dropout_seed")
        heads = (mesh.coords[axis_name] * h_after
                 + torch.arange(h_after, device=dev))
        bh = _bh_ids(mesh, b, h, data_axis, head_axis, heads)
        rows = torch.arange(t, device=dev)
        keep = positional_keep_u8(
            dropout_seed, bh[:, :, None, None], rows[None, None, :, None],
            rows[None, None, None, :], dropout_threshold)  # [B, H/n, T, T]

    m0 = torch.full((b, h_after, t, 1), _NEG_INF, device=dev)
    l0 = torch.zeros((b, h_after, t, 1), device=dev)
    acc0 = torch.zeros((b, t, h_after, d), device=dev)
    _, l, acc = _block_update(qg, kg, vg, m0, l0, acc0, scale, keep=keep)
    out = _finish(acc, l, dropout_threshold, q.dtype)
    if n == 1:
        return out
    # Head-sharded -> token-sharded (the inverse exchange).
    return all_to_all(out, group, split_axis=1, concat_axis=2)


def make_ulysses_attention(mesh, axis_name: str = "seq", **kw):
    """:func:`ulysses_self_attention` as a function of the rank's shards:
    the sibling of :func:`.ring_attention.make_ring_attention` (same
    arguments, same dropout contract, one shared factory)."""
    return make_sp_attention(ulysses_self_attention, mesh, axis_name, **kw)
