"""Ring attention: sequence parallelism over the token axis (the port of
the JAX package's ``parallel/ring_attention.py``).

Q, K and V are sharded over the ``seq`` axis of the mesh: each rank holds
its ``T / n`` tokens. A rank computes attention of its queries against the
K/V block it holds, then passes K and V (stacked, one transfer) to the next
rank of the ring (:func:`.collectives.ring_shift`), ``n - 1`` times. The
softmax accumulates online with the flash kernel's (m, l, acc) recurrence,
so the result is exact. JAX rotates with ``lax.ppermute`` inside
``jax.lax.scan`` and a last, wasted rotation; here the loop is Python and
autograd differentiates it, each shift's backward being the shift the
other way, as JAX's AD transposes ``ppermute``.

The block math is plain PyTorch in f32, as JAX's is XLA einsums and not a
Pallas kernel: no TPU kernel is on this path.

Dropout: the keep bit of every (example, head, query, key) element is
:func:`..ops.dropout.positional_keep_u8` of its *global* coordinates
(example·head over the data and model axes, the global row, the global
column of the K/V block the ring step holds), so the mask is the same
whichever rank and step visit an element, equal to the flash kernel's and
to Ulysses' for the same seed.

Three ways in, as in JAX: the train and eval steps of :mod:`.api` on a mesh
whose ``seq`` axis is > 1 (through
:func:`..ops.attention.sequence_parallel`), :func:`make_ring_attention`
for a function of the rank's shards, and :func:`ring_self_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.dropout import _threshold, positional_keep_u8
from .collectives import ring_shift

_NEG_INF = float(-1e30)


def _block_update(q, k, v, m, l, acc, scale, keep=None):
    """One online-softmax accumulation step against a K/V block.

    q: ``[B, Tq, H, Dh]``; k/v: ``[B, Tk, H, Dh]``; m/l: ``[B, H, Tq, 1]``;
    acc: ``[B, Tq, H, Dh]``, all f32; keep: optional ``[B, H, Tq, Tk]``
    dropout keep mask, applied to the value accumulation only (dropout
    acts on the normalized softmax weights, so the normalizer ``l`` sums
    the undropped probabilities; the survivor rescale comes once at the
    end)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)                         # [B, H, Tq, Tk]
    correction = torch.exp(m - m_new)                # [B, H, Tq, 1]
    l_new = l * correction + p.sum(-1, keepdim=True)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    acc_new = acc * correction.movedim(1, 2) + pv
    return m_new, l_new, acc_new


def _finish(acc, l, threshold: int, dtype: torch.dtype) -> torch.Tensor:
    """``acc / l`` with the survivors' rescale, in ``dtype``."""
    l_safe = torch.where(l == 0.0, 1.0, l)
    keep_prob = 1.0 - threshold / 256.0
    return (acc / (l_safe.movedim(1, 2) * keep_prob)).to(dtype)


def _bh_ids(mesh, b: int, h: int, data_axis: Optional[str],
            head_axis: Optional[str], heads: torch.Tensor) -> torch.Tensor:
    """Global example·head index ``[B, len(heads)]`` of the rank's batch
    rows and of ``heads`` (indices into the rank's own ``h`` heads, or
    beyond them after an exchange): the batch offset is the data index
    times ``b``, the head offset the model index times ``h``."""
    b_off = mesh.coords[data_axis] * b if data_axis is not None else 0
    h_off = mesh.coords[head_axis] * h if head_axis is not None else 0
    h_total = h * (mesh.shape[head_axis] if head_axis is not None else 1)
    rows = b_off + torch.arange(b, device=heads.device)
    return rows[:, None] * h_total + (h_off + heads)[None, :]


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh, axis_name: str = "seq", *,
                        dropout_threshold: int = 0,
                        dropout_seed: Optional[int] = None,
                        data_axis: Optional[str] = None,
                        head_axis: Optional[str] = None) -> torch.Tensor:
    """Exact self-attention with K/V rotating around the ``axis_name`` ring
    of ``mesh`` (this rank's :class:`.mesh.Mesh`).

    Args:
      q, k, v: the rank's token shard ``[B, T_local, H, Dh]`` (rank ``i``
        of the axis holds global tokens ``[i T_local, (i + 1) T_local)``).
      dropout_threshold: uint8 threshold (``ops.dropout._threshold``) of
        attention-weight dropout; 0 disables.
      dropout_seed: the int32 positional-hash seed (required when the
        threshold is > 0), equal on every rank.
      data_axis / head_axis: the mesh axes the batch / heads are sharded
        over (None: not sharded), giving the global example·head indices
        of the mask.

    Returns the rank's rows of the attention output ``[B, T_local, H,
    Dh]`` in ``q``'s dtype.
    """
    n = mesh.shape[axis_name]
    group = mesh.groups.get(axis_name)
    seq_idx = mesh.coords[axis_name]
    scale = q.shape[-1] ** -0.5
    b, t, h, d = q.shape
    qf = q.float()
    dev = q.device

    keep_mask = None
    if dropout_threshold:
        if dropout_seed is None:
            raise ValueError("ring attention dropout needs dropout_seed")
        bh = _bh_ids(mesh, b, h, data_axis, head_axis,
                     torch.arange(h, device=dev))
        rows = seq_idx * t + torch.arange(t, device=dev)

        def keep_mask(r):
            # Ring step r holds the K/V block that started on rank
            # (seq_idx - r) mod n: its global column offset.
            col0 = ((seq_idx - r) % n) * t
            return positional_keep_u8(
                dropout_seed, bh[:, :, None, None], rows[None, None, :, None],
                (col0 + torch.arange(t, device=dev))[None, None, None, :],
                dropout_threshold)

    m = torch.full((b, h, t, 1), _NEG_INF, device=dev)
    l = torch.zeros((b, h, t, 1), device=dev)
    acc = torch.zeros((b, t, h, d), device=dev)
    kv = torch.stack([k, v])
    for r in range(n):
        if r:
            kv = ring_shift(kv, group)
        m, l, acc = _block_update(qf, kv[0].float(), kv[1].float(), m, l,
                                  acc, scale,
                                  keep=keep_mask(r) if keep_mask else None)
    return _finish(acc, l, dropout_threshold, q.dtype)


def make_sp_attention(self_attention_fn, mesh, axis_name: str = "seq", *,
                      data_axis: str = "data",
                      head_axis: Optional[str] = None,
                      dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None,
                      deterministic: bool = True):
    """The shared factory of sequence-parallel self-attention (ring and
    Ulysses): one place for the dropout threshold, the axis filters and the
    seed, so the two strategies cannot drift apart. Returns a function of
    the rank's shards ``(q, k, v) -> out``. ``dropout_seed`` is the int32
    positional-hash seed (JAX derives it from ``dropout_rng``); an axis
    the mesh lacks, or of size 1, shards nothing."""
    threshold = 0
    if not deterministic and dropout_rate > 0.0:
        threshold = _threshold(dropout_rate)
        if dropout_seed is None:
            raise ValueError("sequence-parallel attention dropout needs "
                             "dropout_seed")

    def axis(name):
        return name if name is not None and mesh.shape.get(name, 1) > 1 \
            else None

    def fn(q, k, v):
        return self_attention_fn(
            q, k, v, mesh, axis_name, dropout_threshold=threshold,
            dropout_seed=dropout_seed if threshold else None,
            data_axis=axis(data_axis), head_axis=axis(head_axis))
    return fn


def make_ring_attention(mesh, axis_name: str = "seq", **kw):
    """:func:`ring_self_attention` over ``mesh`` as a function of the rank's
    ``[B, T_local, H, Dh]`` shards: batch sharded over ``data_axis``,
    tokens over ``axis_name``, and with ``head_axis`` (tensor parallelism)
    heads over that axis. ``dropout_rate``/``dropout_seed``/
    ``deterministic`` follow :func:`..ops.attention.dot_product_attention`
    (``seed`` there)."""
    return make_sp_attention(ring_self_attention, mesh, axis_name, **kw)
