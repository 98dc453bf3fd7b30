"""The collectives of the parallel paths, with autograd.

Megatron's conjugate pair of tensor-parallel collectives: ``copy_to_tp``
is the identity forward and an all-reduce of the gradient backward;
``reduce_from_tp`` all-reduces forward and passes the gradient through
backward. A tensor-parallel block puts ``copy_to_tp`` between its
replicated LayerNorm and the sharded projection (so the LayerNorm's
parameters, and the residual stream, receive the full gradient on every
rank) and ``reduce_from_tp`` after the sharded projection back to the
residual width. The JAX package's ``psum`` over the ``model`` axis is the
same pair, with the transposes derived by ``shard_map``.

Sequence parallelism (:mod:`.ring_attention`, :mod:`.ulysses`) adds three,
each the counterpart of a JAX collective inside ``shard_map`` with the
transpose JAX's AD derives for it:

* :func:`ring_shift` (``lax.ppermute`` to the next rank of the ring): one
  ``batch_isend_irecv`` of a send to ``(i + 1) mod n`` and a receive from
  ``(i - 1) mod n``, so no rank blocks in a send before its receive is
  posted; the backward is the shift the other way;
* :func:`all_to_all` (``lax.all_to_all(..., tiled=True)``): chunk ``j`` of
  the split axis to rank ``j``, the received chunks concatenated in source
  rank order, sent point to point in one ``batch_isend_irecv`` (some gloo
  builds have no ``alltoall``); the backward is the inverse exchange;
* :func:`all_gather_tokens` (the gathered fallback of
  :func:`..ops.attention.dot_product_attention`): the token pieces of every
  rank, in rank order; the backward sums the gradient over the group and
  keeps the rank's own piece.

The transfers: NCCL moves CUDA tensors directly. Gloo (ranks that share one
device) takes CPU tensors, so a CUDA tensor goes through host memory; the
backend is read from the group, so the caller passes only the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _via_host(tensor: torch.Tensor, group=None) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def _outbound(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` as the transport takes it: a host copy under gloo on a
    card, else contiguous on its device."""
    t = tensor.detach()
    return t.cpu() if _via_host(t, group) else t.contiguous()


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, as a new tensor on its
    device."""
    if _via_host(tensor, group):
        host = tensor.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(tensor.device)
    out = tensor.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def send(tensor: torch.Tensor, dst: int) -> None:
    """Point-to-point send to global rank ``dst``."""
    dist.send(tensor.detach().cpu() if _via_host(tensor)
              else tensor.detach().contiguous(), dst)


def recv(shape, dtype: torch.dtype, device: torch.device,
         src: int) -> torch.Tensor:
    """Point-to-point receive of a ``shape``/``dtype`` tensor from global
    rank ``src``, returned on ``device``."""
    buf = torch.empty(shape, dtype=dtype)
    if device.type == "cuda" and dist.get_backend() != "gloo":
        buf = buf.to(device)
    dist.recv(buf, src)
    return buf.to(device)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; all-reduce of the gradient over ``group``
    backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward."""
    return _ReduceFromTP.apply(x, group)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` of the rank ``step`` places back on the ring of ``group``
    (the rank sends its own ``step`` places on)."""
    ranks = dist.get_process_group_ranks(group)
    i, n = dist.get_rank(group), len(ranks)
    src = _outbound(x, group)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + step) % n], group),
           dist.P2POp(dist.irecv, buf, ranks[(i - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(x.device)


def _exchange(x: torch.Tensor, group, split_axis: int,
              concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all of ``x`` over ``group``, as one
    ``batch_isend_irecv`` of a send and a receive with every other rank
    (gloo builds without ``alltoall`` run it too)."""
    ranks = dist.get_process_group_ranks(group)
    i, n = dist.get_rank(group), len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not divide by the group size {n}")
    ins = [c.contiguous() for c in _outbound(x, group).chunk(n, split_axis)]
    outs = [c if j == i else torch.empty_like(c) for j, c in enumerate(ins)]
    ops = []
    for j in range(n):
        if j != i:
            ops += [dist.P2POp(dist.isend, ins[j], ranks[j], group),
                    dist.P2POp(dist.irecv, outs[j], ranks[j], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat(outs, concat_axis).to(x.device)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in rank order."""
    rows = _outbound(x, group).contiguous()
    parts = [torch.empty_like(rows)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, rows, group=group)
    return torch.cat(parts, dim).to(x.device)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.step), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis = ctx.args
        return _exchange(grad, group, concat_axis, split_axis), None, None, \
            None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim, n = ctx.args
        i = dist.get_rank(group)
        return all_reduce(grad, group).narrow(dim, i * n, n), None, None


def ring_shift(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Rotate ``x`` around the ring of ``group`` (group rank order): rank
    ``i`` sends to ``(i + step) mod n`` and returns what ``(i - step) mod
    n`` sent. Backward: the rotation by ``-step``."""
    return _RingShift.apply(x, group, step)


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX's ``lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)`` over ``group``: ``x`` split into ``n`` equal chunks
    along ``split_axis``, chunk ``j`` sent to group rank ``j``, the chunks
    received concatenated along ``concat_axis`` in source rank order.
    Backward: the inverse exchange."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def all_gather_tokens(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The concatenation along ``dim`` of every group rank's ``x`` (equal
    shapes), in rank order. Backward: the gradient summed over the group,
    this rank's piece of it."""
    return _GatherTokens.apply(x, group, dim)
