"""Megatron's conjugate pair of tensor-parallel collectives, with autograd.

``copy_to_tp`` is the identity forward and an all-reduce of the gradient
backward; ``reduce_from_tp`` all-reduces forward and passes the gradient
through backward. A tensor-parallel block puts ``copy_to_tp`` between its
replicated LayerNorm and the sharded projection (so the LayerNorm's
parameters, and the residual stream, receive the full gradient on every
rank) and ``reduce_from_tp`` after the sharded projection back to the
residual width. The JAX package's ``psum`` over the ``model`` axis is the
same pair, with the transposes derived by ``shard_map``.

The transfers: NCCL moves CUDA tensors directly. Gloo (ranks that share one
device) takes CPU tensors, so a CUDA tensor goes through host memory; the
backend is read from the group, so the caller passes only the group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _via_host(tensor: torch.Tensor, group=None) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


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
