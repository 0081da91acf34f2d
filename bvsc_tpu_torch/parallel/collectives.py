"""The exchanges of the parallel paths, built from ``all_reduce`` and
``broadcast`` alone.

Those are the two collectives every backend the port meets takes for every
device type: NCCL across cards, gloo on CPU tensors (the tests), and gloo on
CUDA tensors (two ranks sharing one card, which NCCL refuses), where gloo
has no ``send`` / ``recv`` and no ``all_gather``.  So the same code runs on
each backend, with no branch that stages through the host on one of them:

* :func:`all_sum`: the row-parallel sum (JAX's ``psum``);
* :func:`all_gather`: an ``all_reduce`` of a zero-filled buffer into which
  each rank wrote its slice (adding zeros changes no bit but a zero's
  sign);
* :func:`left_context`: the samples before this shard's first, from the
  same gathered buffer indexed from the left (JAX's ``ppermute`` shift,
  reaching past one neighbour where a shard is shorter than the context);
* :func:`broadcast`: one rank's tensor on every rank of the axis (the
  pipeline's hand-off).

A bf16 tensor (the bf16 storage dtype) travels as float32 and comes back
bf16: exact for the gather and the broadcast, which move values, and a sum
rounded once; so no backend needs a bf16 collective.  An axis of one
device exchanges nothing.  The cost is the axis size times
the bytes of a point-to-point exchange, small next to the work at the
sizes here (at most 4 ranks a mesh).  Each takes a ``parallel.mesh.Axis``
and returns a new tensor; its input is not changed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A new float32 copy of a bf16 tensor, else a new copy of ``x``."""
    return x.to(torch.float32) if x.dtype == torch.bfloat16 else x.contiguous().clone()


def all_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks, on each of them."""
    if axis.size == 1:
        return x
    y = _wide(x)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=axis.group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in index
    order (JAX's ``all_gather(tiled=True)``)."""
    if axis.size == 1:
        return x
    dim = dim % x.dim()
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    buf = x.new_zeros(shape, dtype=torch.float32 if x.dtype == torch.bfloat16 else x.dtype)
    buf.narrow(dim, axis.index * n, n).copy_(x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis.group)
    return buf.to(x.dtype)


def left_context(x: torch.Tensor, n: int, axis) -> torch.Tensor:
    """The ``n`` samples (last axis) before this shard's first, the shards
    laid end to end in index order; zeros where they would lie before shard
    0 (a causal conv's zero padding).  Shards hold equal lengths; one
    shorter than ``n`` takes samples from further left."""
    T = x.shape[-1]
    m = min(n, T)
    tails = all_gather(x[..., T - m:].unsqueeze(0), axis, 0)  # (shards, ..., m)
    before = tails[: axis.index]
    flat = (torch.cat(list(before), -1) if axis.index else x[..., :0])
    flat = flat[..., max(0, flat.shape[-1] - n):]
    if flat.shape[-1] < n:
        flat = torch.nn.functional.pad(flat, (n - flat.shape[-1], 0))
    return flat.contiguous()


def from_left(x: torch.Tensor, axis) -> torch.Tensor:
    """The left neighbour's ``x`` (equal shapes); zeros on shard 0 (JAX's
    ``ppermute`` one step right)."""
    return left_context(x, x.shape[-1], axis)


def broadcast(x: torch.Tensor, axis, src: int) -> torch.Tensor:
    """Rank ``src`` (an index along the axis)'s ``x`` on every rank of the
    axis; the others pass a tensor of the same shape and type."""
    if axis.size == 1:
        return x
    y = _wide(x)
    dist.broadcast(y, src=axis.ranks[src], group=axis.group)
    return y.to(x.dtype)


def all_mean(tensors: list[torch.Tensor], axis) -> list[torch.Tensor]:
    """The mean over the axis's ranks of each tensor (one type, the same
    shapes on every rank), by one ``all_reduce`` of them flattened: the
    data-parallel gradient average."""
    if axis.size == 1:
        return list(tensors)
    flat = all_sum(torch.cat([t.reshape(-1) for t in tensors]), axis) / axis.size
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
