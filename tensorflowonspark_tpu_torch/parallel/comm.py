"""Collectives over one mesh axis, and the autograd nodes built on them.

The JAX package writes its manual collectives inside ``shard_map``
(``lax.ppermute``, ``lax.all_to_all``, ``lax.all_gather``, ``lax.psum``)
and gets their transposes from JAX's autodiff.  Eager PyTorch has neither
the axis binding nor differentiable point-to-point sends, so this module
gives the port both:

- the collectives themselves, over a ``torch.distributed`` process group
  (one axis of a :class:`~torch.distributed.device_mesh.DeviceMesh`):
  :func:`all_reduce`, :func:`all_gather`, :func:`all_to_all` (``tiled``, as
  ``lax.all_to_all(..., tiled=True)``) and :func:`shift` (``lax.ppermute``
  by a fixed offset around the group);
- their differentiable forms, each an ``autograd.Function`` whose
  backward is the collective's transpose: :func:`ring_shift` (backward:
  the reverse shift), :func:`all_to_all_exchange` (backward: the inverse
  exchange), and Megatron's conjugate pair :func:`copy_to_group`
  (identity forward, all-reduce backward) and :func:`reduce_from_group`
  (all-reduce forward, identity backward), plus :func:`scatter_to_group`
  (this rank's block forward, all-gather backward) and
  :func:`gather_from_group` (all-gather forward, this rank's block
  backward) for global tensors that every rank holds in full.

**gloo on CUDA tensors.**  On one card several ranks cannot share NCCL,
so the caller may join a gloo group while its tensors live on the card.
gloo runs all-reduce, all-gather, all-to-all and broadcast on CUDA
tensors itself (staging through the host inside gloo), but not
point-to-point sends.  Which route a hop takes is decided by the group's
backend, never by catching an error: a send or receive of a CUDA tensor
over gloo is copied to the host here, and :data:`HOST_STAGED` counts each
such collective by name.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

#: collectives that this module copied to the host because the group's
#: backend does not take them on CUDA tensors, by name
HOST_STAGED: collections.Counter = collections.Counter()


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def _p2p_on_host(group, t: torch.Tensor) -> bool:
    """True when a send or receive of ``t`` must go through host memory:
    the tensor lives on the card and the group's backend is gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, in place; returns ``x``."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (``lax.all_gather(x, axis, axis=dim, tiled=True)``)."""
    n = group_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)``: ``x`` is cut into group-size chunks along ``split_dim``,
    chunk ``j`` goes to rank ``j``, and the chunks received are concatenated
    along ``concat_dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    split_dim %= x.dim()
    concat_dim %= x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split "
                         f"over {n} ranks")
    # [n, ..., S/n at split_dim, ...]: chunk j is row j of a contiguous buffer
    chunks = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] is rank j's chunk for this rank: merge the source dim into
    # concat_dim, source-major
    out = recv.movedim(0, concat_dim)
    return out.flatten(concat_dim, concat_dim + 1)


def shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """``lax.ppermute`` by ``offset``: this rank sends ``x`` to group rank
    ``(r + offset) % n`` and returns what group rank ``(r - offset) % n``
    sent it."""
    n = group_size(group)
    if n == 1 or offset % n == 0:
        return x
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + offset) % n)
    src = dist.get_global_rank(group, (r - offset) % n)
    staged = _p2p_on_host(group, x)
    send = x.contiguous()
    if staged:
        HOST_STAGED["send_recv"] += 1
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device, non_blocking=True) if staged else recv


# ---------------------------------------------------------------- autograd


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return shift(x, group, offset)

    @staticmethod
    def backward(ctx, grad):
        return shift(grad, ctx.group, -ctx.offset), None, None


def ring_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """Differentiable :func:`shift`: the gradient travels the reverse hop,
    as the transpose of ``lax.ppermute`` does."""
    return _Shift.apply(x, group, offset)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.args
        return all_to_all(grad, group, concat_dim, split_dim), None, None, None


def all_to_all_exchange(x: torch.Tensor, group, split_dim: int,
                        concat_dim: int) -> torch.Tensor:
    """Differentiable :func:`all_to_all`; its backward is the inverse
    exchange (split and concat dims swapped)."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce backward.  Put it
    before column-parallel weights, whose ranks each contribute a partial
    gradient of their common input."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: all-reduce forward, identity backward (``lax.psum``
    under ``shard_map``).  Put it after row-parallel weights."""
    return _ReduceFromGroup.apply(x, group)


def _block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return x.chunk(n, dim=dim)[group_rank(group)] if n > 1 else x


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.args
        return all_gather(grad.contiguous(), group, dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.args
        return _block(grad, group, dim).contiguous(), None, None


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (``x`` is the same on every
    rank); the backward all-gathers the blocks' gradients, so ``x`` gets
    its whole gradient on every rank."""
    return _Scatter.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's block concatenated along ``dim``; the backward keeps
    this rank's block of the gradient (every rank computes the same loss
    of the gathered tensor)."""
    return _Gather.apply(x, group, dim)
