"""Differentiable collectives over a mesh axis's process group.

The reference's ``shard_map`` bodies call ``lax.all_to_all``,
``lax.pmean`` and friends, and JAX transposes them.  Here each is a small
``torch.autograd.Function`` whose backward is the collective that the
forward's transpose needs, for the SPMD layout the port's sharded steps
use: along the ``"model"`` axis every rank holds the same activations
(replicated), and a region that splits work over those ranks enters
through :func:`split` / :func:`replicated_param` and leaves through
:func:`gather`, so that the gradient of everything outside the region is
again the same on every rank.

* :func:`all_to_all` — exchange the ``group``-sized leading dimension
  (equal splits); its backward is the same exchange of the gradient.
* :func:`split` — this rank's piece of a replicated tensor along dim 0;
  backward: all-gather of the pieces' gradients.
* :func:`gather` — all-gather the ranks' pieces along dim 0; backward:
  this rank's piece of the (replicated) gradient.
* :func:`replicated_param` — identity; backward: the sum of the ranks'
  gradients, so a weight used for different pieces of work on each rank
  gets its whole gradient on every rank.
* :func:`mean` — the mean of a value over ``group``; backward: the
  gradient times ``grad_scale`` (the caller's share of it, see
  ``models.moe_shard_map``).

Every collective runs through ``torch.distributed`` at call time, with
contiguous tensors on the group's backend device.  A group of one rank
short-cuts each to its local meaning.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "split", "gather", "replicated_param", "mean",
           "all_reduce_sum"]


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    if _size(group) == 1:
        return x.clone()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    n = _size(group)
    if n == 1:
        return x.clone()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _piece(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    return x.chunk(n)[dist.get_rank(group)].contiguous()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; no autograd)."""
    out = x.detach().clone().contiguous()
    if _size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _piece(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.group), None


class _ReplicatedParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return all_reduce_sum(x, group) / _size(group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Row block ``r`` of ``x`` (dim 0 has the group's size) goes to rank
    ``r``; row block ``r`` of the result came from rank ``r``."""
    return _AllToAll.apply(x, group)


def split(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's piece (``torch.chunk`` along dim 0) of a tensor that is
    the same on every rank of ``group``."""
    return _Split.apply(x, group)


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' pieces concatenated along dim 0, in rank order."""
    return _Gather.apply(x, group)


def replicated_param(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``group``."""
    return _ReplicatedParam.apply(x, group)


def mean(x: torch.Tensor, group, grad_scale: float = 1.0) -> torch.Tensor:
    """The mean of ``x`` over ``group``, with gradient ``grad_scale``."""
    return _Mean.apply(x, group, grad_scale)
