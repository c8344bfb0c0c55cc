"""Collectives over a mesh axis's process group, differentiable where a
layer needs them, and the one place where the port's collectives run.

The reference's ``shard_map`` bodies call ``lax.all_to_all``,
``lax.pmean`` and friends, and GSPMD inserts the all-reduces of its
tensor-parallel products; JAX transposes them.  Here each is a small
``torch.autograd.Function`` whose backward is the collective that the
forward's transpose needs, for the SPMD layout of the port's sharded
steps: along the ``"model"`` axis every rank holds the same activations
(replicated); a region that splits work over those ranks enters through
:func:`replicated_param` (or :func:`split`) and leaves through
:func:`reduce` (or :func:`gather`), so that the gradient of everything
outside the region is again the same on every rank.

* :func:`all_to_all` — exchange the ``group``-sized leading dimension
  (equal splits); its backward is the same exchange of the gradient.
* :func:`split` — this rank's piece of a replicated tensor along dim 0;
  backward: all-gather of the pieces' gradients.
* :func:`gather` — all-gather the ranks' pieces along dim 0; backward:
  this rank's piece of the (replicated) gradient.
* :func:`replicated_param` — identity; backward: the sum of the ranks'
  gradients.  The entry of a column-parallel product (each rank's
  gradient of its input is a partial sum), and a whole weight that each
  rank uses for a different piece of work.
* :func:`reduce` — the sum over the group; backward: identity.  The exit
  of a row-parallel product.
* :func:`mean` — the mean of a value over ``group``; backward: the
  gradient times ``grad_scale`` (the caller's share of it, see
  ``models.moe_shard_map``).
* :func:`vocab_embed` and :func:`vocab_cross_entropy` — a vocabulary
  split over the group: a masked lookup plus :func:`reduce`, and the
  log-softmax from a max and a sum of exponentials over the group.
* :func:`all_reduce_sum`, :func:`all_reduce_max`, :func:`reduce_scatter_sum`
  and :func:`all_gather` — the same without autograd (the optimizer's
  ZeRO exchange, metrics, whole logits for greedy decoding).

Every collective runs through ``torch.distributed`` at call time, with
contiguous tensors on the group's backend device, in the tensor's own
dtype (a bfloat16 partial sum is all-reduced in bfloat16, as XLA
all-reduces a bfloat16 product).  A group of one rank short-cuts each to
its local meaning and moves nothing.  A :class:`TracedGroup` (a traced
rank's, ``distributed.sharding.traced_rank``) takes meta tensors and
returns meta tensors of the result's shape: the dry run traces one rank
of a production mesh that way.

Every collective of more than one rank reports its op name (the
reference's HLO names: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``), its operand and result bytes and
its group size to each active observer (:func:`observing`, which
``launch.opstats.counting`` and :func:`tally` use), on real groups and
traced ones alike; :func:`wire_bytes` is the reference's ring model of
the bytes one rank sends.  The collectives' own tensor ops run outside
any ``TorchDispatchMode``, so an op counter sees each as its report
only.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

__all__ = ["TracedGroup", "observing", "tally", "wire_bytes", "all_to_all",
           "split", "gather", "replicated_param", "reduce", "mean",
           "vocab_embed", "vocab_cross_entropy", "all_reduce_sum",
           "all_reduce_max", "reduce_scatter_sum", "all_gather"]


@dataclass(frozen=True)
class TracedGroup:
    """A process group that exists only in a trace: its size and this
    rank's index in it."""

    size: int
    rank: int


def _size(group) -> int:
    if isinstance(group, TracedGroup):
        return group.size
    return dist.get_world_size(group)


def _rank(group) -> int:
    if isinstance(group, TracedGroup):
        return group.rank
    return dist.get_rank(group)


# --------------------------------------------------------------------- #
# Observers
# --------------------------------------------------------------------- #
_observers: List[Callable[[str, int, int, int], None]] = []


@contextlib.contextmanager
def observing(fn: Callable[[str, int, int, int], None]) -> Iterator[None]:
    """Call ``fn(op, operand_bytes, result_bytes, group_size)`` for every
    collective of more than one rank run inside the block."""
    _observers.append(fn)
    try:
        yield
    finally:
        _observers.remove(fn)


def wire_bytes(op: str, operand: float, result: float, g: int) -> float:
    """The bytes one rank sends in a ring collective (the reference's
    ``hloparse`` model): all-reduce ``2 B (g-1)/g``, all-gather
    ``result (g-1)/g``, reduce-scatter and all-to-all
    ``operand (g-1)/g``."""
    share = (g - 1) / max(g, 1)
    if op == "all-reduce":
        return 2.0 * operand * share
    if op == "all-gather":
        return result * share
    return operand * share


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, Dict[str, float]]]:
    """The collectives run inside the block, by op: ``count``,
    ``operand_bytes``, ``result_bytes`` and ``wire_bytes``."""
    out: Dict[str, Dict[str, float]] = {}

    def add(op, operand, result, g):
        rec = out.setdefault(op, {"count": 0, "operand_bytes": 0.0,
                                  "result_bytes": 0.0, "wire_bytes": 0.0})
        rec["count"] += 1
        rec["operand_bytes"] += operand
        rec["result_bytes"] += result
        rec["wire_bytes"] += wire_bytes(op, operand, result, g)

    with observing(add):
        yield out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _report(op: str, operand: torch.Tensor, result: torch.Tensor,
            group) -> None:
    for fn in list(_observers):
        fn(op, _nbytes(operand), _nbytes(result), _size(group))


def _traced(x: torch.Tensor, group) -> bool:
    if not isinstance(group, TracedGroup):
        return False
    if x.device.type != "meta":
        raise ValueError("a traced rank's collectives take meta tensors, "
                         f"not {x.device.type} ones")
    return True


# --------------------------------------------------------------------- #
# The collectives themselves (no autograd)
# --------------------------------------------------------------------- #
def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    with _disable_current_modes():
        x = x.contiguous()
        if _size(group) == 1:
            return x.clone()
        out = torch.empty_like(x)
        _report("all-to-all", x, out, group)
        if not _traced(x, group):
            dist.all_to_all_single(out, x, group=group)
        return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    with _disable_current_modes():
        x = x.contiguous()
        n = _size(group)
        if n == 1:
            return x.clone()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _report("all-gather", x, out, group)
        if not _traced(x, group):
            dist.all_gather_into_tensor(out, x, group=group)
        return out


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    with _disable_current_modes():
        out = x.detach().clone().contiguous()
        if _size(group) > 1:
            _report("all-reduce", out, out, group)
            if not _traced(out, group):
                dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
        return out


def _piece(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    return x.chunk(n)[_rank(group)].contiguous()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; no autograd)."""
    return _all_reduce(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (no autograd)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def reduce_scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Piece ``rank`` of the sum over ``group`` of the flat ``x``, whose
    length the group's size divides (no autograd)."""
    with _disable_current_modes():
        x = x.detach().contiguous()
        n = _size(group)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} elements do not split over {n} "
                             f"ranks")
        if n == 1:
            return x.clone()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        _report("reduce-scatter", x, out, group)
        if not _traced(x, group):
            dist.reduce_scatter_tensor(out, x, group=group)
        return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' pieces concatenated along ``dim``, in rank order (no
    autograd)."""
    if dim in (0, -x.ndim):
        return _all_gather(x.detach(), group)
    return _all_gather(x.detach().movedim(dim, 0), group).movedim(0, dim)


# --------------------------------------------------------------------- #
# Differentiable forms
# --------------------------------------------------------------------- #
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
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return _all_reduce(x, group) / _size(group)

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


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose gradient passes to every
    rank's ``x`` unchanged."""
    return _Reduce.apply(x, group)


def mean(x: torch.Tensor, group, grad_scale: float = 1.0) -> torch.Tensor:
    """The mean of ``x`` over ``group``, with gradient ``grad_scale``."""
    return _Mean.apply(x, group, grad_scale)


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, group,
                start: int) -> torch.Tensor:
    """Rows ``ids`` of a vocabulary split over ``group``: this rank holds
    rows ``[start, start + len(table))``, looks up the ids that fall there
    (zeros for the rest) and the ranks' lookups are summed."""
    V = table.shape[0]
    local = ids - start
    inside = (local >= 0) & (local < V)
    rows = table[local.clamp(0, V - 1)]
    return reduce(torch.where(inside[..., None], rows, rows.new_zeros(())),
                  group)


def vocab_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, group,
                        start: int) -> torch.Tensor:
    """Per-position ``-log softmax(logits)[target]`` over a vocabulary
    split over ``group`` (this rank's columns ``[start, start + V_loc)``):
    the max over the group (a constant shift), the sum of the exponentials
    and the target's logit from the rank that holds it, reduced together;
    ``logits`` float32 ``(..., V_loc)``, ``targets`` ``(...)``."""
    V = logits.shape[-1]
    m = all_reduce_max(logits.detach().amax(-1), group)
    se = (logits - m[..., None]).exp().sum(-1)
    local = targets - start
    inside = (local >= 0) & (local < V)
    t = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    se, t = reduce(torch.stack([se, torch.where(inside, t, t.new_zeros(()))]),
                   group).unbind(0)
    return se.log() + m - t
