"""Op counting of an eager step: product FLOPs, traffic and collectives.

Counterpart of ``repro.launch.hloparse``.  The reference re-derives dot
FLOPs, traffic and collectives from compiled HLO text, because XLA's cost
analysis visits a loop body once.  The port's steps are eager Python, so
nothing is visited once: every op that runs is seen.  Here a
``TorchDispatchMode`` records each aten op while the step runs (on the
meta device for the dry run, so nothing is allocated; on any device
otherwise):

  * products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``,
    ``dot``; ``einsum``, ``matmul`` and ``linear`` reach these) count
    ``2 * prod(out) * prod(contract)`` FLOPs, by the output's dtype;
  * every op that is not a view counts its operand and output bytes (in
    eager these are the traffic of the op, not a fusion-level proxy);
  * every collective of more than one rank, which the port runs through
    :mod:`repro_torch.distributed.collectives` only, counts under the
    reference's op name (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``): its count, its operand bytes and
    its wire bytes by the reference's ring model
    (``collectives.wire_bytes``: all-reduce ``2 B (g-1)/g``, all-gather
    ``result (g-1)/g``, reduce-scatter and all-to-all ``operand
    (g-1)/g``), and its operand and result bytes as traffic, as the
    reference's ``hloparse`` does.  A traced rank's collectives
    (``sharding.traced_rank``) report as a real group's do.

Each entry point of :mod:`repro_torch.kernels.ops` is one leaf: the
wrapper is replaced for the trace by a function that counts the work of
its kernel (the formulas of :mod:`repro_torch.launch.kernel_bench`, which
the kernel table's bounds use) and returns outputs of the right shapes
without running anything, so the plain version, which does other work
(the doubling scan, the per-group flash loop, the MoE experts' weight
copy), is never counted.  A flash or MoE-experts leaf's products count as
product FLOPs; the scan's are elementwise (``leaf_flops``).

``torch.utils.flop_counter.FlopCounterMode`` can run beside it as a
diagnostic (``flop_counter=True``), as ``cost_analysis()`` does in the
reference: it knows no leaf and so no kernel.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..distributed import collectives as coll
from ..kernels import ops, ref
from . import kernel_bench as kb

__all__ = ["OpStats", "counting", "analyze", "snapshot", "add_repeats",
           "add_into", "PRODUCTS", "leaf_work"]

aten = torch.ops.aten


@dataclass
class OpStats:
    """What an eager step did: the fields of the reference's ``HloStats``
    (``while_trips`` is always empty: eager code has no loop to scale),
    the products' FLOPs by dtype, the kernel leaves and the aten ops."""

    dot_flops: float = 0.0
    traffic_bytes: float = 0.0
    coll_counts: Dict[str, float] = field(default_factory=dict)
    coll_operand_bytes: Dict[str, float] = field(default_factory=dict)
    coll_wire_bytes: Dict[str, float] = field(default_factory=dict)
    while_trips: Dict[str, int] = field(default_factory=dict)
    dot_flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    leaf_flops: float = 0.0  # elementwise FLOPs of kernel leaves
    leaves: Dict[str, Dict[str, float]] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)
    flop_counter_flops: float = 0.0  # FlopCounterMode's total, if asked

    @property
    def total_wire(self) -> float:
        return sum(self.coll_wire_bytes.values())

    @property
    def total_coll_operand(self) -> float:
        return sum(self.coll_operand_bytes.values())

    def add_collective(self, op: str, operand: float, result: float,
                       g: int) -> None:
        """One collective of ``g`` ranks (see the module docstring)."""
        self.coll_counts[op] = self.coll_counts.get(op, 0) + 1
        self.coll_operand_bytes[op] = self.coll_operand_bytes.get(op, 0.0) \
            + operand
        self.coll_wire_bytes[op] = self.coll_wire_bytes.get(op, 0.0) + \
            coll.wire_bytes(op, operand, result, g)
        self.traffic_bytes += operand + result

    def add_dot(self, flops: float, dtype) -> None:
        self.dot_flops += flops
        key = str(dtype)
        self.dot_flops_by_dtype[key] = self.dot_flops_by_dtype.get(key, 0.0) \
            + flops


#: product ops -> the index of the first factor in their arguments (the
#: contracted size is its last dimension)
PRODUCTS = {
    aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0, aten.vdot: 0,
    aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1,
}


def _bincount_meta(x, weights=None, minlength=0):
    # The port counts ids below ``minlength`` (MoE experts), so the output
    # holds ``minlength`` entries; the values decide nothing else.
    dt = torch.int64 if weights is None else weights.dtype
    return torch.empty(minlength, dtype=dt, device=x.device)


#: meta-device shapes of the ops PyTorch has no meta kernel for
_META_SHAPES = {aten.bincount: _bincount_meta}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    def __init__(self, st: OpStats):
        super().__init__()
        self.st = st
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        try:
            out = func(*args, **(kwargs or {}))
        except NotImplementedError:
            fallback = _META_SHAPES.get(func.overloadpacket)
            if fallback is None:
                raise
            out = fallback(*args, **(kwargs or {}))
        if self.paused or func.is_view:
            return out
        st = self.st
        name = str(func.overloadpacket)
        st.op_counts[name] = st.op_counts.get(name, 0) + 1
        outs = _tensors(out)
        first = PRODUCTS.get(func.overloadpacket)
        if first is not None:
            a = args[first]
            res = outs[0]
            st.add_dot(2.0 * res.numel() * a.shape[-1], res.dtype)
        st.traffic_bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + \
            sum(map(_nbytes, outs))
        return out


def attention_work(q, k, causal: bool, window, q_offset: int):
    """Bytes and product FLOPs of one flash call (``kernel_bench``'s
    ``flash_work`` for any q and k lengths): q, k, v read and o written
    once, 4 operations per head dim for each visible (query, key) pair."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    nbytes = (2 * B * Sq * nq * hd + 2 * B * Skv * nkv * hd) * \
        q.element_size()
    return nbytes, 4 * B * nq * hd * kb.attention_pairs(Sq, Skv, causal,
                                                         window, q_offset)


def leaf_work(name: str, args, kwargs) -> Tuple[float, float, float]:
    """(bytes, product FLOPs, elementwise FLOPs) of one call of the kernel
    ``name`` on these inputs: the work its bound in the kernel table
    counts."""
    if name == "flash_attention":
        q, k, _ = args
        nbytes, flops = attention_work(
            q, k, kwargs.get("causal", True), kwargs.get("window"),
            kwargs.get("q_offset", 0))
        return nbytes, flops, 0.0
    if name == "selective_scan":
        dt, Bm = args[0], args[2]
        B, S, di = dt.shape
        nbytes, flops, _ = kb.selective_scan_work(B, S, di, Bm.shape[-1],
                                                  dt.element_size())
        return nbytes, 0.0, flops
    if name == "jacobi_halo_sweeps":
        rows, g = args[0].shape
        nbytes, flops = kb.jacobi_halo_work(rows, g, kwargs["sweeps"])
        return nbytes, 0.0, flops
    if name == "jacobi_sweep":
        n = args[0].numel()
        return 3 * n * 8, 0.0, 5 * n
    if name in ("bellman", "bellman_block"):
        idx = args[0]
        rows, A, b = idx.shape
        # every gathered v entry read once (its distinct count needs the
        # values; a meta tensor has none, so all of v is the bound's)
        touched = (args[3].numel() if idx.device.type == "meta"
                   else int(idx.unique().numel()))
        block = name == "bellman_block"
        nbytes = idx.numel() * 4 + (idx.numel() + rows * A + touched
                                    + rows * (2 if block else 1)) * 8
        flops = rows * A * (2 * b + 2) + rows * A + (3 * rows if block else 0)
        return nbytes, 0.0, flops
    if name == "anderson_mix":
        h, N = args[0].shape
        nbytes, flops = kb.anderson_work(h, N)
        return nbytes, 0.0, flops
    if name == "moe_expert_ffn":
        x, wi, _, used = args
        T, d = x.shape
        E, f = wi.shape[0], wi.shape[-1]
        # the picked experts (a meta tensor has no values: the copy's
        # bound, as the plain version sizes it)
        picks = kwargs.get("picks")
        picked = (min(E, E if picks is None else picks)
                  if used.device.type == "meta"
                  else int((used[:E] != 0).sum()))
        nbytes, flops = kb.moe_expert_ffn_work(picked, T, d, f,
                                               x.element_size(),
                                               gated=wi.ndim == 4)
        return nbytes, flops, 0.0
    raise KeyError(name)


def _leaf_outputs(name: str, args, kwargs):
    """The wrapper's outputs, shapes and dtypes only (flash, the scan), or
    its plain version's (the others) run uncounted."""
    if name == "flash_attention":
        return torch.empty_like(args[0])
    if name == "selective_scan":
        dt, A = args[0], args[4]
        B, S, di = dt.shape
        f32 = dict(dtype=torch.float32, device=dt.device)
        return (torch.empty((B, S, di), **f32),
                torch.empty((B, di, A.shape[1]), **f32))
    return getattr(ref, name)(*args, **kwargs)


def _leaf(name: str, st: OpStats, counter: _Counter) -> Callable:
    def leaf(*args, **kwargs):
        nbytes, dot, other = leaf_work(name, args, kwargs)
        rec = st.leaves.setdefault(name, {"calls": 0, "bytes": 0.0,
                                          "dot_flops": 0.0, "flops": 0.0})
        rec["calls"] += 1
        rec["bytes"] += nbytes
        rec["dot_flops"] += dot
        rec["flops"] += other
        st.traffic_bytes += nbytes
        st.leaf_flops += other
        if dot:
            st.add_dot(dot, args[0].dtype)
        counter.paused += 1
        try:
            return _leaf_outputs(name, args, kwargs)
        finally:
            counter.paused -= 1
    return leaf


@contextlib.contextmanager
def counting(flop_counter: bool = False) -> Iterator[OpStats]:
    """Count everything run inside the block into the yielded
    :class:`OpStats`; the kernel entry points of ``ops`` are leaves for
    its duration.  ``flop_counter`` also runs ``FlopCounterMode`` and
    keeps its total in ``flop_counter_flops``."""
    st = OpStats()
    counter = _Counter(st)
    saved = {name: getattr(ops, name) for name in ops.KERNELS}
    with contextlib.ExitStack() as stack:
        fc = None
        if flop_counter:
            from torch.utils.flop_counter import FlopCounterMode

            fc = stack.enter_context(FlopCounterMode(display=False))
        for name in ops.KERNELS:
            setattr(ops, name, _leaf(name, st, counter))
        stack.callback(lambda: [setattr(ops, n, f) for n, f in saved.items()])
        stack.enter_context(coll.observing(st.add_collective))
        stack.enter_context(counter)
        yield st
    if fc is not None:
        st.flop_counter_flops = float(fc.get_total_flops())


def analyze(fn: Callable, *args, flop_counter: bool = False,
            **kwargs) -> Tuple[Any, OpStats]:
    """``fn(*args, **kwargs)`` under :func:`counting`: its result and what
    it did."""
    with counting(flop_counter) as st:
        out = fn(*args, **kwargs)
    return out, st


def _combine(base, lo, hi, k: float):
    """``base + k * (hi - lo)``, key by key for dicts."""
    if any(isinstance(x, dict) for x in (base, lo, hi)):
        base, lo, hi = base or {}, lo or {}, hi or {}
        zero = {} if any(isinstance(v, dict) for d in (base, lo, hi)
                         for v in d.values()) else 0
        return {key: _combine(base.get(key, zero), lo.get(key, zero),
                              hi.get(key, zero), k)
                for key in set(base) | set(lo) | set(hi)}
    return base + k * (hi - lo)


def add_repeats(st: OpStats, start: OpStats, end: OpStats,
                k: int) -> OpStats:
    """``st`` plus ``k`` more runs of what ran between the snapshots
    ``start`` and ``end`` (:func:`snapshot`): a train step's identical
    microbatches counted once each and scaled to the rest."""
    out = OpStats()
    for f in dataclasses.fields(OpStats):
        setattr(out, f.name, _combine(getattr(st, f.name),
                                      getattr(start, f.name),
                                      getattr(end, f.name), k))
    return out


def add_into(st: OpStats, other: OpStats) -> None:
    """Add every count of ``other`` to ``st`` in place."""
    zero = OpStats()
    for f in dataclasses.fields(OpStats):
        setattr(st, f.name, _combine(getattr(st, f.name),
                                     getattr(zero, f.name),
                                     getattr(other, f.name), 1))


def snapshot(st: OpStats) -> OpStats:
    """A copy of the counts so far, inside :func:`counting`'s block."""
    return copy.deepcopy(st)
