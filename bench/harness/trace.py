"""Reading a traced window: device operations, the benchmark's host
spans, busy and idle time, and the breakdown.

The profiler (``torch.profiler``, CUPTI on the card) records the
window; :func:`read_trace` keeps the device operations (kernels, copies
and sets; the profiler's mirrors of host ranges are not operations) and
the benchmark's own host spans (``record_function`` ranges named
``bench.*``), both on the profiler's clock.  The kernel groups are a
frozen copy of ``repro_torch.launch.lm_profile``'s ``_GROUPS``: a later
change to the program's grouping does not move this yardstick.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["GROUPS", "kernel_group", "DeviceOp", "Span", "Trace",
           "read_trace", "merge", "breakdown"]

#: (group, substrings of a kernel's name in lower case), first match wins
GROUPS = (("flash_attention", ("flash_fwd_kernel", "flash_bf16_kernel")),
          ("selective_scan", ("selective_scan_kernel",)),
          ("matmul", ("gemm", "gemv", "sm90_", "cutlass", "xmma", "nvjet")),
          ("copies", ("memcpy", "memset")),
          ("moe_dispatch", ("topk", "sort", "index", "scatter", "gather",
                            "histogram")))

SPAN_PREFIX = "bench."
#: a device operation's name in the breakdown is cut to this many letters
NAME_CHARS = 160


def kernel_group(name: str) -> str:
    name = name.lower()
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """One traced window: its device operations and host spans, and the
    window's bounds (the ``bench.window`` span)."""

    ops: List[DeviceOp]
    spans: List[Span]
    start_ns: int
    end_ns: int
    _busy: Optional[List[Tuple[int, int]]] = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        if self._busy is None:
            self._busy = merge([(max(o.start_ns, self.start_ns),
                                 min(o.end_ns, self.end_ns))
                                for o in self.ops])
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def seconds_by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for o in self.ops:
            out[kernel_group(o.name)] += (o.end_ns - o.start_ns) / 1e9
        return dict(out)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for o in self.ops:
            out[o.name] += (o.end_ns - o.start_ns) / 1e9
        return dict(out)

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals of the device inside the window."""
        out, t = [], self.start_ns
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end_ns > t:
            out.append((t, self.end_ns))
        return out

    def span_at(self, t_ns: int) -> str:
        """The innermost benchmark span open on the host at ``t_ns``."""
        best: Optional[Span] = None
        for s in self.spans:
            if s.start_ns <= t_ns < s.end_ns and (
                    best is None or s.start_ns >= best.start_ns):
                best = s
        return best.name if best is not None else "none"


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _is_annotation(e) -> bool:
    """A ``record_function`` range (or the profiler's mirror of one on
    the device), not an operation."""
    try:
        return bool(e.is_user_annotation())
    except AttributeError:  # an older profiler: by the benchmark's names
        return e.name().startswith(SPAN_PREFIX)


def read_trace(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    window the benchmark marked with the span ``bench.window``."""
    from torch.autograd import DeviceType

    ops: List[DeviceOp] = []
    spans: List[Span] = []
    for e in prof.profiler.kineto_results.events():
        if _is_annotation(e):
            if e.device_type() == DeviceType.CPU and e.name().startswith(
                    SPAN_PREFIX):
                spans.append(Span(e.name(), e.start_ns(),
                                  e.start_ns() + e.duration_ns()))
            continue
        if e.device_type() == DeviceType.CUDA:
            ops.append(DeviceOp(e.name(), e.start_ns(),
                                e.start_ns() + e.duration_ns()))
    windows = [s for s in spans if s.name == SPAN_PREFIX + "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} bench.window "
                           f"spans, expected 1")
    w = windows[0]
    return Trace(ops, spans, w.start_ns, w.end_ns)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the longest idle
    gaps named by the benchmark span open on the host."""
    ops = sorted(trace.seconds_by_name().items(), key=lambda kv: -kv[1])
    gaps = sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:top]],
            "idle_gaps": [[trace.span_at(a), (b - a) / 1e9]
                          for a, b in gaps]}
