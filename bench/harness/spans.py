"""Reading the program's own spans in a traced window: each device
operation put down to the host span its launch ran in, each span's self
and total device time, and the window's idle time split by the host's
innermost open span.

The program names its serving path's parts with ``record_function``
ranges while a profiler records (``repro_torch.telemetry.serving``);
this module keeps a frozen copy of their prefixes (:data:`PROGRAM`), so a
later change of the program's names does not move this yardstick, and
imports nothing of the program.  Kineto records those ranges, the
benchmark's ``bench.*`` spans, the CPU operators, the CUDA API calls
(``cuda*`` and ``cu*``) and the device operations on one clock.

A device operation is linked to the host by its CUPTI correlation id
(the CUDA API call with the same ``correlation_id``: a CPU
event that itself links to an operator), else by its
``linked_correlation_id`` (the CPU operator that launched it); the host
span it belongs to is the innermost one open at that call's start.
Where neither link is in the trace (on the card: the port's own kernels,
launched from its library), the innermost device-side mirror of the
ranges (``gpu_user_annotation``) holding the operation's start names
the span, and the host span of that name open at, or next opened after,
the launch of the operation before it on the device stands for its
launch.  :attr:`SpanTrace.links` counts how many took each way; an
operation with no link and no mirror is ``unattributed``.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import DeviceOp, Trace, kernel_group

__all__ = ["PROGRAM", "BENCH", "UNATTRIBUTED", "NONE", "HostSpan", "Op",
           "Timeline", "SpanTrace", "read_spans", "device_seconds",
           "self_by_group", "idle_seconds", "longest_gaps",
           "program_idle_seconds",
           "summary", "lines"]

#: prefixes of the program's span names (frozen copy)
PROGRAM = ("lm.", "lm_serve.")
BENCH = "bench."
#: the program span whose idle time is the host's wait on the device
SYNC = "lm_serve.sync"
#: where an operation's launch and mirror are both missing
UNATTRIBUTED = "unattributed"
#: where no host span is open
NONE = "none"
#: host operators and runtime calls this long are kept, to name the host
#: work in a long idle gap
LONG_NS = 500_000


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


@dataclass(frozen=True)
class HostSpan:
    name: str
    start_ns: int
    end_ns: int


@dataclass(frozen=True)
class Op:
    """A device operation and the span names open where it was launched,
    outermost first (None: no link and no mirror)."""
    name: str
    start_ns: int
    end_ns: int
    chain: Optional[Tuple[str, ...]]


class Timeline:
    """The spans open at each instant, as a piecewise-constant stack
    (outermost first); a span opens at its start and closes at its end,
    and of two open spans the later-started is the inner."""

    def __init__(self, spans: Sequence[HostSpan]):
        spans = [s for s in spans if s.end_ns > s.start_ns]
        marks = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                       + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
        self.names = [s.name for s in spans]
        self.times: List[int] = []
        self.stacks: List[Tuple[int, ...]] = []
        open_: List[int] = []
        k = 0
        while k < len(marks):
            t = marks[k][0]
            while k < len(marks) and marks[k][0] == t:
                _, opening, i = marks[k]
                if opening:
                    open_.append(i)
                else:
                    open_.remove(i)
                k += 1
            self.times.append(t)
            self.stacks.append(tuple(open_))

    def _index(self, t_ns: int) -> int:
        return bisect.bisect_right(self.times, t_ns) - 1

    def chain(self, t_ns: int) -> Tuple[str, ...]:
        i = self._index(t_ns)
        return tuple(self.names[j] for j in self.stacks[i]) if i >= 0 else ()

    def parts(self, a: int, b: int):
        """(seconds, chain) of each piece of [a, b) with one stack."""
        i, t = self._index(a), a
        while t < b:
            end = min(self.times[i + 1] if i + 1 < len(self.times) else b, b)
            chain = (tuple(self.names[j] for j in self.stacks[i])
                     if i >= 0 else ())
            yield (end - t) / 1e9, chain
            t, i = end, i + 1


@dataclass
class SpanTrace:
    """One traced window: its device operations with their host span
    chains, the host spans, the window's bounds and how each operation
    was linked (``launch``, ``operator``, ``mirror``, ``none``)."""
    ops: List[Op]
    spans: List[HostSpan]
    start_ns: int
    end_ns: int
    links: Dict[str, int] = field(default_factory=dict)
    #: host operators and runtime calls of at least :data:`LONG_NS`
    long_calls: List[HostSpan] = field(default_factory=list)
    _timeline: Optional[Timeline] = field(default=None, repr=False)

    @property
    def timeline(self) -> Timeline:
        if self._timeline is None:
            self._timeline = Timeline(self.spans)
        return self._timeline

    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals inside the window
        (``trace.Trace.gaps``)."""
        return Trace([DeviceOp(o.name, o.start_ns, o.end_ns)
                      for o in self.ops], [], self.start_ns,
                     self.end_ns).gaps()


def read_spans(prof) -> SpanTrace:
    """A :class:`SpanTrace` from a finished ``torch.profiler.profile``
    whose window the benchmark marked with ``bench.window``."""
    from torch.autograd import DeviceType

    host: List[HostSpan] = []
    mirrors: List[HostSpan] = []
    launches: Dict[int, int] = {}  # CUPTI correlation id -> call's start
    operators: Dict[int, int] = {}  # CPU operator's id -> its start
    device = []
    long_calls: List[HostSpan] = []
    for e in prof.profiler.kineto_results.events():
        cuda = e.device_type() == DeviceType.CUDA
        name = e.name()
        if e.is_user_annotation():
            if name.startswith(PROGRAM) or name.startswith(BENCH):
                s = HostSpan(name, e.start_ns(),
                             e.start_ns() + e.duration_ns())
                (mirrors if cuda else host).append(s)
        elif cuda:
            device.append(e)
        elif e.linked_correlation_id() > 0:  # a CUDA API call
            launches[e.correlation_id()] = e.start_ns()
        else:
            operators[e.correlation_id()] = e.start_ns()
        if not cuda and not e.is_user_annotation() and \
                e.duration_ns() >= LONG_NS:
            long_calls.append(HostSpan(name, e.start_ns(),
                                       e.start_ns() + e.duration_ns()))
    windows = [s for s in host if s.name == BENCH + "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} bench.window "
                           f"spans, expected 1")
    timeline, mirror_line = Timeline(host), Timeline(mirrors)
    ends: Dict[str, List[int]] = collections.defaultdict(list)
    starts: Dict[str, List[int]] = collections.defaultdict(list)
    for h in sorted(host, key=lambda h: h.start_ns):
        ends[h.name].append(h.end_ns)
        starts[h.name].append(h.start_ns)
    links: Dict[str, int] = collections.Counter()
    ops: List[Op] = []
    before = -1  # the launch of the last linked operation on the device
    for e in sorted(device, key=lambda e: e.start_ns()):
        t = launches.get(e.correlation_id())
        how = "launch"
        if t is None:
            t, how = operators.get(e.linked_correlation_id()), "operator"
        if t is not None:
            before = t
        else:
            how = "none"
            name = (mirror_line.chain(e.start_ns()) or (None,))[-1]
            i = bisect.bisect_right(ends.get(name, []), before)
            if i < len(ends.get(name, [])):
                t, how = max(starts[name][i], before), "mirror"
        chain = None if t is None else timeline.chain(t)
        if how == "mirror" and name in chain:  # no deeper than the mirror
            chain = chain[:len(chain) - chain[::-1].index(name)]
        links[how] += 1
        ops.append(Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                      chain))
    w = windows[0]
    return SpanTrace(ops, host, w.start_ns, w.end_ns, dict(links),
                     long_calls, timeline)


def device_seconds(st: SpanTrace) -> Dict[str, Dict[str, float]]:
    """Device seconds by span name: ``self`` (operations whose innermost
    span it is; ``none`` where no span was open at the launch,
    ``unattributed`` where no link was found) and ``total`` (operations
    launched with it anywhere on the chain)."""
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: {"self": 0.0, "total": 0.0})
    for o in st.ops:
        s = (o.end_ns - o.start_ns) / 1e9
        if o.chain is None:
            names: Tuple[str, ...] = (UNATTRIBUTED,)
        else:
            names = o.chain or (NONE,)
        out[names[-1]]["self"] += s
        for n in set(names):
            out[n]["total"] += s
    return dict(out)


def self_by_group(st: SpanTrace) -> Dict[str, Dict[str, float]]:
    """Each span's self device seconds by kernel group (``trace.GROUPS``,
    the benchmark's frozen grouping)."""
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        collections.Counter)
    for o in st.ops:
        name = UNATTRIBUTED if o.chain is None else (o.chain or (NONE,))[-1]
        out[name][kernel_group(o.name)] += (o.end_ns - o.start_ns) / 1e9
    return {k: dict(v) for k, v in out.items()}


def idle_seconds(st: SpanTrace) -> Dict[str, float]:
    """The window's idle device seconds by the host's innermost open
    span (``none`` where none is open)."""
    out: Dict[str, float] = collections.Counter()
    for a, b in st.gaps():
        for s, chain in st.timeline.parts(a, b):
            out[chain[-1] if chain else NONE] += s
    return dict(out)


def program_idle_seconds(st: SpanTrace) -> float:
    """Idle device seconds during which the host's innermost open span
    is a program span other than the wait on the device."""
    return sum(s for n, s in idle_seconds(st).items()
               if is_program(n) and n != SYNC)


def longest_gaps(st: SpanTrace, top: int = 10) -> List[Dict]:
    """The ``top`` longest idle gaps: their milliseconds; over the
    largest part of each, the innermost span and the innermost program
    span; and the host call running through it: the shortest operator
    or runtime call that covers half the gap or more (``none``: the
    host was in Python, between profiled calls)."""
    out = []
    for a, b in sorted(st.gaps(), key=lambda g: g[0] - g[1])[:top]:
        _, chain = max(st.timeline.parts(a, b), key=lambda p: p[0])
        prog = [n for n in chain if is_program(n)]
        calls = [c for c in st.long_calls
                 if 2 * (min(c.end_ns, b) - max(c.start_ns, a)) >= b - a]
        call = min(calls, key=lambda c: c.end_ns - c.start_ns, default=None)
        out.append({"ms": (b - a) / 1e6,
                    "span": chain[-1] if chain else NONE,
                    "program_span": prog[-1] if prog else NONE,
                    "host_call": call.name if call else NONE,
                    "host_call_ms": ((call.end_ns - call.start_ns) / 1e6
                                     if call else 0.0)})
    return out


def summary(st: SpanTrace, n: int) -> Dict:
    """The window's spans, idle time and links, per call or step
    (``n`` of them) in milliseconds."""
    dev = device_seconds(st)
    total = sum((o.end_ns - o.start_ns) for o in st.ops) / 1e9
    self_sum = sum(v["self"] for v in dev.values())
    under_lm = sum((o.end_ns - o.start_ns) for o in st.ops if o.chain and
                   any(c.startswith("lm.") for c in o.chain)) / 1e9
    per = 1e3 / max(n, 1)
    return {
        "n": n,
        "program_ranges": (sum(is_program(h.name) for h in st.spans)
                           / max(n, 1)),
        "device_ms": total * per,
        "self_sum_ms": self_sum * per,
        "attributed_share": (1.0 - (dev.get(UNATTRIBUTED, {}).get("self", 0.0)
                                    + dev.get(NONE, {}).get("self", 0.0))
                             / total) if total else None,
        "lm_share": under_lm / total if total else None,
        "links": st.links,
        "spans": {k: {"self_ms": v["self"] * per,
                      "total_ms": v["total"] * per}
                  for k, v in sorted(dev.items(),
                                     key=lambda kv: -kv[1]["total"])},
        "self_by_group_ms": {k: {g: t * per for g, t in v.items()}
                             for k, v in self_by_group(st).items()},
        "idle_ms": {k: v * per for k, v in sorted(
            idle_seconds(st).items(), key=lambda kv: -kv[1])},
        "program_idle_ms": program_idle_seconds(st) * per,
        "longest_gaps": longest_gaps(st),
    }


def lines(s: Dict, unit: str) -> List[str]:
    """The ``[spans]``, ``[span-groups]`` and ``[gaps]`` log lines of a
    :func:`summary`."""
    spans = "; ".join(f"{k} self {v['self_ms']:.3f} total "
                      f"{v['total_ms']:.3f}" for k, v in s["spans"].items())
    idle = "; ".join(f"{k} {v:.3f}" for k, v in s["idle_ms"].items())
    gaps = "; ".join(f"{g['ms']:.3f} ms in {g['span']} "
                     f"({g['program_span']}; host {g['host_call']} "
                     f"{g['host_call_ms']:.3f} ms)"
                     for g in s["longest_gaps"])
    groups = "; ".join(
        f"{k}: " + ", ".join(f"{g} {t:.3f}" for g, t in sorted(
            v.items(), key=lambda gt: -gt[1]))
        for k, v in sorted(s["self_by_group_ms"].items(),
                           key=lambda kv: -sum(kv[1].values())))
    return [f"[spans] device ms a {unit} over {s['n']}: {spans}",
            f"[span-groups] self device ms a {unit} by kernel group: "
            f"{groups}",
            f"[gaps] idle ms a {unit}: {idle}; program idle "
            f"{s['program_idle_ms']:.3f}; longest: {gaps}"]
