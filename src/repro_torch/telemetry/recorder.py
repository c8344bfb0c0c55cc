"""Ring-buffer telemetry recorder: typed spans + metric series.

This is the port's copy of the reference's recorder: stdlib only, the same
span taxonomy, metric names, capture format and summary, so a capture from
either package reads the same.

Design constraints, in order:

1. **Zero cost when off.**  The recorder only exists when
   ``RunConfig.telemetry`` is set; every hot-path hook in the engine is a
   single ``if coord.telemetry is not None`` guard, and the recorder never
   consumes rng or touches iterate floats, so virtual runs stay
   byte-identical with telemetry off *or on*.
2. **Lock-light when on.**  Emits append to ``collections.deque`` ring
   buffers (drop-oldest beyond ``TelemetryConfig.ring_size``, with a
   ``dropped`` counter so truncation is never silent) under one tiny
   internal lock; the thread backend emits almost entirely under the
   coordinator lock anyway, and process workers batch their spans over
   the existing result channel instead of sharing the recorder.
3. **One clock per capture.**  Spans carry the *backend's* clock (virtual
   seconds on the virtual backend, ``elapsed()`` wall seconds on the real
   ones) installed via :meth:`TelemetryRecorder.install_clock` /
   :meth:`set_time`; host-side (perf_counter) durations ride along in
   span args where the two differ (inline fires on virtual time).

What a span covers on the card: the port's problems cross to host numpy at
the ``FixedPointProblem`` boundary, so every evaluation a span brackets
(a block update, a full map, a residual norm) has synchronized with the
device before the span closes; the recorder adds no synchronization.

Span taxonomy (``SPAN_KINDS``) and metric registry (``METRICS``) are the
single source of truth: every :data:`repro_torch.chaos.scenario.EVENT_KINDS`
entry and every trace-event kind has a mapping here (``SCENARIO_SPAN_MAP``
/ ``TRACE_SPAN_MAP``), so an event kind can never be silently
uninstrumented.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "METRICS",
    "SCENARIO_SPAN_MAP",
    "SPAN_KINDS",
    "TRACE_SPAN_MAP",
    "TelemetryCapture",
    "TelemetryConfig",
    "TelemetryRecorder",
    "as_telemetry_config",
    "worker_lane",
]

TELEMETRY_VERSION = 1

#: Span kinds -> what the span covers (the reference's text, word for word,
#: so captures of both packages carry one taxonomy).
SPAN_KINDS: Dict[str, str] = {
    "task": "one worker task: dispatch -> compute -> arrival, with "
            "disposition (applied/filtered/crash/preempt_discard) and "
            "applied staleness",
    "compute": "worker-side kernel evaluation only (process/ray workers "
               "measure it locally and ship batches over the result "
               "channel; anchored at the parent's receive clock)",
    "fire": "accel begin -> feed -> commit window, with the commit "
            "verdict (accept/fallback/discard/partial) and pin mode",
    "record": "residual record: evaluation -> history append",
    "eval": "one offloaded evaluation item (full-map or residual norm) "
            "served by a worker/eval thread",
    "checkpoint": "checkpoint capture + atomic write",
    "restore": "checkpoint restore into a fresh coordinator (instant)",
    "sdc_screen": "SDC guard rejection of one arriving block (instant)",
    "serve": "serve-layer request: admission -> dispatch -> finish, with "
             "tenant and queueing delay",
    "scenario": "scripted or controller-issued scenario event (instant)",
    "restart": "worker crash-restart rejoin (instant)",
}

#: Metric series -> meaning (the reference's names and text).
METRICS: Dict[str, str] = {
    "staleness": "applied-update staleness histogram (value -> count)",
    "residual": "residual norm vs backend clock, one point per record",
    "busy_frac": "coordinator busy fraction over time (busy_s / t; "
                 "host-clock fraction on the virtual backend, where "
                 "coordinator work is free in virtual time)",
    "pool_leases": "outstanding leases on this run's warm worker pool "
                   "at acquire time (process backend)",
    "pool_respawns": "times this run's pool family had to be rebuilt "
                     "from scratch (0 = every run rode one warm pool)",
    "queue_depth": "serve-layer pending request queue depth over time",
}

#: Every ``repro_torch.chaos.scenario.EVENT_KINDS`` entry maps to a span kind.
SCENARIO_SPAN_MAP: Dict[str, str] = {
    "set_profile": "scenario",
    "preempt": "scenario",
    "join": "scenario",
    "pause": "scenario",
    "resume": "scenario",
    "coordinator_crash": "scenario",
}

#: Every ``repro_torch.chaos.trace`` event kind maps to a span kind, so a
#: trace-captured run and a telemetry capture describe the same events.
TRACE_SPAN_MAP: Dict[str, str] = {
    "dispatch": "task",
    "arrival": "task",
    "restart": "restart",
    "fire": "fire",
    "record": "record",
    "offload": "eval",
    "scenario": "scenario",
}


def worker_lane(worker: int, gen: int = 0) -> str:
    """Timeline lane for one worker *incarnation*.

    A preempted worker's rejoin gets a fresh lane (``w3#r1``), so
    evictions show as a lane that simply ends — the gap the paper's
    straggler/preemption story is about is visible, not averaged away.
    """
    return f"w{worker}" if gen == 0 else f"w{worker}#r{gen}"


@dataclass
class TelemetryConfig:
    """Knobs for one recorder (``RunConfig.telemetry`` accepts this or
    ``True`` for all-defaults)."""

    ring_size: int = 65536  # max retained events; oldest dropped beyond
    series_size: int = 4096  # max points per metric series
    series_every: int = 16  # busy-frac sampling cadence, in arrival ticks
    worker_batch: int = 32  # process worker-side span batch size

    def __post_init__(self) -> None:
        if self.ring_size < 1:
            raise ValueError("ring_size must be >= 1")
        if self.series_size < 1:
            raise ValueError("series_size must be >= 1")
        if self.series_every < 1:
            raise ValueError("series_every must be >= 1")
        if self.worker_batch < 1:
            raise ValueError("worker_batch must be >= 1")


def as_telemetry_config(knob) -> TelemetryConfig:
    """Normalize the ``RunConfig.telemetry`` knob (``True`` or a config)."""
    if isinstance(knob, TelemetryConfig):
        return knob
    if knob is True:
        return TelemetryConfig()
    raise TypeError(
        f"telemetry must be None, True, or a TelemetryConfig, got {knob!r}")


@dataclass
class TelemetryCapture:
    """One finished capture: meta + event ring + series + summary.

    JSON-serializable end to end; :mod:`repro_torch.telemetry.export` renders
    it and ``repro_torch.launch.run_report`` reads it back from disk.
    """

    meta: dict = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    series: Dict[str, list] = field(default_factory=dict)
    summary: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"version": TELEMETRY_VERSION, "meta": self.meta,
                "events": self.events, "series": self.series,
                "summary": self.summary}

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryCapture":
        if d.get("version", TELEMETRY_VERSION) != TELEMETRY_VERSION:
            raise ValueError(
                f"unsupported telemetry version {d.get('version')!r}")
        return cls(meta=dict(d.get("meta", {})),
                   events=list(d.get("events", [])),
                   series=dict(d.get("series", {})),
                   summary=dict(d.get("summary", {})))

    def save(self, path: str) -> str:
        import json

        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    @classmethod
    def load(cls, path: str) -> "TelemetryCapture":
        import json

        with open(path) as f:
            return cls.from_dict(json.load(f))


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of a sorted sequence (0 if empty)."""
    if not sorted_vals:
        return 0.0
    idx = int(round(q * (len(sorted_vals) - 1)))
    return float(sorted_vals[idx])


class TelemetryRecorder:
    """Collects spans and metric series for one run (or one service).

    Emit paths never raise on full buffers — the oldest event drops and
    ``dropped`` counts it.  All public emit methods are thread-safe.
    """

    def __init__(self, cfg: Optional[TelemetryConfig] = None,
                 meta: Optional[dict] = None, n_workers: int = 1):
        self.cfg = cfg or TelemetryConfig()
        self.meta: dict = dict(meta or {})
        self._lock = threading.Lock()
        self.events: deque = deque(maxlen=self.cfg.ring_size)
        self.series: Dict[str, deque] = {}
        self.dropped = 0
        self.span_counts: Dict[str, int] = {}
        # Applied-staleness: exact histogram (small int keys) plus a
        # bounded recent window shared with the autoscale SignalProbe
        # (the ``telemetry_source`` adapter) so both read one buffer.
        self.staleness_hist: Dict[int, int] = {}
        self.staleness_window: deque = deque(
            maxlen=max(16, 4 * int(n_workers)))
        self.staleness_n = 0
        # Fire ledger (verdict -> count), fed by the fire spans.
        self.fires: Dict[str, int] = {}
        # In-flight task tracking: lane-keyed open dispatches.  The open
        # count is what lets inline fires report ``fire_window_arrivals``
        # (arrivals whose flight overlapped the fire — see
        # ``Coordinator.maybe_fire_accel``).
        self._open: Dict[Tuple[int, int], Tuple[float, Optional[int]]] = {}
        # Clocks: the backend installs its own (virtual or elapsed-wall);
        # until then ``now()`` is host seconds since construction.
        self._t0_host = time.perf_counter()
        self._now: Optional[Callable[[], float]] = None
        self._vt = 0.0
        # Host-side coordinator busy accounting (virtual inline runs have
        # no backend-metered busy_s; this is the recorder-side fallback).
        self.host_busy_s = 0.0
        self._busy_tick = 0

    # ---- clocks ------------------------------------------------------- #
    def install_clock(self, fn: Callable[[], float]) -> None:
        """Real backends: route ``now()`` to the loop's ``elapsed()``."""
        self._now = fn

    def set_time(self, t: float) -> None:
        """Virtual backend: pin ``now()`` to the event loop's clock."""
        self._vt = float(t)
        if self._now is not self._read_vt:
            self._now = self._read_vt

    def _read_vt(self) -> float:
        return self._vt

    def now(self) -> float:
        if self._now is not None:
            return self._now()
        return time.perf_counter() - self._t0_host

    def host_elapsed(self) -> float:
        return time.perf_counter() - self._t0_host

    def host_busy_frac(self) -> float:
        """Fraction of host time spent in coordinator-side math."""
        el = self.host_elapsed()
        return min(1.0, self.host_busy_s / el) if el > 0 else 0.0

    @contextmanager
    def host_busy(self):
        """Charge a host-clock coordinator section (inline fires/records
        on the virtual backend, where virtual time charges nothing)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_busy_s += time.perf_counter() - t0

    # ---- raw emits ---------------------------------------------------- #
    def _emit(self, ev: dict) -> None:
        with self._lock:
            k = ev["k"]
            self.span_counts[k] = self.span_counts.get(k, 0) + 1
            if len(self.events) == self.events.maxlen:
                self.dropped += 1
            self.events.append(ev)

    def span(self, kind: str, lane: str, t0: float, t1: float,
             **args) -> None:
        ev = {"k": kind, "lane": lane, "t0": float(t0),
              "t1": float(max(t0, t1))}
        if args:
            ev.update(args)
        self._emit(ev)

    def instant(self, kind: str, lane: str, t: Optional[float] = None,
                **args) -> None:
        ev = {"k": kind, "lane": lane,
              "t": float(self.now() if t is None else t)}
        if args:
            ev.update(args)
        self._emit(ev)

    def series_point(self, metric: str, t: float, value: float) -> None:
        with self._lock:
            s = self.series.get(metric)
            if s is None:
                s = self.series[metric] = deque(maxlen=self.cfg.series_size)
            s.append((float(t), float(value)))

    # ---- engine hooks ------------------------------------------------- #
    def observe_staleness(self, s: int) -> None:
        s = int(s)
        with self._lock:
            self.staleness_hist[s] = self.staleness_hist.get(s, 0) + 1
            self.staleness_window.append(s)
            self.staleness_n += 1

    def task_open(self, worker: int, t: Optional[float] = None,
                  gen: int = 0, block: Optional[int] = None) -> None:
        t = self.now() if t is None else float(t)
        with self._lock:
            self._open[(int(worker), int(gen))] = (t, block)

    def task_close(self, worker: int, t: Optional[float] = None,
                   disp: str = "applied", staleness: int = 0,
                   gen: int = 0) -> None:
        t = self.now() if t is None else float(t)
        with self._lock:
            entry = self._open.pop((int(worker), int(gen)), None)
        if entry is None:
            return  # truncated (e.g. a restore mid-flight): nothing to span
        t0, block = entry
        ev = {"k": "task", "lane": worker_lane(worker, gen),
              "t0": float(t0), "t1": float(max(t0, t)), "disp": disp,
              "s": int(staleness)}
        if block is not None:
            ev["b"] = int(block)
        self._emit(ev)

    @property
    def open_tasks(self) -> int:
        """Dispatches without an arrival yet (in-flight work)."""
        return len(self._open)

    def fire_span(self, t0: float, t1: float, verdict: str,
                  **args) -> None:
        with self._lock:
            self.fires[verdict] = self.fires.get(verdict, 0) + 1
        self.span("fire", "coord", t0, t1, v=verdict, **args)

    def maybe_sample_busy(self, t: float, busy_s: float) -> None:
        """Sample the busy-fraction series every ``series_every`` ticks.

        Real backends pass their metered ``coord.busy_s``; when that is
        zero (virtual inline runs, where coordinator work costs no
        virtual time) the host-clock fraction stands in, which closes the
        inline observability gap for ``coordinator_busy_frac``.
        """
        self._busy_tick += 1
        if self._busy_tick % self.cfg.series_every:
            return
        frac = (min(1.0, busy_s / t) if (busy_s > 0.0 and t > 0.0)
                else self.host_busy_frac())
        self.series_point("busy_frac", t, frac)

    def merge_worker_batch(self, worker: int, batch, recv_t: float) -> None:
        """Fold a process worker's shipped span batch into the ring.

        Workers measure compute with their own ``perf_counter`` (not
        comparable across processes), so each batch entry is
        ``(age_s, dur_s, kind)`` — *age* is how long before the batch
        send the span ended.  Anchoring ``t1 = recv_t - age`` keeps every
        lane on the parent's clock with only queue-transit skew.
        """
        for age, dur, kind in batch:
            t1 = max(0.0, float(recv_t) - float(age))
            t0 = max(0.0, t1 - float(dur))
            self.span(str(kind), worker_lane(worker), t0, t1, src="worker")

    # ---- summary / capture ------------------------------------------- #
    def staleness_percentile(self, q: float) -> float:
        """Exact nearest-rank percentile over the full histogram."""
        with self._lock:
            items = sorted(self.staleness_hist.items())
            n = self.staleness_n
        if n == 0:
            return 0.0
        rank = int(round(q * (n - 1)))
        seen = 0
        for value, count in items:
            seen += count
            if rank < seen:
                return float(value)
        return float(items[-1][0])

    def summary(self) -> dict:
        """Compact run digest (``RunResult.telemetry_summary``)."""
        with self._lock:
            busy = list(self.series.get("busy_frac", ()))
            counts = dict(self.span_counts)
            fires = dict(self.fires)
            dropped = self.dropped
            n = self.staleness_n
        return {
            "version": TELEMETRY_VERSION,
            "staleness_p50": self.staleness_percentile(0.50),
            "staleness_p95": self.staleness_percentile(0.95),
            "staleness_n": n,
            "busy_frac_tail": [round(v, 6) for _, v in busy[-8:]],
            "span_counts": counts,
            "fires": fires,
            "events_dropped": dropped,
        }

    def to_capture(self) -> TelemetryCapture:
        with self._lock:
            events = list(self.events)
            series = {k: [list(p) for p in v] for k, v in self.series.items()}
            series["staleness"] = [
                [int(s), int(c)]
                for s, c in sorted(self.staleness_hist.items())]
        return TelemetryCapture(meta=dict(self.meta), events=events,
                                series=series, summary=self.summary())

    def finalize(self, t: float, busy_s: float = 0.0) -> None:
        """Close out the capture at the run's final clock ``t``."""
        self.meta.setdefault("t_end", float(t))
        self.meta.setdefault("host_elapsed_s", self.host_elapsed())
        # One final busy sample so even short runs get a series point.
        frac = (min(1.0, busy_s / t) if (busy_s > 0.0 and t > 0.0)
                else self.host_busy_frac())
        self.series_point("busy_frac", float(t), frac)


def percentile_of(values, q: float) -> float:
    """Convenience for exporters/tests: nearest-rank of an iterable."""
    return _percentile(sorted(values), q)
