"""Control signals: what a closed-loop membership controller observes.

The probe is the observation half of :mod:`repro_torch.autoscale`: the
coordinator owns one :class:`SignalProbe` instance when (and only when)
``RunConfig.controller`` is set, feeds it one integer per applied arrival
(the update's staleness) and asks it at arrival ticks whether a control
decision is due.  When one is, :meth:`SignalProbe.sample` snapshots the
coordinator's counters into an immutable :class:`ControlSignals` — the
*only* interface a policy gets, which is what keeps policies uniform
across the virtual, thread, and process backends: the same numbers mean
the same thing whether ``t`` is virtual or wall seconds.

Zero-cost when disabled: a run without a controller never constructs a
probe, and the single ``if self.probe is not None`` guard on the arrival
path is the entire overhead — the scenario-free virtual hot loop stays
byte-identical.

The probe also owns the run's **worker-seconds integral** (the cost
model's first factor): ``accumulate(count, t)`` advances a piecewise-
constant integral of ``|active - paused|`` and is called at every
membership event and decision tick, so scripted preemptions stop the
meter exactly when the scenario says the instance was reclaimed.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Optional, Tuple

__all__ = ["ControlSignals", "SignalProbe"]


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence (0 if empty)."""
    if not sorted_vals:
        return 0.0
    idx = int(round(q * (len(sorted_vals) - 1)))
    return float(sorted_vals[idx])


@dataclass(frozen=True)
class ControlSignals:
    """One observation snapshot handed to ``Controller.decide``.

    Everything here is a plain value (no live references into the
    coordinator), so a policy cannot mutate engine state except through
    the :class:`~repro_torch.chaos.ScenarioEvent` actions it returns.
    """

    t: float  # backend clock (virtual or wall seconds)
    tick: int  # decision index, 0 = the pre-launch tick
    arrivals: int  # total worker returns so far (applied or not)
    worker_updates: int  # applied updates so far
    arrival_rate: float  # arrivals/sec since the previous decision
    staleness_p50: float  # median applied-update staleness, recent window
    staleness_p95: float  # p95 applied-update staleness, recent window
    staleness_window: Tuple[int, ...]  # the raw recent window (oldest first)
    stale_limit: int  # resolved accel_stale_limit (the bound to stay under)
    accel_fires: int
    accel_discards: int  # fires dropped by the commit staleness guard
    accel_partial_commits: int
    n_workers: int  # fleet size (ids 0..n_workers-1 may exist)
    active: FrozenSet[int]  # current membership
    paused: FrozenSet[int]  # active but not being dispatched
    scenario_down: FrozenSet[int]  # scripted away; not joinable by a policy
    service_fractions: Dict[int, float]  # per-worker share of applied updates
    queue_depth: int  # pending serve-layer requests (0 outside serve/)
    worker_seconds: float  # cost meter so far
    # Scripted events within the policy's lookahead horizon, as
    # (t, kind, worker) tuples — empty unless the controller declares
    # ``lookahead > 0`` and the run has a visible scenario.
    upcoming: Tuple[Tuple[float, str, Optional[int]], ...] = ()


class SignalProbe:
    """Arrival-tick sampler feeding a controller; owned by the coordinator.

    Decision cadence: a tick is *due* on the first call (so policies can
    shape the membership before the first dispatch), after ``tick_every``
    further arrivals (default: one fleet's worth), or — for the real
    backends' timed driver paths, where arrivals can stall while every
    member is down — after ``tick_dt`` seconds.  Extra ``controller_tick``
    calls between due points are cheap no-ops.
    """

    def __init__(self, cfg, n_workers: int, stale_limit: int,
                 controller) -> None:
        self.n_workers = int(n_workers)
        self.stale_limit = int(stale_limit)
        self.tick_every = int(getattr(controller, "tick_every", None)
                              or n_workers)
        self.tick_dt: Optional[float] = getattr(controller, "tick_dt", None)
        self.lookahead = float(getattr(controller, "lookahead", 0.0) or 0.0)
        self.queue_depth_fn: Optional[Callable[[], int]] = getattr(
            controller, "queue_depth_fn", None)
        self.staleness: deque = deque(maxlen=max(16, 4 * self.n_workers))
        # Telemetry adapter (attach_telemetry): when the run also carries a
        # TelemetryRecorder, the probe reads the recorder's staleness
        # window instead of maintaining a second copy of the same signal.
        self.telemetry_source = None
        self.ticks = 0
        self.worker_seconds = 0.0
        self._ws_t = 0.0  # clock position of the worker-seconds meter
        self._last_t = 0.0  # clock at the previous due decision
        self._last_arrivals = 0
        # Scenario visibility for drain-ahead policies: a sorted copy of the
        # script (the controller sees the forecast, never the clock itself).
        self._events: Tuple[Tuple[float, str, Optional[int]], ...] = ()
        if self.lookahead > 0.0 and getattr(cfg, "scenario", None) is not None:
            self._events = tuple(
                (float(ev.t), ev.kind, ev.worker)
                for ev in cfg.scenario.sorted_events())

    # ------------------------------------------------------------------ #
    def attach_telemetry(self, recorder) -> None:
        """Share the telemetry recorder's staleness window.

        The recorder's ``observe_staleness`` runs first on the arrival
        path (same ``maxlen`` formula, same feed order), so the probe's
        :meth:`observe` becomes a no-op and both planes read one buffer —
        a controller and an exporter can never disagree about the recent
        staleness distribution.
        """
        self.telemetry_source = recorder
        self.staleness = recorder.staleness_window

    def observe(self, staleness: int) -> None:
        """Record one applied update's staleness (arrival path)."""
        if self.telemetry_source is not None:
            return  # the recorder already fed the shared window
        self.staleness.append(staleness)

    def accumulate(self, member_count: int, t: float) -> None:
        """Advance the worker-seconds meter to ``t`` at the *old* count.

        Call with the membership size that held since the last call —
        i.e. before applying a membership event at ``t``.
        """
        dt = t - self._ws_t
        if dt > 0.0:
            self.worker_seconds += member_count * dt
            self._ws_t = t

    def due(self, arrivals: int, t: float) -> bool:
        if self.ticks == 0:
            return True
        if arrivals - self._last_arrivals >= self.tick_every:
            return True
        return (self.tick_dt is not None
                and t - self._last_t >= self.tick_dt)

    # ------------------------------------------------------------------ #
    def sample(self, coord, t: float,
               arrivals: Optional[int] = None) -> ControlSignals:
        """Snapshot the coordinator into a ControlSignals and advance.

        ``arrivals`` overrides ``coord.arrivals`` for the virtual loops,
        which keep their own event-loop counters."""
        if arrivals is None:
            arrivals = coord.arrivals
        dt = t - self._last_t
        rate = ((arrivals - self._last_arrivals) / dt) if dt > 0.0 else 0.0
        window = tuple(self.staleness)
        svals = sorted(window)
        applied = coord.applied_by_worker
        total = sum(applied.values()) or 1
        qd = 0
        if self.queue_depth_fn is not None:
            try:
                qd = int(self.queue_depth_fn())
            except Exception:
                qd = 0
        upcoming: Tuple[Tuple[float, str, Optional[int]], ...] = ()
        if self._events:
            horizon = t + self.lookahead
            upcoming = tuple(ev for ev in self._events
                             if t <= ev[0] <= horizon)
        sig = ControlSignals(
            t=t,
            tick=self.ticks,
            arrivals=arrivals,
            worker_updates=coord.wu,
            arrival_rate=rate,
            staleness_p50=_percentile(svals, 0.50),
            staleness_p95=_percentile(svals, 0.95),
            staleness_window=window,
            stale_limit=self.stale_limit,
            accel_fires=coord.accel.n_fire if coord.accel is not None else 0,
            accel_discards=coord.accel_discards,
            accel_partial_commits=coord.accel_partial_commits,
            n_workers=self.n_workers,
            active=frozenset(coord.active),
            paused=frozenset(coord.paused),
            scenario_down=frozenset(coord.scenario_down),
            service_fractions={w: c / total for w, c in applied.items()},
            queue_depth=qd,
            worker_seconds=self.worker_seconds,
            upcoming=upcoming,
        )
        self.ticks += 1
        self._last_t = t
        self._last_arrivals = arrivals
        return sig
