"""Declarative chaos scenarios: scripted time-varying faults and membership.

A :class:`FaultScenario` is a list of timestamped :class:`ScenarioEvent`\\ s
— profile changes, preemptions, joins, pauses — that the engine backends
interpret against their own clock: *virtual seconds* on the virtual-time
simulator, *wall seconds* on the thread and process backends.  One script
therefore means the same thing everywhere, which is what lets the virtual
backend *predict* a scenario's sync/async behaviour before a real backend
measures it.  This is the port's copy of the reference's module: the same
grammar, builders and JSON form.

Scenario-script grammar
-----------------------
An event is ``(t, kind, worker, profile)`` with ``kind`` one of:

- ``set_profile`` — from time ``t`` the worker (or all workers when
  ``worker`` is None) draws delays/crashes from ``profile`` instead of
  ``RunConfig.faults``;
- ``preempt``     — the worker leaves the membership at ``t``: its
  in-flight result is discarded and its blocks are reassigned to the
  least-loaded survivors (handed back on join);
- ``join``        — the worker (re)joins at ``t`` and takes its home
  block back (plus any orphaned blocks);
- ``pause``       — the worker (or all) stops taking new work after its
  current task; its blocks stay assigned and its in-flight result still
  applies (unlike ``preempt``);
- ``resume``      — a paused worker is dispatched again;
- ``coordinator_crash`` — the control plane itself dies at ``t``:
  the backend raises :class:`repro_torch.recover.CoordinatorCrash` out of
  the run (workers drain their in-flight results first on the process
  backend).  Recovery resumes from the latest checkpoint
  (:func:`repro_torch.recover.resume_fixed_point`).

Delay-trace segments (``bimodal_delay``, ``ramp_delay``) are sugar that
compiles down to sequences of ``set_profile`` events, so every backend
interprets them with the same machinery.

Scenarios attach to a run via ``RunConfig.scenario`` (async and sync modes;
``selection="fixed"``; ``accel_eval="worker"`` on the real backends only).
The :class:`ScenarioClock` is the tiny interpreter the backends share: it
hands out events whose time has come, in order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

from ..core.engine.types import FaultProfile

__all__ = ["ScenarioEvent", "FaultScenario", "ScenarioClock", "EVENT_KINDS"]

EVENT_KINDS = ("set_profile", "preempt", "join", "pause", "resume",
               "coordinator_crash")


@dataclass
class ScenarioEvent:
    """One timestamped chaos event (see the module grammar)."""

    t: float
    kind: str
    worker: Optional[int] = None  # None => all workers (set_profile/pause/resume)
    profile: Optional[FaultProfile] = None  # set_profile only

    def to_dict(self) -> dict:
        d: dict = {"t": float(self.t), "kind": self.kind}
        if self.worker is not None:
            d["worker"] = int(self.worker)
        if self.profile is not None:
            d["profile"] = dataclasses.asdict(self.profile)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioEvent":
        prof = d.get("profile")
        return cls(
            t=float(d["t"]), kind=d["kind"], worker=d.get("worker"),
            profile=FaultProfile(**prof) if prof is not None else None,
        )


@dataclass
class FaultScenario:
    """An ordered script of chaos events; builder methods chain."""

    name: str = "custom"
    description: str = ""
    events: List[ScenarioEvent] = field(default_factory=list)

    # ------------------------------------------------------------------ #
    # Builders (each returns self so scripts read as one chained block)
    # ------------------------------------------------------------------ #
    def at(self, t: float, kind: str, worker: Optional[int] = None,
           profile: Optional[FaultProfile] = None) -> "FaultScenario":
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown scenario event kind {kind!r}; one of {EVENT_KINDS}")
        self.events.append(ScenarioEvent(t, kind, worker, profile))
        return self

    def set_profile(self, t: float, profile: FaultProfile,
                    worker: Optional[int] = None) -> "FaultScenario":
        return self.at(t, "set_profile", worker, profile)

    def preempt(self, t: float, worker: int) -> "FaultScenario":
        return self.at(t, "preempt", worker)

    def join(self, t: float, worker: int) -> "FaultScenario":
        return self.at(t, "join", worker)

    def pause(self, t: float, worker: Optional[int] = None) -> "FaultScenario":
        return self.at(t, "pause", worker)

    def resume(self, t: float, worker: Optional[int] = None) -> "FaultScenario":
        return self.at(t, "resume", worker)

    def coordinator_crash(self, t: float) -> "FaultScenario":
        """Kill the control plane at ``t`` (raises CoordinatorCrash)."""
        return self.at(t, "coordinator_crash")

    # ------------------------------------------------------------------ #
    # Delay-trace segments (compile to set_profile sequences)
    # ------------------------------------------------------------------ #
    def bimodal_delay(self, t0: float, t1: float, period: float,
                      slow: FaultProfile,
                      fast: Optional[FaultProfile] = None,
                      worker: Optional[int] = None) -> "FaultScenario":
        """Alternate ``slow``/``fast`` profiles every ``period`` over
        ``[t0, t1)`` — the bimodal-straggler regime of Hannah & Yin's
        heterogeneous-delay analysis."""
        if period <= 0:
            raise ValueError("bimodal_delay needs period > 0")
        fast = fast if fast is not None else FaultProfile()
        t, hot = float(t0), True
        while t < t1:
            self.set_profile(t, slow if hot else fast, worker)
            t, hot = t + period, not hot
        self.set_profile(float(t1), fast, worker)
        return self

    def ramp_delay(self, t0: float, t1: float, d0: float, d1: float,
                   steps: int = 8,
                   worker: Optional[int] = None) -> "FaultScenario":
        """Linearly ramp ``delay_mean`` from ``d0`` to ``d1`` over
        ``[t0, t1]`` in ``steps`` piecewise-constant segments."""
        if steps < 1:
            raise ValueError("ramp_delay needs steps >= 1")
        for k in range(steps + 1):
            frac = k / steps
            self.set_profile(
                t0 + frac * (t1 - t0),
                FaultProfile(delay_mean=d0 + frac * (d1 - d0)), worker)
        return self

    # ------------------------------------------------------------------ #
    def sorted_events(self) -> List[ScenarioEvent]:
        """Events by time, ties broken by insertion order (stable sort)."""
        return sorted(self.events, key=lambda ev: ev.t)

    def scaled(self, factor: float) -> "FaultScenario":
        """Same script with every timestamp multiplied by ``factor``
        (stretch a scenario to a slower problem without re-authoring it)."""
        out = FaultScenario(self.name, self.description)
        out.events = [dataclasses.replace(ev, t=ev.t * factor)
                      for ev in self.events]
        return out

    def validate(self, n_workers: int) -> None:
        """Raise ValueError on events no run with ``n_workers`` can honour."""
        for ev in self.events:
            if ev.kind not in EVENT_KINDS:
                raise ValueError(f"unknown event kind {ev.kind!r}")
            if ev.t < 0.0:
                raise ValueError(f"negative event time {ev.t}")
            if ev.kind in ("preempt", "join") and ev.worker is None:
                raise ValueError(f"{ev.kind} needs an explicit worker")
            if ev.kind == "coordinator_crash" and ev.worker is not None:
                raise ValueError(
                    "coordinator_crash kills the control plane, not a "
                    "worker; leave worker unset")
            if ev.worker is not None and not 0 <= ev.worker < n_workers:
                raise ValueError(
                    f"event worker {ev.worker} out of range for "
                    f"n_workers={n_workers} (elastic membership is a subset "
                    "of the configured worker set)")
            if ev.kind == "set_profile" and ev.profile is None:
                raise ValueError("set_profile needs a FaultProfile")

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {"name": self.name, "description": self.description,
                "events": [ev.to_dict() for ev in self.events]}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultScenario":
        out = cls(d.get("name", "custom"), d.get("description", ""))
        out.events = [ScenarioEvent.from_dict(e) for e in d.get("events", [])]
        return out


class ScenarioClock:
    """Orders a scenario's events and hands out the ones that are due.

    Backends call :meth:`due` with *their* notion of "now" (virtual seconds
    or wall seconds) at the points where they can act on events, and use
    :meth:`next_time` to bound waits so no event is discovered late.
    """

    def __init__(self, scenario: Optional[FaultScenario]):
        self._events = scenario.sorted_events() if scenario is not None else []
        self._i = 0

    def due(self, now: float) -> List[ScenarioEvent]:
        """Pop (in order) every event with ``t <= now``."""
        out = []
        while self._i < len(self._events) and self._events[self._i].t <= now:
            out.append(self._events[self._i])
            self._i += 1
        return out

    def next_time(self) -> Optional[float]:
        """Timestamp of the next undelivered event, or None when drained."""
        return self._events[self._i].t if self._i < len(self._events) else None

    def drain(self) -> List[ScenarioEvent]:
        """Pop every remaining event (virtual backend: heap-schedule them)."""
        out = self._events[self._i:]
        self._i = len(self._events)
        return out

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self._events)
