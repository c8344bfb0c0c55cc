"""Deterministic trace capture and virtual-time replay.

A real-backend run with ``RunConfig.capture_trace=True`` records its event
trace — dispatches, arrivals (with dispositions and staleness), crashes,
restarts, accel fires, residual records, offloaded evaluations, scenario
events — as it executes.  The trace is the *schedule skeleton* of the run:
it pins the global order of coordinator interactions without storing any
iterate bytes, so it stays small (O(arrivals) dicts) and JSON-serializable
(:class:`RunTrace`).

:func:`replay_trace` re-executes a trace through a fresh coordinator on
virtual time: dispatches re-evaluate the recorded block on the replayed
state, arrivals re-apply in the recorded order with the recorded
dispositions (no rng is consumed), fires re-run the Anderson machine at
the recorded points, and records re-evaluate the residual.  For runs with
inline (coordinator-side) fires and ``noise_std=0`` this reproduces the
measured float trajectory *exactly* — the recorded lock/arrival order is
the only nondeterminism a real backend has — which makes replay a
postmortem microscope: :func:`trace_agreement` quantifies how closely the
replayed residual trajectory tracks the measured one per record point.

Known approximations (documented, not silent):

- ``noise_std > 0`` — the injected noise draws are not recorded, so a
  replayed noisy run diverges from the measured trajectory;
- ``accel_eval="worker"`` traces — offloaded fires are replayed as inline
  fires at their commit position (the pinned-iterate window is collapsed),
  so agreement is approximate rather than bit-exact;
- drop vs staleness filtering is recorded as one ``filtered`` disposition
  (replay counts them all as ``drops``);
- process-backend traces record ``dispatch`` when the coordinator
  *queues* the task, while the worker snapshots the iterate from shared
  memory slightly later — replay evaluates on the dispatch-time basis, so
  agreement there is close but not bit-exact.  Thread-backend traces
  (snapshot under the coordinator lock) and Ray-backend traces (the
  iterate is ``ray.put`` into the object store at dispatch) replay
  exactly.

This is the port's copy of the reference's module: the same JSON format
and version, so a trace captured by either package replays in the other.
Replay runs the problem it is given, on that problem's device.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..core.engine.coordinator import Coordinator, worker_eval
from ..core.engine.types import FaultProfile, RunConfig, RunResult
from .scenario import ScenarioEvent

__all__ = ["TraceRecorder", "RunTrace", "replay_trace", "trace_agreement",
           "TRACE_EVENT_KINDS"]

TRACE_VERSION = 1

#: Every event kind a :class:`TraceRecorder` can emit.
TRACE_EVENT_KINDS = ("dispatch", "arrival", "restart", "fire", "record",
                     "offload", "scenario")


@dataclass
class RunTrace:
    """A captured run trace: schedule metadata + ordered event dicts."""

    meta: dict = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"version": TRACE_VERSION, "meta": self.meta,
                "events": self.events}

    @classmethod
    def from_dict(cls, d: dict) -> "RunTrace":
        if d.get("version", TRACE_VERSION) != TRACE_VERSION:
            raise ValueError(f"unsupported trace version {d.get('version')}")
        return cls(meta=dict(d.get("meta", {})),
                   events=list(d.get("events", [])))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "RunTrace":
        return cls.from_dict(json.loads(s))

    def counts(self) -> dict:
        """Event-kind histogram (postmortem at-a-glance)."""
        out: dict = {}
        for ev in self.events:
            out[ev["k"]] = out.get(ev["k"], 0) + 1
        return out


class TraceRecorder:
    """Collects trace events during a run.

    Backends record ``dispatch``/``arrival``/``restart`` at their loop
    sites; the coordinator (when its ``tracer`` attribute is set) records
    ``fire``/``record``/``offload``/``scenario`` events from inside
    ``accel_commit``/``record``/``accel_feed``/``apply_scenario_event`` —
    so every loop that sets a tracer captures the coordinator-side events
    for free, in the exact order they interleave with arrivals.
    """

    def __init__(self, cfg: RunConfig, backend: str,
                 problem: Optional[object] = None):
        self.events: List[dict] = []
        self.meta = {
            "backend": backend,
            "n_workers": cfg.n_workers,
            "seed": cfg.seed,
            "mode": cfg.mode,
            "accel": cfg.accel is not None,
            "accel_eval": cfg.accel_eval,
            "scenario": (cfg.scenario.name
                         if getattr(cfg.scenario, "name", None) else None),
            "controller": getattr(cfg.controller, "name", None),
            "problem": type(problem).__name__ if problem is not None else None,
        }

    # ---- backend-loop hooks ------------------------------------------ #
    def dispatch(self, t: float, worker: int, block: Optional[int],
                 gen: int = 0) -> None:
        """``gen`` is the worker's incarnation (``Coordinator.preempt_gen``)
        at dispatch time; arrivals echo it so replay can match a result to
        its dispatch even when a preempted incarnation's result and a
        rejoined incarnation's dispatch are in flight simultaneously."""
        self.events.append({"k": "dispatch", "t": float(t), "w": int(worker),
                            "b": block if block is None else int(block),
                            "g": int(gen)})

    def arrival(self, t: float, worker: int, disp: str,
                staleness: int = 0, gen: int = 0) -> None:
        self.events.append({"k": "arrival", "t": float(t), "w": int(worker),
                            "d": disp, "s": int(staleness), "g": int(gen)})

    def restart(self, t: float, worker: int) -> None:
        self.events.append({"k": "restart", "t": float(t), "w": int(worker)})

    # ---- coordinator hooks ------------------------------------------- #
    def fire(self, verdict: str, t: Optional[float] = None) -> None:
        ev: dict = {"k": "fire", "v": verdict}
        if t is not None:
            ev["t"] = float(t)
        self.events.append(ev)

    def record(self, t: float, res: float) -> None:
        self.events.append({"k": "record", "t": float(t), "r": float(res)})

    def offload(self, kind: str) -> None:
        self.events.append({"k": "offload", "e": kind})

    def scenario_event(self, t: float, ev: ScenarioEvent) -> None:
        self.events.append({"k": "scenario", "t": float(t),
                            "ev": ev.to_dict()})

    def to_trace(self) -> RunTrace:
        return RunTrace(meta=dict(self.meta), events=self.events)


_NO_FAULT = FaultProfile()


def replay_trace(problem, trace: RunTrace, cfg: RunConfig) -> RunResult:
    """Re-execute a captured trace deterministically on virtual time.

    ``problem`` must be (an equal reconstruction of) the traced problem and
    ``cfg`` the traced run's config — replay reuses its accel settings and
    partitioning but ignores its executor, scenario, and fault channels
    (dispositions come from the trace, so no randomness is consumed).
    """
    import dataclasses as _dc

    if trace.meta.get("mode", "async") != "async":
        raise ValueError("only async traces replay (sync runs are already "
                         "deterministic given the round plan)")
    rcfg = _dc.replace(cfg, executor="virtual", scenario=None,
                       controller=None, capture_trace=False,
                       accel_eval="coordinator", eval_time=None)
    coord = Coordinator(problem, rcfg)
    # In-flight work keyed by (worker, incarnation): within one incarnation
    # a worker has at most one dispatch outstanding, and the incarnation
    # key keeps a preempted result from consuming the entry of a fresh
    # dispatch racing it (preempt + join while a result is in flight).
    pending: dict = {}  # (worker, gen) -> (indices, values)
    t = 0.0
    for ev in trace.events:
        k = ev["k"]
        t = float(ev.get("t", t))
        if k == "dispatch":
            w, b = ev["w"], ev["b"]
            if b is None:
                raise ValueError("trace has a non-fixed-selection dispatch; "
                                 "replay supports selection='fixed' only")
            idx = coord.blocks[b]
            pending[(w, ev.get("g", 0))] = (
                idx, worker_eval(problem, rcfg, coord.x, idx))
        elif k == "arrival":
            w, disp = ev["w"], ev["d"]
            entry = pending.pop((w, ev.get("g", 0)), None)
            if disp == "crash":
                coord.crashes += 1
            elif disp == "preempt_discard":
                coord.preempt_discards += 1
            elif entry is None:
                continue  # truncated trace: arrival without its dispatch
            elif disp == "filtered":
                coord.drops += 1
            else:
                idx, vals = entry
                coord.apply_return(idx, vals, _NO_FAULT,
                                   staleness=int(ev.get("s", 0)), worker=w)
        elif k == "fire":
            coord.maybe_fire_accel()
        elif k == "record":
            coord.record(t)
        elif k == "restart":
            coord.restarts += 1
        elif k == "scenario":
            coord.apply_scenario_event(ScenarioEvent.from_dict(ev["ev"]))
        # "offload" events are postmortem annotations; nothing to replay.
    return coord.result(t, coord.wu, coord.converged())


def trace_agreement(measured: RunResult, replayed: RunResult) -> dict:
    """Per-record measured-over-replay residual-trajectory agreement.

    Compares the two histories index-by-index over their common prefix.
    ``mean_abs_log10_ratio == 0`` is bit-exact agreement; values ≪ 1 mean
    the replay tracks the measured trajectory to well under an order of
    magnitude at every record point.
    """
    mh = [r for (_, _, r) in measured.history]
    rh = [r for (_, _, r) in replayed.history]
    n = min(len(mh), len(rh))
    logs = [abs(math.log10(m / r))
            for m, r in zip(mh[:n], rh[:n]) if m > 0 and r > 0]
    final = (mh[n - 1] / rh[n - 1]) if n and rh[n - 1] > 0 else float("nan")
    return {
        "records_compared": n,
        "records_measured": len(mh),
        "records_replayed": len(rh),
        "mean_abs_log10_ratio": float(np.mean(logs)) if logs else 0.0,
        "max_abs_log10_ratio": float(max(logs)) if logs else 0.0,
        "final_ratio": float(final),
    }
