"""Coordinator logic shared by every execution backend.

The coordinator owns the global iterate ``x`` (host numpy, the reference
contract), applies worker returns in arrival order (with fault filtering),
fires Anderson/DIIS with the Eq. 5 safeguard, records the residual
history, and assembles the :class:`~repro_torch.core.engine.types.RunResult`.
Backends differ only in *how* worker evaluations are scheduled (virtual
event queue vs real threads).  This is the reference coordinator's apply,
accel (begin/feed/commit), record and result logic, with its elastic
membership, trace, checkpoint, autoscale-controller and telemetry hooks.

Evaluation pipeline
-------------------
The accel/record path is a *pure state machine* so its expensive
evaluations (the full map at the fire's pinned iterate, the Eq. 5
safeguard residual norms, the residual-history records) can run anywhere:

- :meth:`Coordinator.accel_begin` pins the current iterate and emits the
  first :class:`EvalItem`; :meth:`Coordinator.accel_feed` consumes one
  evaluated item and emits the next; :meth:`Coordinator.accel_commit`
  applies the accept/reject verdict against the *live* iterate — guarded
  by ``cfg.accel_stale_limit``.
- :meth:`Coordinator.record_begin` / :meth:`Coordinator.record_commit`
  give residual-history evaluations the same treatment.

:meth:`maybe_fire_accel` (the inline path every sync loop and the default
async mode use) drives exactly this state machine with immediate
evaluations.

Elastic membership (repro_torch.chaos)
--------------------------------------
The coordinator also owns the worker -> blocks assignment.  Statically it
is the identity (block ``w`` served by worker ``w``); chaos scenarios and
the SDC quarantine move it: ``preempt_worker`` rebalances a leaver's
blocks onto the least-loaded survivors (or orphans them when nobody is
left), ``join_worker`` hands the home block back, ``next_dispatch`` walks
a worker's assignment round-robin, and ``preempt_gen`` lets backends
recognize (and discard) results computed by a preempted incarnation.
A fire whose begin -> commit window crossed a membership change commits
only to the blocks whose ownership did not move.

The Anderson window lives on the problem's device (``problem.device``);
everything else here is host numpy.
"""

from __future__ import annotations

import time
from dataclasses import replace as _dc_replace
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..anderson import AndersonState
from ..fixedpoint import FixedPointProblem, as_block_slice, restrict
from .types import (
    CoordinatorCrash,
    FaultProfile,
    RunConfig,
    RunResult,
    _fault_for,
    _writable,
)

__all__ = [
    "Coordinator",
    "EvalItem",
    "AccelPlan",
    "RecordPlan",
    "worker_eval",
    "measure_compute",
    "warm_problem",
    "problem_payload",
    "rebuild_problem",
]


def measure_compute(problem: FixedPointProblem, blocks: Sequence[np.ndarray]) -> float:
    """Measure per-update compute cost of a representative block (warm)."""
    idx = blocks[0]
    problem.block_update(problem.initial(), idx)  # warm-up
    x = problem.initial()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        problem.block_update(x, idx)
    return max((time.perf_counter() - t0) / reps, 1e-7)


def worker_eval(
    problem: FixedPointProblem, cfg: RunConfig, x_snapshot: np.ndarray,
    indices: np.ndarray,
) -> np.ndarray:
    """The worker computation (on its stale snapshot)."""
    if cfg.return_mode == "full_map":
        return restrict(np.asarray(problem.full_map(x_snapshot)), indices)
    return np.asarray(problem.block_update(x_snapshot, indices))


def warm_problem(problem: FixedPointProblem, cfg: RunConfig,
                 blocks: Optional[Sequence[np.ndarray]] = None) -> None:
    """Run every block shape a run's dispatches will hit once, before the
    clock starts (the first CUDA call of a kernel builds and loads the
    library).  Selection warming uses plain aranges of the exact index-set
    sizes the run will produce, leaving the coordinator rng untouched."""
    x0 = problem.initial()
    if blocks is None:
        blocks = problem.default_blocks(cfg.n_workers)
    for blk in blocks:
        worker_eval(problem, cfg, x0, blk)
    if cfg.accel_eval == "worker":
        problem.full_map(x0)
        problem.residual_norm(x0)
    if cfg.selection != "fixed":
        k = cfg.selection_k or max(1, problem.n // cfg.n_workers)
        sizes = {min(k, problem.n)}
        if cfg.mode == "sync":
            total = min(cfg.n_workers * k, problem.n)
            sizes = {len(c) for c in
                     np.array_split(np.arange(total), cfg.n_workers)}
        for sz in sizes:
            if sz:
                worker_eval(problem, cfg, x0, np.arange(sz))


def problem_payload(problem: FixedPointProblem):
    """Picklable recipe for rebuilding ``problem`` in another interpreter.

    Prefers ``factory_spec()``; falls back to pickling the instance itself
    (fine for plain-numpy problems).  Raises with a pointer to
    ``factory_spec`` if neither works.
    """
    spec = problem.factory_spec()
    if spec is not None:
        return ("factory", spec)
    import pickle

    try:
        pickle.dumps(problem)
    except Exception as e:
        raise ValueError(
            f"{type(problem).__name__} cannot cross process boundaries: it "
            f"does not pickle ({e!r}) and defines no factory_spec(). "
            "Implement FixedPointProblem.factory_spec() returning "
            "(factory, args, kwargs)."
        ) from e
    return ("pickle", problem)


def rebuild_problem(payload) -> FixedPointProblem:
    kind, data = payload
    if kind == "factory":
        factory, args, kwargs = data
        return factory(*args, **kwargs)
    return data


def _validate_layers(cfg: RunConfig) -> None:
    """The reference coordinator's checks on the chaos, trace, controller
    and checkpoint knobs (same conditions, same messages)."""
    if (cfg.scenario is not None or cfg.capture_trace
            or cfg.controller is not None):
        # Scenarios, trace replay and controllers pin the dispatch schedule
        # to the memoized block partition.
        if cfg.selection != "fixed":
            raise ValueError(
                "chaos scenarios, trace capture and controllers require "
                f"selection='fixed' (got {cfg.selection!r})")
        if cfg.eval_time is not None:
            raise ValueError(
                "chaos scenarios / trace capture / controllers do not "
                "compose with the virtual eval-cost model (cfg.eval_time)")
    if cfg.capture_trace and cfg.mode == "sync":
        raise ValueError(
            "capture_trace records async schedules only (a sync run is "
            "already reproducible from its round plan)")
    if cfg.checkpoint_every is not None:
        if cfg.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 (got {cfg.checkpoint_every})")
        if not cfg.checkpoint_dir:
            raise ValueError(
                "checkpoint_every requires checkpoint_dir (where the "
                "SolveCheckpoint JSON + npz files land)")
        if cfg.mode != "async":
            raise ValueError(
                "checkpointing covers async solves only (a sync run is "
                "already reproducible from its round plan)")
        if cfg.accel_eval == "worker" or cfg.eval_time is not None:
            # Arrival boundaries are the consistency points; offloaded
            # fires keep evaluation plans in flight across them.
            raise ValueError(
                "checkpointing requires accel_eval='coordinator' and no "
                "eval_time (in-flight offloaded evaluations cannot be "
                "checkpointed)")
    if cfg.resume_from is not None:
        if (cfg.scenario is not None or cfg.controller is not None
                or cfg.capture_trace):
            raise ValueError(
                "a resumed run cannot re-attach a scenario, controller or "
                "trace capture (their state died with the control plane); "
                "use repro_torch.recover.resume_fixed_point, which strips "
                "them")
        if cfg.mode != "async":
            raise ValueError("resume_from covers async solves only")
    if cfg.scenario is not None or cfg.controller is not None:
        if cfg.accel_eval == "worker" and cfg.executor == "virtual":
            # The virtual chaos event loop evaluates fires inline only.
            raise ValueError(
                "chaos scenarios with accel_eval='worker' need a real "
                "backend (thread/process); the virtual chaos loop "
                "evaluates fires coordinator-side")
        validate = getattr(cfg.scenario, "validate", None)
        if validate is not None:
            validate(cfg.n_workers)


class _BusyTimer:
    """Timer behind :meth:`Coordinator.busy` (each enter opens its own
    interval; backends never nest them)."""

    __slots__ = ("_coord", "_t0")

    def __init__(self, coord: "Coordinator"):
        self._coord = coord
        self._t0 = 0.0

    def __enter__(self) -> "_BusyTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._coord.busy_s += time.perf_counter() - self._t0


# --------------------------------------------------------------------- #
# Evaluation pipeline work items / plans
# --------------------------------------------------------------------- #
class EvalItem:
    """One evaluation the accel/record pipeline needs: ``"full_map"``
    (evaluate ``G`` at ``x``) or ``"res_norm"``
    (``problem.residual_norm(x)``)."""

    __slots__ = ("kind", "x")
    FULL_MAP = "full_map"
    RES_NORM = "res_norm"

    def __init__(self, kind: str, x: np.ndarray):
        self.kind = kind
        self.x = x


# Below this iterate size an eager pin copy costs less than the lock
# round-trip a deferred (copy-on-write) materialization forces on the fire
# path; lazy pins pay off once copying all of x under the lock is the
# bigger stall.
LAZY_PIN_MIN_N = 1 << 16


class AccelPlan:
    """State of one in-flight Anderson/DIIS fire (begin -> feed* -> commit).

    Pins the iterate and applied-update count at ``accel_begin``;
    ``next_item()`` is an idempotent peek at the evaluation the plan
    currently needs (None once the verdict is decided).
    """

    __slots__ = ("x_pin", "wu_begin", "t_begin", "mver", "stage", "g", "cand",
                 "cur_res", "verdict", "done", "_item", "_pin_lazy",
                 "_pin_saves", "_tel_t0")

    def __init__(self, x_pin: np.ndarray, wu_begin: int, t_begin: float,
                 mver: int = 0):
        self.x_pin = x_pin
        self.wu_begin = wu_begin
        self.t_begin = t_begin
        self.mver = mver  # membership version at begin (reassignment guard)
        self._tel_t0 = t_begin  # telemetry fire-span open (recorder clock)
        # Copy-on-write pin (accel_begin(pin="lazy")): while True, x_pin is
        # the *live* iterate and _pin_saves holds the (indices, old values)
        # of every block overwritten since begin.
        self._pin_lazy = False
        self._pin_saves: List[Tuple[object, np.ndarray]] = []
        self.stage = "map"  # "map" -> ("cur" -> "cand")? -> done
        self.g: Optional[np.ndarray] = None
        self.cand: Optional[np.ndarray] = None
        self.cur_res: Optional[float] = None
        self.verdict: Optional[str] = None  # "accept" | "fallback"
        self.done = False
        self._item: Optional[EvalItem] = EvalItem(EvalItem.FULL_MAP, x_pin)

    def next_item(self) -> Optional[EvalItem]:
        return self._item


class RecordPlan:
    """One in-flight residual-history record (begin -> commit), evaluated
    at the iterate pinned at ``record_begin``."""

    __slots__ = ("t", "wu", "x_version", "done", "_item")

    def __init__(self, x_pin: np.ndarray, wu: int, t: float, x_version: int):
        self.t = t
        self.wu = wu
        self.x_version = x_version
        self.done = False
        self._item: Optional[EvalItem] = EvalItem(EvalItem.RES_NORM, x_pin)

    def next_item(self) -> Optional[EvalItem]:
        return self._item


class Coordinator:
    """Shared coordinator state and apply/accel/record logic."""

    def __init__(self, problem: FixedPointProblem, cfg: RunConfig):
        if cfg.accel_eval not in ("coordinator", "worker"):
            raise ValueError(
                f"unknown accel_eval {cfg.accel_eval!r}; "
                "expected 'coordinator' or 'worker'")
        _validate_layers(cfg)
        self.problem = problem
        self.cfg = cfg
        self.x = _writable(problem.initial())
        self.rng = np.random.default_rng(cfg.seed)
        self.wu = 0
        self.drops = 0
        self.stale_drops = 0
        self.crashes = 0
        self.restarts = 0
        self.staleness_sum = 0
        self.staleness_n = 0
        self.history: List[Tuple[float, int, float]] = []
        # The window lives where the problem keeps its data.
        self.accel: Optional[AndersonState] = (
            AndersonState(cfg.accel, device=getattr(problem, "device", None))
            if cfg.accel is not None else None
        )
        self.blocks = problem.default_blocks(cfg.n_workers)
        # Identity projections skip the per-arrival project/copy round trip,
        # and the memoized partition's consecutive blocks are written
        # through slices (one memcpy).  Keyed by id(): the block arrays are
        # owned by this coordinator and arrivals hand back the same objects.
        self._trivial_project = bool(problem.is_projection_trivial())
        self._block_slices = {}
        for blk in self.blocks:
            sl = as_block_slice(blk)
            if sl is not None:
                self._block_slices[id(blk)] = sl
        self.res_norm = problem.residual_norm(self.x)
        self.record_every = cfg.record_every or cfg.n_workers
        self.max_arrivals = (
            cfg.max_arrivals if cfg.max_arrivals is not None
            else 10 * cfg.max_updates
        )
        self.coordinator_evals = 0
        self.arrivals = 0  # worker returns seen (applied, dropped or crashed)
        self.since_record = 0  # arrivals since the last residual check
        # --- evaluation pipeline bookkeeping --------------------------- #
        self.offloaded_evals = 0
        self.accel_discards = 0
        self.busy_s = 0.0  # coordinator-occupied time (backend clock)
        self.fire_window_s = 0.0
        self.fire_window_arrivals = 0
        # The thread backend turns this on so inline fires measure their
        # blocking window; the virtual backend keeps its clock virtual.
        self.measure_fire_windows = False
        self._fires_inflight = 0
        # --- pin bookkeeping (accel_begin pin modes) ------------------- #
        self._pin_watch: List[AccelPlan] = []
        self._x_spare: Optional[np.ndarray] = None
        self.pin_copies_avoided = 0
        self.pin_cow_saves = 0
        # --- device-resident data plane (cfg.device_plane) ------------- #
        # A worker's resident block mirrors x[block] iff its own last apply
        # was verbatim and no accel commit has rewritten x since.
        self.commit_version = 0
        self.last_apply_verbatim = False
        self.device_dispatches = 0
        self.device_refreshes = 0
        # Last fused block-local residual norm per worker (a convergence
        # proxy for observability; the recorded history stays the true
        # full residual).
        self.device_local_norms: dict = {}
        self._accel_stale_limit = (
            cfg.accel_stale_limit if cfg.accel_stale_limit is not None
            else 4 * cfg.n_workers
        )
        # _x_version bumps on every mutation of x; result() reuses
        # self.res_norm iff nothing moved since it was evaluated.
        self._x_version = 0
        self._res_version = 0
        # --- elastic membership (chaos scenarios, SDC quarantine) ------- #
        # The block partition is fixed; the worker -> blocks assignment is
        # not.  Initially block w is served by worker w; a preemption
        # reassigns the leaver's blocks to the least-loaded survivors and
        # a join hands the home block back.
        p = cfg.n_workers
        self.active: set = set(range(p))  # workers currently in membership
        self.paused: set = set()  # in membership but not taking new work
        self.worker_blocks: dict = {w: [w] for w in range(p)}
        self.block_owner: dict = {b: b for b in range(len(self.blocks))}
        self._orphan_blocks: list = []  # blocks with no live server
        self._rr: dict = {w: 0 for w in range(p)}  # multi-block round-robin
        self.preempt_gen: dict = {w: 0 for w in range(p)}
        self.preemptions = 0
        self.joins = 0
        self.reassigned_blocks = 0
        self.preempt_discards = 0
        self.applied_by_worker: dict = {}
        self._membership_version = 0
        # block -> membership version at which its ownership last changed:
        # lets accel_commit restrict a fire that crossed a preempt/join to
        # the blocks that did not move.
        self._block_moved_at: dict = {}
        self.accel_partial_commits = 0
        # Scenario set_profile overrides (worker -> live FaultProfile).
        self.live_profiles: dict = {}
        # --- closed-loop autoscaling (repro_torch.autoscale) ------------ #
        # Workers removed by *scripted* preemptions: their infrastructure
        # is gone until the script joins them back, so a controller may
        # never "resurrect" them (controller_admissible).  Maintained by
        # apply_scenario_event's source tag; controller-initiated
        # preemptions (voluntary shedding) do not land here.
        self.scenario_down: set = set()
        self.controller_actions = 0
        # Trace recorder (repro_torch.chaos.TraceRecorder), set by backends
        # when cfg.capture_trace; fire/record/offload/scenario events are
        # emitted from here so every loop captures them in arrival order.
        self.tracer = None
        # --- SDC guard state -------------------------------------------- #
        self.sdc_rejects = 0
        self.quarantined = 0
        self._sdc_norms: List[float] = []
        self._sdc_strikes: dict = {}
        self._sdc_block_rejects: dict = {}  # block key -> consecutive rejects
        # --- checkpoints (repro_torch.recover) --------------------------- #
        # _last_ckpt_wu stops a wu that stalls on drops from re-writing
        # the same checkpoint.
        self.checkpoints_written = 0
        self.resumed_from: Optional[str] = None
        self._last_ckpt_wu = -1
        self.probe = None
        if cfg.controller is not None:
            from ...autoscale.signals import SignalProbe

            cfg.controller.reset(cfg)
            self.probe = SignalProbe(cfg, p, self._accel_stale_limit,
                                     cfg.controller)
        # --- unified telemetry plane (repro_torch.telemetry) ------------ #
        # Span/series recorder, None by default: every hook below is one
        # `is not None` guard, and the recorder consumes no rng and never
        # touches iterate floats, so runs are bit-identical off *or* on.
        self.telemetry = None
        if cfg.telemetry:
            from ...telemetry import TelemetryRecorder, as_telemetry_config

            self.telemetry = TelemetryRecorder(
                as_telemetry_config(cfg.telemetry),
                meta={"executor": cfg.executor, "mode": cfg.mode,
                      "n_workers": p, "seed": cfg.seed,
                      "accel": cfg.accel is not None,
                      "accel_eval": cfg.accel_eval},
                n_workers=p)
            if self.probe is not None:
                # One staleness window for both planes: the probe reads
                # the recorder's buffer instead of keeping its own.
                self.probe.attach_telemetry(self.telemetry)

    # ----------------------------------------------------------------- #
    def busy(self):
        """Context manager accumulating coordinator-occupied wall time."""
        return _BusyTimer(self)

    # ----------------------------------------------------------------- #
    # Elastic membership (chaos scenarios, SDC quarantine)
    # ----------------------------------------------------------------- #
    def fault_for(self, worker: int) -> FaultProfile:
        """The worker's *live* fault profile: a scenario ``set_profile``
        override when one is in effect, else the static ``cfg.faults``."""
        prof = self.live_profiles.get(worker)
        return prof if prof is not None else _fault_for(self.cfg, worker)

    def preempt_worker(self, worker: int) -> int:
        """Remove a worker from the membership; rebalance its blocks onto
        the least-loaded survivors, or orphan them when none is left.
        Returns the number of blocks moved.  In-flight results from the
        old incarnation are recognized (and discarded) through
        ``preempt_gen``."""
        if worker not in self.active:
            return 0
        self.active.discard(worker)
        self.paused.discard(worker)
        self.preemptions += 1
        self.preempt_gen[worker] += 1
        moved = self.worker_blocks.get(worker, [])
        self.worker_blocks[worker] = []
        survivors = sorted(self.active)
        if not survivors:
            self._orphan_blocks.extend(moved)
        else:
            for b in moved:
                tgt = min(survivors,
                          key=lambda s: (len(self.worker_blocks[s]), s))
                self.worker_blocks[tgt].append(b)
                self.block_owner[b] = tgt
            self.reassigned_blocks += len(moved)
        self._membership_version += 1
        for b in moved:
            self._block_moved_at[b] = self._membership_version
        return len(moved)

    def join_worker(self, worker: int) -> int:
        """(Re)admit a worker: it takes back its home block (plus any
        orphaned blocks).  Returns the number of blocks it received."""
        if worker in self.active:
            return 0
        self.active.add(worker)
        self.joins += 1
        self.worker_blocks.setdefault(worker, [])
        back = list(self._orphan_blocks)
        self._orphan_blocks = []
        home = worker if worker in self.block_owner else None
        if (home is not None and home not in back
                and self.block_owner[home] != worker):
            holder = self.block_owner[home]
            if home in self.worker_blocks.get(holder, []):
                self.worker_blocks[holder].remove(home)
            back.append(home)
        for b in back:
            self.block_owner[b] = worker
            self.worker_blocks[worker].append(b)
        self.reassigned_blocks += len(back)
        self._membership_version += 1
        for b in back:
            self._block_moved_at[b] = self._membership_version
        return len(back)

    def dispatchable(self, worker: int) -> bool:
        """True when the worker may be handed new work right now."""
        return (worker in self.active and worker not in self.paused
                and bool(self.worker_blocks.get(worker)))

    def apply_scenario_event(self, ev, t: float = 0.0,
                             source: str = "script") -> None:
        """Apply one :class:`repro_torch.chaos.ScenarioEvent` to the
        membership / live-profile state.  Backend-specific plumbing
        (waking parked threads, re-dispatching joined workers, pushing
        profiles into worker processes) stays in the backends.  A
        ``coordinator_crash`` raises :class:`CoordinatorCrash`.

        ``source`` tells scripted events (``"script"``) from controller
        actions (``"controller"``): scripted preemptions mark the worker
        ``scenario_down`` (its infrastructure is gone until the script
        joins it back), while controller preemptions are voluntary
        shedding the controller may undo.  Both apply through the same
        idempotent membership primitives."""
        if self.probe is not None:
            # Worker-seconds meter: charge the segment that ends here at
            # the membership size that held during it.
            self.probe.accumulate(len(self.active - self.paused), t)
        if source == "script":
            if ev.kind == "preempt":
                self.scenario_down.add(ev.worker)
            elif ev.kind == "join":
                self.scenario_down.discard(ev.worker)
        if ev.kind == "set_profile":
            targets = ([ev.worker] if ev.worker is not None
                       else range(self.cfg.n_workers))
            for w in targets:
                self.live_profiles[w] = ev.profile
        elif ev.kind == "preempt":
            self.preempt_worker(ev.worker)
        elif ev.kind == "join":
            self.join_worker(ev.worker)
        elif ev.kind == "pause":
            targets = ([ev.worker] if ev.worker is not None
                       else list(self.active))
            self.paused.update(w for w in targets if w in self.active)
        elif ev.kind == "resume":
            if ev.worker is None:
                self.paused.clear()
            else:
                self.paused.discard(ev.worker)
        elif ev.kind == "coordinator_crash":
            # The one event that targets the control plane itself: raising
            # here unwinds whatever backend loop applied the event.
            raise CoordinatorCrash(
                f"scenario killed the coordinator at t={t:.6g} "
                f"(wu={self.wu})")
        else:
            raise ValueError(f"unknown scenario event kind {ev.kind!r}")
        if self.tracer is not None:
            self.tracer.scenario_event(t, ev)
        if self.telemetry is not None:
            # (A coordinator_crash raises above and so never lands here:
            # the post-restore "restore" instant marks it instead.)
            self.telemetry.instant("scenario", "coord", t, ev=ev.kind,
                                   worker=ev.worker, src=source)

    # ----------------------------------------------------------------- #
    # Closed-loop autoscaling (repro_torch.autoscale)
    # ----------------------------------------------------------------- #
    def controller_admissible(self, ev) -> bool:
        """Safety rails on controller intents (policies stay unprivileged).

        - never join a worker the *script* holds down (``scenario_down``:
          reclaimed infrastructure), nor one already in the membership,
          nor an id outside the fleet;
        - never preempt or pause away the last dispatchable worker — a
          controller may be wrong, but it may not wedge the run.
        """
        kind, w = ev.kind, ev.worker
        if kind == "join":
            return (w is not None and 0 <= w < self.cfg.n_workers
                    and w not in self.active and w not in self.scenario_down)
        if kind in ("preempt", "pause"):
            live = self.active - self.paused
            return (w in live and len(live) > 1)
        return True  # set_profile / resume are always safe

    def controller_tick(self, t: float, arrivals: Optional[int] = None) -> list:
        """Give the controller a decision opportunity at time ``t``.

        Returns the *applied* actions (possibly []), so backends can do
        their plumbing (launch joined workers, wake parked threads).  Free
        when no controller is configured; between due decision points it
        costs one cadence check.  Every loop calls this at its arrival
        ticks (plus timed driver points on the real backends, where
        arrivals can stall).  The virtual loops keep their own arrival
        counters and pass them in so the ``tick_every`` cadence means the
        same thing on every backend.
        """
        ctl = self.cfg.controller
        if ctl is None:
            return []
        if arrivals is None:
            arrivals = self.arrivals
        probe = self.probe
        probe.accumulate(len(self.active - self.paused), t)
        if not probe.due(arrivals, t):
            return []
        sig = probe.sample(self, t, arrivals)
        applied = []
        for ev in (ctl.decide(sig) or []):
            if not self.controller_admissible(ev):
                continue
            ev = _dc_replace(ev, t=t)
            self.apply_scenario_event(ev, t, source="controller")
            self.controller_actions += 1
            ctl.decision_log.append({
                "tick": sig.tick, "t": round(float(t), 9),
                "kind": ev.kind, "worker": ev.worker})
            applied.append(ev)
        return applied

    def round_participants(self) -> List[int]:
        """Sync mode: the workers that take part in the next round."""
        return sorted(self.active - self.paused)

    def round_assignment(self, worker: int) -> np.ndarray:
        """Sync mode: all indices the worker serves this round (its
        assigned blocks concatenated; a single block is returned as the
        memoized block object itself)."""
        bs = self.worker_blocks.get(worker) or []
        if len(bs) == 1:
            return self.blocks[bs[0]]
        return np.concatenate([self.blocks[b] for b in bs])

    # ----------------------------------------------------------------- #
    # Index selection
    # ----------------------------------------------------------------- #
    def next_dispatch(self, worker: int) -> Tuple[Optional[int], np.ndarray]:
        """One async dispatch for ``worker``: ``(block_id, indices)``."""
        cfg = self.cfg
        if cfg.selection == "fixed":
            if self._membership_version == 0:
                return worker, self.blocks[worker]
            bs = self.worker_blocks.get(worker) or [worker]
            b = bs[self._rr[worker] % len(bs)]
            self._rr[worker] += 1
            return b, self.blocks[b]
        return None, self._select_indices_dynamic(worker)

    def select_indices(self, worker: int) -> np.ndarray:
        """Per-dispatch selection (async mode: workers launch one at a time)."""
        return self.next_dispatch(worker)[1]

    def _select_indices_dynamic(self, worker: int) -> np.ndarray:
        cfg = self.cfg
        k = cfg.selection_k or max(1, self.problem.n // cfg.n_workers)
        if cfg.selection == "uniform":
            return self.rng.choice(self.problem.n, size=k, replace=False)
        if cfg.selection == "greedy":
            comp = self.problem.component_residual(self.x)
            return np.argpartition(comp, -k)[-k:]
        raise ValueError(f"unknown selection {cfg.selection!r}")

    def select_round_indices(self) -> List[np.ndarray]:
        """Per-round selection (sync mode): one disjoint block per worker."""
        cfg = self.cfg
        p = cfg.n_workers
        if cfg.selection == "fixed":
            return [self.blocks[w] for w in range(p)]
        k = cfg.selection_k or max(1, self.problem.n // p)
        total = min(p * k, self.problem.n)
        if cfg.selection == "uniform":
            pool = self.rng.choice(self.problem.n, size=total, replace=False)
        elif cfg.selection == "greedy":
            comp = self.problem.component_residual(self.x)
            pool = np.argpartition(comp, -total)[-total:]
        else:
            raise ValueError(f"unknown selection {cfg.selection!r}")
        return list(np.array_split(pool, p))

    # ----------------------------------------------------------------- #
    def apply_return(
        self, indices: np.ndarray, values: np.ndarray, profile: FaultProfile,
        staleness: int, worker: Optional[int] = None,
    ) -> bool:
        """Apply one worker return; returns False if dropped."""
        cfg = self.cfg
        self.last_apply_verbatim = False
        if profile.max_staleness is not None and staleness > profile.max_staleness:
            self.stale_drops += 1
            return False
        if profile.drop_prob > 0.0 and self.rng.random() < profile.drop_prob:
            self.drops += 1
            return False
        verbatim = True
        if profile.noise_std > 0.0:
            values = values + self.rng.normal(0.0, profile.noise_std, values.shape)
            verbatim = False
        if profile.sample_corrupt(self.rng):
            values = profile.corrupt(values, self.rng)
            verbatim = False
        ind = self._block_slices.get(id(indices), indices)
        if cfg.sdc_guard:
            if not self._sdc_admit(ind, values):
                self.sdc_rejects += 1
                if self.telemetry is not None:
                    self.telemetry.instant("sdc_screen", "coord",
                                           worker=worker)
                if worker is not None and cfg.sdc_strikes > 0:
                    s = self._sdc_strikes.get(worker, 0) + 1
                    self._sdc_strikes[worker] = s
                    if (s >= cfg.sdc_strikes and worker in self.active
                            and len(self.active - self.paused) > 1):
                        # k consecutive strikes: quarantine the repeat
                        # offender (never the last dispatchable worker).
                        self.preempt_worker(worker)
                        self.quarantined += 1
                return False
            if worker is not None:
                self._sdc_strikes.pop(worker, None)
        if self._pin_watch:
            # Copy-on-write for lazy accel pins: save this block's current
            # values so materialize_pin can undo the write.
            for p in self._pin_watch:
                p._pin_saves.append((ind, np.copy(self.x[ind])))
        if cfg.block_damping is not None:
            a = cfg.block_damping
            self.x[ind] = (1.0 - a) * self.x[ind] + a * values
            verbatim = False
        else:
            self.x[ind] = values
        if not self._trivial_project:
            self.x = _writable(self.problem.project(self.x))
        self.wu += 1
        self.last_apply_verbatim = verbatim
        self._x_version += 1
        if self._fires_inflight > 0:
            self.fire_window_arrivals += 1
        self.staleness_sum += staleness
        self.staleness_n += 1
        if self.telemetry is not None:
            self.telemetry.observe_staleness(staleness)
        if self.probe is not None:  # autoscale signal window; off => free
            self.probe.observe(staleness)
        if worker is not None:
            self.applied_by_worker[worker] = (
                self.applied_by_worker.get(worker, 0) + 1)
        return True

    #: Block-consensus escape: after this many *consecutive* divergence
    #: rejections of the same block, the next finite arrival for it is
    #: admitted regardless of magnitude.
    _SDC_ESCAPE_REJECTS = 3

    @staticmethod
    def _sdc_block_key(ind):
        if isinstance(ind, slice):
            return (ind.start, ind.stop, ind.step)
        a = np.asarray(ind)
        return (int(a[0]), int(a[-1]), int(a.size))

    def _sdc_admit(self, ind, values: np.ndarray) -> bool:
        """SDC screen for one arriving block (``cfg.sdc_guard`` only):
        every component finite, and the update norm within
        ``cfg.sdc_threshold`` times the median of the last
        ``cfg.sdc_window`` accepted update norms (after a warm-up), with
        the per-block consecutive-reject escape."""
        if not np.isfinite(values).all():
            return False
        upd = float(np.linalg.norm(values - self.x[ind]))
        base = self._sdc_norms
        key = self._sdc_block_key(ind)
        if len(base) >= max(4, self.cfg.sdc_window // 4):
            med = float(np.median(base))
            if upd > self.cfg.sdc_threshold * max(med, 1e-300):
                n = self._sdc_block_rejects.get(key, 0) + 1
                if n < self._SDC_ESCAPE_REJECTS:
                    self._sdc_block_rejects[key] = n
                    return False
                self._sdc_block_rejects.pop(key, None)
                return True
        self._sdc_block_rejects.pop(key, None)
        base.append(upd)
        if len(base) > self.cfg.sdc_window:
            del base[0]
        return True

    # ----------------------------------------------------------------- #
    # Durable solves (repro_torch.recover)
    # ----------------------------------------------------------------- #
    def checkpoint_due(self) -> bool:
        ce = self.cfg.checkpoint_every
        return (ce is not None and self.wu > 0 and self.wu % ce == 0
                and self.wu != self._last_ckpt_wu)

    def maybe_checkpoint(self, t: float, loop_state=None) -> bool:
        """Write a SolveCheckpoint if the cadence says one is due.

        Backends call this at arrival boundaries — a consistent point: no
        apply, fire or record is mid-flight.  ``loop_state`` is the
        backend's own resumable loop state, a ``(meta, arrays)`` pair or a
        zero-arg callable evaluated only when a checkpoint is due.
        """
        if not self.checkpoint_due():
            return False
        from ...recover.checkpoint import write_checkpoint  # lazy: no cycle

        t_h0 = time.perf_counter()
        write_checkpoint(self, t,
                         loop_state() if callable(loop_state) else loop_state)
        self._last_ckpt_wu = self.wu
        self.checkpoints_written += 1
        if self.telemetry is not None:
            self.telemetry.span(
                "checkpoint", "coord", t, t, wu=self.wu,
                host_dur_s=time.perf_counter() - t_h0)
        return True

    # ----------------------------------------------------------------- #
    # Evaluation pipeline
    # ----------------------------------------------------------------- #
    def eval_item(self, item: EvalItem):
        """Coordinator-side evaluation of one pipeline work item."""
        if item.kind == EvalItem.FULL_MAP:
            return self.problem.full_map(item.x)
        return self.problem.residual_norm(item.x)

    def accel_begin(self, t: float = 0.0,
                    pin: str = "copy") -> Optional[AccelPlan]:
        """Open a fire: pin the iterate, emit the full-map work item.

        ``pin`` is ``"copy"`` (eager O(n) copy), ``"ref"`` (the live
        iterate, for callers that drive begin -> commit atomically) or
        ``"lazy"`` (copy-on-write, see :meth:`materialize_pin`).  Returns
        None when acceleration is off (or monitor-mode).
        """
        if self.accel is None or self.cfg.accel_mode == "monitor":
            return None
        if pin == "lazy" and not self._trivial_project:
            pin = "copy"
        if pin == "copy":
            x_pin = self.x.copy()
        else:
            x_pin = self.x
        plan = AccelPlan(x_pin, self.wu, t, self._membership_version)
        if self.telemetry is not None:
            # Recorder clock, not the caller's t: inline fires pass the
            # t=0.0 default, and the recorder's clock matches t on the
            # paths that do pass one.
            plan._tel_t0 = self.telemetry.now()
        if pin == "ref":
            self.pin_copies_avoided += 1
        elif pin == "lazy":
            plan._pin_lazy = True
            self._pin_watch.append(plan)
        self._fires_inflight += 1
        return plan

    def materialize_pin(self, plan: AccelPlan) -> None:
        """Turn a lazy (copy-on-write) pin into a private snapshot by
        replaying the saved blocks newest first onto a copy of the live
        iterate.  Must run atomically with arrivals; idempotent."""
        if not plan._pin_lazy:
            return
        spare = self._x_spare
        if spare is not None and spare.shape == self.x.shape \
                and spare.dtype == self.x.dtype:
            self._x_spare = None
            np.copyto(spare, self.x)
            snap = spare
        else:
            snap = self.x.copy()
        for ind, old in reversed(plan._pin_saves):
            snap[ind] = old
        self.pin_cow_saves += len(plan._pin_saves)
        item = plan._item
        if item is not None and item.x is plan.x_pin:
            item.x = snap
        plan.x_pin = snap
        plan._pin_lazy = False
        plan._pin_saves = []
        try:
            self._pin_watch.remove(plan)
        except ValueError:
            pass

    def accel_feed(self, plan: AccelPlan, value, offloaded: bool = False) -> None:
        """Feed one evaluated item; advances the plan's state machine:
        full map -> push/propose -> the Eq. 5 safeguard's current-then-
        candidate residual norms (only when there is a candidate)."""
        cfg, problem = self.cfg, self.problem
        item = plan._item
        plan._item = None
        if offloaded:
            self.offloaded_evals += 1
            if self.tracer is not None and item is not None:
                self.tracer.offload(item.kind)
        elif item is not None and item.kind == EvalItem.FULL_MAP:
            self.coordinator_evals += 1
        if plan.stage == "map":
            g = value
            plan.g = g
            f = problem.accel_residual(plan.x_pin, g)
            self.accel.push(plan.x_pin, g, f)
            cand = self.accel.propose()
            if cand is None:
                plan.verdict = "fallback"  # Eq. 5 fallback: G(x)
                plan.done = True
                return
            plan.cand = _writable(problem.project(cand))
            if cfg.accel.safeguard:
                plan.stage = "cur"
                plan._item = EvalItem(EvalItem.RES_NORM, plan.x_pin)
            else:
                plan.verdict = "accept"
                plan.done = True
            return
        if plan.stage == "cur":
            plan.cur_res = float(value)
            plan.stage = "cand"
            plan._item = EvalItem(EvalItem.RES_NORM, plan.cand)
            return
        cand_res = float(value)
        if np.isfinite(cand_res) and cand_res < plan.cur_res:
            plan.verdict = "accept"
        else:
            plan.verdict = "fallback"
        plan.done = True

    def accel_commit(self, plan: AccelPlan, t: Optional[float] = None) -> str:
        """Apply the fire's verdict against the live iterate.

        A fire with more than ``cfg.accel_stale_limit`` worker updates
        applied since ``accel_begin`` is discarded; one whose window
        crossed a membership change commits only to the blocks whose
        ownership did not move (every block moved: discarded).
        Returns the applied verdict: "accept" | "fallback" | "discard".
        """
        self._fires_inflight -= 1
        if t is not None:
            self.fire_window_s += max(0.0, t - plan.t_begin)
        stale = self.wu - plan.wu_begin
        moved: set = set()
        if plan.mver != self._membership_version:
            moved = {b for b, mv in self._block_moved_at.items()
                     if mv > plan.mver}
        if stale > self._accel_stale_limit or len(moved) >= len(self.blocks):
            if plan._pin_lazy:
                plan._pin_lazy = False
                plan._pin_saves = []
                try:
                    self._pin_watch.remove(plan)
                except ValueError:
                    pass
                self.pin_copies_avoided += 1
            self.accel_discards += 1
            self.accel.record_reject()
            if self.tracer is not None:
                self.tracer.fire("discard", t)
            if self.telemetry is not None:
                t1 = t if t is not None else self.telemetry.now()
                self.telemetry.fire_span(plan._tel_t0, t1, "discard",
                                         stale=stale, moved=len(moved))
            return "discard"
        for p in [p for p in self._pin_watch if p is not plan]:
            self.materialize_pin(p)
        if plan.verdict == "accept":
            self.accel.record_accept()
            target = plan.cand
        else:
            self.accel.record_reject()
            target = _writable(self.problem.project(plan.g))
        if moved:
            for b, blk in enumerate(self.blocks):
                if b in moved:
                    continue
                ind = self._block_slices.get(id(blk), blk)
                self.x[ind] = target[ind]
            if not self._trivial_project:
                self.x = _writable(self.problem.project(self.x))
            self.accel_partial_commits += 1
        else:
            # Full rebind; the displaced buffer becomes the spare the next
            # lazy-pin materialization copies into.
            spare = self.x
            self.x = target
            if (self._trivial_project and spare.shape == target.shape
                    and spare.dtype == target.dtype
                    and spare is not target):
                self._x_spare = spare
        self._x_version += 1
        self.commit_version += 1
        if self.tracer is not None:
            self.tracer.fire(plan.verdict, t)
        if self.telemetry is not None:
            t1 = t if t is not None else self.telemetry.now()
            self.telemetry.fire_span(plan._tel_t0, t1, plan.verdict,
                                     stale=stale, moved=len(moved))
        return plan.verdict

    def maybe_fire_accel(self) -> Optional[str]:
        """Coordinator-level Anderson/DIIS (paper §3.4 modes 2 and 3),
        driving the begin/feed/commit machine with inline evaluations.

        The pin is by reference: this method drives the whole plan
        atomically (its callers hold the backend lock / are the virtual
        event loop), so no arrival can land between begin and commit.
        """
        plan = self.accel_begin(pin="ref")
        if plan is None:
            return None
        t0 = time.perf_counter()
        item = plan.next_item()
        while item is not None:
            self.accel_feed(plan, self.eval_item(item))
            item = plan.next_item()
        if self.measure_fire_windows:
            self.fire_window_s += time.perf_counter() - t0
        tel = self.telemetry
        if tel is not None:
            # Inline observability: an inline fire blocks the loop, so the
            # work overlapping it is what is still in flight — count the
            # open dispatches.  Host busy accounting rides along for
            # backends whose metered busy_s is zero (virtual inline).
            tel.host_busy_s += time.perf_counter() - t0
            self.fire_window_arrivals += tel.open_tasks
        return self.accel_commit(plan)

    # ----------------------------------------------------------------- #
    # Shared real-backend loop machinery
    # ----------------------------------------------------------------- #
    def plan_round(
        self, alive: Set[int], round_idx: Sequence[np.ndarray]
    ) -> List[Tuple[int, FaultProfile, np.ndarray, float, bool]]:
        """Sample per-worker (delay, crash) plans for one BSP round, from
        the coordinator rng in worker order."""
        plans = []
        for w in sorted(alive):
            prof = self.fault_for(w)
            delay = prof.sample_delay(self.rng)
            crashed = prof.sample_crash(self.rng)
            plans.append((w, prof, round_idx[w], delay, crashed))
        return plans

    def note_sync_crash(self, prof: FaultProfile, w: int,
                        alive: Set[int]) -> None:
        """Account one planned BSP crash: lost in-flight result, permanent
        exit or rejoin."""
        self.crashes += 1
        if prof.restart_after is None:
            alive.discard(w)
        else:
            self.restarts += 1

    def sync_round_tick(self, rounds: int, elapsed) -> Tuple[float, Optional[str]]:
        """Real-backend round epilogue: barrier overhead, accel cadence,
        residual record and stop checks.  Returns ``(t, verdict)`` with
        verdict ``None`` (continue), ``"converged"``/``"diverged"`` or
        ``"budget"`` (max_wall exceeded)."""
        cfg = self.cfg
        if cfg.sync_overhead > 0.0:
            time.sleep(cfg.sync_overhead)
        if self.accel is not None and rounds % cfg.fire_every == 0:
            self.maybe_fire_accel()
        t = elapsed()
        res = self.record(t)
        if not np.isfinite(res) or res > 1e60:
            return t, "diverged"
        if self.converged():
            return t, "converged"
        if cfg.max_wall is not None and t > cfg.max_wall:
            return t, "budget"
        return t, None

    def arrival_tick(self, t: float) -> bool:
        """Per-arrival bookkeeping of the real async backends: counters
        plus every stop condition.  Callers with concurrent arrivals (the
        thread backend) must hold their coordinator lock."""
        self.arrivals += 1
        self.since_record += 1
        if self.telemetry is not None:
            self.telemetry.maybe_sample_busy(t, self.busy_s)
        stop = self.arrivals >= self.max_arrivals
        if self.since_record >= self.record_every:
            res = self.record(t)
            self.since_record = 0
            if not np.isfinite(res) or res > 1e60:
                stop = True
            elif self.converged():
                stop = True
        if self.wu >= self.cfg.max_updates:
            stop = True
        if self.cfg.max_wall is not None and t > self.cfg.max_wall:
            stop = True
        return stop

    def arrival_tick_offload(self, t: float) -> Tuple[bool, bool]:
        """Worker-eval variant of :meth:`arrival_tick`: a due residual
        record is *reported* (second return value) instead of evaluated."""
        self.arrivals += 1
        self.since_record += 1
        if self.telemetry is not None:
            self.telemetry.maybe_sample_busy(t, self.busy_s)
        stop = self.arrivals >= self.max_arrivals
        record_due = False
        if self.since_record >= self.record_every:
            record_due = True
            self.since_record = 0
        if self.wu >= self.cfg.max_updates:
            stop = True
        if self.cfg.max_wall is not None and t > self.cfg.max_wall:
            stop = True
        return stop, record_due

    def record(self, t: float) -> float:
        tel = self.telemetry
        t_h0 = time.perf_counter() if tel is not None else 0.0
        self.res_norm = self.problem.residual_norm(self.x)
        self._res_version = self._x_version
        self.history.append((t, self.wu, self.res_norm))
        if self.tracer is not None:
            self.tracer.record(t, self.res_norm)
        if tel is not None:
            tel.host_busy_s += time.perf_counter() - t_h0
            tel.span("record", "coord", t, t, res=self.res_norm, wu=self.wu)
            tel.series_point("residual", t, self.res_norm)
            tel.maybe_sample_busy(t, self.busy_s)
        return self.res_norm

    def record_begin(self, t: float) -> RecordPlan:
        """Open an offloaded residual record at the current iterate."""
        return RecordPlan(self.x.copy(), self.wu, t, self._x_version)

    def record_commit(self, plan: RecordPlan, value,
                      offloaded: bool = False) -> float:
        """Feed the evaluated residual norm back; returns it."""
        if offloaded:
            self.offloaded_evals += 1
        plan.done = True
        plan._item = None
        self.res_norm = float(value)
        self._res_version = plan.x_version
        self.history.append((plan.t, plan.wu, self.res_norm))
        if self.tracer is not None:
            self.tracer.record(plan.t, self.res_norm)
        if self.telemetry is not None:
            tel = self.telemetry
            tel.span("record", "coord", plan.t, plan.t,
                     res=self.res_norm, wu=plan.wu, offloaded=offloaded)
            tel.series_point("residual", plan.t, self.res_norm)
        return self.res_norm

    def converged(self) -> bool:
        if self.cfg.converge_on == "error":
            err = self.problem.error_norm(self.x)
            return err is not None and err < self.cfg.tol
        return self.res_norm < self.cfg.tol

    def result(self, t: float, rounds: int, converged: bool) -> RunResult:
        mean_stale = self.staleness_sum / max(self.staleness_n, 1)
        acc = self.accel
        if self.probe is not None:  # close the worker-seconds meter at t
            self.probe.accumulate(len(self.active - self.paused), t)
        if self._res_version == self._x_version:
            res = self.res_norm
        else:
            res = self.problem.residual_norm(self.x)
        busy_frac = min(1.0, self.busy_s / t) if t > 0 else 0.0
        tel = self.telemetry
        tel_capture = tel_summary = None
        if tel is not None:
            if self.busy_s == 0.0:
                # Inline virtual runs never meter busy_s (coordinator work
                # is free in virtual time); the recorder's host-clock
                # fraction stands in.
                busy_frac = tel.host_busy_frac()
            tel.finalize(t, self.busy_s)
            tel_capture = tel.to_capture()
            tel_summary = tel_capture.summary
        return RunResult(
            x=self.x,
            converged=converged,
            worker_updates=self.wu,
            wall_time=t,
            residual_norm=res,
            history=self.history,
            rounds=rounds,
            drops=self.drops,
            stale_drops=self.stale_drops,
            accel_fires=acc.n_fire if acc else 0,
            accel_accepts=acc.n_accept if acc else 0,
            accel_rejects=acc.n_reject if acc else 0,
            coordinator_evals=self.coordinator_evals,
            mean_staleness=mean_stale,
            error_norm=self.problem.error_norm(self.x),
            crashes=self.crashes,
            restarts=self.restarts,
            offloaded_evals=self.offloaded_evals,
            accel_discards=self.accel_discards,
            accel_partial_commits=self.accel_partial_commits,
            coordinator_busy_frac=busy_frac,
            fire_window_s=self.fire_window_s,
            fire_window_arrivals=self.fire_window_arrivals,
            preemptions=self.preemptions,
            joins=self.joins,
            reassigned_blocks=self.reassigned_blocks,
            preempt_discards=self.preempt_discards,
            service_fractions={
                w: cnt / max(self.wu, 1)
                for w, cnt in sorted(self.applied_by_worker.items())},
            worker_seconds=(self.probe.worker_seconds
                            if self.probe is not None else 0.0),
            controller_actions=self.controller_actions,
            sdc_rejects=self.sdc_rejects,
            quarantined=self.quarantined,
            checkpoints_written=self.checkpoints_written,
            resumed_from=self.resumed_from,
            pin_copies_avoided=self.pin_copies_avoided,
            pin_cow_saves=self.pin_cow_saves,
            device_dispatches=self.device_dispatches,
            device_refreshes=self.device_refreshes,
            trace=(self.tracer.to_trace() if self.tracer is not None
                   else None),
            telemetry=tel_capture,
            telemetry_summary=tel_summary,
        )
