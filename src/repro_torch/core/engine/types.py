"""Shared engine datatypes: fault profiles, run configuration, run results.

These are backend-agnostic: the same :class:`RunConfig` drives the
deterministic virtual-time simulator and the real-concurrency thread and
process backends (``cfg.executor`` selects which — see
:mod:`repro_torch.core.engine.base`).

The port's engine carries the reference engine's fields so a config reads
the same in both packages.  Chaos scenarios, trace capture, checkpoints,
autoscale controllers and telemetry are ported; the Ray backend is not:
``executor="ray"`` raises ``NotImplementedError`` naming the ROADMAP.md
item that ports it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..anderson import AndersonConfig

__all__ = ["FaultProfile", "RunConfig", "RunResult", "CoordinatorCrash"]

_UNPORTED_EXECUTORS = {
    "ray": "ROADMAP.md queue 1, item 5 (the Ray backend)",
}


class CoordinatorCrash(RuntimeError):
    """The control plane died mid-solve.

    Raised out of a backend's coordinator loop when a chaos scenario's
    ``coordinator_crash`` event fires: the session fails (workers drain
    their in-flight results and are torn down with the loop), and any
    checkpoints written so far stay on disk for
    :func:`repro_torch.recover.resume_fixed_point`.
    """


@dataclass
class FaultProfile:
    """Per-worker fault injection (paper §4).

    ``delay``/``noise``/``drop``/``max_staleness`` are the paper's four
    fault channels.  ``crash_prob``/``restart_after`` extend them with
    worker churn: with probability ``crash_prob`` per update the worker
    crashes — its in-flight result is lost — and it rejoins after
    ``restart_after`` seconds (``None`` means it never comes back).  The
    virtual-time backend charges virtual seconds for delays and downtime,
    the thread backend sleeps through real ones.  ``RunResult.restarts``
    counts a restart when the downtime *ends*.
    """

    delay_mean: float = 0.0  # seconds added per update (virtual or real)
    delay_std: float = 0.0
    noise_std: float = 0.0  # additive N(0, std) on returned components
    drop_prob: float = 0.0  # probability a returned update is lost
    max_staleness: Optional[int] = None  # in worker-updates; older => dropped
    crash_prob: float = 0.0  # probability per update the worker crashes
    restart_after: Optional[float] = None  # seconds down; None => permanent
    # Evaluation-service fault channel (``RunConfig.accel_eval="worker"``):
    # probability that one offloaded full-map / residual-norm evaluation is
    # lost in flight.  The coordinator falls back to evaluating that item
    # itself, so a lossy eval service degrades throughput, never correctness.
    eval_crash_prob: float = 0.0
    # Silent-data-corruption channel: with probability ``corrupt_prob`` per
    # returned update, the worker's value block is corrupted in flight.
    # Modes: ``"bitflip"`` flips one random bit of one float64 element,
    # ``"nan"`` overwrites one element with NaN, ``"scale"`` multiplies one
    # element by 1e8.
    corrupt_prob: float = 0.0
    corrupt_mode: str = "bitflip"  # "bitflip" | "nan" | "scale"

    def sample_delay(self, rng: np.random.Generator) -> float:
        if self.delay_mean == 0.0 and self.delay_std == 0.0:
            return 0.0
        return max(0.0, rng.normal(self.delay_mean, self.delay_std))

    def sample_crash(self, rng: np.random.Generator) -> bool:
        """Draw a crash event; consumes randomness only when enabled."""
        return self.crash_prob > 0.0 and rng.random() < self.crash_prob

    def sample_corrupt(self, rng: np.random.Generator) -> bool:
        """Draw an SDC event; consumes randomness only when enabled."""
        return self.corrupt_prob > 0.0 and rng.random() < self.corrupt_prob

    def corrupt(self, values: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
        """Return a corrupted *copy* of ``values`` (one element hit)."""
        v = np.array(values, dtype=np.float64)
        i = int(rng.integers(v.size))
        if self.corrupt_mode == "nan":
            v[i] = np.nan
        elif self.corrupt_mode == "scale":
            v[i] *= 1e8
        elif self.corrupt_mode == "bitflip":
            bit = np.uint64(int(rng.integers(64)))
            u = v.view(np.uint64)
            u[i] ^= np.uint64(1) << bit
        else:
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")
        return v


@dataclass
class RunConfig:
    """One (a)synchronous run of a fixed-point problem.

    Field meanings follow the reference engine's ``RunConfig``.  The
    ``"ray"`` executor, not ported yet, raises ``NotImplementedError``.
    """

    n_workers: int = 4
    mode: str = "async"  # "sync" | "async"
    executor: str = "virtual"  # "virtual" | "thread" | "process"
    # --- acceleration -------------------------------------------------- #
    accel: Optional[AndersonConfig] = None
    accel_mode: str = "coordinator"  # "monitor" | "coordinator" | "periodic"
    fire_every: int = 1  # E: fire each E worker returns (async) / rounds (sync)
    # --- damping -------------------------------------------------------- #
    block_damping: Optional[float] = None  # damped application of block updates
    # --- selection (paper §5.2 / Fig. 6) --------------------------------- #
    selection: str = "fixed"  # "fixed" | "uniform" | "greedy"
    selection_k: Optional[int] = None  # block size for uniform/greedy
    # --- worker return mode (paper §6 future work) ----------------------- #
    return_mode: str = "block"  # "block" | "full_map"
    # --- evaluation pipeline placement (paper §6 redesign) ---------------- #
    # "coordinator" evaluates accel/record full maps and safeguard norms
    # inline; "worker" offloads them to an eval thread (thread backend), an
    # idle pool worker (process backend) or a modeled eval server (virtual
    # backend) so fires overlap arrivals.
    accel_eval: str = "coordinator"  # "coordinator" | "worker"
    # Offloaded fires applied after more than this many worker updates since
    # accel_begin are discarded.  None => 4 * n_workers.
    accel_stale_limit: Optional[int] = None
    # Virtual backend only: seconds one full-map / residual-norm evaluation
    # costs in the opt-in evaluation-cost event model.
    eval_time: Optional[float] = None
    # --- termination ------------------------------------------------------ #
    tol: float = 1e-6
    max_updates: int = 200_000
    # Liveness guard: total worker returns (applied + dropped + stale +
    # crashed) before the run stops.  None => 10 * max_updates.
    max_arrivals: Optional[int] = None
    max_wall: Optional[float] = None  # seconds (virtual or real)
    record_every: Optional[int] = None  # residual check cadence (default p)
    # --- determinism / timing --------------------------------------------- #
    seed: int = 0
    compute_time: Optional[float] = None  # virtual s/update; None => measure
    sync_overhead: float = 0.0  # per-round barrier cost (BSP coordination)
    async_overhead: float = 0.0  # per-dispatch cost in async mode
    faults: Union[None, FaultProfile, Dict[int, FaultProfile]] = None
    converge_on: str = "residual"  # "residual" | "error"
    # --- chaos scenarios (repro_torch.chaos) ------------------------------ #
    # A FaultScenario of timestamped events (set_profile / preempt / join /
    # pause / resume / coordinator_crash and delay-trace segments)
    # interpreted against virtual time on the virtual backend and wall time
    # on thread/process.  Preempted workers' blocks are reassigned to the
    # least-loaded survivors and handed back on join.  Requires
    # selection="fixed"; composes with accel_eval="worker" on the real
    # backends (a fire whose begin->commit window crossed a membership
    # change commits only to the blocks whose ownership did not move).
    scenario: Optional[object] = None  # repro_torch.chaos.FaultScenario
    # --- closed-loop autoscaling (repro_torch.autoscale) ------------------ #
    # A Controller policy observing ControlSignals at arrival ticks and
    # emitting the same join/preempt/pause/set_profile events scenarios
    # script, actuated through apply_scenario_event on every backend; it
    # composes with a scripted scenario (the coordinator's safety rails stop
    # a policy from resurrecting workers the script reclaimed or wedging
    # the membership).  Requires selection="fixed".  None keeps every
    # default loop untouched.
    controller: Optional[object] = None  # repro_torch.autoscale.Controller
    # Record the run's event trace into RunResult.trace for deterministic
    # replay (repro_torch.chaos.replay_trace).  Async, selection="fixed".
    capture_trace: bool = False
    # --- durable solves (repro_torch.recover) ----------------------------- #
    # Write a SolveCheckpoint (JSON + npz under checkpoint_dir) every this
    # many applied worker updates, at an arrival boundary.  None disables.
    checkpoint_every: Optional[int] = None
    checkpoint_dir: Optional[str] = None  # required when checkpoint_every set
    # Resume handle: a SolveCheckpoint (or a path to one); use
    # repro_torch.recover.resume_fixed_point rather than setting it.
    resume_from: Optional[object] = None
    # --- SDC quarantine (coordinator-side guard) --------------------------- #
    # Screen every arriving block for NaN/Inf and for update norms that
    # diverge from a windowed baseline of recently accepted update norms; a
    # worker collecting sdc_strikes rejections is quarantined.
    sdc_guard: bool = False
    sdc_window: int = 32  # baseline window (accepted update norms)
    sdc_threshold: float = 25.0  # reject when norm > threshold * median
    sdc_strikes: int = 3  # rejections before quarantine (0 => never)
    # --- device-resident data plane (thread and process backends) --------- #
    # Keep each worker's block resident on the problem's device across the
    # dispatch loop, shipping only halo/dependency slices per dispatch and
    # running the fused block-update(+local-residual) kernels:
    #   "off"  — host path everywhere
    #   "auto" — (default) the kernel path once n >= AUTO_THRESHOLD and the
    #            run shape qualifies (see engine.device_plane); else "off"
    #   "on"   — force the kernel path
    #   "ref"  — force the numpy oracle on the resident block (tests)
    # The virtual backend always ignores this knob.
    device_plane: str = "auto"
    # --- telemetry plane (repro_torch.telemetry) -------------------------- #
    # None (default: no recorder is ever constructed), True, or a
    # TelemetryConfig.  When set, the coordinator owns a TelemetryRecorder
    # collecting typed spans + metric series; the capture lands on
    # RunResult.telemetry and a digest on RunResult.telemetry_summary.  The
    # recorder consumes no rng and touches no iterate floats.
    telemetry: Optional[object] = None

    def __post_init__(self) -> None:
        if self.executor in _UNPORTED_EXECUTORS:
            raise NotImplementedError(
                f"executor {self.executor!r} is not ported to repro_torch "
                f"yet: {_UNPORTED_EXECUTORS[self.executor]}")


@dataclass
class RunResult:
    x: np.ndarray
    converged: bool
    worker_updates: int
    wall_time: float
    residual_norm: float
    history: List[Tuple[float, int, float]]  # (t, WU, residual norm)
    rounds: int = 0  # sync: barrier rounds; async: applied updates
    drops: int = 0
    stale_drops: int = 0
    accel_fires: int = 0
    accel_accepts: int = 0
    accel_rejects: int = 0
    coordinator_evals: int = 0  # full-map evaluations done by the coordinator
    mean_staleness: float = 0.0
    error_norm: Optional[float] = None
    crashes: int = 0  # worker crash events (in-flight update lost)
    restarts: int = 0  # crashed workers that rejoined
    # --- evaluation pipeline (accel_eval="worker") ------------------------ #
    offloaded_evals: int = 0  # eval items served worker-side
    accel_discards: int = 0  # fires dropped by the commit staleness guard
    # Fires whose begin->commit window crossed a membership change and
    # committed restricted to the blocks whose ownership did not move.
    accel_partial_commits: int = 0
    # Fraction of the run the coordinator spent doing its own work —
    # measured on the thread backend, modeled on the virtual eval-cost loop.
    coordinator_busy_frac: float = 0.0
    fire_window_s: float = 0.0
    fire_window_arrivals: int = 0
    # --- elastic membership (chaos scenarios, SDC quarantine) ------------ #
    preemptions: int = 0  # workers removed from the membership
    joins: int = 0  # workers that (re)joined the membership
    reassigned_blocks: int = 0  # block moves across preempt/join events
    preempt_discards: int = 0  # in-flight results discarded by a preemption
    # Fraction of applied worker updates each worker served.
    service_fractions: Dict[int, float] = field(default_factory=dict)
    # --- closed-loop autoscaling (repro_torch.autoscale) ------------------ #
    # Integral of |active - paused| over the run (the capacity actually
    # provisioned), metered only when a controller is configured.
    worker_seconds: float = 0.0
    controller_actions: int = 0  # applied controller decisions
    # --- durable solves (repro_torch.recover) ------------------------------ #
    sdc_rejects: int = 0  # corrupted arrivals rejected by the SDC guard
    quarantined: int = 0  # workers quarantined by the k-strikes policy
    checkpoints_written: int = 0  # SolveCheckpoints written this run
    resumed_from: Optional[str] = None  # checkpoint tag this run resumed from
    # --- device-resident data plane --------------------------------------- #
    pin_copies_avoided: int = 0
    pin_cow_saves: int = 0
    device_dispatches: int = 0  # block updates served by the device plane
    device_refreshes: int = 0  # device blocks re-synced from the host iterate
    # --- trace capture (cfg.capture_trace) -------------------------------- #
    trace: Optional[object] = None  # repro_torch.chaos.RunTrace
    # --- telemetry plane (cfg.telemetry) ----------------------------------- #
    telemetry: Optional[object] = None  # repro_torch.telemetry.TelemetryCapture
    # Compact digest (staleness p50/p95, busy-frac series tail, span
    # counts, fire ledger).
    telemetry_summary: Optional[dict] = None

    def to_dict(self, include_history: bool = True,
                include_x: bool = False) -> dict:
        """JSON-safe dict of this result.  ``x`` is omitted unless
        ``include_x`` (it is O(n)); the trace and telemetry capture, when
        present, serialize through their own ``to_dict``.  Round-trips
        through :meth:`from_dict`."""
        out: dict = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "x":
                if include_x:
                    out["x"] = np.asarray(v, dtype=np.float64).tolist()
            elif f.name == "history":
                if include_history:
                    out["history"] = [[float(t), int(wu), float(r)]
                                      for t, wu, r in v]
            elif f.name in ("trace", "telemetry"):
                if v is not None:
                    out[f.name] = v.to_dict() if hasattr(v, "to_dict") else v
            elif f.name == "telemetry_summary":
                if v is not None:
                    out["telemetry_summary"] = dict(v)
            elif f.name == "service_fractions":
                out["service_fractions"] = {
                    str(k): float(sv) for k, sv in (v or {}).items()}
            elif f.name == "error_norm":
                out["error_norm"] = None if v is None else float(v)
            elif isinstance(v, (bool, int, str)) or v is None:
                out[f.name] = v
            else:
                out[f.name] = float(v)
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        """Rebuild a result from :meth:`to_dict` output (the reference's
        too: keys this port does not carry are ignored).  Absent payloads
        come back empty: ``x`` as a zero-length array, ``history`` as
        ``[]``, the trace and the telemetry capture as the raw dicts they
        were serialized to (``TelemetryCapture.from_dict`` reads the
        latter)."""
        kw = dict(d)
        kw["x"] = np.asarray(kw.pop("x", []), dtype=np.float64)
        kw["history"] = [(float(t), int(wu), float(r))
                         for t, wu, r in kw.pop("history", [])]
        kw["service_fractions"] = {
            int(k): float(v)
            for k, v in (kw.pop("service_fractions", {}) or {}).items()}
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in kw.items() if k in known})

    def summary(self) -> str:
        return (
            f"converged={self.converged} WU={self.worker_updates} "
            f"wall={self.wall_time:.3f}s res={self.residual_norm:.3e} "
            f"fires={self.accel_fires} acc={self.accel_accepts} "
            f"rej={self.accel_rejects} stale_drops={self.stale_drops}"
        )


def _writable(a: np.ndarray) -> np.ndarray:
    """Return a float64 array that is safe to mutate in place."""
    a = np.asarray(a, dtype=np.float64)
    return a if a.flags.writeable else a.copy()


def _fault_for(cfg: RunConfig, worker: int) -> FaultProfile:
    if cfg.faults is None:
        return FaultProfile()
    if isinstance(cfg.faults, FaultProfile):
        return cfg.faults
    return cfg.faults.get(worker, FaultProfile())
