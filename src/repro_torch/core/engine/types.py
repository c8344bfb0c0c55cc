"""Shared engine datatypes: fault profiles, run configuration, run results.

These are backend-agnostic: the same :class:`RunConfig` drives the
deterministic virtual-time simulator and the real-concurrency thread
backend (``cfg.executor`` selects which — see
:mod:`repro_torch.core.engine.base`).

The port's engine carries the reference engine's fields so a config reads
the same in both packages, but the layers that hook into the reference
coordinator (chaos scenarios, autoscale controllers, trace capture,
checkpoints, telemetry) and the process and Ray backends are not ported
yet: setting any of them raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..anderson import AndersonConfig

__all__ = ["FaultProfile", "RunConfig", "RunResult"]

_LAYERS_ITEM = ("ROADMAP.md queue 1, item 4 (recover/, telemetry/, chaos/, "
                "autoscale/, serve/)")
_UNPORTED_EXECUTORS = {
    "process": "ROADMAP.md queue 1, item 2 (the process backend with CUDA "
               "workers)",
    "ray": "ROADMAP.md queue 1, item 5 (the Ray backend)",
}


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
    knobs of layers the port does not carry yet (``scenario``,
    ``controller``, ``capture_trace``, ``checkpoint_every``,
    ``checkpoint_dir``, ``resume_from``, ``telemetry`` and the
    ``"process"``/``"ray"`` executors) raise ``NotImplementedError``.
    """

    n_workers: int = 4
    mode: str = "async"  # "sync" | "async"
    executor: str = "virtual"  # "virtual" | "thread"
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
    # inline; "worker" offloads them to an eval thread (thread backend) or
    # a modeled eval server (virtual backend) so fires overlap arrivals.
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
    # --- layers not ported yet (raise NotImplementedError when set) ------- #
    scenario: Optional[object] = None
    controller: Optional[object] = None
    capture_trace: bool = False
    checkpoint_every: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    resume_from: Optional[object] = None
    telemetry: Optional[object] = None
    # --- SDC quarantine (coordinator-side guard) --------------------------- #
    # Screen every arriving block for NaN/Inf and for update norms that
    # diverge from a windowed baseline of recently accepted update norms; a
    # worker collecting sdc_strikes rejections is quarantined.
    sdc_guard: bool = False
    sdc_window: int = 32  # baseline window (accepted update norms)
    sdc_threshold: float = 25.0  # reject when norm > threshold * median
    sdc_strikes: int = 3  # rejections before quarantine (0 => never)
    # --- device-resident data plane (thread backend) ----------------------- #
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

    def __post_init__(self) -> None:
        for name in ("scenario", "controller", "telemetry", "resume_from",
                     "checkpoint_every", "checkpoint_dir"):
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"RunConfig.{name} is not ported to repro_torch yet: "
                    f"{_LAYERS_ITEM}")
        if self.capture_trace:
            raise NotImplementedError(
                "RunConfig.capture_trace is not ported to repro_torch yet: "
                f"{_LAYERS_ITEM}")
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
    # Fires whose begin->commit window crossed a quarantine and committed
    # restricted to the blocks whose ownership did not move.
    accel_partial_commits: int = 0
    # Fraction of the run the coordinator spent doing its own work —
    # measured on the thread backend, modeled on the virtual eval-cost loop.
    coordinator_busy_frac: float = 0.0
    fire_window_s: float = 0.0
    fire_window_arrivals: int = 0
    # --- membership (SDC quarantine) -------------------------------------- #
    preemptions: int = 0  # workers removed from the membership
    reassigned_blocks: int = 0  # block moves to surviving workers
    preempt_discards: int = 0  # in-flight results of quarantined workers
    service_fractions: Dict[int, float] = field(default_factory=dict)
    sdc_rejects: int = 0  # corrupted arrivals rejected by the SDC guard
    quarantined: int = 0  # workers quarantined by the k-strikes policy
    # --- device-resident data plane --------------------------------------- #
    pin_copies_avoided: int = 0
    pin_cow_saves: int = 0
    device_dispatches: int = 0  # block updates served by the device plane
    device_refreshes: int = 0  # device blocks re-synced from the host iterate

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
