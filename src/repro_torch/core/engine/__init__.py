"""Pluggable (a)synchronous fixed-point execution engine (PyTorch port).

- :mod:`repro_torch.core.engine.types`        — FaultProfile / RunConfig /
  RunResult
- :mod:`repro_torch.core.engine.coordinator`  — shared apply/accel/record
  logic
- :mod:`repro_torch.core.engine.base`         — Executor ABC + registry
- :mod:`repro_torch.core.engine.virtual_time` — deterministic
  discrete-event backend
- :mod:`repro_torch.core.engine.threadpool`   — real-concurrency thread
  backend, with the device-resident data plane
- :mod:`repro_torch.core.engine.process`      — persistent process pools
  (spawned interpreters, CUDA workers), with the same data plane
- :mod:`repro_torch.core.engine.ray_backend`  — Ray actors, the paper's
  §4 runtime (optional dependency; CUDA actors share the card)
- :mod:`repro_torch.core.engine.poolreg`      — the pools' LRU registry
- :mod:`repro_torch.core.engine.device_plane` — the data-plane resolver

Chaos scenarios and trace capture (:mod:`repro_torch.chaos`) and
checkpoints (:mod:`repro_torch.recover`) hook into the coordinator and
every backend.

:func:`run_fixed_point` is the one-call API; the backend is selected with
``RunConfig.executor`` (``"virtual"`` | ``"thread"`` | ``"process"`` |
``"ray"``).
:func:`submit_fixed_point` returns a started :class:`SolveSession`.
"""

from __future__ import annotations

from ..fixedpoint import FixedPointProblem
from .base import (
    Executor,
    available_executors,
    get_executor,
    known_executors,
    register_executor,
    register_unavailable,
)
from .coordinator import (
    AccelPlan,
    Coordinator,
    EvalItem,
    RecordPlan,
    measure_compute,
    worker_eval,
)
from .poolreg import PoolLease, PoolRegistry, payload_key
from .process import (
    ProcessPoolExecutor,
    pool_stats,
    process_pools,
    shutdown_pools,
)
from .session import SessionState, SolveSession
from .threadpool import ThreadPoolExecutor
from .types import CoordinatorCrash, FaultProfile, RunConfig, RunResult
from .virtual_time import VirtualTimeExecutor

from . import ray_backend as _ray_backend  # registers "ray" or its absence
from .ray_backend import ray_pool_stats, ray_pools, shutdown_ray_pools

RayExecutor = getattr(_ray_backend, "RayExecutor", None)

__all__ = [
    "FaultProfile",
    "RunConfig",
    "RunResult",
    "CoordinatorCrash",
    "run_fixed_point",
    "submit_fixed_point",
    "SolveSession",
    "SessionState",
    "Executor",
    "VirtualTimeExecutor",
    "ThreadPoolExecutor",
    "ProcessPoolExecutor",
    "RayExecutor",
    "shutdown_pools",
    "process_pools",
    "pool_stats",
    "PoolRegistry",
    "PoolLease",
    "payload_key",
    "Coordinator",
    "EvalItem",
    "AccelPlan",
    "RecordPlan",
    "register_executor",
    "register_unavailable",
    "get_executor",
    "available_executors",
    "known_executors",
    "measure_compute",
    "worker_eval",
    "ray_pool_stats",
    "ray_pools",
    "shutdown_ray_pools",
]


def run_fixed_point(problem: FixedPointProblem, cfg: RunConfig) -> RunResult:
    """Run one (a)synchronous fixed-point solve under the given config."""
    return get_executor(cfg.executor).run(problem, cfg)


def submit_fixed_point(problem: FixedPointProblem,
                       cfg: RunConfig) -> SolveSession:
    """Start one solve without blocking: returns a running
    :class:`SolveSession` whose ``result()`` yields the :class:`RunResult`."""
    return get_executor(cfg.executor).submit(problem, cfg)
