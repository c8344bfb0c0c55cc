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
- :mod:`repro_torch.core.engine.device_plane` — the data-plane resolver

:func:`run_fixed_point` is the one-call API; the backend is selected with
``RunConfig.executor`` (``"virtual"`` | ``"thread"``).
:func:`submit_fixed_point` returns a started :class:`SolveSession`.
"""

from __future__ import annotations

from ..fixedpoint import FixedPointProblem
from .base import (
    Executor,
    available_executors,
    get_executor,
    register_executor,
)
from .coordinator import (
    AccelPlan,
    Coordinator,
    EvalItem,
    RecordPlan,
    measure_compute,
    worker_eval,
)
from .session import SessionState, SolveSession
from .threadpool import ThreadPoolExecutor
from .types import FaultProfile, RunConfig, RunResult
from .virtual_time import VirtualTimeExecutor

__all__ = [
    "FaultProfile",
    "RunConfig",
    "RunResult",
    "run_fixed_point",
    "submit_fixed_point",
    "SolveSession",
    "SessionState",
    "Executor",
    "VirtualTimeExecutor",
    "ThreadPoolExecutor",
    "Coordinator",
    "EvalItem",
    "AccelPlan",
    "RecordPlan",
    "register_executor",
    "get_executor",
    "available_executors",
    "measure_compute",
    "worker_eval",
]


def run_fixed_point(problem: FixedPointProblem, cfg: RunConfig) -> RunResult:
    """Run one (a)synchronous fixed-point solve under the given config."""
    return get_executor(cfg.executor).run(problem, cfg)


def submit_fixed_point(problem: FixedPointProblem,
                       cfg: RunConfig) -> SolveSession:
    """Start one solve without blocking: returns a running
    :class:`SolveSession` whose ``result()`` yields the :class:`RunResult`."""
    return get_executor(cfg.executor).submit(problem, cfg)
