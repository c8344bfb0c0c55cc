"""Re-export shim: delegates to :mod:`repro_torch.core.engine`, nothing more.

The reference package keeps this module for code written against its
pre-refactor monolithic engine; the port keeps the same names so such code
imports unchanged.  Import from ``repro_torch.core`` or
``repro_torch.core.engine`` in new code.
"""

from __future__ import annotations

from .engine import (
    Executor,
    FaultProfile,
    ProcessPoolExecutor,
    RayExecutor,
    RunConfig,
    RunResult,
    ThreadPoolExecutor,
    VirtualTimeExecutor,
    available_executors,
    get_executor,
    known_executors,
    register_executor,
    run_fixed_point,
)
from .engine.coordinator import Coordinator as _Coordinator  # noqa: F401
from .engine.coordinator import measure_compute as _measure_compute  # noqa: F401
from .engine.coordinator import worker_eval as _worker_eval  # noqa: F401
from .engine.types import _fault_for, _writable  # noqa: F401

__all__ = [
    "FaultProfile",
    "RunConfig",
    "RunResult",
    "run_fixed_point",
    "Executor",
    "VirtualTimeExecutor",
    "ThreadPoolExecutor",
    "ProcessPoolExecutor",
    "RayExecutor",
    "register_executor",
    "get_executor",
    "available_executors",
    "known_executors",
]
