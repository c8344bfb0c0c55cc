"""Core library of the port: the paper's engine over PyTorch problems.

- :mod:`repro_torch.core.fixedpoint` — partitioned fixed-point problem
  interface (numpy-only, the coordinator contract)
- :mod:`repro_torch.core.anderson`   — Anderson/DIIS with the Eq. 5
  safeguard, window on the device
- :mod:`repro_torch.core.engine`     — coordinator, virtual-time and
  thread backends, device plane
"""

from .anderson import AndersonConfig, AndersonState, diis_solve
from .engine import (
    Executor,
    FaultProfile,
    RunConfig,
    RunResult,
    SolveSession,
    ThreadPoolExecutor,
    VirtualTimeExecutor,
    available_executors,
    get_executor,
    measure_compute,
    register_executor,
    run_fixed_point,
    submit_fixed_point,
)
from .fixedpoint import FixedPointProblem, contiguous_blocks

__all__ = [
    "AndersonConfig",
    "AndersonState",
    "diis_solve",
    "FaultProfile",
    "RunConfig",
    "RunResult",
    "run_fixed_point",
    "submit_fixed_point",
    "SolveSession",
    "Executor",
    "VirtualTimeExecutor",
    "ThreadPoolExecutor",
    "register_executor",
    "get_executor",
    "available_executors",
    "measure_compute",
    "FixedPointProblem",
    "contiguous_blocks",
]
