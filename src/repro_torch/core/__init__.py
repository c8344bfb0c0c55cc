"""Core library of the port: the paper's engine over PyTorch problems.

- :mod:`repro_torch.core.fixedpoint` — partitioned fixed-point problem
  interface (numpy-only, the coordinator contract)
- :mod:`repro_torch.core.anderson`   — Anderson/DIIS with the Eq. 5
  safeguard, window on the device
- :mod:`repro_torch.core.engine`     — coordinator, virtual-time, thread,
  process and Ray backends, device plane, elastic membership, checkpoint,
  autoscale and telemetry hooks
- :mod:`repro_torch.core.coupling`   — coupling-density analysis (paper
  §3.5)
"""

from .anderson import AndersonConfig, AndersonState, diis_solve
from .engine import (
    CoordinatorCrash,
    Executor,
    FaultProfile,
    ProcessPoolExecutor,
    RayExecutor,
    RunConfig,
    RunResult,
    SolveSession,
    ThreadPoolExecutor,
    VirtualTimeExecutor,
    available_executors,
    get_executor,
    known_executors,
    measure_compute,
    pool_stats,
    process_pools,
    ray_pool_stats,
    ray_pools,
    register_executor,
    run_fixed_point,
    shutdown_pools,
    shutdown_ray_pools,
    submit_fixed_point,
)
from .coupling import (
    block_internal_coupling,
    coupling_density,
    predict_acceleration_survives,
)
from .fixedpoint import FixedPointProblem, contiguous_blocks

__all__ = [
    "AndersonConfig",
    "AndersonState",
    "diis_solve",
    "FaultProfile",
    "RunConfig",
    "RunResult",
    "CoordinatorCrash",
    "run_fixed_point",
    "submit_fixed_point",
    "SolveSession",
    "Executor",
    "VirtualTimeExecutor",
    "ThreadPoolExecutor",
    "ProcessPoolExecutor",
    "RayExecutor",
    "shutdown_pools",
    "process_pools",
    "pool_stats",
    "ray_pool_stats",
    "ray_pools",
    "shutdown_ray_pools",
    "register_executor",
    "get_executor",
    "available_executors",
    "known_executors",
    "measure_compute",
    "FixedPointProblem",
    "contiguous_blocks",
    "coupling_density",
    "block_internal_coupling",
    "predict_acceleration_survives",
]
