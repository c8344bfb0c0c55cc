"""Durable solves: checkpoint/restore and coordinator crash recovery (the
port's copy of the reference's ``recover`` package).

- **Checkpoint/restore** — :class:`SolveCheckpoint` snapshots the full
  coordinator state (iterate, rng, Anderson window, membership,
  accounting) plus the backend's resumable loop state at arrival
  boundaries; :func:`resume_fixed_point` reconstructs the session on any
  backend, bit-identically on the virtual backend and on a one-worker
  fault-free thread run.
- **Coordinator crash recovery** — the ``coordinator_crash`` chaos event
  raises :class:`CoordinatorCrash` out of the control plane; resuming from
  the latest checkpoint gives at-most-once commits.
- **SDC quarantine** — ``FaultProfile.corrupt_prob`` and
  ``RunConfig.sdc_guard`` live in the engine (``core.engine``).
"""

from ..core.engine.types import CoordinatorCrash
from .checkpoint import (
    SolveCheckpoint,
    capture,
    latest_checkpoint,
    list_checkpoints,
    resolve_checkpoint,
    restore_coordinator,
    write_checkpoint,
)
from .resume import resume_config, resume_fixed_point, submit_resume

__all__ = [
    "CoordinatorCrash",
    "SolveCheckpoint",
    "capture",
    "write_checkpoint",
    "latest_checkpoint",
    "list_checkpoints",
    "resolve_checkpoint",
    "restore_coordinator",
    "resume_config",
    "resume_fixed_point",
    "submit_resume",
]
