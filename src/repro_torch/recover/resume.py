"""Resume a durable solve from its latest SolveCheckpoint.

:func:`resume_fixed_point` is the one-call restore path: give it the
problem, the original config, and (optionally) a specific checkpoint, and
it reconstructs the session on whatever backend the config names.  The
contract mirrors :func:`repro_torch.core.engine.run_fixed_point`, plus:

- the resumed run picks up *exactly* where the checkpoint left off — on
  the virtual backend, and the thread backend with one fault-free worker,
  the continuation is bit-identical to an uninterrupted run (the
  checkpoint carries the rng state, the Anderson window and the backend's
  loop state);
- commit semantics across the restore boundary are at-most-once: arrivals
  applied after the snapshot were never committed into it and are redone,
  never double-counted, and no accel fire replays;
- control-plane attachments die with the control plane: a scenario
  script, autoscale controller or trace capture configured on the
  original run is stripped from the resume config (their remaining
  events/state lived in the crashed coordinator).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.engine import run_fixed_point, submit_fixed_point
from ..core.engine.types import RunConfig, RunResult
from .checkpoint import SolveCheckpoint, latest_checkpoint, resolve_checkpoint

__all__ = ["resume_config", "resume_fixed_point", "submit_resume"]


def resume_config(cfg: RunConfig,
                  ckpt: Optional[SolveCheckpoint] = None) -> RunConfig:
    """Build the config for a resumed run.

    Locates the newest checkpoint under ``cfg.checkpoint_dir`` when
    ``ckpt`` is not given, installs it as ``resume_from``, and strips the
    control-plane attachments (scenario / controller / capture_trace) that
    cannot survive a coordinator loss.  Checkpointing itself stays
    on, so the resumed run keeps extending the same checkpoint chain.
    """
    if ckpt is None:
        if not cfg.checkpoint_dir:
            raise ValueError(
                "resume_fixed_point needs a checkpoint: pass one, or a cfg "
                "with checkpoint_dir set")
        ckpt = latest_checkpoint(cfg.checkpoint_dir)
        if ckpt is None:
            raise FileNotFoundError(
                f"no checkpoints under {cfg.checkpoint_dir!r}")
    else:
        ckpt = resolve_checkpoint(ckpt)
    return dataclasses.replace(
        cfg, resume_from=ckpt, scenario=None, controller=None,
        capture_trace=False)


def resume_fixed_point(problem, cfg: RunConfig,
                       ckpt: Optional[SolveCheckpoint] = None) -> RunResult:
    """Reconstruct and finish a checkpointed solve (blocking)."""
    return run_fixed_point(problem, resume_config(cfg, ckpt))


def submit_resume(problem, cfg: RunConfig,
                  ckpt: Optional[SolveCheckpoint] = None):
    """Session-surface twin of :func:`resume_fixed_point`: returns a
    started :class:`repro_torch.core.engine.SolveSession`."""
    return submit_fixed_point(problem, resume_config(cfg, ckpt))
