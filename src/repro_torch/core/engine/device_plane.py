"""Device-resident data plane resolution (``RunConfig.device_plane``).

The device plane keeps each worker's block resident on the problem's
device across the dispatch loop: per dispatch the worker ships only the
halo/dependency slices its block update reads (two g-length rows for
Jacobi, the unique successor closure for VI) instead of re-materializing
the O(n) iterate, and runs the fused block-update(+local-residual) kernel
on the resident block.  :func:`resolve_device_plane` decides whether a run
qualifies and which flavour to use; the *problems* decide per block
whether they can serve it (``FixedPointProblem.device_block_plan``).

Flavours: ``"kernel"`` runs the fused kernels through
:mod:`repro_torch.kernels.ops` (the hand-written CUDA kernels on the card,
their plain versions on the CPU); ``"ref"`` runs the numpy oracle on the
resident block, for differential tests.

Structural requirements (anything else returns None — host path):

* the thread backend; the virtual backend always ignores the knob so
  fixed-seed virtual runs stay bit-identical to the goldens,
* async mode with fixed selection and block returns (the resident block
  IS the worker's fixed block),
* identity projection, no offloaded eval service in the loop
  (``accel_eval="worker"`` keeps the host loop), and no SDC guard (its
  quarantine reassigns blocks, which a resident block cannot follow).

``"auto"`` (the default) additionally requires ``n >= AUTO_THRESHOLD``.
"""

from __future__ import annotations

from typing import Optional

from ..fixedpoint import FixedPointProblem
from .types import RunConfig

__all__ = ["AUTO_THRESHOLD", "resolve_device_plane"]

#: "auto" turns the device plane on at this state size.  It is the
#: reference's value (n = 2**20, an 8 MB iterate); it has not been measured
#: on the card.
AUTO_THRESHOLD = 1 << 20

_MODES = ("off", "auto", "on", "ref")


def resolve_device_plane(problem: FixedPointProblem, cfg: RunConfig,
                         backend: str) -> Optional[str]:
    """Kernel flavour (``"kernel"``/``"ref"``) for this run, or None for
    the host path."""
    mode = cfg.device_plane or "off"
    if mode not in _MODES:
        raise ValueError(
            f"unknown device_plane {mode!r} (expected one of {_MODES})")
    if mode == "off":
        return None
    if backend != "thread":
        return None
    if cfg.mode != "async":
        return None
    if cfg.selection != "fixed" or cfg.return_mode != "block":
        return None
    if cfg.accel_eval == "worker":
        return None
    if cfg.sdc_guard:
        # A quarantine moves blocks between workers, and a worker's plan
        # holds only its own block resident.
        return None
    if not problem.is_projection_trivial():
        return None
    if mode == "auto":
        return "kernel" if problem.n >= AUTO_THRESHOLD else None
    return "kernel" if mode == "on" else mode
