"""Carry state from the JAX package's objects into the port's.

Each function takes plain numpy arrays (what ``np.asarray`` of a reference
object's fields gives), so this module imports nothing of the reference
package.  The tests build port objects from reference objects this way,
so both sides compute on identical data.
"""

from __future__ import annotations

import numpy as np

from .core.anderson import AndersonConfig, AndersonState
from .problems.jacobi import JacobiProblem
from .problems.value_iteration import GarnetMDP

__all__ = ["jacobi_from_arrays", "garnet_from_arrays",
           "anderson_from_snapshot"]


def jacobi_from_arrays(b, grid: int, sweeps: int, device=None) -> JacobiProblem:
    """A port :class:`JacobiProblem` whose right-hand side is exactly ``b``
    (flat ``(grid*grid,)``, e.g. a reference problem's ``_b``)."""
    b = np.array(b, dtype=np.float64).reshape(-1)
    if b.shape != (grid * grid,):
        raise ValueError(f"expected b of shape ({grid * grid},), got "
                         f"{b.shape}")
    prob = JacobiProblem(grid=grid, sweeps=sweeps, seed=0, device=device)
    prob._b = b
    prob._b_t = prob._b_t.new_tensor(b)
    return prob


def garnet_from_arrays(idx, probs, R, gamma: float, device=None) -> GarnetMDP:
    """A port :class:`GarnetMDP` holding exactly these arrays
    (``idx`` ``(S, A, b)`` int32, ``probs`` ``(S, A, b)``, ``R``
    ``(S, A)``)."""
    idx = np.asarray(idx)
    S, A, b = idx.shape
    probs = np.asarray(probs, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    if probs.shape != (S, A, b) or R.shape != (S, A):
        raise ValueError("inconsistent MDP array shapes")
    return GarnetMDP.from_arrays(idx.astype(np.int32), probs, R, gamma,
                                 device=device)


def anderson_from_snapshot(snap: dict, config: AndersonConfig,
                           device=None) -> AndersonState:
    """A port :class:`AndersonState` restored from the dict of the
    reference ``AndersonState.snapshot()`` (counters and window)."""
    state = AndersonState(config, device=device)
    state.restore(snap)
    return state
