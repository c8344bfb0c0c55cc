"""Coupling-density analysis (paper §3.5).

Coupling density of a fixed-point map: the fraction of the full iterate each
component's update depends on.  Block internal coupling: the fraction of a
component's dependencies that live inside its own block — the quantity whose
~90% threshold governs whether multi-sweep local solves help (paper Fig. 3).

The port's copy of the reference's module, numpy only: it reads the
problems' ``dependency_counts`` and ``dependency_indices`` hooks, which
the port's problems answer from host numpy without touching the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .fixedpoint import FixedPointProblem

__all__ = [
    "coupling_density",
    "block_internal_coupling",
    "predict_acceleration_survives",
]


def coupling_density(problem: FixedPointProblem) -> float:
    """Mean fraction of the iterate each component's update reads."""
    counts = problem.dependency_counts()
    if counts is None:
        return 1.0  # dense map (e.g. SCF through two-electron integrals)
    return float(np.mean(counts) / problem.n)


def block_internal_coupling(
    problem: FixedPointProblem, blocks: Sequence[np.ndarray]
) -> float:
    """Mean fraction of each component's dependencies inside its own block."""
    owner = np.empty(problem.n, dtype=np.int64)
    for b, idx in enumerate(blocks):
        owner[idx] = b
    fractions: List[float] = []
    for b, idx in enumerate(blocks):
        for i in idx:
            deps: Optional[np.ndarray] = problem.dependency_indices(int(i))
            if deps is None:  # dense row: internal fraction = |block|/n
                fractions.append(len(idx) / problem.n)
                continue
            if len(deps) == 0:
                fractions.append(1.0)
                continue
            fractions.append(float(np.mean(owner[deps] == b)))
    return float(np.mean(fractions)) if fractions else 1.0


def predict_acceleration_survives(problem: FixedPointProblem, threshold: float = 0.5) -> bool:
    """The paper's §3.5 design heuristic.

    High coupling density => staleness is an evaluation-level perturbation
    (bounded by rho^tau) and Anderson survives; low coupling density =>
    iterate-level corruption and Anderson fails.  The paper's problems sit at
    the two extremes (Jacobi ~5e-4, VI/SCF ~1), so any mid threshold works;
    0.5 is recorded here for the tests.
    """
    return coupling_density(problem) >= threshold
