"""Fixed-point problem interface for the async coordinator/worker engine.

A problem exposes the partitioned Frommer–Szyld model of paper §3.1: the
global state is a flat float64 vector ``x`` of length ``n``; worker ``l``
computes new values for an index block from a (possibly stale) snapshot of
the full state.  Two return modes matter for the paper's central finding:

  * ``block``   — the worker returns only its owned components (partial
                  update; this is what the paper's systems do, and what
                  produces *iterate-level corruption* for low-coupling maps);
  * ``full_map``— the worker returns a full map evaluation (the paper's
                  §6 future-work redesign; staleness then enters only as an
                  *evaluation-level perturbation*).

The flat numpy view here is the coordinator-side contract; concrete
problems keep their data as torch tensors on their device and cross this
boundary at every call.
"""

from __future__ import annotations

import abc
from typing import List, Optional

import numpy as np

__all__ = ["FixedPointProblem", "DeviceBlockPlan", "contiguous_blocks",
           "as_block_slice", "restrict"]


class DeviceBlockPlan:
    """Contract for a device-resident block (``RunConfig.device_plane``).

    A plan owns one block of the iterate as a device tensor that stays
    resident across the worker's dispatch loop.  Per dispatch the
    backend ships only the host slices named by ``needs`` (halo rows,
    dependency closures) instead of re-materializing the full iterate:

    * ``needs`` — list of ``slice`` objects (or sorted index arrays, for
      dependency closures) into the flat iterate whose current host
      values ``step`` consumes each dispatch;
    * ``refresh(block_values)`` — (re)load the resident block from host
      values (after an accel commit or a non-verbatim apply);
    * ``step(*need_vals)`` — run one fused block update on the resident
      block, advance it in place, and return ``(values, local_norm)``
      where ``values`` is the host copy for ``apply_return`` and
      ``local_norm`` the kernel's fused block-local residual norm.
    """

    needs: List[slice] = []

    def refresh(self, block_values: np.ndarray) -> None:
        raise NotImplementedError

    def step(self, *need_vals: np.ndarray):
        raise NotImplementedError


def contiguous_blocks(n: int, p: int) -> List[np.ndarray]:
    """Split ``range(n)`` into ``p`` contiguous, near-equal index blocks."""
    bounds = np.linspace(0, n, p + 1).astype(np.int64)
    return [np.arange(bounds[i], bounds[i + 1]) for i in range(p)]


def as_block_slice(indices) -> Optional[slice]:
    """``slice(i0, i1)`` when ``indices`` is a consecutive run, else None.

    The engine's default partitioning (:func:`contiguous_blocks` and the
    problems' row-block overrides) produces consecutive index arrays, for
    which slice indexing (one memcpy) beats integer fancy indexing (an
    index-array read plus a gather/scatter) by a wide margin at large
    blocks — the coordinator's per-arrival write and the problems' restrict
    gathers both dispatch through this.  The verification is exact (a full
    consecutive-run check), so callers may substitute the slice for the
    index array without changing any value.
    """
    if isinstance(indices, slice):
        return indices
    idx = np.asarray(indices)
    if idx.ndim != 1 or idx.size == 0 or idx.dtype == np.bool_:
        return None  # boolean masks index by position, not value
    i0, i1 = int(idx[0]), int(idx[-1])
    if i0 < 0 or i1 - i0 + 1 != idx.size:
        return None  # negative indices: slice(i0, i1+1) would not agree
    if idx.size > 1 and not np.array_equal(
            idx, np.arange(i0, i1 + 1, dtype=idx.dtype)):
        return None
    return slice(i0, i1 + 1)


def restrict(values: np.ndarray, indices) -> np.ndarray:
    """``values[indices]`` through a slice when the indices are a block.

    The shared restrict step of every 'evaluate the full map, return the
    owned components' ``block_update`` (VI, Jacobi's non-row path) and of
    ``worker_eval``'s full-map return mode.
    """
    sl = as_block_slice(indices)
    return values[indices] if sl is None else values[sl]


class FixedPointProblem(abc.ABC):
    """A fixed-point iteration ``x <- G(x)`` with block partitioning."""

    #: flattened state size
    n: int

    # ------------------------------------------------------------------ #
    # Required interface
    # ------------------------------------------------------------------ #
    @abc.abstractmethod
    def initial(self) -> np.ndarray:
        """Initial iterate (flat, float64)."""

    @abc.abstractmethod
    def full_map(self, x: np.ndarray) -> np.ndarray:
        """One application of G to the full state."""

    @abc.abstractmethod
    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        """New values at ``indices`` computed from the full snapshot ``x``.

        This is the worker computation.  Problems may do more work per call
        than a strict ``G`` restriction (e.g. Jacobi multi-sweep local
        solves, paper §5.1) — that is part of the studied design space.
        """

    # ------------------------------------------------------------------ #
    # Residuals
    # ------------------------------------------------------------------ #
    def residual(self, x: np.ndarray) -> np.ndarray:
        """Natural problem residual (default: fixed-point residual)."""
        return self.full_map(x) - x

    def residual_norm(self, x: np.ndarray) -> float:
        """Scalar convergence measure (default: 2-norm of residual)."""
        return float(np.linalg.norm(self.residual(x)))

    def component_residual(self, x: np.ndarray) -> np.ndarray:
        """Per-component |residual| for greedy (Gauss–Southwell) selection."""
        return np.abs(self.residual(x))

    def accel_residual(self, x: np.ndarray, g: np.ndarray) -> np.ndarray:
        """Residual fed to Anderson/DIIS (default g - x)."""
        return g - x

    def project(self, x: np.ndarray) -> np.ndarray:
        """Coordinator-side projection after each application (default: id)."""
        return x

    def is_projection_trivial(self) -> bool:
        """True when ``project`` is the base-class identity.

        The coordinator uses this to keep its per-arrival cost O(block):
        trivially-projected problems (Jacobi, value iteration, …) get their
        blocks written in place with no ``project``/copy round trip, while
        overriders keep the full post-apply projection.
        """
        return type(self).project is FixedPointProblem.project

    # ------------------------------------------------------------------ #
    # Device-resident data plane (RunConfig.device_plane)
    # ------------------------------------------------------------------ #
    def device_block_plan(self, indices, mode: str):
        """A :class:`DeviceBlockPlan` for ``indices``, or None.

        Problems whose block update can run against a device-resident
        block plus a small set of host slices (halo rows, dependency
        closures) return a plan here; ``None`` (the default) keeps the
        host path for this block.  ``mode`` selects the kernel flavour:
        ``"kernel"`` (the fused kernels through
        :mod:`repro_torch.kernels.ops`: CUDA on the card, the plain
        PyTorch version on the CPU) or ``"ref"`` (numpy oracle — for
        differential testing).
        """
        return None

    # ------------------------------------------------------------------ #
    # Partitioning / reference
    # ------------------------------------------------------------------ #
    def default_blocks(self, p: int) -> List[np.ndarray]:
        return contiguous_blocks(self.n, p)

    def factory_spec(self):
        """Picklable recipe ``(factory, args, kwargs)`` to rebuild this problem.

        The process executor ships this recipe, not the instance, and each
        worker calls ``factory(*args, **kwargs)`` in its own interpreter.
        The factory must be importable by reference (a top-level class or
        function) and args/kwargs plain Python and numpy, so that the
        pickled payload (and the pool key hashed from it) is the same on
        every run; the device goes as a string (``"cuda:0"``, ``"cpu"``),
        so the worker rebuilds the problem on the device it came from.
        ``None`` (the default) means "no recipe": the executor then pickles
        the instance itself and fails with a clear error if that is
        impossible.
        """
        return None

    def exact_solution(self) -> Optional[np.ndarray]:
        """Known solution for validation, if available."""
        return None

    def error_norm(self, x: np.ndarray) -> Optional[float]:
        sol = self.exact_solution()
        if sol is None:
            return None
        return float(np.linalg.norm(x - sol))

    # ------------------------------------------------------------------ #
    # Structure (coupling density, paper §3.5)
    # ------------------------------------------------------------------ #
    def dependency_counts(self) -> Optional[np.ndarray]:
        """Number of components each component's update reads (or None)."""
        return None

    def dependency_indices(self, i: int) -> Optional[np.ndarray]:
        """Indices read by component ``i``'s update (or None if dense)."""
        return None
