"""Block Jacobi for the 2-D Laplacian (paper §3.3.1, §5.1), in PyTorch.

``A x = b`` with the standard 5-point stencil on a ``g × g`` grid
(Dirichlet), Jacobi splitting ``A = D - (L + U)``: the fixed-point map is
``G(x) = D^{-1}(b + (L+U) x)`` with iteration matrix spectral radius
``rho = cos(pi / (g+1))`` (< 1, l2-contraction).

Workers own contiguous row-blocks of the grid and perform ``sweeps`` local
Jacobi sweeps per update with the block boundary frozen at the snapshot
(the paper's multi-sweep local solve).

The right-hand side lives on the problem's device.  ``full_map`` goes
through :func:`repro_torch.kernels.ops.jacobi_sweep` and the whole-rows
``block_update`` through :func:`~repro_torch.kernels.ops.jacobi_halo_sweeps`:
the hand-written CUDA kernels on the card, their plain versions on the CPU.
The block update keeps the reference's neighbour order
``((up + down) + left) + right``, and ``backend`` picks the full map's
order as the reference's argument of that name does, so both maps equal
the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device, to_device, to_host
from ..core.fixedpoint import DeviceBlockPlan, FixedPointProblem, restrict
from ..kernels import ops
from ..kernels.ref import JACOBI_ORDERS, oracle_jacobi_halo_sweeps

__all__ = ["JacobiProblem"]


def _apply_A(x: torch.Tensor, g: int) -> torch.Tensor:
    """y = A x for the 5-point Laplacian (diag 4, neighbors -1)."""
    xg = x.reshape(g, g)
    p = F.pad(xg, (1, 1, 1, 1))
    nb = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
    return (4.0 * xg - nb).reshape(-1)


class _JacobiDevicePlan(DeviceBlockPlan):
    """Device-resident whole-rows Jacobi block: per dispatch it consumes
    only the two g-length halo rows (r0-1 and r1) instead of the O(n)
    iterate — 32 KB instead of 32 MB at g=2048."""

    def __init__(self, problem: "JacobiProblem", r0: int, r1: int,
                 mode: str):
        if mode not in ("kernel", "ref"):
            raise ValueError(f"unknown device_plane mode {mode!r}")
        g = problem.g
        self._g, self._r0, self._r1 = g, r0, r1
        self._rows = r1 - r0
        self._sweeps = problem.sweeps
        self._mode = mode
        self._device = problem.device
        self._bg = problem._b_t.reshape(g, g)[r0:r1]
        self._zeros = problem._zeros
        self.needs = [s for s in (
            slice((r0 - 1) * g, r0 * g) if r0 > 0 else None,
            slice(r1 * g, (r1 + 1) * g) if r1 < g else None,
        ) if s is not None]
        self._blk: Optional[torch.Tensor] = None

    def refresh(self, block_values: np.ndarray) -> None:
        self._blk = to_device(
            np.asarray(block_values).reshape(self._rows, self._g),
            self._device)

    def step(self, *need_vals: np.ndarray):
        halos = iter(need_vals)
        top = (to_device(next(halos), self._device) if self._r0 > 0
               else self._zeros)
        bot = (to_device(next(halos), self._device) if self._r1 < self._g
               else self._zeros)
        if self._mode == "kernel":
            new, norm = ops.jacobi_halo_sweeps(self._blk, top, bot, self._bg,
                                               sweeps=self._sweeps)
        else:
            new_np, norm = oracle_jacobi_halo_sweeps(
                to_host(self._blk), to_host(top), to_host(bot),
                to_host(self._bg), sweeps=self._sweeps)
            new = to_device(new_np, self._device)
        self._blk = new
        return to_host(new).ravel(), float(norm)


class JacobiProblem(FixedPointProblem):
    """2-D Laplacian block Jacobi with multi-sweep local solves."""

    def __init__(self, grid: int = 100, sweeps: int = 10, seed: int = 0,
                 backend: str = "jnp", device=None):
        """``backend`` mirrors the reference's argument and picks the full
        map's add order, not a framework: ``"jnp"`` (the default) sums
        ``(b + (((up + down) + left) + right)) / 4`` like the reference's
        ``_full_sweep``, ``"pallas"`` ``((((b + up) + down) + left) +
        right) * 0.25`` like its Pallas kernel.  Both run the CUDA
        ``jacobi_sweep`` kernel on the card and its plain version on the
        CPU."""
        if backend not in JACOBI_ORDERS:
            raise ValueError(f"backend must be one of {JACOBI_ORDERS}, got "
                             f"{backend!r}")
        self.device = resolve_device(device)
        self.backend = backend
        self.g = grid
        self.n = grid * grid
        self.sweeps = sweeps
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Random right-hand side: the solution A^{-1} b is dominated by the
        # smooth (slow) Laplacian modes, which is the regime in which the
        # paper's 100x100 run needs ~3,240 x 10-sweep rounds to reach an
        # absolute residual of 1e-6.
        self._b = rng.standard_normal(self.n)
        self._b_t = to_device(self._b, self.device)
        self._zeros = torch.zeros(grid, dtype=torch.float64,
                                  device=self.device)
        self._x_star: Optional[np.ndarray] = None

    # ----------------------------------------------------------------- #
    def initial(self) -> np.ndarray:
        return np.zeros(self.n)

    def full_map(self, x: np.ndarray) -> np.ndarray:
        return to_host(ops.jacobi_sweep(to_device(x, self.device), self._b_t,
                                        self.g, self.backend))

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        r0, r1 = self._rows_of(indices)
        if r0 is not None:
            # Only the block and its two halo rows cross to the device.
            g, dev = self.g, self.device
            xg = np.asarray(x).reshape(g, g)
            top = to_device(xg[r0 - 1], dev) if r0 > 0 else self._zeros
            bot = to_device(xg[r1], dev) if r1 < g else self._zeros
            new, _ = ops.jacobi_halo_sweeps(
                to_device(xg[r0:r1], dev), top, bot,
                self._b_t.reshape(g, g)[r0:r1], sweeps=self.sweeps)
            return to_host(new).ravel()
        # Non-whole-rows selection (uniform/greedy): single-sweep restriction.
        return restrict(self.full_map(x), indices)

    def _rows_of(self, indices: np.ndarray) -> Tuple[Optional[int], Optional[int]]:
        """Detect a contiguous whole-rows block; else (None, None)."""
        i0, i1 = int(indices[0]), int(indices[-1]) + 1
        if i1 - i0 != len(indices) or i0 % self.g or i1 % self.g:
            return None, None
        if len(indices) > 1 and indices[1] - indices[0] != 1:
            return None, None
        return i0 // self.g, i1 // self.g

    def device_block_plan(self, indices, mode: str):
        r0, r1 = self._rows_of(np.asarray(indices))
        if r0 is None:
            return None  # not a whole-rows block: host path
        return _JacobiDevicePlan(self, r0, r1, mode)

    # ----------------------------------------------------------------- #
    def residual(self, x: np.ndarray) -> np.ndarray:
        return self._b - to_host(_apply_A(to_device(x, self.device), self.g))

    def residual_norm(self, x: np.ndarray) -> float:
        # Absolute 2-norm, matching the paper's convergence criterion.
        return float(np.linalg.norm(self.residual(x)))

    def exact_solution(self) -> np.ndarray:
        """``A^{-1} b`` by the fast sine transform.

        The Dirichlet 5-point Laplacian is diagonalised by the 2-D type-I
        DST (eigenvalues ``4 sin^2(pi k / 2(g+1))`` per axis), which solves
        the g = 2048 grid in well under a second where a sparse LU would
        take minutes; it agrees with the reference's ``spsolve`` to
        rounding.
        """
        if self._x_star is None:
            from scipy.fft import dstn, idstn

            g = self.g
            lam = 4.0 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
            bh = dstn(self._b.reshape(g, g), type=1)
            self._x_star = idstn(bh / (lam[:, None] + lam[None, :]),
                                 type=1).reshape(-1)
        return self._x_star

    # --- structure (coupling, paper §3.5) ------------------------------ #
    def dependency_counts(self) -> np.ndarray:
        counts = np.full(self.n, 5, dtype=np.int64)  # self + 4 neighbors
        grid_idx = np.arange(self.n).reshape(self.g, self.g)
        counts[grid_idx[0, :]] -= 1
        counts[grid_idx[-1, :]] -= 1
        counts[grid_idx[:, 0]] -= 1
        counts[grid_idx[:, -1]] -= 1
        return counts

    def dependency_indices(self, i: int) -> np.ndarray:
        r, c = divmod(i, self.g)
        deps = [i]
        if r > 0:
            deps.append(i - self.g)
        if r < self.g - 1:
            deps.append(i + self.g)
        if c > 0:
            deps.append(i - 1)
        if c < self.g - 1:
            deps.append(i + 1)
        return np.asarray(deps)

    # --- analysis helpers ---------------------------------------------- #
    @property
    def spectral_radius(self) -> float:
        return float(np.cos(np.pi / (self.g + 1)))
