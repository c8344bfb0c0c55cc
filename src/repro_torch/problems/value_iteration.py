"""Asynchronous value iteration on Garnet MDPs (paper §3.3.2, §5.2), in
PyTorch.

The Bellman optimality operator

    (T V)(s) = max_a [ R(s,a) + gamma * sum_b P(s'_b | s,a) V(s'_b) ]

is a gamma-contraction in the sup norm.  Garnet(S, A, b) random MDPs
(Archibald et al. 1995): each (s, a) has ``b`` distinct successor states
with stick-breaking probabilities and uniform(0,1) rewards.

Workers own state blocks; each update is the *full map component* evaluated
on the (stale) snapshot — the evaluation-level-perturbation mechanism that
lets Anderson survive asynchrony (paper §3.5).

The MDP's tensors (``idx`` int32, ``probs`` and ``R`` float64) live on its
device; ``full_map`` goes through :func:`repro_torch.kernels.ops.bellman`
and the device plane through :func:`~repro_torch.kernels.ops.bellman_block`.
The numpy draws are the JAX package's, in the same order, so a port MDP
and a reference MDP built from one seed hold identical arrays.

A :class:`PolicyEvaluationProblem` (linear, T_pi V = r_pi + gamma P_pi V)
isolates the max-operator non-smoothness from the l2/linf norm mismatch.
A :class:`GridWorldMDP` provides a known-optimal-policy validation target.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from ..core.fixedpoint import (
    DeviceBlockPlan,
    FixedPointProblem,
    as_block_slice,
    restrict,
)
from ..kernels import ops
from ..kernels.ref import oracle_bellman_block

__all__ = [
    "GarnetMDP",
    "GridWorldMDP",
    "ValueIterationProblem",
    "PolicyEvaluationProblem",
]


def _q_values(V: torch.Tensor, idx, probs, R, gamma: float) -> torch.Tensor:
    ev = (probs * V[idx.long()]).sum(-1)
    return R + gamma * ev


class GarnetMDP:
    """Garnet(S, A, b) random MDP (Archibald/McKinnon/Thomas 1995)."""

    def __init__(self, S: int = 500, A: int = 4, b: int = 5,
                 gamma: float = 0.95, seed: int = 0, sample: str = "exact",
                 device=None):
        self.device = resolve_device(device)
        self.S, self.A, self.b, self.gamma = S, A, b, gamma
        rng = np.random.default_rng(seed)
        if sample == "fast":
            # Vectorized successor draw for large-S runs: one rng.integers
            # call instead of S*A rng.choice calls.  Unlike the exact
            # recipe the b successors per (s, a) may repeat (probability
            # O(b^2/S) — negligible at benchmark scales).
            idx = rng.integers(0, S, size=(S, A, b), dtype=np.int64)
            idx = idx.astype(np.int32)
        elif sample == "exact":
            idx = np.empty((S, A, b), dtype=np.int32)
            for s in range(S):
                for a in range(A):
                    idx[s, a] = rng.choice(S, size=b, replace=False)
        else:
            raise ValueError(f"unknown sample mode {sample!r}")
        # Stick-breaking transition probabilities (standard Garnet recipe).
        cuts = np.sort(rng.uniform(size=(S, A, b - 1)), axis=-1)
        probs = np.diff(np.concatenate(
            [np.zeros((S, A, 1)), cuts, np.ones((S, A, 1))], axis=-1), axis=-1)
        self._set_arrays(idx, probs, rng.uniform(size=(S, A)))

    def _set_arrays(self, idx, probs, R) -> None:
        self.idx = torch.as_tensor(np.array(idx, dtype=np.int32),
                                   device=self.device)
        self.probs = to_device(probs, self.device)
        self.R = to_device(R, self.device)

    @classmethod
    def from_arrays(cls, idx, probs, R, gamma: float, device=None):
        """An MDP holding exactly these arrays (no sampling)."""
        mdp = cls.__new__(cls)
        mdp.device = resolve_device(device)
        mdp.S, mdp.A, mdp.b = np.shape(idx)
        mdp.gamma = gamma
        mdp._set_arrays(idx, probs, R)
        return mdp

    def bellman(self, V: np.ndarray) -> np.ndarray:
        return to_host(ops.bellman(self.idx, self.probs, self.R,
                                   to_device(V, self.device),
                                   gamma=self.gamma))

    def q_values(self, V: np.ndarray) -> np.ndarray:
        return to_host(_q_values(to_device(V, self.device), self.idx,
                                 self.probs, self.R, self.gamma))

    def greedy_policy(self, V: np.ndarray) -> np.ndarray:
        return np.argmax(self.q_values(V), axis=1)


class GridWorldMDP(GarnetMDP):
    """Deterministic grid navigation with a goal — known-optimal validation.

    ``g x g`` grid, 4 actions (N/S/E/W), step reward -1, absorbing goal at
    the top-left corner with reward 0.  Optimal V*(s) = -gamma-discounted
    Manhattan distance; computed in closed form for the tests.
    """

    def __init__(self, g: int = 10, gamma: float = 0.95, device=None):
        self.device = resolve_device(device)
        self.S, self.A, self.b, self.gamma = g * g, 4, 1, gamma
        self.g = g
        S = self.S
        idx = np.zeros((S, 4, 1), dtype=np.int32)
        R = np.full((S, 4), -1.0)
        for s in range(S):
            r, c = divmod(s, g)
            moves = [(max(r - 1, 0), c), (min(r + 1, g - 1), c),
                     (r, max(c - 1, 0)), (r, min(c + 1, g - 1))]
            for a, (nr, nc) in enumerate(moves):
                idx[s, a, 0] = nr * g + nc
        goal = 0
        idx[goal, :, 0] = goal
        R[goal, :] = 0.0
        self._set_arrays(idx, np.ones((S, 4, 1)), R)

    def optimal_values(self) -> np.ndarray:
        """Closed form: V*(s) = -(1 - gamma^d(s)) / (1 - gamma)."""
        g, gamma = self.g, self.gamma
        V = np.zeros(self.S)
        for s in range(self.S):
            r, c = divmod(s, g)
            d = r + c
            V[s] = -(1.0 - gamma**d) / (1.0 - gamma)
        return V


class _VIDevicePlan(DeviceBlockPlan):
    """Device-resident VI state block.

    The block's transition rows (idx, probs, R) stay resident; per
    dispatch the plan consumes the block's *dependency closure* — the
    unique successor states its backups read, remapped once at build time
    via ``searchsorted`` — instead of the full iterate.  Garnet blocks
    whose closure approaches the full state space (dep > n/2) ship all of
    x; the fused kernel still saves the full-map restriction (the host
    path evaluates T V at every state and throws away all but the block).
    """

    def __init__(self, problem: "ValueIterationProblem", s0: int, s1: int,
                 mode: str):
        if mode not in ("kernel", "ref"):
            raise ValueError(f"unknown device_plane mode {mode!r}")
        mdp = problem.mdp
        self._mode = mode
        self._gamma = mdp.gamma
        self._device = mdp.device
        idx_blk = to_host(mdp.idx[s0:s1])
        dep = np.unique(idx_blk)
        if dep.size > problem.n // 2:
            self.needs = [slice(0, problem.n)]
            self._remap = mdp.idx[s0:s1]
        else:
            self.needs = [dep.astype(np.int64)]
            self._remap = torch.as_tensor(
                np.searchsorted(dep, idx_blk).astype(np.int32),
                device=self._device)
        self._probs = mdp.probs[s0:s1]
        self._R = mdp.R[s0:s1]
        self._blk: Optional[torch.Tensor] = None

    def refresh(self, block_values: np.ndarray) -> None:
        self._blk = to_device(block_values, self._device)

    def step(self, *need_vals: np.ndarray):
        v = to_device(need_vals[0], self._device)
        if self._mode == "kernel":
            tv, norm = ops.bellman_block(self._remap, self._probs, self._R,
                                         v, self._blk, gamma=self._gamma)
        else:
            tv_np, norm = oracle_bellman_block(
                to_host(self._remap), to_host(self._probs), to_host(self._R),
                to_host(v), to_host(self._blk), gamma=self._gamma)
            tv = to_device(tv_np, self._device)
        self._blk = tv
        return to_host(tv), float(norm)


class ValueIterationProblem(FixedPointProblem):
    """V <- T V as a partitioned fixed-point problem."""

    def __init__(self, mdp: GarnetMDP):
        self.mdp = mdp
        self.device = mdp.device
        self.n = mdp.S
        self._sol: Optional[np.ndarray] = None

    def initial(self) -> np.ndarray:
        return np.zeros(self.n)

    def full_map(self, x: np.ndarray) -> np.ndarray:
        return self.mdp.bellman(x)

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        # Each state's update IS the full map component at the stale snapshot
        # (evaluation-level perturbation, paper §3.5).  Contiguous state
        # blocks restrict via a slice (memcpy) instead of a gather.
        return restrict(self.full_map(x), indices)

    def residual_norm(self, x: np.ndarray) -> float:
        # linf: the Bellman operator contracts in the sup norm.
        return float(np.max(np.abs(self.residual(x))))

    def exact_solution(self) -> np.ndarray:
        if self._sol is None:
            V = np.zeros(self.n)
            for _ in range(200_000):
                V2 = self.full_map(V)
                if np.max(np.abs(V2 - V)) < 1e-13:
                    V = V2
                    break
                V = V2
            self._sol = V
        return self._sol

    def device_block_plan(self, indices, mode: str):
        sl = as_block_slice(indices)
        if sl is None:
            return None  # scattered selection: host path
        return _VIDevicePlan(self, sl.start, sl.stop, mode)

    # --- structure ------------------------------------------------------ #
    def dependency_counts(self) -> np.ndarray:
        idx = to_host(self.mdp.idx).reshape(self.n, -1)
        return np.asarray(
            [len(np.unique(np.append(row, i))) for i, row in enumerate(idx)],
            dtype=np.int64,
        )

    def dependency_indices(self, i: int) -> np.ndarray:
        row = to_host(self.mdp.idx[i]).reshape(-1)
        return np.unique(np.append(row, i))


class PolicyEvaluationProblem(ValueIterationProblem):
    """Linear fixed point V = r_pi + gamma P_pi V (no max operator).

    Anderson applies cleanly via the Walker–Ni GMRES equivalence while the
    linf contraction remains — isolates non-smoothness from norm mismatch.
    Host path only: the fused kernels compute the max backup.
    """

    def __init__(self, mdp: GarnetMDP, policy: Optional[np.ndarray] = None):
        super().__init__(mdp)
        if policy is None:
            V_star = ValueIterationProblem(mdp).exact_solution()
            policy = mdp.greedy_policy(V_star)
        self.policy = torch.as_tensor(np.asarray(policy, dtype=np.int64),
                                      device=mdp.device)

    def full_map(self, x: np.ndarray) -> np.ndarray:
        mdp = self.mdp
        q = _q_values(to_device(x, self.device), mdp.idx, mdp.probs, mdp.R,
                      mdp.gamma)
        return to_host(q.gather(1, self.policy[:, None])[:, 0])

    def device_block_plan(self, indices, mode: str):
        # The fused kernel computes the max backup; the policy backup is a
        # different operator — host path only.
        return None

    def exact_solution(self) -> np.ndarray:
        if self._sol is None:
            # Direct linear solve of (I - gamma P_pi) V = r_pi.
            S = self.n
            idx = to_host(self.mdp.idx)
            probs = to_host(self.mdp.probs)
            R = to_host(self.mdp.R)
            pi = to_host(self.policy)
            P = np.zeros((S, S))
            r = np.empty(S)
            for s in range(S):
                a = pi[s]
                np.add.at(P[s], idx[s, a], probs[s, a])
                r[s] = R[s, a]
            self._sol = np.linalg.solve(np.eye(S) - self.mdp.gamma * P, r)
        return self._sol
