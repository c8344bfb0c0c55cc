"""Hartree–Fock SCF on the Pariser–Parr–Pople model (paper §3.3.3, §5.3),
in PyTorch.

The PPP Hamiltonian for a 1-D chain of ``n`` sites (one orthogonal basis
function per site, S = I): core Hamiltonian with nearest-neighbour hopping
``-t``; two-electron integrals in the Ohno parameterization

    gamma_{mu nu} = U / sqrt(1 + (U * R_{mu nu})^2),     R in units of the
    lattice spacing, so gamma_{mu mu} = U.

Closed-shell restricted HF fixed-point map F: P -> P' (paper steps 1-3):

    F(P)  = H + diag(gamma @ diag(P)) - 1/2 * P ⊙ gamma     (Fock build)
    F C = C eps                                              (eigh, S = I)
    P'    = 2 * C_occ C_occ^T                                (density)

U/|t| controls the SCF Jacobian's spectral radius: small => rapid
contraction; ~2.5 => multiple fixed points (async convergence becomes
stochastic, paper Fig. 8); >= 4 => even synchronous DIIS struggles.

The state is the flattened density matrix; workers own row-blocks, evaluate
the *full* SCF map on the stale snapshot and return only their rows (paper
§3.3.3) — evaluation-level perturbation, coupling density 1.  The
coordinator symmetrizes after every application (``project``) and uses the
DIIS commutator residual ``[F(P), P]`` for acceleration and convergence.

``H`` and ``gamma`` are built in numpy exactly as the JAX package builds
them and live as float64 tensors on the chain's device (the card unless
the caller passes ``device="cpu"``).  The Fock build, ``torch.linalg.eigh``
(cuSOLVER on the card), the density product, the commutator and the energy
are plain PyTorch: the reference computes all of them outside any Pallas
kernel.  The density ``2 C_occ C_occᵀ`` does not depend on the signs
LAPACK or cuSOLVER give the eigenvectors; it is well defined while the
HOMO–LUMO gap (:meth:`PPPChain.homo_lumo_gap`) is far above rounding.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from ..core.fixedpoint import FixedPointProblem, restrict

__all__ = ["PPPChain", "UHFPPP", "SCFProblem", "UHFSCFProblem"]


class PPPChain:
    """PPP model for a 1-D chain at half filling (n even)."""

    def __init__(self, n_atoms: int = 8, U: float = 2.0, t: float = 1.0,
                 device=None):
        if n_atoms % 2:
            raise ValueError("half filling requires even n_atoms")
        self.device = resolve_device(device)
        self._ctor = dict(n_atoms=n_atoms, U=U, t=t, device=str(self.device))
        self.n = n_atoms
        self.U = U
        self.t = t
        self.n_occ = n_atoms // 2
        H = np.zeros((n_atoms, n_atoms))
        for i in range(n_atoms - 1):
            H[i, i + 1] = H[i + 1, i] = -t
        R = np.abs(np.arange(n_atoms)[:, None] - np.arange(n_atoms)[None, :])
        gamma = U / np.sqrt(1.0 + (U * R) ** 2)  # Ohno
        self.H = to_device(H, self.device)
        self.gamma = to_device(gamma, self.device)
        # Nuclear(core)-core repulsion of the +1 cores, constant shift.
        self.e_core = float(np.sum(np.triu(gamma, k=1)))

    def tensor(self, P) -> torch.Tensor:
        """``P`` as a float64 tensor on the chain's device (tensors on it
        pass through)."""
        if isinstance(P, torch.Tensor):
            return P.to(device=self.device, dtype=torch.float64)
        return to_device(P, self.device)

    # ------------------------------------------------------------------ #
    def fock(self, P) -> torch.Tensor:
        P = self.tensor(P)
        J = torch.diag(self.gamma @ torch.diag(P))
        K = P * self.gamma
        return self.H + J - 0.5 * K

    def scf_map(self, P) -> torch.Tensor:
        _, C = torch.linalg.eigh(self.fock(P))
        Cocc = C[:, : self.n_occ]
        return 2.0 * Cocc @ Cocc.T

    def commutator(self, P) -> torch.Tensor:
        P = self.tensor(P)
        F = self.fock(P)
        return F @ P - P @ F  # S = I

    def electronic_energy(self, P) -> torch.Tensor:
        P = self.tensor(P)
        return 0.5 * torch.sum(P * (self.H + self.fock(P)))

    def energy(self, P) -> float:
        Pm = self.tensor(P).reshape(self.n, self.n)
        return float(self.electronic_energy(Pm)) + self.e_core

    def core_guess(self) -> np.ndarray:
        _, C = torch.linalg.eigh(self.H)
        Cocc = C[:, : self.n_occ]
        return to_host(2.0 * Cocc @ Cocc.T)

    def homo_lumo_gap(self, P) -> float:
        """``eps_LUMO - eps_HOMO`` of ``F(P)``: the density of the map is
        unique (free of eigenvector signs and rotations) while this is far
        above rounding."""
        P = self.tensor(P).reshape(self.n, self.n)
        eps = torch.linalg.eigvalsh(self.fock(P))
        return float(eps[self.n_occ] - eps[self.n_occ - 1])


class UHFPPP:
    """Spin-unrestricted PPP Hartree-Fock (paper §3.3.3 map, UHF variant).

    The UHF energy landscape at intermediate U/|t| admits competing
    paramagnetic and spin-density-wave fixed points — the multistability
    regime of paper Fig. 8.  State: (P_up, P_dn) stacked.

        F_sigma = H + diag(gamma @ diag(P_up + P_dn)) - P_sigma ⊙ gamma
    """

    def __init__(self, chain: PPPChain):
        self.chain = chain
        self.n = chain.n
        self.n_occ = chain.n // 2  # S_z = 0: n/2 up + n/2 down electrons

    def fock(self, Pu, Pd):
        c = self.chain
        Pu, Pd = c.tensor(Pu), c.tensor(Pd)
        J = torch.diag(c.gamma @ torch.diag(Pu + Pd))
        return c.H + J - Pu * c.gamma, c.H + J - Pd * c.gamma

    def scf_map(self, Pu, Pd):
        Fu, Fd = self.fock(Pu, Pd)
        _, Cu = torch.linalg.eigh(Fu)
        _, Cd = torch.linalg.eigh(Fd)
        Pu2 = Cu[:, : self.n_occ] @ Cu[:, : self.n_occ].T
        Pd2 = Cd[:, : self.n_occ] @ Cd[:, : self.n_occ].T
        return Pu2, Pd2

    def commutator(self, Pu, Pd):
        c = self.chain
        Pu, Pd = c.tensor(Pu), c.tensor(Pd)
        Fu, Fd = self.fock(Pu, Pd)
        return Fu @ Pu - Pu @ Fu, Fd @ Pd - Pd @ Fd

    def energy(self, Pu, Pd) -> float:
        c = self.chain
        Pu, Pd = c.tensor(Pu), c.tensor(Pd)
        Fu, Fd = self.fock(Pu, Pd)
        e = 0.5 * (torch.sum((Pu + Pd) * c.H) + torch.sum(Pu * Fu)
                   + torch.sum(Pd * Fd))
        return float(e) + c.e_core


def _rebuild_scf(chain_kwargs, guess):
    """Factory for multi-interpreter executors (see ``factory_spec``)."""
    return SCFProblem(PPPChain(**chain_kwargs), guess=guess)


def _rebuild_uhf_scf(chain_kwargs, spin_seed):
    return UHFSCFProblem(PPPChain(**chain_kwargs), spin_seed=spin_seed)


def _flat(*mats: torch.Tensor) -> np.ndarray:
    """Host copy of the matrices, flattened and concatenated."""
    if len(mats) == 1:
        return to_host(mats[0]).reshape(-1)
    return to_host(torch.cat([m.reshape(-1) for m in mats]))


class UHFSCFProblem(FixedPointProblem):
    """UHF-PPP as a partitioned fixed-point problem; state = (P_up | P_dn).

    Workers own row-blocks of BOTH spin densities; the coordinator
    symmetrizes each spin block (paper §3.3.3 'assembles, symmetrizes').
    The multistable regime (paper Fig. 8) lives here: paramagnetic vs
    spin-density-wave fixed points at intermediate U/|t|.
    """

    def __init__(self, chain: PPPChain, spin_seed: float = 0.05):
        self.uhf = UHFPPP(chain)
        self.chain = chain
        self.device = chain.device
        self.n_ao = chain.n
        self.n = 2 * chain.n * chain.n
        self.spin_seed = spin_seed

    def _split(self, x: np.ndarray):
        n = self.n_ao
        t = to_device(x, self.device)
        return t[: n * n].reshape(n, n), t[n * n:].reshape(n, n)

    def initial(self) -> np.ndarray:
        P = self.chain.core_guess() / 2.0
        alt = np.diag(0.5 * self.spin_seed * (-1.0) ** np.arange(self.n_ao))
        Pu, Pd = P + alt, P - alt
        return np.concatenate([Pu.reshape(-1), Pd.reshape(-1)])

    def full_map(self, x: np.ndarray) -> np.ndarray:
        return _flat(*self.uhf.scf_map(*self._split(x)))

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        # Spin blocks concatenate two flat ranges, so a single slice rarely
        # applies — but uniform/greedy runs still benefit when it does.
        return restrict(self.full_map(x), indices)

    def default_blocks(self, p: int):
        n = self.n_ao
        bounds = np.linspace(0, n, p + 1).astype(int)
        blocks = []
        for i in range(p):
            rows = np.arange(bounds[i] * n, bounds[i + 1] * n)
            blocks.append(np.concatenate([rows, rows + n * n]))
        return blocks

    def project(self, x: np.ndarray) -> np.ndarray:
        n = self.n_ao
        Pu, Pd = x[: n * n].reshape(n, n), x[n * n:].reshape(n, n)
        return np.concatenate([(0.5 * (Pu + Pu.T)).reshape(-1),
                               (0.5 * (Pd + Pd.T)).reshape(-1)])

    def accel_residual(self, x: np.ndarray, g: np.ndarray) -> np.ndarray:
        return _flat(*self.uhf.commutator(*self._split(x)))

    def residual(self, x: np.ndarray) -> np.ndarray:
        return self.accel_residual(x, x)

    def residual_norm(self, x: np.ndarray) -> float:
        return float(np.linalg.norm(self.residual(x)))

    def energy(self, x: np.ndarray) -> float:
        return self.uhf.energy(*self._split(x))

    def dependency_counts(self) -> None:
        return None  # dense coupling

    def factory_spec(self):
        return (_rebuild_uhf_scf, (self.chain._ctor, self.spin_seed), {})

    def reference_energy(self, max_iter: int = 400, tol: float = 1e-11) -> float:
        """Lowest UHF energy over PM / SDW(+) / SDW(-) DIIS starts."""
        from ..core.anderson import AndersonConfig, AndersonState

        best = np.inf
        for seed in (0.0, self.spin_seed, -self.spin_seed, 4 * self.spin_seed):
            save = self.spin_seed
            self.spin_seed = seed
            x = self.initial()
            self.spin_seed = save
            st = AndersonState(AndersonConfig(m=8, beta=1.0, reg=1e-12),
                               device=self.device)
            for _ in range(max_iter):
                g = self.full_map(x)
                st.push(x, g, self.accel_residual(x, g))
                cand = st.propose()
                x = self.project(cand if cand is not None else g)
                if self.residual_norm(x) < tol:
                    break
            if self.residual_norm(x) < 1e-6:
                best = min(best, self.energy(x))
        return best


class SCFProblem(FixedPointProblem):
    """SCF as a partitioned fixed-point problem on the flattened density."""

    def __init__(self, chain: PPPChain, guess: Optional[np.ndarray] = None):
        self.chain = chain
        self.device = chain.device
        self.n_ao = chain.n
        self.n = chain.n * chain.n
        self._guess = guess

    def _P(self, x: np.ndarray) -> torch.Tensor:
        return to_device(x, self.device).reshape(self.n_ao, self.n_ao)

    # ----------------------------------------------------------------- #
    def initial(self) -> np.ndarray:
        P0 = self.chain.core_guess() if self._guess is None else self._guess
        return np.asarray(P0).reshape(-1).astype(np.float64)

    def full_map(self, x: np.ndarray) -> np.ndarray:
        return _flat(self.chain.scf_map(self._P(x)))

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        # Worker: full SCF map on the stale snapshot, return owned rows only
        # (row blocks are flat consecutive ranges: restricted on the device
        # through a slice, so only the block crosses to the host).
        return to_host(restrict(self.chain.scf_map(self._P(x)).reshape(-1),
                                indices))

    def default_blocks(self, p: int) -> List[np.ndarray]:
        # Row blocks of the density matrix, as flat index ranges.
        bounds = np.linspace(0, self.n_ao, p + 1).astype(int)
        return [
            np.arange(bounds[i] * self.n_ao, bounds[i + 1] * self.n_ao)
            for i in range(p)
        ]

    def project(self, x: np.ndarray) -> np.ndarray:
        """Coordinator-side symmetrization (paper: 'assembles, symmetrizes')."""
        P = x.reshape(self.n_ao, self.n_ao)
        return (0.5 * (P + P.T)).reshape(-1)

    # ----------------------------------------------------------------- #
    def accel_residual(self, x: np.ndarray, g: np.ndarray) -> np.ndarray:
        """DIIS commutator error FPS - SPF (S = I) at the current iterate."""
        return self.residual(x)

    def residual(self, x: np.ndarray) -> np.ndarray:
        return _flat(self.chain.commutator(self._P(x)))

    def residual_norm(self, x: np.ndarray) -> float:
        return float(np.linalg.norm(self.residual(x)))

    def energy(self, x: np.ndarray) -> float:
        return self.chain.energy(x)

    # --- structure: dense coupling through the two-electron integrals --- #
    def dependency_counts(self) -> None:
        return None  # dense => coupling density 1

    def factory_spec(self):
        guess = None if self._guess is None else np.asarray(self._guess)
        return (_rebuild_scf, (self.chain._ctor, guess), {})

    # --- reference ------------------------------------------------------ #
    def reference_solution(self, max_iter: int = 500, tol: float = 1e-12,
                           diis_m: int = 8) -> np.ndarray:
        """Synchronous DIIS from the core guess (the paper's sync baseline)."""
        from ..core.anderson import AndersonConfig, AndersonState

        x = self.initial()
        st = AndersonState(AndersonConfig(m=diis_m, beta=1.0, reg=1e-12),
                           device=self.device)
        for _ in range(max_iter):
            g = self.full_map(x)
            st.push(x, g, self.accel_residual(x, g))
            cand = st.propose()
            x_new = cand if cand is not None else g
            x_new = self.project(x_new)
            if self.residual_norm(x_new) < tol:
                return x_new
            x = x_new
        return x
