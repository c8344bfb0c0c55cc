"""The port's Hartree–Fock SCF against the JAX package's, on the CPU.

The same chains and densities (numpy, from seeds) go through
``repro.problems.scf`` and ``repro_torch.problems.scf``:

* ``PPPChain``'s ``H``, ``gamma`` and ``e_core`` are byte-equal (both are
  built in numpy by the same recipe);
* ``fock``, ``scf_map``, ``commutator``, ``electronic_energy`` and
  ``core_guess`` (and the UHF counterparts) agree within 1e-12 — LAPACK
  and XLA order their products and reductions differently, and the two
  ``eigh`` may return eigenvectors of opposite sign, which the density
  ``C_occ C_occᵀ`` does not see;
* the reference solution's energy and the UHF reference energy agree
  within 1e-10 (DIIS to a tolerance of 1e-12 / 1e-11);
* the reference's ``TestSCF`` is mirrored on the port.

The density is well defined only while the HOMO–LUMO gap is far above
rounding, so every size used here, in the card tests and in
``chip_smoke.py`` has its gap checked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.problems as jp  # noqa: E402  (enables jax x64)
from repro.core.coupling import coupling_density  # noqa: E402

import repro_torch  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    FaultProfile,
    RunConfig,
    run_fixed_point,
)

SIZES = [4, 8, 32]
COUPLINGS = [1e-12, 2.0, 4.0]  # the reference TestSCF's U values


def _chains(n, U):
    return jp.PPPChain(n, U), tp.PPPChain(n, U, device="cpu")


def _density(n, seed):
    """A physical trial density: the U = 0 core guess plus a symmetric
    perturbation (the same for both packages)."""
    H = np.diag(-np.ones(n - 1), 1)
    _, C = np.linalg.eigh(H + H.T)
    P = 2.0 * C[:, : n // 2] @ C[:, : n // 2].T
    E = 0.05 * np.random.default_rng(seed).standard_normal((n, n))
    return P + E + E.T


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _gap(F: np.ndarray, n_occ: int) -> float:
    eps = np.linalg.eigvalsh(F)
    return float(eps[n_occ] - eps[n_occ - 1])


@pytest.mark.parametrize("U", COUPLINGS)
@pytest.mark.parametrize("n", SIZES)
class TestRHFMatchesJax:
    def test_chain_arrays_byte_equal(self, n, U):
        jc, tc = _chains(n, U)
        assert tc.H.dtype == tc.gamma.dtype == torch.float64
        assert tc.H.numpy().tobytes() == np.asarray(jc.H).tobytes()
        assert tc.gamma.numpy().tobytes() == np.asarray(jc.gamma).tobytes()
        assert tc.e_core == jc.e_core

    def test_functions(self, n, U):
        jc, tc = _chains(n, U)
        P = _density(n, seed=n)
        # The map's density is unique only with a gap far above rounding.
        gap = tc.homo_lumo_gap(P)
        assert gap > 1e-3
        assert gap == pytest.approx(_gap(np.asarray(jc.fock(jnp.asarray(P))),
                                         n // 2), abs=1e-12)
        _close(tc.fock(P), jc.fock(jnp.asarray(P)))
        _close(tc.scf_map(P), jc.scf_map(jnp.asarray(P)))
        _close(tc.commutator(P), jc.commutator(jnp.asarray(P)))
        _close(tc.electronic_energy(P), jc.electronic_energy(jnp.asarray(P)))
        assert tc.energy(P.reshape(-1)) == pytest.approx(
            jc.energy(P.reshape(-1)), rel=1e-12, abs=1e-12)
        _close(tc.core_guess(), jc.core_guess())

    def test_problem_methods(self, n, U):
        jprob = jp.SCFProblem(jp.PPPChain(n, U))
        tprob = tp.SCFProblem(tp.PPPChain(n, U, device="cpu"))
        x = _density(n, seed=n + 1).reshape(-1)
        _close(tprob.initial(), jprob.initial())
        _close(tprob.full_map(x), jprob.full_map(x))
        _close(tprob.residual(x), jprob.residual(x))
        assert tprob.residual_norm(x) == pytest.approx(
            jprob.residual_norm(x), rel=1e-12)
        assert tprob.project(x).tobytes() == jprob.project(x).tobytes()
        for blk in tprob.default_blocks(3):
            _close(tprob.block_update(x, blk), jprob.block_update(x, blk))
        assert [b.tolist() for b in tprob.default_blocks(3)] == \
            [b.tolist() for b in jprob.default_blocks(3)]


@pytest.mark.parametrize("U", COUPLINGS)
@pytest.mark.parametrize("n", SIZES)
def test_uhf_matches_jax(n, U):
    jprob = jp.UHFSCFProblem(jp.PPPChain(n, U), spin_seed=0.1)
    tprob = tp.UHFSCFProblem(tp.PPPChain(n, U, device="cpu"), spin_seed=0.1)
    x0 = tprob.initial()
    _close(x0, jprob.initial())
    x = x0 + 0.01 * np.random.default_rng(n).standard_normal(x0.size)
    x = tprob.project(x)
    Pu, Pd = x[: n * n].reshape(n, n), x[n * n:].reshape(n, n)
    for got, want in zip(tprob.uhf.fock(Pu, Pd),
                         jprob.uhf.fock(jnp.asarray(Pu), jnp.asarray(Pd))):
        _close(got, want)
        assert _gap(got.numpy(), n // 2) > 1e-3  # each spin's density unique
    for got, want in zip(tprob.uhf.scf_map(Pu, Pd),
                         jprob.uhf.scf_map(jnp.asarray(Pu), jnp.asarray(Pd))):
        _close(got, want)
    for got, want in zip(tprob.uhf.commutator(Pu, Pd),
                         jprob.uhf.commutator(jnp.asarray(Pu),
                                              jnp.asarray(Pd))):
        _close(got, want)
    _close(tprob.full_map(x), jprob.full_map(x))
    _close(tprob.residual(x), jprob.residual(x))
    assert tprob.project(x).tobytes() == jprob.project(x).tobytes()
    assert tprob.energy(x) == pytest.approx(jprob.energy(x), rel=1e-12,
                                            abs=1e-12)
    assert [b.tolist() for b in tprob.default_blocks(2)] == \
        [b.tolist() for b in jprob.default_blocks(2)]


class TestReferenceEnergies:
    def test_reference_solution_energy(self):
        jprob = jp.SCFProblem(jp.PPPChain(8, 2.0))
        tprob = tp.SCFProblem(tp.PPPChain(8, 2.0, device="cpu"))
        xj, xt = jprob.reference_solution(), tprob.reference_solution()
        assert tprob.residual_norm(xt) < 1e-11
        assert abs(tprob.energy(xt) - jprob.energy(xj)) <= 1e-10
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10)

    @pytest.mark.parametrize("n", [8, 32])
    def test_uhf_reference_energy_multistable(self, n):
        """U = 3: paramagnetic and spin-density-wave fixed points compete
        (paper Fig. 8); both packages pick the same lowest one."""
        e_jax = jp.UHFSCFProblem(jp.PPPChain(n, 3.0)).reference_energy()
        e_port = tp.UHFSCFProblem(tp.PPPChain(n, 3.0, device="cpu")
                                  ).reference_energy()
        assert np.isfinite(e_port)
        assert abs(e_port - e_jax) <= 1e-10


@pytest.mark.parametrize("n,U", [
    (8, 2.0),      # the golden configurations' chain
    (32, 3.0),     # the UHF parity chain of chip_smoke.py
    (256, 2.0),    # the card test's chain
    (1024, 2.0),   # chip_smoke.py's SCF main path
])
def test_homo_lumo_gap_far_above_rounding(n, U):
    """At the core guess and after one map, the gap is more than 10^9
    times the rounding of the Fock matrix's eigenvalues, so ``eigh``'s
    density does not depend on the LAPACK or cuSOLVER build."""
    chain = tp.PPPChain(n, U, device="cpu")
    P0 = chain.core_guess()
    P1 = chain.scf_map(P0)
    F = chain.fock(P1).numpy()
    rounding = np.finfo(np.float64).eps * np.abs(np.linalg.eigvalsh(F)).max()
    for P in (P0, P1):
        gap = chain.homo_lumo_gap(P)
        assert gap == pytest.approx(_gap(chain.fock(P).numpy(), n // 2),
                                    abs=1e-12)
        assert gap > 1e9 * rounding


class TestSCF:
    """The reference's ``tests/test_problems.py::TestSCF`` on the port."""

    def _prob(self, n=8, U=2.0):
        return tp.SCFProblem(tp.PPPChain(n_atoms=n, U=U, device="cpu"))

    def test_density_trace_is_electron_count(self):
        prob = self._prob()
        P1 = prob.full_map(prob.initial()).reshape(8, 8)
        assert np.trace(P1) == pytest.approx(8.0)  # 2 * n_occ

    def test_density_idempotency(self):
        """P/2 is a projector: (P/2)^2 = P/2 for the map output."""
        prob = self._prob()
        P = prob.full_map(prob.initial()).reshape(8, 8)
        np.testing.assert_allclose((P / 2) @ (P / 2), P / 2, atol=1e-10)

    def test_fock_symmetric(self):
        chain = tp.PPPChain(n_atoms=8, U=2.0, device="cpu")
        F = chain.fock(chain.core_guess()).numpy()
        np.testing.assert_allclose(F, F.T, atol=1e-12)

    def test_converged_commutator_vanishes(self):
        prob = self._prob()
        assert prob.residual_norm(prob.reference_solution()) < 1e-9

    def test_sync_diis_converges_fast_weak_correlation(self):
        r = run_fixed_point(self._prob(), RunConfig(
            mode="sync", tol=1e-10, max_updates=5000, compute_time=1e-4,
            accel=AndersonConfig(m=8)))
        assert r.converged
        assert r.rounds < 60  # paper: 28 iterations

    def test_energy_variational_bound(self):
        """HF energy from any idempotent trial density >= converged energy."""
        prob = self._prob()
        e_ref = prob.energy(prob.reference_solution())
        assert prob.energy(prob.initial()) >= e_ref - 1e-10

    def test_async_diis_corrects_bias(self):
        """Paper §5.3: async+DIIS reaches the correct energy."""
        prob = self._prob()
        e_ref = prob.energy(prob.reference_solution())
        r = run_fixed_point(prob, RunConfig(
            mode="async", tol=1e-9, max_updates=60000, compute_time=1e-3,
            accel=AndersonConfig(m=8), fire_every=4,
            faults={0: FaultProfile(delay_mean=0.02)}, seed=0))
        assert r.converged
        assert abs(prob.energy(r.x) - e_ref) < 1e-6

    def test_coupling_density_dense(self):
        assert coupling_density(self._prob()) == 1.0

    def test_hopping_only_limit(self):
        """U=0: Fock == core Hamiltonian, energy is the tight-binding sum."""
        chain = tp.PPPChain(n_atoms=6, U=1e-12, device="cpu")
        P = chain.core_guess()
        np.testing.assert_allclose(chain.fock(P).numpy(), chain.H.numpy(),
                                   atol=1e-10)
        w = np.linalg.eigvalsh(chain.H.numpy())
        assert chain.energy(P.reshape(-1)) == pytest.approx(
            2 * w[:3].sum() + chain.e_core, abs=1e-8)


class TestDevices:
    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tp.SCFProblem(tp.PPPChain(8))
        with pytest.raises(RuntimeError):
            tp.UHFSCFProblem(tp.PPPChain(8, device="cuda"))

    def test_exports_and_device(self):
        for name in ("PPPChain", "UHFPPP", "SCFProblem", "UHFSCFProblem"):
            assert getattr(repro_torch, name) is getattr(tp, name)
        prob = tp.SCFProblem(tp.PPPChain(8, device="cpu"))
        assert prob.device == torch.device("cpu")
        assert prob.chain.H.device == prob.chain.gamma.device == prob.device

    def test_odd_chain_refused(self):
        with pytest.raises(ValueError, match="even"):
            tp.PPPChain(7, device="cpu")
