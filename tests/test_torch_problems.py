"""The port's problems against the JAX package's, on identical data.

Both sides build their data from the same numpy draws, so the arrays must
be equal bit for bit; the maps are then held to the JAX functions:

* Jacobi block updates (adds and an exact division in the reference's
  order): exact.  ``full_map`` goes through the ``jacobi_sweep`` wrapper
  in the add order the ``backend`` argument picks, the reference problem's
  for the same ``backend``: exact for both.  ``exact_solution`` is a
  sine-transform solve in the port and a sparse LU in the reference:
  1e-10 relative.
* Value iteration: the successor expectation is a reduction ordered
  differently by XLA and torch: 1e-13.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.problems as jp  # noqa: E402  (enables jax x64)
from repro.core.anderson import AndersonConfig as JAndersonConfig  # noqa: E402
from repro.core.anderson import AndersonState as JAndersonState  # noqa: E402

import repro_torch.problems as tp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.anderson import AndersonConfig, AndersonState  # noqa: E402

RNG = np.random.default_rng(42)


def _jac_pair(grid=16, sweeps=5, seed=0, **kw):
    return (jp.JacobiProblem(grid=grid, sweeps=sweeps, seed=seed, **kw),
            tp.JacobiProblem(grid=grid, sweeps=sweeps, seed=seed,
                             device="cpu", **kw))


def _vi_pair(S=60, sample="exact", seed=0):
    return (jp.ValueIterationProblem(jp.GarnetMDP(
                S=S, A=4, b=5, gamma=0.9, seed=seed, sample=sample)),
            tp.ValueIterationProblem(tp.GarnetMDP(
                S=S, A=4, b=5, gamma=0.9, seed=seed, sample=sample,
                device="cpu")))


class TestIdenticalData:
    @pytest.mark.parametrize("sample", ["exact", "fast"])
    def test_garnet_arrays_bitwise(self, sample):
        jv, tv = _vi_pair(S=80, sample=sample, seed=3)
        np.testing.assert_array_equal(tv.mdp.idx.numpy(),
                                      np.asarray(jv.mdp.idx))
        assert tv.mdp.idx.dtype == torch.int32
        np.testing.assert_array_equal(tv.mdp.probs.numpy(),
                                      np.asarray(jv.mdp.probs))
        np.testing.assert_array_equal(tv.mdp.R.numpy(), np.asarray(jv.mdp.R))

    def test_jacobi_rhs_bitwise(self):
        jj, tj = _jac_pair(grid=24, seed=5)
        np.testing.assert_array_equal(tj._b, jj._b)
        np.testing.assert_array_equal(tj._b_t.numpy(), jj._b)

    def test_gridworld_arrays_bitwise(self):
        jg, tg = jp.GridWorldMDP(g=5), tp.GridWorldMDP(g=5, device="cpu")
        np.testing.assert_array_equal(tg.idx.numpy(), np.asarray(jg.idx))
        np.testing.assert_array_equal(tg.R.numpy(), np.asarray(jg.R))
        np.testing.assert_array_equal(tg.optimal_values(),
                                      jg.optimal_values())


class TestJacobiAgrees:
    def test_block_update_exact(self):
        jj, tj = _jac_pair(grid=24, sweeps=4)
        x = RNG.standard_normal(jj.n)
        for p in (2, 3):
            for blk in jj.default_blocks(p):
                np.testing.assert_array_equal(tj.block_update(x, blk),
                                              jj.block_update(x, blk))
        scattered = np.array([3, 50, 77, 100])  # non-row path
        np.testing.assert_array_equal(tj.block_update(x, scattered),
                                      jj.block_update(x, scattered))

    def test_full_map_residual_solution(self):
        jj, tj = _jac_pair(grid=16)
        assert tj.backend == jj.backend == "jnp"
        x = RNG.standard_normal(jj.n)
        np.testing.assert_array_equal(tj.full_map(x), jj.full_map(x))
        np.testing.assert_array_equal(tj.residual(x), jj.residual(x))
        assert tj.residual_norm(x) == jj.residual_norm(x)
        np.testing.assert_allclose(tj.exact_solution(), jj.exact_solution(),
                                   rtol=1e-10, atol=1e-12)
        assert tj.residual_norm(tj.exact_solution()) < 1e-10

    @pytest.mark.parametrize("grid", [8, 16, 24])
    def test_full_map_pallas_backend(self, grid):
        """``backend="pallas"``: the Pallas kernel's add order, held to the
        reference problem's Pallas full map (interpret mode)."""
        jj, tj = _jac_pair(grid=grid, backend="pallas")
        x = np.random.default_rng(grid).standard_normal(jj.n)
        np.testing.assert_array_equal(tj.full_map(x), jj.full_map(x))
        scattered = np.array([1, grid + 2, 3 * grid])
        np.testing.assert_array_equal(tj.block_update(x, scattered),
                                      jj.block_update(x, scattered))

    def test_backend_picks_the_add_order(self):
        """The two orders differ in the last place on random data, so each
        backend is held to its own reference, not to the other."""
        jj, tj = _jac_pair(grid=16)
        jp_, tp_ = _jac_pair(grid=16, backend="pallas")
        x = np.random.default_rng(1).standard_normal(jj.n)
        assert not np.array_equal(tj.full_map(x), tp_.full_map(x))
        np.testing.assert_array_equal(tp_.full_map(x), jp_.full_map(x))
        with pytest.raises(ValueError, match="backend"):
            tp.JacobiProblem(grid=4, backend="cuda", device="cpu")

    def test_convert_passes_the_backend(self):
        jj = jp.JacobiProblem(grid=12, sweeps=3, seed=4, backend="pallas")
        tj = convert.jacobi_from_arrays(jj._b, 12, 3, backend="pallas",
                                        device="cpu")
        assert tj.backend == "pallas"
        x = np.random.default_rng(2).standard_normal(jj.n)
        np.testing.assert_array_equal(tj.full_map(x), jj.full_map(x))

    def test_structure(self):
        jj, tj = _jac_pair(grid=8)
        np.testing.assert_array_equal(tj.dependency_counts(),
                                      jj.dependency_counts())
        for i in (0, 9, 63):
            np.testing.assert_array_equal(tj.dependency_indices(i),
                                          jj.dependency_indices(i))
        assert tj.spectral_radius == jj.spectral_radius

    @pytest.mark.parametrize("mode", ["kernel", "ref"])
    def test_device_step_matches_block_update(self, mode):
        """One fused device dispatch == the host-path block_update slice,
        bitwise, for every whole-rows block of a 2-worker split (mirrors
        the reference's device-plane test)."""
        jj, tj = _jac_pair(grid=24, sweeps=4)
        x = RNG.standard_normal(jj.n)
        for blk in tj.default_blocks(2):
            plan = tj.device_block_plan(blk, mode)
            assert plan is not None
            plan.refresh(x[blk])
            vals, norm = plan.step(*[np.copy(x[s]) for s in plan.needs])
            want = jj.block_update(x, blk)
            np.testing.assert_array_equal(vals, want)
            assert norm == pytest.approx(
                float(np.sum((want - x[blk]) ** 2)), rel=1e-12)
            assert all(isinstance(s, slice) for s in plan.needs)
            assert sum(s.stop - s.start for s in plan.needs) <= 2 * tj.g

    def test_non_row_block_returns_none(self):
        _, tj = _jac_pair(grid=16)
        assert tj.device_block_plan(np.array([0, 2, 4]), "kernel") is None


class TestValueIterationAgrees:
    def test_maps_and_residual(self):
        jv, tv = _vi_pair()
        x = RNG.standard_normal(jv.n)
        np.testing.assert_allclose(tv.full_map(x), jv.full_map(x),
                                   rtol=1e-13, atol=1e-13)
        blk = np.arange(10, 30)
        np.testing.assert_allclose(tv.block_update(x, blk),
                                   jv.block_update(x, blk),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(tv.residual_norm(x), jv.residual_norm(x),
                                   rtol=1e-13)
        np.testing.assert_allclose(tv.mdp.q_values(x), jv.mdp.q_values(x),
                                   rtol=1e-13, atol=1e-13)

    def test_exact_solution_and_structure(self):
        jv, tv = _vi_pair(S=40)
        np.testing.assert_allclose(tv.exact_solution(), jv.exact_solution(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(tv.dependency_counts(),
                                      jv.dependency_counts())
        np.testing.assert_array_equal(tv.dependency_indices(7),
                                      jv.dependency_indices(7))

    def test_policy_evaluation(self):
        jmdp = jp.GarnetMDP(S=30, A=3, b=4, gamma=0.9, seed=2)
        tmdp = tp.GarnetMDP(S=30, A=3, b=4, gamma=0.9, seed=2, device="cpu")
        jpe = jp.PolicyEvaluationProblem(jmdp)
        tpe = tp.PolicyEvaluationProblem(tmdp)
        np.testing.assert_array_equal(tpe.policy.numpy(),
                                      np.asarray(jpe.policy))
        x = RNG.standard_normal(30)
        np.testing.assert_allclose(tpe.full_map(x), jpe.full_map(x),
                                   rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(tpe.exact_solution(), jpe.exact_solution(),
                                   rtol=1e-12, atol=1e-12)
        assert tpe.device_block_plan(np.arange(5), "kernel") is None

    def test_gridworld_value_iteration_converges_to_optimum(self):
        prob = tp.ValueIterationProblem(tp.GridWorldMDP(g=6, device="cpu"))
        np.testing.assert_allclose(prob.exact_solution(),
                                   prob.mdp.optimal_values(), atol=1e-10)

    @pytest.mark.parametrize("mode", ["kernel", "ref"])
    @pytest.mark.parametrize("S,p", [(60, 4), (400, 40)])
    def test_device_step_matches_block_update(self, mode, S, p):
        """A closure-remapped device step gives the host block update;
        S=60 ships all of x (closure > n/2), S=400 ships the closure."""
        jv, tv = _vi_pair(S=S)
        x = RNG.standard_normal(S)
        for blk in tv.default_blocks(p):
            plan = tv.device_block_plan(blk, mode)
            plan.refresh(x[blk])
            vals, norm = plan.step(*[np.copy(x[s]) for s in plan.needs])
            want = jv.block_update(x, blk)
            np.testing.assert_allclose(vals, want, rtol=1e-13, atol=1e-13)
            np.testing.assert_allclose(norm, np.max(np.abs(want - x[blk])),
                                       rtol=1e-13)
        assert isinstance(plan.needs[0], slice) == (S == 60)


class TestConvert:
    def test_jacobi_round_trip(self):
        jj = jp.JacobiProblem(grid=12, sweeps=3, seed=9)
        tj = convert.jacobi_from_arrays(jj._b, 12, 3, device="cpu")
        np.testing.assert_array_equal(tj._b, jj._b)
        x = RNG.standard_normal(jj.n)
        blk = jj.default_blocks(3)[1]
        np.testing.assert_array_equal(tj.block_update(x, blk),
                                      jj.block_update(x, blk))
        with pytest.raises(ValueError):
            convert.jacobi_from_arrays(jj._b[:-1], 12, 3, device="cpu")

    def test_garnet_round_trip(self):
        jm = jp.GarnetMDP(S=50, A=3, b=4, gamma=0.93, seed=4)
        tm = convert.garnet_from_arrays(np.asarray(jm.idx),
                                        np.asarray(jm.probs),
                                        np.asarray(jm.R), jm.gamma,
                                        device="cpu")
        for a, b in ((tm.idx, jm.idx), (tm.probs, jm.probs), (tm.R, jm.R)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert (tm.S, tm.A, tm.b, tm.gamma) == (50, 3, 4, 0.93)
        v = RNG.standard_normal(50)
        np.testing.assert_allclose(tm.bellman(v), jm.bellman(v), rtol=1e-13,
                                   atol=1e-13)

    @pytest.mark.parametrize("gram", ["exact", "incremental"])
    def test_anderson_round_trip(self, gram):
        r = np.random.default_rng(6)
        n = 40
        jst = JAndersonState(JAndersonConfig(m=3, gram=gram))
        for _ in range(6):
            x = r.standard_normal(n)
            jst.push(x, x + 0.1 * r.standard_normal(n))
        jst.n_fire, jst.n_accept = 7, 5
        snap = jst.snapshot()
        tst = convert.anderson_from_snapshot(snap, AndersonConfig(m=3,
                                                                   gram=gram),
                                             device="cpu")
        back = tst.snapshot()
        for k in ("X", "G", "F"):
            np.testing.assert_array_equal(back[k], snap[k])
        assert (back["n_fire"], back["n_accept"]) == (7, 5)
        np.testing.assert_allclose(tst.propose(), jst.propose(), rtol=1e-12,
                                   atol=1e-12)


class TestAndersonState:
    """The port's device-window Anderson against the numpy reference."""

    @pytest.mark.parametrize("beta", [0.0, 0.6, 1.0])
    @pytest.mark.parametrize("gram", ["exact", "incremental"])
    def test_window_and_proposals_match(self, beta, gram):
        r = np.random.default_rng(7)
        n = 50
        jst = JAndersonState(JAndersonConfig(m=3, beta=beta, gram=gram))
        tst = AndersonState(AndersonConfig(m=3, beta=beta, gram=gram),
                            device="cpu")
        for _ in range(9):  # wraps the 2(m+1) ring buffer
            x = r.standard_normal(n)
            g = x + 0.1 * r.standard_normal(n)
            jst.push(x, g)
            tst.push(x, g)
            for a, b in zip(tst.fs, jst.fs):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(tst.propose(), jst.propose(),
                                       rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tst.last_alpha, jst.last_alpha,
                                   rtol=1e-10, atol=1e-12)

    def test_mix_wrapper_path_matches(self):
        """A forced ``mix_kernel_n`` routes the combine through the
        ``anderson_mix`` wrapper (its plain version on the CPU)."""
        r = np.random.default_rng(8)
        n = 300
        kern = AndersonState(AndersonConfig(m=3, beta=0.6, mix_kernel_n=n),
                             device="cpu")
        ref_st = JAndersonState(JAndersonConfig(m=3, beta=0.6))
        for _ in range(5):
            x, g = r.standard_normal(n), r.standard_normal(n)
            kern.push(x, g)
            ref_st.push(x, g)
        np.testing.assert_allclose(kern.propose(), ref_st.propose(),
                                   rtol=1e-10, atol=1e-10)
