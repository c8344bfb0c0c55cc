"""The port's engine end to end against the JAX package's.

Six of the golden trajectories of ``tests/test_hotpath_goldens.py`` run
through both packages on the virtual executor, with ``device="cpu"``
problems on the port's side:

* ``jacobi_async_plain`` is held to the bytes: identical worker updates,
  virtual wall time and sha256 of the iterate (the block updates are adds
  and an exact division in the same order on both sides).
* ``jacobi_async_accel`` is held to the bytes too (tolerance 0.0), with
  identical update, fire and accept counts.  Async Jacobi with Anderson
  is the paper's iterate-level-corruption case and amplifies any
  last-ulp difference, so the port computes the reference's float
  operations in the reference's order: the full map in ``_full_sweep``'s
  add order (``backend="jnp"``, the default of both problems), and on
  the CPU the Anderson Gram and combine as numpy products of the window's
  zero-copy views (``TestCpuGram``, ``TestCpuCombine``).
* The other accelerated runs and the value-iteration runs are held to
  identical update, fire and accept counts, with iterates within 1e-12
  relative: the VI expectation is reduced in another order by torch and
  XLA, so those bytes may differ in the last place.

Also here: the thread executor with the device plane against the JAX
thread run, the device-plane resolver matrix, and the guard that refuses
the knobs of layers the port does not carry yet.
"""

import hashlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.problems as jp  # noqa: E402  (enables jax x64)
from repro.core import AndersonConfig as JAnderson  # noqa: E402
from repro.core import FaultProfile as JFault  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402

import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    FaultProfile,
    RunConfig,
    run_fixed_point,
)
from repro_torch.core.engine.device_plane import (  # noqa: E402
    AUTO_THRESHOLD,
    resolve_device_plane,
)
from repro_torch.core.engine.threadpool import ThreadPoolExecutor  # noqa: E402
from repro_torch.core.engine.virtual_time import VirtualTimeExecutor  # noqa: E402


def _sha(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _jac(pkg, **kw):
    return pkg.JacobiProblem(grid=16, sweeps=5, seed=0, **kw)


def _vi(pkg, **kw):
    return pkg.ValueIterationProblem(
        pkg.GarnetMDP(S=60, A=4, b=5, gamma=0.9, seed=0, **kw))


_FAULT = dict(delay_mean=0.002, delay_std=0.001)
_VIRT = dict(compute_time=1e-3)

# name -> (problem factory, config, accel kwargs or None, iterate rtol)
GOLDEN = {
    "jacobi_async_plain": (
        _jac, dict(mode="async", tol=1e-10, max_updates=600, seed=7),
        None, None),
    "jacobi_async_accel": (
        _jac, dict(mode="async", tol=1e-10, max_updates=600, seed=7,
                   fire_every=4), {}, 0.0),
    "jacobi_sync_accel": (
        _jac, dict(mode="sync", tol=1e-10, max_updates=400, seed=7,
                   fire_every=1), {}, 1e-12),
    "vi_async_plain": (
        _vi, dict(mode="async", tol=1e-12, max_updates=800, seed=11),
        None, 1e-12),
    "vi_async_accel": (
        _vi, dict(mode="async", tol=1e-12, max_updates=800, seed=11,
                  fire_every=4), {}, 1e-12),
    "vi_async_accel_beta05": (
        _vi, dict(mode="async", tol=1e-12, max_updates=800, seed=11,
                  fire_every=4), dict(beta=0.5), 1e-12),
}

#: committed golden of ``jacobi_async_plain`` (tests/test_hotpath_goldens.py)
_JACOBI_PLAIN = (600, 0.4318607003352541,
                 "af8fd221f9b65b94b6d21a5e5dcc7dbef42cf475a86dd05ad8e08d5b43b1bfc9")


def _pair(factory, cfg, accel, **extra):
    """(JAX result, port result) of one config on both packages."""
    jkw = dict(cfg, faults=JFault(**_FAULT), **_VIRT, **extra)
    tkw = dict(cfg, faults=FaultProfile(**_FAULT), **_VIRT, **extra)
    if accel is not None:
        jkw["accel"] = JAnderson(m=5, **accel)
        tkw["accel"] = AndersonConfig(m=5, **accel)
    return (j_run(factory(jp), JRunConfig(**jkw)),
            run_fixed_point(factory(tp, device="cpu"), RunConfig(**tkw)))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class TestGoldenParity:
    @pytest.mark.parametrize("name", sorted(GOLDEN))
    def test_matches_live_jax_run(self, name):
        factory, cfg, accel, rtol = GOLDEN[name]
        jr, tr = _pair(factory, cfg, accel)
        assert tr.worker_updates == jr.worker_updates
        assert tr.wall_time == jr.wall_time
        assert (tr.accel_fires, tr.accel_accepts, tr.accel_rejects) == (
            jr.accel_fires, jr.accel_accepts, jr.accel_rejects)
        if rtol is None:
            assert _sha(tr.x) == _sha(jr.x)
            assert (tr.worker_updates, tr.wall_time, _sha(tr.x)) == \
                _JACOBI_PLAIN
        else:
            assert _rel(tr.x, jr.x) <= rtol

    def test_offloaded_eval_model_matches(self):
        """accel_eval="worker" on the virtual backend (the eval-cost event
        loop) takes the same decisions in both packages."""
        jr, tr = _pair(_vi, GOLDEN["vi_async_accel"][1], {},
                       accel_eval="worker")
        assert (tr.worker_updates, tr.wall_time, tr.accel_fires,
                tr.accel_accepts, tr.offloaded_evals, tr.accel_discards) == (
            jr.worker_updates, jr.wall_time, jr.accel_fires,
            jr.accel_accepts, jr.offloaded_evals, jr.accel_discards)
        assert _rel(tr.x, jr.x) <= 1e-12

    def test_faults_and_sdc_guard_match(self):
        """Drops, crashes with restarts and SDC screening consume the
        coordinator rng identically in both packages."""
        prof = dict(drop_prob=0.1, crash_prob=0.05, restart_after=0.01,
                    corrupt_prob=0.05, corrupt_mode="scale")
        kw = dict(mode="async", tol=1e-10, max_updates=300, seed=3,
                  sdc_guard=True, compute_time=1e-3)
        jr = j_run(_jac(jp), JRunConfig(faults=JFault(**prof), **kw))
        tr = run_fixed_point(_jac(tp, device="cpu"),
                             RunConfig(faults=FaultProfile(**prof), **kw))
        assert (tr.worker_updates, tr.wall_time, tr.drops, tr.crashes,
                tr.restarts, tr.sdc_rejects, tr.quarantined) == (
            jr.worker_updates, jr.wall_time, jr.drops, jr.crashes,
            jr.restarts, jr.sdc_rejects, jr.quarantined)
        assert tr.sdc_rejects > 0 and tr.crashes > 0
        np.testing.assert_array_equal(tr.x, jr.x)


class TestCpuGram:
    """On the CPU the Anderson Gram is numpy's ``F @ F.T`` (and its
    incremental rows numpy GEMVs) on the window's zero-copy views: the
    reference's float operations, bit for bit."""

    @pytest.mark.parametrize("gram", ["exact", "incremental"])
    def test_gram_equals_reference_bytes(self, gram):
        from repro.core.anderson import AndersonState as JState
        from repro_torch.core.anderson import AndersonState, _gram

        r = np.random.default_rng(3)
        jst = JState(JAnderson(m=3, gram=gram))
        tst = AndersonState(AndersonConfig(m=3, gram=gram), device="cpu")
        for _ in range(6):  # wraps and compacts the window once
            x, g = r.standard_normal(1001), r.standard_normal(1001)
            jst.push(x, g)
            tst.push(x, g)
        if gram == "incremental":
            want, got = jst._B, tst._B
        else:
            F = jst._window(jst._F)
            want, got = F @ F.T, _gram(tst._window(tst._F))
        assert got.shape == want.shape == (4, 4)
        assert got.tobytes() == want.tobytes()


class TestCpuCombine:
    """On the CPU the Anderson combine is numpy's ``alpha @ G`` (``@ X``,
    ``@`` the damped scratch rows) on the window's views: the reference's
    ``_combine``, bit for bit."""

    @pytest.mark.parametrize("beta", [1.0, 0.0, 0.5])
    def test_combine_equals_numpy_bytes(self, beta):
        from repro.core.anderson import AndersonState as JState
        from repro_torch.core.anderson import AndersonState

        r = np.random.default_rng(5)
        jst = JState(JAnderson(m=4, beta=beta))
        tst = AndersonState(AndersonConfig(m=4, beta=beta), device="cpu")
        for _ in range(7):  # wraps and compacts the window once
            x, g = r.standard_normal(2003), r.standard_normal(2003)
            jst.push(x, g)
            tst.push(x, g)
        alpha = r.standard_normal(tst.depth)
        alpha /= alpha.sum()
        X, G = tst._window(tst._X), tst._window(tst._G)
        got = tst._combine(X, G, alpha, beta).numpy()
        want = jst._combine(jst._window(jst._X), jst._window(jst._G), alpha,
                            beta)
        assert got.tobytes() == want.tobytes()
        if beta == 1.0:
            assert got.tobytes() == (alpha @ G.numpy()).tobytes()
        np.testing.assert_array_equal(tst.propose(), jst.propose())


class TestThreadExecutor:
    def test_single_worker_device_plane_matches_jax(self):
        """One thread worker, device plane on, Anderson: both packages
        converge to the same fixed point (the solution to 1e-8)."""
        cfg = dict(mode="async", executor="thread", n_workers=1,
                   device_plane="on", tol=1e-9, max_updates=2000,
                   fire_every=4, seed=1)
        jr = j_run(_jac(jp), JRunConfig(accel=JAnderson(m=5), **cfg))
        prob = _jac(tp, device="cpu")
        tr = run_fixed_point(prob, RunConfig(accel=AndersonConfig(m=5), **cfg))
        assert jr.converged and tr.converged
        assert tr.device_dispatches == tr.worker_updates
        assert tr.accel_fires > 0
        sol = prob.exact_solution()
        assert _rel(tr.x, sol) <= 1e-8 and _rel(jr.x, sol) <= 1e-8
        assert _rel(tr.x, jr.x) <= 1e-8

    @pytest.mark.parametrize("mode", ["on", "ref"])
    def test_device_plane_runs(self, mode):
        p = tp.JacobiProblem(grid=32, sweeps=3, device="cpu")
        cfg = RunConfig(mode="async", executor="thread", n_workers=2,
                        device_plane=mode, max_updates=120, seed=1)
        res = ThreadPoolExecutor().run(p, cfg)
        assert res.device_dispatches >= 120
        assert res.device_refreshes >= cfg.n_workers
        assert res.device_refreshes < res.device_dispatches
        assert p.residual_norm(res.x) < 0.5 * p.residual_norm(p.initial())

    def test_accel_commits_force_refreshes(self):
        p = tp.ValueIterationProblem(tp.GarnetMDP(S=200, A=4, b=5,
                                                  device="cpu"))
        cfg = RunConfig(mode="async", executor="thread", n_workers=2,
                        device_plane="on", max_updates=100, seed=2,
                        accel=AndersonConfig(m=3), fire_every=10)
        res = ThreadPoolExecutor().run(p, cfg)
        assert res.device_dispatches > 0 and res.accel_fires > 0
        assert res.device_refreshes >= res.accel_accepts
        assert p.residual_norm(res.x) < 0.5 * p.residual_norm(p.initial())

    def test_sync_and_offload_loops(self):
        p = tp.JacobiProblem(grid=16, sweeps=3, device="cpu")
        r0 = p.residual_norm(p.initial())
        for cfg in (
            RunConfig(mode="sync", executor="thread", n_workers=2,
                      max_updates=60, accel=AndersonConfig(m=3)),
            RunConfig(mode="async", executor="thread", n_workers=2,
                      max_updates=60, accel=AndersonConfig(m=3),
                      fire_every=5, accel_eval="worker"),
        ):
            res = run_fixed_point(p, cfg)
            assert res.device_dispatches == 0
            assert p.residual_norm(res.x) < 0.5 * r0

    def test_worker_errors_propagate(self):
        """An error inside a worker thread (a failed kernel launch) ends
        the run and re-raises on the caller: no result is returned."""
        class Flaky(tp.JacobiProblem):
            def __init__(self, **kw):
                super().__init__(**kw)
                self._calls = itertools.count()

            def block_update(self, x, indices):
                if next(self._calls) >= 4:  # after the warm-up calls
                    raise RuntimeError("kernel launch failed")
                return super().block_update(x, indices)

        cfg = RunConfig(mode="async", executor="thread", n_workers=2,
                        max_updates=50, device_plane="off")
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            run_fixed_point(Flaky(grid=8, sweeps=1, device="cpu"), cfg)

    def test_virtual_runs_ignore_device_plane(self):
        p = tp.JacobiProblem(grid=20, sweeps=3, device="cpu")
        runs = {}
        for mode in ("off", "auto", "on"):
            runs[mode] = VirtualTimeExecutor().run(p, RunConfig(
                device_plane=mode, n_workers=2, max_updates=60, seed=3))
            assert runs[mode].device_dispatches == 0
        np.testing.assert_array_equal(runs["off"].x, runs["on"].x)
        np.testing.assert_array_equal(runs["off"].x, runs["auto"].x)


def _cfg(**kw):
    kw.setdefault("mode", "async")
    kw.setdefault("n_workers", 2)
    kw.setdefault("max_updates", 40)
    return RunConfig(**kw)


class TestResolver:
    """The port's resolver matrix (mirrors the reference's TestResolver)."""

    def setup_method(self):
        self.p = tp.JacobiProblem(grid=16, sweeps=2, device="cpu")

    def test_explicit_modes_resolve(self):
        assert resolve_device_plane(self.p, _cfg(device_plane="on"),
                                    "thread") == "kernel"
        assert resolve_device_plane(self.p, _cfg(device_plane="ref"),
                                    "thread") == "ref"

    @pytest.mark.parametrize("mode", ["gpu", "jnp", "pallas", "interpret"])
    def test_off_and_unknown(self, mode):
        assert resolve_device_plane(self.p, _cfg(device_plane="off"),
                                    "thread") is None
        with pytest.raises(ValueError):
            resolve_device_plane(self.p, _cfg(device_plane=mode), "thread")

    def test_never_on_virtual_backend(self):
        for mode in ("on", "auto", "ref"):
            assert resolve_device_plane(self.p, _cfg(device_plane=mode),
                                        "virtual") is None

    @pytest.mark.parametrize("kw", [
        dict(mode="sync"),
        dict(selection="uniform", selection_k=8),
        dict(return_mode="full_map"),
        dict(accel_eval="worker"),
        dict(sdc_guard=True),  # quarantines move blocks between workers
    ])
    def test_exclusions(self, kw):
        cfg = _cfg(device_plane="on", **kw)
        assert resolve_device_plane(self.p, cfg, "thread") is None

    def test_auto_threshold(self):
        cfg = _cfg(device_plane="auto")
        assert resolve_device_plane(self.p, cfg, "thread") is None

        class Big:
            n = AUTO_THRESHOLD

            def is_projection_trivial(self):
                return True

        assert resolve_device_plane(Big(), cfg, "thread") == "kernel"

    def test_nontrivial_projection_excluded(self):
        class Proj:
            n = AUTO_THRESHOLD

            def is_projection_trivial(self):
                return False

        assert resolve_device_plane(Proj(), _cfg(device_plane="on"),
                                    "thread") is None


class TestUnportedKnobs:
    @pytest.mark.parametrize("kw,item", [
        (dict(scenario=object()), "item 4"),
        (dict(controller=object()), "item 4"),
        (dict(telemetry=True), "item 4"),
        (dict(capture_trace=True), "item 4"),
        (dict(checkpoint_every=10), "item 4"),
        (dict(checkpoint_dir="ckpt"), "item 4"),
        (dict(resume_from="ckpt"), "item 4"),
        (dict(executor="process"), "item 2"),
        (dict(executor="ray"), "item 5"),
    ])
    def test_raises_naming_the_roadmap_item(self, kw, item):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, "
                                                      f"{item}"):
            RunConfig(**kw)

    def test_defaults_pass(self):
        RunConfig()
        RunConfig(executor="thread", sdc_guard=True, accel_eval="worker")
