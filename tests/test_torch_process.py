"""The port's process backend on the CPU (``device="cpu"`` payloads).

* Every problem crosses the process boundary by its ``factory_spec``
  recipe (the device as a string) and the rebuilt problem's ``full_map``
  is bit-equal; problems without a recipe are pickled, and a problem that
  neither has a recipe nor pickles is refused with an error naming
  ``factory_spec``.
* Runs: the sync loop converges, one async worker equals one thread worker
  byte for byte (the relation the reference's own process and thread runs
  show at that config, checked here too), the offloaded eval service
  works, a worker's error ends the run and retires its pool, a payload
  that names the default device (the card) raises instead of falling back
  to the CPU, pools are reused with zero spawns and keyed on
  ``n_workers``, and CPU runs count no kernel launches.

Pools stay small (one or two workers) and are shut down in ``finally``;
each spawn costs a torch import.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    FaultProfile,
    FixedPointProblem,
    RunConfig,
    pool_stats,
    process_pools,
    run_fixed_point,
    shutdown_pools,
)
from repro_torch.core.engine import payload_key  # noqa: E402
from repro_torch.core.engine.coordinator import (  # noqa: E402
    problem_payload,
    rebuild_problem,
)
from repro_torch.core.engine.device_plane import (  # noqa: E402
    resolve_device_plane,
)
from repro_torch.kernels import ops  # noqa: E402


def _problems():
    mdp = tp.GarnetMDP(S=40, A=3, b=4, gamma=0.9, seed=2, device="cpu")
    return {
        "jacobi": tp.JacobiProblem(grid=12, sweeps=3, seed=4, device="cpu"),
        "jacobi_pallas_order": tp.JacobiProblem(grid=12, sweeps=2, seed=1,
                                                backend="pallas",
                                                device="cpu"),
        "vi_exact": tp.ValueIterationProblem(mdp),
        "vi_fast": tp.ValueIterationProblem(tp.GarnetMDP(
            S=50, A=4, b=5, seed=3, sample="fast", device="cpu")),
        "gridworld": tp.ValueIterationProblem(tp.GridWorldMDP(
            g=5, gamma=0.9, device="cpu")),
        "policy_eval": tp.PolicyEvaluationProblem(mdp),
        "scf": tp.SCFProblem(tp.PPPChain(8, 2.0, device="cpu")),
        "scf_guess": tp.SCFProblem(
            tp.PPPChain(6, 3.0, device="cpu"),
            guess=np.eye(6) + 0.01 * np.ones((6, 6))),
        "uhf": tp.UHFSCFProblem(tp.PPPChain(6, 3.0, device="cpu"),
                                spin_seed=0.2),
    }


def _plain(obj) -> bool:
    """True for plain Python and numpy values (classes by reference)."""
    if isinstance(obj, dict):
        return all(_plain(k) and _plain(v) for k, v in obj.items())
    if isinstance(obj, (tuple, list)):
        return all(_plain(v) for v in obj)
    return isinstance(obj, (type(None), bool, int, float, str, type,
                            np.ndarray))


class TestPayloads:
    @pytest.mark.parametrize("name", sorted(_problems()))
    def test_factory_round_trip_is_bit_equal(self, name):
        prob = _problems()[name]
        payload = problem_payload(prob)
        assert payload[0] == "factory"
        factory, args, kwargs = payload[1]
        assert _plain((args, kwargs))  # no tensors, no torch.device
        assert "'cpu'" in repr((args, kwargs))  # the device, as a string
        # The pool key is stable from run to run.
        cfg = RunConfig(n_workers=2)
        assert payload_key(payload, cfg) == payload_key(
            problem_payload(_problems()[name]), cfg)
        twin = rebuild_problem(pickle.loads(pickle.dumps(payload)))
        assert type(twin) is type(prob) and twin.device == prob.device
        x = prob.initial() + 0.1 * np.random.default_rng(0).standard_normal(
            prob.n)
        assert twin.full_map(x).tobytes() == prob.full_map(x).tobytes()
        assert twin.initial().tobytes() == prob.initial().tobytes()

    def test_problem_without_recipe_is_pickled(self):
        src = tp.GarnetMDP(S=30, A=2, b=3, seed=5, device="cpu")
        prob = tp.ValueIterationProblem(tp.GarnetMDP.from_arrays(
            src.idx.numpy(), src.probs.numpy(), src.R.numpy(), 0.9,
            device="cpu"))
        assert prob.factory_spec() is None
        kind, data = problem_payload(prob)
        assert kind == "pickle" and data is prob
        twin = rebuild_problem(pickle.loads(pickle.dumps((kind, data))))
        x = np.random.default_rng(1).standard_normal(prob.n)
        assert twin.full_map(x).tobytes() == prob.full_map(x).tobytes()

    def test_unpicklable_problem_names_factory_spec(self):
        prob = Toy(4)
        prob.hook = lambda v: v  # lambdas do not pickle
        with pytest.raises(ValueError, match="factory_spec"):
            problem_payload(prob)

    def test_resolver_takes_the_process_backend(self):
        p = tp.JacobiProblem(grid=16, sweeps=2, device="cpu")
        cfg = RunConfig(mode="async", n_workers=2, device_plane="on")
        assert resolve_device_plane(p, cfg, "process") == "kernel"
        guarded = RunConfig(mode="async", n_workers=2, device_plane="on",
                            sdc_guard=True)
        assert resolve_device_plane(p, guarded, "process") is None


class Toy(FixedPointProblem):
    """A numpy contraction with no recipe (pickled across processes)."""

    def __init__(self, n: int):
        self.n = n

    def initial(self):
        return np.zeros(self.n)

    def full_map(self, x):
        return 0.5 * x + 1.0

    def block_update(self, x, indices):
        return self.full_map(x)[indices]


class Flaky(tp.JacobiProblem):
    """Fails on its third block update (after the worker's warm-up)."""

    def block_update(self, x, indices):
        self._calls = getattr(self, "_calls", 0) + 1
        if self._calls >= 3:
            raise RuntimeError("kernel launch failed")
        return super().block_update(x, indices)

    def factory_spec(self):
        return (Flaky, (), dict(grid=self.g, sweeps=self.sweeps,
                                device=str(self.device)))


class DefaultDevice(tp.JacobiProblem):
    """A CPU problem whose recipe names the default device (the card)."""

    def factory_spec(self):
        return (tp.JacobiProblem, (), dict(grid=self.g, sweeps=self.sweeps))


def _cfg(**kw):
    base = dict(mode="async", executor="process", n_workers=1, tol=1e-14,
                max_updates=30, seed=1)
    base.update(kw)
    return RunConfig(**base)


class TestRuns:
    def test_sync_run_converges(self):
        prob = tp.SCFProblem(tp.PPPChain(8, 2.0, device="cpu"))
        try:
            r = run_fixed_point(prob, _cfg(
                mode="sync", n_workers=2, tol=1e-10, max_updates=5000,
                accel=AndersonConfig(m=8)))
        finally:
            shutdown_pools()
        assert r.converged and r.rounds < 60  # as the virtual run
        assert prob.residual_norm(r.x) < 1e-10

    def test_reference_one_process_worker_equals_one_thread_worker(self):
        """The relation the port is held to below, on the reference."""
        from repro.core import AndersonConfig as JAnderson
        from repro.core import RunConfig as JRunConfig
        from repro.core import run_fixed_point as j_run
        from repro.core import shutdown_pools as j_shutdown
        from repro.problems import JacobiProblem as JJacobi

        kw = dict(mode="async", n_workers=1, device_plane="on", tol=1e-14,
                  max_updates=30, seed=1, accel=JAnderson(m=3), fire_every=4)
        prob = JJacobi(grid=16, sweeps=3, seed=0)
        try:
            rt = j_run(prob, JRunConfig(executor="thread", **kw))
            rp = j_run(prob, JRunConfig(executor="process", **kw))
        finally:
            j_shutdown()
        assert rp.device_dispatches == rt.device_dispatches == 30
        assert rp.x.tobytes() == rt.x.tobytes()

    @pytest.mark.parametrize("plane", ["on", "off"])
    def test_one_process_worker_equals_one_thread_worker(self, plane):
        prob = tp.JacobiProblem(grid=16, sweeps=3, seed=0, device="cpu")
        kw = dict(device_plane=plane, accel=AndersonConfig(m=3),
                  fire_every=4)
        try:
            rt = run_fixed_point(prob, _cfg(executor="thread", **kw))
            rp = run_fixed_point(prob, _cfg(**kw))
        finally:
            shutdown_pools()
        assert (rp.worker_updates, rp.accel_fires, rp.accel_accepts) == (
            rt.worker_updates, rt.accel_fires, rt.accel_accepts)
        assert rp.device_dispatches == rt.device_dispatches == (
            30 if plane == "on" else 0)
        assert rp.x.tobytes() == rt.x.tobytes()

    def test_offloaded_eval_service(self):
        prob = tp.SCFProblem(tp.PPPChain(8, 2.0, device="cpu"))
        try:
            r = run_fixed_point(prob, _cfg(
                n_workers=2, tol=1e-9, max_updates=2000,
                accel=AndersonConfig(m=5), fire_every=4,
                accel_eval="worker",
                faults={1: FaultProfile(eval_crash_prob=0.3)}))
        finally:
            shutdown_pools()
        assert r.converged
        assert r.offloaded_evals > 0 and r.accel_fires > 0
        assert r.device_dispatches == 0  # the eval service keeps the host loop
        assert prob.residual_norm(r.x) < 1e-9

    def test_worker_error_propagates_and_retires_the_pool(self):
        prob = Flaky(grid=8, sweeps=1, device="cpu")
        try:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                run_fixed_point(prob, _cfg(n_workers=2, device_plane="off",
                                           max_updates=50))
            assert pool_stats() == {}  # retired, not kept for reuse
        finally:
            shutdown_pools()

    def test_default_device_payload_raises_without_cuda(self):
        """No fallback: a recipe that names the card is rebuilt on the card
        or the run raises; it is never rebuilt on the CPU."""
        prob = DefaultDevice(grid=8, sweeps=1, device="cpu")
        try:
            with pytest.raises(RuntimeError, match="CUDA device"):
                run_fixed_point(prob, _cfg())
            assert pool_stats() == {}
        finally:
            shutdown_pools()

    def test_cpu_runs_count_no_launches(self):
        prob = tp.JacobiProblem(grid=16, sweeps=3, seed=0, device="cpu")
        ops.reset_launch_counts()
        try:
            r = run_fixed_point(prob, _cfg(n_workers=2, device_plane="on",
                                           accel=AndersonConfig(m=3)))
        finally:
            shutdown_pools()
        assert r.device_dispatches > 0
        assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


class TestPoolReuse:
    """Mirrors the reference's ``TestPoolReuse``."""

    def test_second_run_reuses_workers(self):
        shutdown_pools()
        prob = tp.JacobiProblem(grid=8, sweeps=3, seed=123, device="cpu")
        cfg = _cfg(n_workers=2, tol=1e-10, max_updates=40)
        try:
            r1 = run_fixed_point(prob, cfg)
            stats = pool_stats()
            assert len(stats) == 1
            (key, info), = stats.items()
            pids = list(info["pids"])
            assert info["runs_served"] == 1 and info["healthy"]
            assert info["boot_s"] > 0.0
            r2 = run_fixed_point(prob, cfg)
            stats = pool_stats()
            assert set(stats) == {key}          # no second pool
            assert stats[key]["pids"] == pids   # zero new interpreters
            assert stats[key]["runs_served"] == 2
            assert vars(r1).keys() == vars(r2).keys()
            assert r1.worker_updates == r2.worker_updates == 40
            for r in (r1, r2):
                assert r.rounds == r.worker_updates
                assert len(r.history) >= 1
        finally:
            shutdown_pools()
        assert pool_stats() == {}

    def test_distinct_config_keys_get_distinct_pools(self):
        prob = tp.JacobiProblem(grid=8, sweeps=3, seed=123, device="cpu")
        with process_pools():
            for p in (1, 2):
                run_fixed_point(prob, _cfg(n_workers=p, tol=1e-10,
                                           max_updates=10))
            assert len(pool_stats()) == 2  # keyed on n_workers
        assert pool_stats() == {}
