"""The port's Ray backend against the JAX package's, under a stand-in for ray.

``ray`` is not installed where these tests run, so both packages'
``RayExecutor`` run under ``tests/torch_ray_standin.py``, which
keeps Ray's semantics for the seven calls they make (pickled arguments,
read-only arrays out of the store, top-level refs resolved, completion
order, timeouts, errors, kills, ``CUDA_VISIBLE_DEVICES`` per actor).

Isolation: the stand-in never enters this process's ``sys.modules`` (the
JAX package's tests read ``ray`` as absent, whichever xdist worker runs
them).  Every run under it goes through a child interpreter that installs
it as ``ray`` before it imports either package; the children start
together, once per module, and return plain dicts.  Actors run as threads
of the child (the stand-in's thread mode: same pickling and read-only
arrays) except in the ``process`` child, whose actors are processes of
their own.

* Absence, in this process: ``"ray"`` is known but unavailable, with the
  reference's reason and error, and the pool helpers are no-ops.
* The stand-in itself, in both modes.
* Parity (Jacobi grid 16): a sync run with Anderson, a straggler and a
  planned crash equals the port's thread run and the JAX package's Ray
  run byte for byte; one async actor equals one thread worker
  (``device_plane="off"``) and the reference's one-actor run byte for
  byte, with threads and with an actor process.  Value iteration (Garnet
  S = 60) and SCF (PPP chain of 8) sync runs match the reference's Ray
  runs to 1e-12 and 1e-10 relative with equal update, fire and accept
  counts.
* Traces: a Ray capture (with and without ``spot_wave``) replays bit for
  bit on the port's virtual backend.  The offloaded eval service
  converges under eval crashes.
* Pools and errors: a warm run creates no actor, pool keys follow
  ``n_workers``, an actor error ends the run and retires its pool, a
  payload on the default device (the card) raises without CUDA, and CPU
  runs count no kernel launches.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    RunConfig,
    available_executors,
    get_executor,
    known_executors,
    ray_pool_stats,
    ray_pools,
    shutdown_ray_pools,
)

ROOT = Path(__file__).resolve().parents[1]
_CHILD = ("import sys, torch_ray_standin as s; "
          "sys.exit(s.child_main(*sys.argv[1:]))")


# --------------------------------------------------------------------- #
# Child interpreters
# --------------------------------------------------------------------- #
def _run_children(groups, timeout=240.0):
    """Run each group ``name -> (mode, {label: (function name, kwargs)})``
    of this module's job functions in its own child interpreter, all at
    once; ``name -> {label: (status, value)}``."""
    with tempfile.TemporaryDirectory(prefix="torch_ray_") as tmp:
        return _run_in(Path(tmp), groups, timeout)


def _run_in(tmp, groups, timeout):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "tests"), str(ROOT / "src"),
         os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name, (mode, jobs) in groups.items():
        jobs_path, out = tmp / f"{name}.jobs", tmp / f"{name}.out"
        jobs_path.write_bytes(pickle.dumps(
            [(f"{__name__}:{fn}", kw) for fn, kw in jobs.values()]))
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(jobs_path), str(out)],
            env=dict(env, RAY_STANDIN_MODE=mode), cwd=str(tmp),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    deadline = time.monotonic() + timeout
    results = {}
    try:
        for name, (proc, out) in procs.items():
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if proc.returncode != 0:
                raise RuntimeError(f"child {name} exited {proc.returncode}:"
                                   f"\n{err[-4000:]}")
            results[name] = dict(zip(groups[name][1],
                                     pickle.loads(out.read_bytes())))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def _ok(result):
    status, value = result
    if status != "ok":
        raise AssertionError(f"job failed in the child:\n{value}")
    return value


# --------------------------------------------------------------------- #
# Jobs (run in the children, where ``import ray`` is the stand-in)
# --------------------------------------------------------------------- #
def _pkg(name):
    """``(core, problems, chaos, problem kwargs)`` of ``"port"`` or
    ``"jax"``."""
    import importlib

    mod = "repro_torch" if name == "port" else "repro"
    return (importlib.import_module(f"{mod}.core"),
            importlib.import_module(f"{mod}.problems"),
            importlib.import_module(f"{mod}.chaos"),
            dict(device="cpu") if name == "port" else {})


def _fields(r):
    """The numbers and arrays of a ``RunResult`` (no trace, no telemetry)."""
    return {k: v for k, v in vars(r).items()
            if isinstance(v, (bool, int, float, str, np.ndarray, type(None)))}


def _jacobi(pkg):
    _, probs, _, dev = _pkg(pkg)
    return probs.JacobiProblem(grid=16, sweeps=3, seed=0, **dev)


def job_jacobi_sync(pkg, executors=("ray", "thread")):
    """Jacobi sync: Anderson, worker 0 a straggler, worker 2 crashing
    (the coordinator plans sync crashes, so the runs are deterministic)."""
    core, _, _, _ = _pkg(pkg)
    kw = dict(mode="sync", n_workers=4, tol=1e-10, max_updates=400, seed=3,
              accel=core.AndersonConfig(m=3), fire_every=1,
              faults={0: core.FaultProfile(delay_mean=0.004),
                      2: core.FaultProfile(crash_prob=0.1,
                                           restart_after=0.002)})
    try:
        return {ex: _fields(core.run_fixed_point(
            _jacobi(pkg), core.RunConfig(executor=ex, **kw)))
            for ex in executors}
    finally:
        core.shutdown_ray_pools()


def job_one_actor(pkg, executors=("ray", "thread")):
    """One async worker with Anderson every 4 arrivals."""
    core, _, _, _ = _pkg(pkg)
    kw = dict(mode="async", n_workers=1, device_plane="off", tol=1e-14,
              max_updates=30, seed=1, accel=core.AndersonConfig(m=3),
              fire_every=4)
    try:
        return {ex: _fields(core.run_fixed_point(
            _jacobi(pkg), core.RunConfig(executor=ex, **kw)))
            for ex in executors}
    finally:
        core.shutdown_ray_pools()


def job_one_actor_card():
    """One CUDA actor against one thread worker on the card (Jacobi, host
    path on both), with the actor's kernel launches merged in."""
    from repro_torch.kernels import ops

    core, probs, _, _ = _pkg("port")
    prob = probs.JacobiProblem(grid=128, sweeps=5, seed=2, device="cuda:0")
    kw = dict(mode="async", n_workers=1, device_plane="off", max_updates=20,
              tol=1e-12, accel=core.AndersonConfig(m=3), fire_every=4)
    try:
        rt = core.run_fixed_point(prob, core.RunConfig(executor="thread",
                                                       **kw))
        ops.reset_launch_counts()
        rr = core.run_fixed_point(prob, core.RunConfig(executor="ray", **kw))
        launches = ops.launch_counts()
        stats = core.ray_pool_stats()
    finally:
        core.shutdown_ray_pools()
    return dict(ray=_fields(rr), thread=_fields(rt), launches=launches,
                stats=stats)


def job_vi_sync(pkg):
    core, probs, _, dev = _pkg(pkg)
    prob = probs.ValueIterationProblem(probs.GarnetMDP(
        S=60, A=4, b=5, gamma=0.9, seed=0, **dev))
    try:
        return _fields(core.run_fixed_point(prob, core.RunConfig(
            mode="sync", executor="ray", n_workers=3, tol=1e-10,
            max_updates=3000, seed=2, accel=core.AndersonConfig(m=5),
            fire_every=2)))
    finally:
        core.shutdown_ray_pools()


def job_scf_sync(pkg):
    core, probs, _, dev = _pkg(pkg)
    prob = probs.SCFProblem(probs.PPPChain(8, 2.0, **dev))
    try:
        return _fields(core.run_fixed_point(prob, core.RunConfig(
            mode="sync", executor="ray", n_workers=2, tol=1e-10,
            max_updates=5000, seed=0, accel=core.AndersonConfig(m=8))))
    finally:
        core.shutdown_ray_pools()


def job_trace_replay(scenario):
    """An async Ray capture (4 actors) replayed on the virtual backend."""
    core, probs, chaos, dev = _pkg("port")
    kw = dict(mode="async", executor="ray", n_workers=4, tol=1e-8, seed=0,
              capture_trace=True, accel=core.AndersonConfig(m=3),
              fire_every=4, faults=core.FaultProfile(delay_mean=2e-4))
    if scenario:
        kw.update(max_updates=3000, scenario=chaos.get_scenario(
            "spot_wave", 4, t0=0.02, downtime=0.05, stagger=0.005,
            slow=0.002))
    else:
        kw.update(max_updates=300)
    cfg = core.RunConfig(**kw)
    try:
        r = core.run_fixed_point(_jacobi("port"), cfg)
    finally:
        core.shutdown_ray_pools()
    rep = chaos.replay_trace(_jacobi("port"), r.trace, cfg)
    return dict(run=_fields(r), replay=_fields(rep),
                backend=r.trace.meta["backend"], counts=r.trace.counts(),
                agreement=chaos.trace_agreement(r, rep))


def job_offload():
    core, probs, _, dev = _pkg("port")
    prob = probs.SCFProblem(probs.PPPChain(8, 2.0, **dev))
    try:
        r = core.run_fixed_point(prob, core.RunConfig(
            mode="async", executor="ray", n_workers=2, tol=1e-9,
            max_updates=2000, seed=0, accel=core.AndersonConfig(m=5),
            fire_every=4, accel_eval="worker",
            faults={1: core.FaultProfile(eval_crash_prob=0.3)}))
    finally:
        core.shutdown_ray_pools()
    return dict(run=_fields(r), residual=float(prob.residual_norm(r.x)))


def job_pools():
    """Warm runs, pool keys and shutdown, counting actor creations."""
    import ray

    core, _, _, _ = _pkg("port")
    prob = _jacobi("port")
    out = {}
    before = ray.actors_created()
    try:
        cfg = core.RunConfig(mode="async", executor="ray", n_workers=2,
                             tol=1e-10, max_updates=40, seed=1)
        r1 = core.run_fixed_point(prob, cfg)
        made, stats1 = ray.actors_created(), core.ray_pool_stats()
        r2 = core.run_fixed_point(prob, cfg)
        stats2 = core.ray_pool_stats()
        out["warm_created"] = ray.actors_created() - made
        out["cold_created"] = made - before
        out["stats1"], out["stats2"] = stats1, stats2
        out["updates"] = (r1.worker_updates, r2.worker_updates)
        with core.ray_pools():
            for p in (1, 2):
                core.run_fixed_point(prob, core.RunConfig(
                    mode="async", executor="ray", n_workers=p, tol=1e-10,
                    max_updates=10, seed=1))
            out["keys"] = sorted(k[1] for k in core.ray_pool_stats())
        out["after_scope"] = core.ray_pool_stats()
    finally:
        core.shutdown_ray_pools()
    out["after_shutdown"] = core.ray_pool_stats()
    return out


def _flaky(grid, sweeps, device):
    import repro_torch.problems as tp

    class _Flaky(tp.JacobiProblem):
        def block_update(self, x, indices):
            self._calls = getattr(self, "_calls", 0) + 1
            if self._calls >= 3:
                raise RuntimeError("kernel launch failed")
            return super().block_update(x, indices)

        def factory_spec(self):
            return (_flaky, (self.g, self.sweeps, str(self.device)), {})

    return _Flaky(grid=grid, sweeps=sweeps, device=device)


def _default_device(grid, sweeps):
    """A recipe that names the default device (the card)."""
    import repro_torch.problems as tp

    return tp.JacobiProblem(grid=grid, sweeps=sweeps)


def job_errors():
    """An actor's error ends the run and retires its pool; a recipe on the
    default device raises without CUDA instead of running on the CPU; a
    CPU run counts no launches."""
    import repro_torch.problems as tp
    from repro_torch.kernels import ops

    core, _, _, _ = _pkg("port")
    out = {}
    cfg = core.RunConfig(mode="async", executor="ray", n_workers=2,
                         device_plane="off", max_updates=50, seed=1)
    try:
        core.run_fixed_point(_flaky(8, 1, "cpu"), cfg)
        out["flaky"] = None
    except Exception as e:  # noqa: BLE001 - reported to the test
        out["flaky"] = (type(e).__name__, str(e))
    out["flaky_pools"] = core.ray_pool_stats()

    prob = tp.JacobiProblem(grid=8, sweeps=1, device="cpu")
    prob.factory_spec = lambda: (_default_device, (8, 1), {})
    try:
        core.run_fixed_point(prob, cfg)
        out["default_device"] = None
    except Exception as e:  # noqa: BLE001
        out["default_device"] = (type(e).__name__, str(e))
    out["default_device_pools"] = core.ray_pool_stats()

    ops.reset_launch_counts()
    try:
        r = core.run_fixed_point(_jacobi("port"), core.RunConfig(
            mode="async", executor="ray", n_workers=2, max_updates=30,
            seed=1, accel=core.AndersonConfig(m=3)))
    finally:
        core.shutdown_ray_pools()
    out["cpu_updates"] = r.worker_updates
    out["launches"] = ops.launch_counts()
    out["kernels"] = list(ops.KERNELS)
    return out


class Probe:
    """The stand-in's test actor."""

    def __init__(self, fail=False):
        if fail:
            raise ValueError("constructor refused")
        self.calls = 0

    def echo(self, v):
        self.calls += 1
        return v

    def describe(self, v):
        """What arrived: the type and, for an array, its writeable flag."""
        return (type(v).__name__,
                getattr(getattr(v, "flags", None), "writeable", None))

    def sleep(self, s, tag):
        time.sleep(s)
        return tag

    def boom(self):
        raise ValueError("method refused")

    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def count(self):
        return self.calls


def job_standin(gpus):
    """Observations of the stand-in's semantics (``gpus``: also the
    ``CUDA_VISIBLE_DEVICES`` an actor sees, process mode only)."""
    import ray

    ray.init(num_gpus=2 if gpus else None)
    P = ray.remote(Probe)
    a, b = P.remote(), P.remote()
    out = {}
    arr = np.arange(4.0)
    ref = ray.put(arr)
    arr[:] = -1.0  # put copied it
    out["put_value"] = ray.get(ref).tolist()
    out["put_writeable"] = ray.get(ref).flags.writeable
    out["top_level"] = ray.get(a.describe.remote(ref))
    out["nested"] = ray.get(a.describe.remote([ref]))[0]
    sub = np.zeros(3)
    r_sub = a.echo.remote(sub)
    sub[:] = 7.0  # the argument was copied at submission
    got = ray.get(r_sub)
    out["arg_copied"], out["result_writeable"] = got.tolist(), \
        got.flags.writeable
    ray.get([a.count.remote(), b.count.remote()])  # both booted
    slow, fast = a.sleep.remote(0.4, "slow"), b.sleep.remote(0.05, "fast")
    ready, rest = ray.wait([slow, fast], num_returns=2)
    out["completion_order"] = ray.get(ready)
    slow = a.sleep.remote(0.5, "slow")
    ready, rest = ray.wait([slow], num_returns=1, timeout=0.01)
    out["wait_timeout"] = (len(ready), len(rest))
    try:
        ray.get(slow, timeout=0.01)
        out["get_timeout"] = None
    except TimeoutError as e:
        out["get_timeout"] = type(e).__name__
    out["in_order"] = ray.get([a.count.remote(), a.echo.remote(1),
                               a.count.remote()])
    try:
        ray.get(b.boom.remote())
        out["raised"] = None
    except ValueError as e:
        out["raised"] = (str(e), type(e.__cause__).__name__)
    out["alive_after_error"] = ray.get(b.echo.remote("still here"))
    bad = P.remote(fail=True)
    try:
        ray.get(bad.count.remote())
        out["ctor"] = None
    except ray.exceptions.RayActorError as e:
        out["ctor"] = "constructor refused" in str(e)
    pending = b.sleep.remote(2.0, "never")
    t0 = time.perf_counter()
    ray.kill(b, no_restart=True)
    for key, r in (("kill_pending", pending),
                   ("kill_later", b.echo.remote(1))):
        try:
            ray.get(r)
            out[key] = None
        except ray.exceptions.RayActorError:
            out[key] = "RayActorError"
    out["kill_s"] = time.perf_counter() - t0
    if gpus:
        half = P.options(num_gpus=0.5)
        cards = [a, half.remote(), half.remote(),
                 P.options(num_gpus=1).remote()]
        out["visible"] = ray.get([c.visible.remote() for c in cards])
    out["created"] = ray.actors_created()
    ray.shutdown()
    return out


# --------------------------------------------------------------------- #
# The children, started once for the module
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs():
    port = dict(jacobi_sync=("job_jacobi_sync", dict(pkg="port")),
                one_actor=("job_one_actor", dict(pkg="port")),
                vi_sync=("job_vi_sync", dict(pkg="port")),
                scf_sync=("job_scf_sync", dict(pkg="port")),
                trace_plain=("job_trace_replay", dict(scenario=False)),
                trace_spot_wave=("job_trace_replay", dict(scenario=True)),
                offload=("job_offload", {}),
                pools=("job_pools", {}),
                errors=("job_errors", {}),
                standin=("job_standin", dict(gpus=False)))
    jax = dict(jacobi_sync=("job_jacobi_sync",
                            dict(pkg="jax", executors=("ray",))),
               one_actor=("job_one_actor",
                          dict(pkg="jax", executors=("ray",))),
               vi_sync=("job_vi_sync", dict(pkg="jax")),
               scf_sync=("job_scf_sync", dict(pkg="jax")))
    procs = dict(standin=("job_standin", dict(gpus=True)),
                 one_actor=("job_one_actor",
                            dict(pkg="port", executors=("ray",))))
    return _run_children(dict(port=("thread", port), jax=("thread", jax),
                              process=("process", procs)))


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


_COUNTS = ("worker_updates", "accel_fires", "accel_accepts", "rounds")


# --------------------------------------------------------------------- #
# Absence, in this process
# --------------------------------------------------------------------- #
class TestAbsence:
    """Mirrors the reference's ``test_executors.py`` and
    ``test_evalservice.py`` rows for a missing ``ray``."""

    def test_no_ray_in_this_process(self):
        assert "ray" not in sys.modules
        assert "ray" not in available_executors()

    def test_known_but_unavailable(self):
        assert known_executors()["ray"].startswith("requires")
        with pytest.raises(ValueError, match="unavailable.*ray"):
            get_executor("ray")

    def test_config_passes(self):
        assert RunConfig(executor="ray").executor == "ray"

    def test_pool_helpers_are_noops(self):
        assert ray_pool_stats() == {}
        shutdown_ray_pools()
        with ray_pools():
            with ray_pools():
                pass
        assert ray_pool_stats() == {}


# --------------------------------------------------------------------- #
# The stand-in
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["thread", "process"])
def standin(request, runs):
    if request.param == "thread":
        return _ok(runs["port"]["standin"])
    return _ok(runs["process"]["standin"])


class TestStandin:
    def test_put_copies_and_reads_back_read_only(self, standin):
        assert standin["put_value"] == [0.0, 1.0, 2.0, 3.0]
        assert standin["put_writeable"] is False

    def test_top_level_ref_arrives_resolved(self, standin):
        assert standin["top_level"] == ("ndarray", False)
        assert standin["nested"] == "list"

    def test_arguments_copied_results_read_only(self, standin):
        assert standin["arg_copied"] == [0.0, 0.0, 0.0]
        assert standin["result_writeable"] is False

    def test_wait_order_and_timeouts(self, standin):
        assert standin["completion_order"] == ["fast", "slow"]
        assert standin["wait_timeout"] == (0, 1)
        assert standin["get_timeout"] == "GetTimeoutError"

    def test_calls_run_in_order(self, standin):
        assert standin["in_order"] == [1, 1, 2]

    def test_errors_surface_at_get(self, standin):
        assert standin["raised"] == ("method refused", "RayTaskError")
        assert standin["alive_after_error"] == "still here"
        assert standin["ctor"] is True

    def test_kill_fails_owed_and_later_refs(self, standin):
        assert standin["kill_pending"] == "RayActorError"
        assert standin["kill_later"] == "RayActorError"
        assert standin["kill_s"] < 2.0

    def test_cuda_visible_devices(self, runs):
        got = _ok(runs["process"]["standin"])
        # No num_gpus: no card; halves pack onto card 0; a whole card is 1.
        assert got["visible"] == ["", "0", "0", "1"]
        assert got["created"] == 6


# --------------------------------------------------------------------- #
# Parity
# --------------------------------------------------------------------- #
class TestParity:
    def test_jacobi_sync_equals_thread_and_reference(self, runs):
        port = _ok(runs["port"]["jacobi_sync"])
        ref = _ok(runs["jax"]["jacobi_sync"])["ray"]
        ray_, thr = port["ray"], port["thread"]
        assert ray_["crashes"] > 0 and ray_["accel_fires"] > 0
        for k in _COUNTS + ("crashes",):
            assert ray_[k] == thr[k] == ref[k], k
        assert ray_["x"].tobytes() == thr["x"].tobytes() == ref["x"].tobytes()

    @pytest.mark.parametrize("group", ["port", "process"])
    def test_one_actor_equals_one_thread_worker_and_reference(self, runs,
                                                               group):
        port = _ok(runs["port"]["one_actor"])
        ray_ = _ok(runs[group]["one_actor"])["ray"]
        thr = port["thread"]
        ref = _ok(runs["jax"]["one_actor"])["ray"]
        for k in _COUNTS:
            assert ray_[k] == thr[k] == ref[k], k
        assert ray_["device_dispatches"] == thr["device_dispatches"] == 0
        assert ray_["x"].tobytes() == thr["x"].tobytes() == ref["x"].tobytes()

    def test_vi_sync_matches_reference(self, runs):
        got = _ok(runs["port"]["vi_sync"])
        want = _ok(runs["jax"]["vi_sync"])
        assert got["converged"] and want["converged"]
        for k in _COUNTS:
            assert got[k] == want[k], k
        assert _rel(got["x"], want["x"]) <= 1e-12

    def test_scf_sync_matches_reference(self, runs):
        got = _ok(runs["port"]["scf_sync"])
        want = _ok(runs["jax"]["scf_sync"])
        assert got["converged"] and want["converged"]
        for k in _COUNTS:
            assert got[k] == want[k], k
        assert _rel(got["x"], want["x"]) <= 1e-10


# --------------------------------------------------------------------- #
# Traces and the eval service
# --------------------------------------------------------------------- #
class TestTraces:
    @pytest.mark.parametrize("scenario", ["plain", "spot_wave"])
    def test_capture_replays_bit_exact(self, runs, scenario):
        got = _ok(runs["port"][f"trace_{scenario}"])
        run, rep = got["run"], got["replay"]
        assert got["backend"] == "ray"
        assert got["counts"]["arrival"] > 0 and got["counts"]["fire"] > 0
        assert rep["worker_updates"] == run["worker_updates"]
        assert (rep["accel_fires"], rep["accel_accepts"]) == (
            run["accel_fires"], run["accel_accepts"])
        assert got["agreement"]["mean_abs_log10_ratio"] == 0.0
        assert rep["x"].tobytes() == run["x"].tobytes()
        if scenario == "spot_wave":
            assert run["preemptions"] > 0

    def test_offloaded_eval_service(self, runs):
        got = _ok(runs["port"]["offload"])
        r = got["run"]
        assert r["converged"] and got["residual"] < 1e-9
        assert r["offloaded_evals"] > 0 and r["accel_fires"] > 0
        assert r["device_dispatches"] == 0


# --------------------------------------------------------------------- #
# Pools and errors
# --------------------------------------------------------------------- #
class TestPools:
    def test_warm_run_creates_no_actor(self, runs):
        got = _ok(runs["port"]["pools"])
        assert got["cold_created"] == 2 and got["warm_created"] == 0
        (key, s1), = got["stats1"].items()
        assert got["stats2"][key]["pids"] == s1["pids"]
        assert (s1["runs_served"], got["stats2"][key]["runs_served"]) == (1, 2)
        assert s1["healthy"] and s1["boot_s"] > 0.0
        assert got["updates"] == (40, 40)

    def test_keys_follow_n_workers_and_shutdown_empties(self, runs):
        got = _ok(runs["port"]["pools"])
        assert got["keys"] == [1, 2]
        assert got["after_scope"] == {} and got["after_shutdown"] == {}

    def test_actor_error_ends_run_and_retires_pool(self, runs):
        got = _ok(runs["port"]["errors"])
        assert got["flaky"] == ("RuntimeError", "kernel launch failed")
        assert got["flaky_pools"] == {}

    def test_default_device_payload_raises_without_cuda(self, runs):
        got = _ok(runs["port"]["errors"])
        name, msg = got["default_device"]
        assert name == "RayActorError" and "CUDA device" in msg
        assert got["default_device_pools"] == {}

    def test_cpu_runs_count_no_launches(self, runs):
        got = _ok(runs["port"]["errors"])
        assert got["cpu_updates"] == 30
        assert got["launches"] == dict.fromkeys(got["kernels"], 0)
