"""The port's autoscale layer (``repro_torch.autoscale``) against the JAX
package's.

The same controllers drive the same runs through both packages, with
``device="cpu"`` problems on the port's side:

* The registry: the same policy names and descriptions, and the port's
  ``get_policy`` builds the port's classes.
* Decisions: for each of ``static``, ``target_staleness`` and
  ``drain_ahead`` with the reference's golden configuration (six workers
  under a scaled ``spot_wave``, virtual backend), the port's
  ``decision_log``, ``controller_actions``, ``worker_seconds`` and iterate
  bytes equal the live reference run's (Jacobi: tolerance 0.0).  The
  signals a policy sees are the same snapshot in both packages; a value
  iteration under a controller is held to 1e-12 relative with equal
  counts; the sync loop takes the same decisions.
* Replay: a controller-driven thread run captures a trace that replays bit
  for bit (the controller is stripped, its actions are scenario events),
  and a virtual controller trace of either package replays in the port.
* Actuation on the real backends: a thread run and a process run (one
  spawned CPU pool) apply the controller's actions; a controller holding
  an unpicklable hook never crosses to the worker interpreters.
* The rails: the device plane, worker-seconds metering, the cost model,
  ``selection="fixed"`` and the resume config all treat controllers as
  the reference does.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.autoscale as ja  # noqa: E402
import repro.chaos as jc  # noqa: E402
import repro.problems as jp  # noqa: E402
from repro.core import FaultProfile as JFault  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402

import repro_torch.autoscale as ta  # noqa: E402
import repro_torch.chaos as tc  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FaultProfile,
    RunConfig,
    run_fixed_point,
    shutdown_pools,
)
from repro_torch.core.engine.device_plane import (  # noqa: E402
    resolve_device_plane,
)

JAX = dict(auto=ja, chaos=jc, fault=JFault, cfg=JRunConfig, run=j_run,
           probs=jp, device={})
PORT = dict(auto=ta, chaos=tc, fault=FaultProfile, cfg=RunConfig,
            run=run_fixed_point, probs=tp, device=dict(device="cpu"))

#: the reference's per-policy kwargs for its decision goldens
#: (tests/test_autoscale.py POLICY_KW)
POLICY_KW = {
    "static": {"size": 3},
    "target_staleness": {"target": 3.0, "initial_size": 3},
    "drain_ahead": {"lookahead": 0.05},
}


def _sha(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _jac(pkg, grid=8):
    return pkg["probs"].JacobiProblem(grid=grid, sweeps=5, seed=0,
                                      **pkg["device"])


def _vi(pkg):
    p = pkg["probs"]
    return p.ValueIterationProblem(p.GarnetMDP(S=60, A=4, b=5, gamma=0.9,
                                               seed=0, **pkg["device"]))


def _golden_cfg(pkg, ctl, **kw):
    """The reference's golden configuration: six workers under a
    ``spot_wave`` scaled to land inside the short virtual run."""
    base = dict(mode="async", executor="virtual", n_workers=6, tol=1e-6,
                max_updates=10 ** 5, seed=0, compute_time=2e-3,
                faults=pkg["fault"](delay_mean=4e-3),
                scenario=pkg["chaos"].get_scenario("spot_wave",
                                                   6).scaled(0.05),
                controller=ctl)
    base.update(kw)
    return pkg["cfg"](**base)


def _controlled(pkg, name, prob=None, **kw):
    ctl = pkg["auto"].get_policy(name, **POLICY_KW[name])
    res = pkg["run"](prob if prob is not None else _jac(pkg),
                     _golden_cfg(pkg, ctl, **kw))
    return res, ctl


def _counts(r):
    return (r.worker_updates, r.accel_fires, r.accel_accepts, r.preemptions,
            r.joins, r.reassigned_blocks, r.preempt_discards,
            r.controller_actions, r.wall_time, r.converged)


# --------------------------------------------------------------------- #
class TestRegistry:
    def test_library_matches_reference(self):
        assert ta.policy_library() == ja.policy_library()
        assert set(ta.policy_library()) == set(POLICY_KW)

    @pytest.mark.parametrize("name,cls", [
        ("static", ta.StaticPolicy),
        ("target_staleness", ta.TargetStalenessPolicy),
        ("drain_ahead", ta.DrainAheadPolicy),
    ])
    def test_get_policy_builds_the_ports_classes(self, name, cls):
        ctl = ta.get_policy(name, **POLICY_KW[name])
        assert isinstance(ctl, cls) and isinstance(ctl, ta.Controller)
        ref = ja.get_policy(name, **POLICY_KW[name])
        assert (ctl.tick_every, ctl.tick_dt, ctl.lookahead) == \
            (ref.tick_every, ref.tick_dt, ref.lookahead)

    def test_unknown_policy_rejected(self):
        with pytest.raises(KeyError, match="unknown policy"):
            ta.get_policy("does_not_exist")

    def test_policies_emit_the_ports_scenario_events(self):
        """A policy's actions are the port's ScenarioEvent, never the
        reference's."""
        ctl = ta.get_policy("static", size=1)
        res = run_fixed_point(_jac(PORT), _golden_cfg(PORT, ctl,
                                                      scenario=None))
        assert res.controller_actions == 5
        sig = ta.ControlSignals(
            t=0.0, tick=0, arrivals=0, worker_updates=0, arrival_rate=0.0,
            staleness_p50=0.0, staleness_p95=0.0, staleness_window=(),
            stale_limit=8, accel_fires=0, accel_discards=0,
            accel_partial_commits=0, n_workers=2,
            active=frozenset({0, 1}), paused=frozenset(),
            scenario_down=frozenset(), service_fractions={}, queue_depth=0,
            worker_seconds=0.0)
        (ev,) = ta.StaticPolicy(size=1).decide(sig)
        assert isinstance(ev, tc.ScenarioEvent)
        assert not isinstance(ev, jc.ScenarioEvent)


# --------------------------------------------------------------------- #
class TestDecisionParity:
    """The same policy on the same run takes the same decisions in both
    packages, and the runs agree to the byte (Jacobi)."""

    @pytest.mark.parametrize("name", sorted(POLICY_KW))
    def test_decisions_and_bytes_match_reference(self, name):
        jr, jctl = _controlled(JAX, name)
        tr, tctl = _controlled(PORT, name)
        assert tr.converged
        assert tctl.decision_log == jctl.decision_log
        assert tr.controller_actions == len(tctl.decision_log) == \
            jr.controller_actions
        assert tr.worker_seconds == jr.worker_seconds > 0.0
        assert _counts(tr) == _counts(jr)
        assert _sha(tr.x) == _sha(jr.x)
        assert tr.history == jr.history

    @pytest.mark.parametrize("name", sorted(POLICY_KW))
    def test_decision_log_reproducible(self, name):
        (r1, c1), (r2, c2) = _controlled(PORT, name), _controlled(PORT, name)
        assert c1.decision_log == c2.decision_log
        assert _counts(r1) == _counts(r2)
        assert _sha(r1.x) == _sha(r2.x)

    def test_reset_clears_controller_state(self):
        """One controller instance reused across runs behaves like a fresh
        one: the coordinator calls ``reset`` at run start."""
        ctl = ta.get_policy("target_staleness",
                            **POLICY_KW["target_staleness"])
        run_fixed_point(_jac(PORT), _golden_cfg(PORT, ctl))
        first = list(ctl.decision_log)
        run_fixed_point(_jac(PORT), _golden_cfg(PORT, ctl))
        ref = ja.get_policy("target_staleness",
                            **POLICY_KW["target_staleness"])
        j_run(_jac(JAX), _golden_cfg(JAX, ref))
        assert ctl.decision_log == first == ref.decision_log

    def test_signals_match_reference(self):
        """A spy controller sees the same snapshot sequence in both
        packages (tick, clock, arrivals, staleness window, membership,
        service fractions, worker-seconds)."""
        def spy(pkg):
            seen = []

            class Spy(pkg["auto"].Controller):
                name = "spy"
                tick_every = 8

                def decide(self, sig):
                    seen.append(dataclasses.asdict(sig))
                    return []

            r = pkg["run"](_jac(pkg), pkg["cfg"](
                mode="async", executor="virtual", n_workers=4, tol=1e-6,
                max_updates=10 ** 5, seed=0, compute_time=1e-3,
                controller=Spy()))
            return r, seen

        (jr, js), (tr, ts) = spy(JAX), spy(PORT)
        assert len(ts) == len(js) >= 2
        assert ts == js
        last = ts[-1]
        assert last["active"] == frozenset(range(4))
        assert abs(sum(last["service_fractions"].values()) - 1.0) < 1e-9
        assert last["queue_depth"] == 0
        assert _sha(tr.x) == _sha(jr.x)

    def test_value_iteration_within_tolerance(self):
        jr, jctl = _controlled(JAX, "target_staleness", prob=_vi(JAX))
        tr, tctl = _controlled(PORT, "target_staleness", prob=_vi(PORT))
        assert tctl.decision_log == jctl.decision_log
        assert _counts(tr) == _counts(jr)
        rel = np.max(np.abs(tr.x - jr.x)) / np.max(np.abs(jr.x))
        assert rel <= 1e-12

    def test_sync_loop_matches_reference(self):
        def go(pkg):
            ctl = pkg["auto"].get_policy("static", size=2)
            r = pkg["run"](_jac(pkg), pkg["cfg"](
                mode="sync", executor="virtual", n_workers=4, tol=1e-6,
                max_updates=4000, seed=1, compute_time=1e-3,
                controller=ctl))
            return r, ctl

        (jr, jctl), (tr, tctl) = go(JAX), go(PORT)
        assert tctl.decision_log == jctl.decision_log
        assert tr.controller_actions == 2
        assert _counts(tr) == _counts(jr)
        assert tr.worker_seconds == jr.worker_seconds
        assert _sha(tr.x) == _sha(jr.x)


# --------------------------------------------------------------------- #
class TestControllerTraceReplay:
    def test_thread_controller_capture_replays_bit_exact(self):
        ctl = ta.get_policy("target_staleness", target=2.0, initial_size=3)
        cfg = RunConfig(mode="async", executor="thread", n_workers=4,
                        tol=1e-6, max_updates=10 ** 5, seed=0,
                        capture_trace=True, controller=ctl)
        r = run_fixed_point(_jac(PORT), cfg)
        assert r.converged and r.trace is not None
        assert r.trace.meta["backend"] == "thread"
        assert r.trace.meta["controller"] == "target_staleness"
        assert r.trace.counts().get("scenario", 0) >= 1
        assert r.controller_actions == len(ctl.decision_log) >= 1
        rep = tc.replay_trace(_jac(PORT), r.trace, cfg)
        ag = tc.trace_agreement(r, rep)
        assert ag["mean_abs_log10_ratio"] == 0.0
        np.testing.assert_array_equal(r.x, rep.x)
        assert (rep.preemptions, rep.joins) == (r.preemptions, r.joins)

    @pytest.mark.parametrize("src", ["port", "reference"])
    def test_virtual_controller_trace_replays_in_the_port(self, src):
        """A virtual controller run's trace (captured by either package)
        replays in the port to the captured run's bytes."""
        pkg = PORT if src == "port" else JAX
        ctl = pkg["auto"].get_policy("target_staleness",
                                     **POLICY_KW["target_staleness"])
        r = pkg["run"](_jac(pkg), _golden_cfg(pkg, ctl, capture_trace=True))
        trace = (r.trace if src == "port"
                 else tc.RunTrace.from_dict(r.trace.to_dict()))
        cfg = _golden_cfg(PORT, ta.get_policy(
            "target_staleness", **POLICY_KW["target_staleness"]),
            capture_trace=True)
        rep = tc.replay_trace(_jac(PORT), trace, cfg)
        assert rep.x.tobytes() == r.x.tobytes()
        assert (rep.preemptions, rep.joins, rep.worker_updates) == \
            (r.preemptions, r.joins, r.worker_updates)


# --------------------------------------------------------------------- #
class TestRealBackends:
    def test_thread_run_applies_controller_actions(self):
        ctl = ta.get_policy("static", size=2)
        r = run_fixed_point(_jac(PORT, grid=16), RunConfig(
            mode="async", executor="thread", n_workers=4, tol=1e-6,
            max_updates=10 ** 5, seed=0, controller=ctl,
            faults={0: FaultProfile(delay_mean=0.002)}))
        assert r.converged
        assert r.controller_actions == len(ctl.decision_log) == 2
        assert r.preemptions == 2 and r.reassigned_blocks == 2
        assert r.worker_seconds > 0.0
        assert r.device_dispatches == 0

    def test_process_run_strips_the_controller_from_workers(self):
        """The controller holds an unpicklable hook (the serve layer's
        queue-depth closure); the process backend must keep it in the
        parent and still actuate its decisions."""
        ctl = ta.get_policy("static", size=1)
        ctl.queue_depth_fn = lambda: 0
        try:
            r = run_fixed_point(_jac(PORT, grid=16), RunConfig(
                mode="async", executor="process", n_workers=2, tol=1e-6,
                max_updates=10 ** 5, seed=0, controller=ctl))
        finally:
            shutdown_pools()
        assert r.converged
        assert r.controller_actions == 1 and r.preemptions == 1
        assert ctl.decision_log == [
            {"tick": 0, "t": 0.0, "kind": "preempt", "worker": 1}]
        assert r.service_fractions == {0: 1.0}


# --------------------------------------------------------------------- #
class TestRails:
    def test_device_plane_refused_under_a_controller(self):
        prob = _jac(PORT, grid=16)
        on = RunConfig(mode="async", executor="thread", device_plane="on")
        assert resolve_device_plane(prob, on, "thread") == "kernel"
        ctl = dataclasses.replace(on, controller=ta.StaticPolicy())
        assert resolve_device_plane(prob, ctl, "thread") is None
        assert resolve_device_plane(prob, ctl, "process") is None

    def test_worker_seconds_metered_only_with_controller(self):
        base = dict(mode="async", executor="virtual", tol=1e-6,
                    max_updates=10 ** 5, seed=0, compute_time=1e-3)
        off = run_fixed_point(_jac(PORT), RunConfig(**base))
        on = run_fixed_point(_jac(PORT), RunConfig(
            controller=ta.StaticPolicy(), **base))
        ref = j_run(_jac(JAX), JRunConfig(controller=ja.StaticPolicy(),
                                          **base))
        assert off.worker_seconds == 0.0 and off.controller_actions == 0
        assert on.worker_seconds == ref.worker_seconds
        assert on.worker_seconds == pytest.approx(4 * on.wall_time,
                                                  rel=0.05)
        assert on.worker_updates == off.worker_updates
        assert _sha(on.x) == _sha(off.x)
        assert math.isinf(ta.run_cost(off))
        assert ta.run_cost(on) == ja.run_cost(ref) == pytest.approx(
            on.worker_seconds * on.wall_time)

    def test_controller_requires_fixed_selection(self):
        with pytest.raises(ValueError, match="selection"):
            run_fixed_point(_jac(PORT), RunConfig(
                mode="async", executor="virtual", tol=1e-6, seed=0,
                selection="uniform", controller=ta.StaticPolicy()))

    def test_resume_config_strips_the_controller(self, tmp_path):
        from repro_torch.recover import latest_checkpoint, resume_config

        cfg = RunConfig(mode="async", executor="virtual", tol=1e-300,
                        max_updates=100, seed=0, compute_time=1e-3,
                        checkpoint_every=50, checkpoint_dir=str(tmp_path),
                        controller=ta.StaticPolicy(size=2))
        run_fixed_point(_jac(PORT), cfg)
        ck = latest_checkpoint(str(tmp_path))
        out = resume_config(cfg, ck)
        assert out.controller is None and out.scenario is None
        assert out.resume_from is ck
