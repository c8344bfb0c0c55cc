"""The port's chaos layer (``repro_torch.chaos``) against the JAX package's.

The same scripts run through both packages, with ``device="cpu"``
problems on the port's side:

* Scenario scripts: builders, ``scaled``, ``validate`` and the JSON round
  trip give the same dicts as the reference's, and the library registers
  the same names with the same scripts.
* Virtual scripted runs: ``spot_wave``, ``rolling_restart``,
  ``flash_crowd``, pause/resume (before the first dispatch too, and a
  pause of everyone that never ends), a sync scenario,
  ``bimodal_stragglers``, ``sdc_storm`` and the preempt/join races give
  identical counts (updates, preemptions, joins, reassigned blocks,
  partial commits, discards, fires, accepts) and the same virtual wall in
  both packages.  Jacobi iterates are held to tolerance 0.0 (adds and an
  exact scaling, and on the CPU the Anderson Gram and combine are numpy
  products, as in the reference); value-iteration iterates to 1e-12
  relative (torch and XLA reduce the expectation in other orders).
* Elastic membership at the coordinator: the fire-across-membership-change
  rule commits the same bytes in both packages, and preempting the last
  worker orphans its blocks instead of failing.
* Traces: a virtual trace captured by either package replays in the port
  to the port's measured result bit for bit; the JSON of a JAX trace loads
  in the port and replays to the JAX run's result (Jacobi exact, VI
  1e-12); a thread-backend capture in the port replays bit for bit.
* The real backends under scenarios (thread and, in spawned CPU worker
  processes, process), with the offloaded eval service too.
* The device-plane resolver keeps every scenario, trace, checkpoint and
  resume run on the host path.
"""

import hashlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chaos as jc  # noqa: E402
import repro.problems as jp  # noqa: E402
from repro.core import AndersonConfig as JAnderson  # noqa: E402
from repro.core import FaultProfile as JFault  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import RunResult as JRunResult  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402
from repro.core.engine.coordinator import Coordinator as JCoordinator  # noqa: E402

import repro_torch.chaos as tc  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    FaultProfile,
    RunConfig,
    RunResult,
    run_fixed_point,
    shutdown_pools,
)
from repro_torch.core.engine.coordinator import Coordinator  # noqa: E402
from repro_torch.core.engine.device_plane import (  # noqa: E402
    resolve_device_plane,
)

#: the reference package and the port, each as (chaos, FaultProfile, ...)
JAX = dict(chaos=jc, fault=JFault, cfg=JRunConfig, accel=JAnderson,
           run=j_run, probs=jp, device={})
PORT = dict(chaos=tc, fault=FaultProfile, cfg=RunConfig, accel=AndersonConfig,
            run=run_fixed_point, probs=tp, device=dict(device="cpu"))


def _sha(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _jac(pkg, grid=32):
    return pkg["probs"].JacobiProblem(grid=grid, sweeps=5, seed=0,
                                      **pkg["device"])


def _vi(pkg):
    p = pkg["probs"]
    return p.ValueIterationProblem(p.GarnetMDP(S=60, A=4, b=5, gamma=0.9,
                                               seed=0, **pkg["device"]))


# --------------------------------------------------------------------- #
# Scenario scripts
# --------------------------------------------------------------------- #
def _custom(pkg):
    c, F = pkg["chaos"], pkg["fault"]
    return (c.FaultScenario("mix", "every builder")
            .preempt(0.5, 1)
            .set_profile(0.1, F(delay_mean=0.2, crash_prob=0.01), worker=0)
            .join(0.9, 1)
            .pause(0.3).resume(0.4)
            .bimodal_delay(0.0, 1.0, 0.25, F(delay_mean=0.1), worker=2)
            .ramp_delay(0.0, 1.0, 0.0, 0.1, steps=4, worker=3)
            .coordinator_crash(2.0))


def _dicts(scn):
    return [ev.to_dict() for ev in scn.sorted_events()]


class TestScenarioScripts:
    def test_builders_match_reference(self):
        j, t = _custom(JAX), _custom(PORT)
        assert t.to_dict() == j.to_dict()
        assert _dicts(t) == _dicts(j)
        assert _dicts(t.scaled(0.5)) == _dicts(j.scaled(0.5))

    @pytest.mark.parametrize("n_workers", [2, 3, 4, 7])
    def test_library_matches_reference(self, n_workers):
        assert tc.scenario_library() == jc.scenario_library()
        assert set(tc.scenario_library()) == {
            "spot_wave", "rolling_restart", "bimodal_stragglers",
            "flash_crowd", "sdc_storm"}
        for name in tc.scenario_library():
            t = tc.get_scenario(name, n_workers)
            assert t.to_dict() == jc.get_scenario(name, n_workers).to_dict()
            assert t.scaled(0.05).to_dict() == \
                jc.get_scenario(name, n_workers).scaled(0.05).to_dict()
        kn = dict(t0=0.1, downtime=0.3, stagger=0.02, slow=0.02)
        assert tc.get_scenario("spot_wave", n_workers, **kn).to_dict() == \
            jc.get_scenario("spot_wave", n_workers, **kn).to_dict()

    def test_json_round_trips_across_packages(self):
        """A script serialized by either package loads in the other."""
        for src, dst in ((JAX, PORT), (PORT, JAX)):
            d = json.loads(json.dumps(_custom(src).to_dict()))
            back = dst["chaos"].FaultScenario.from_dict(d)
            assert back.to_dict() == _custom(dst).to_dict()
            assert isinstance(back.events[1].profile, dst["fault"])

    @pytest.mark.parametrize("bad,match", [
        (lambda c: c.FaultScenario().preempt(0.1, 7), "out of range"),
        (lambda c: c.FaultScenario().preempt(-1.0, 0), "negative"),
        (lambda c: c.FaultScenario().at(0.1, "preempt"), "explicit worker"),
        (lambda c: c.FaultScenario().at(0.1, "set_profile", 0),
         "FaultProfile"),
        (lambda c: c.FaultScenario().at(0.1, "coordinator_crash", worker=1),
         "worker unset"),
    ])
    def test_validate_refuses_what_the_reference_refuses(self, bad, match):
        for c in (jc, tc):
            with pytest.raises(ValueError, match=match):
                bad(c).validate(4)

    def test_unknown_kind_and_name_refused(self):
        with pytest.raises(ValueError, match="unknown scenario event"):
            tc.FaultScenario().at(0.0, "explode", 0)
        with pytest.raises(ValueError, match="unknown scenario"):
            tc.get_scenario("nope", 4)
        with pytest.raises(ValueError, match="downtime < period"):
            tc.get_scenario("rolling_restart", 4, downtime=1.0)

    def test_clock_due_and_drain(self):
        s = tc.FaultScenario().preempt(0.2, 0).join(0.6, 0).preempt(0.6, 1)
        clock = tc.ScenarioClock(s)
        assert clock.next_time() == pytest.approx(0.2)
        assert [ev.kind for ev in clock.due(0.3)] == ["preempt"]
        assert not clock.exhausted
        assert [ev.kind for ev in clock.drain()] == ["join", "preempt"]
        assert clock.exhausted and clock.next_time() is None
        assert tc.EVENT_KINDS == jc.EVENT_KINDS


# --------------------------------------------------------------------- #
# Virtual scripted runs through both packages
# --------------------------------------------------------------------- #
def _lib(name, scale=1.0, **kn):
    return lambda pkg: pkg["chaos"].get_scenario(name, 4, **kn).scaled(scale)


def _script(*steps):
    """A custom script: ``steps`` of (method, args...); set_profile steps
    carry FaultProfile kwargs as their last argument."""
    def build(pkg):
        s = pkg["chaos"].FaultScenario("custom")
        for meth, *args in steps:
            if meth == "set_profile":
                t, kw, w = args
                s.set_profile(t, pkg["fault"](**kw), worker=w)
            else:
                getattr(s, meth)(*args)
        return s
    return build


_BASE = dict(mode="async", tol=1e-6, max_updates=1500, compute_time=1e-3,
             seed=0)
_ACCEL = dict(fire_every=4)

# name -> (problem, scenario builder, config, Anderson kwargs or None,
#          faults (FaultProfile kwargs per worker) or None)
CASES = {
    "spot_wave_accel": ("jacobi", _lib("spot_wave", 0.05), _ACCEL, {}, None),
    "rolling_restart": ("jacobi", _lib("rolling_restart", 0.05), {}, None,
                        None),
    "flash_crowd_accel": ("jacobi", _lib("flash_crowd"), _ACCEL, {}, None),
    "bimodal_stragglers_accel": ("jacobi", _lib("bimodal_stragglers", 0.05),
                                 _ACCEL, {}, None),
    "sdc_storm_guarded": ("jacobi", _lib("sdc_storm", 0.05),
                          dict(sdc_guard=True, sdc_strikes=2), None, None),
    "pause_resume": ("jacobi", _script(("pause", 0.02), ("resume", 0.06)),
                     {}, None, None),
    "pause_before_first_dispatch": (
        "jacobi", _script(("pause", 0.0), ("resume", 0.05)), _ACCEL, {},
        None),
    "pause_all_forever": ("jacobi", _script(("pause", 0.005)),
                          dict(tol=1e-12), None, None),
    "join_races_inflight_result": (
        "jacobi", _script(("set_profile", 0.0, dict(delay_mean=0.05), 1),
                          ("preempt", 0.02, 1), ("join", 0.025, 1)),
        _ACCEL, {}, None),
    "crash_then_preempt_in_downtime": (
        "jacobi", _script(("preempt", 0.5, 0), ("join", 0.8, 0)),
        dict(tol=0.0, max_updates=2000), None,
        {0: dict(crash_prob=0.05, restart_after=2.0)}),
    "all_preempted_then_join": (
        "jacobi", _script(("preempt", 0.01, 0), ("preempt", 0.01, 1),
                          ("preempt", 0.01, 2), ("preempt", 0.01, 3),
                          ("join", 0.03, 2)), _ACCEL, {}, None),
    "sync_spot_wave_accel": ("jacobi", _lib("spot_wave", 0.05),
                             dict(mode="sync", fire_every=1), {}, None),
    "sync_rolling_restart": ("jacobi", _lib("rolling_restart", 0.05),
                             dict(mode="sync"), None, None),
    "vi_spot_wave_accel": ("vi", _lib("spot_wave", 0.05),
                           dict(tol=1e-12), {}, None),
    "vi_rolling_restart_accel": ("vi", _lib("rolling_restart", 0.05),
                                 dict(tol=1e-12), {}, None),
    "vi_sync_flash_crowd": ("vi", _lib("flash_crowd", 0.05),
                            dict(mode="sync", tol=1e-12), None, None),
}

_COUNTS = ("worker_updates", "rounds", "wall_time", "converged",
           "preemptions", "joins", "reassigned_blocks",
           "accel_partial_commits", "accel_discards", "preempt_discards",
           "accel_fires", "accel_accepts", "accel_rejects", "crashes",
           "restarts", "drops", "sdc_rejects", "quarantined",
           "coordinator_evals")


def _case_run(pkg, name, **extra):
    kind, build, cfg, accel, faults = CASES[name]
    kw = dict(_BASE, **cfg, **extra)
    kw["scenario"] = build(pkg)
    if accel is not None:
        kw["accel"] = pkg["accel"](m=5, **accel)
    if faults is not None:
        kw["faults"] = {w: pkg["fault"](**f) for w, f in faults.items()}
    prob = _jac(pkg) if kind == "jacobi" else _vi(pkg)
    return pkg["run"](prob, pkg["cfg"](**kw)), prob


class TestVirtualScenarioParity:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_counts_and_iterate_match_reference(self, name):
        jr, _ = _case_run(JAX, name)
        tr, _ = _case_run(PORT, name)
        for f in _COUNTS:
            assert getattr(tr, f) == getattr(jr, f), f
        assert tr.service_fractions == jr.service_fractions
        assert [h[:2] for h in tr.history] == [h[:2] for h in jr.history]
        if CASES[name][0] == "jacobi":
            assert _sha(tr.x) == _sha(jr.x)
            assert tr.history == jr.history
        else:
            assert _rel(tr.x, jr.x) <= 1e-12

    def test_scenarios_really_moved_the_membership(self):
        """The cases exercise what they are named for (so the parity above
        is not parity of idle runs)."""
        r = {n: _case_run(PORT, n)[0] for n in (
            "spot_wave_accel", "flash_crowd_accel", "sdc_storm_guarded",
            "pause_all_forever", "join_races_inflight_result",
            "crash_then_preempt_in_downtime", "all_preempted_then_join")}
        assert r["spot_wave_accel"].preemptions == 2
        assert r["spot_wave_accel"].joins == 2
        assert r["spot_wave_accel"].preempt_discards == 2
        assert r["spot_wave_accel"].accel_fires > 0
        assert r["flash_crowd_accel"].joins == 3
        assert r["sdc_storm_guarded"].sdc_rejects > 0
        assert not r["pause_all_forever"].converged
        assert r["join_races_inflight_result"].preempt_discards == 1
        assert r["crash_then_preempt_in_downtime"].restarts == 0
        assert r["crash_then_preempt_in_downtime"].service_fractions[0] <= 0.26
        assert r["all_preempted_then_join"].joins == 1
        assert set(r["all_preempted_then_join"].service_fractions) >= {2}

    def test_scripted_runs_are_reproducible(self):
        a, _ = _case_run(PORT, "spot_wave_accel")
        b, _ = _case_run(PORT, "spot_wave_accel")
        assert _sha(a.x) == _sha(b.x) and a.wall_time == b.wall_time

    def test_worker_eval_needs_a_real_backend(self):
        scn = tc.FaultScenario("x").preempt(0.05, 1).join(0.15, 1)
        with pytest.raises(ValueError, match="need a real backend"):
            run_fixed_point(_jac(PORT), RunConfig(
                mode="async", n_workers=2, accel=AndersonConfig(m=3),
                accel_eval="worker", scenario=scn, max_updates=100))
        with pytest.raises(ValueError, match="selection='fixed'"):
            Coordinator(_jac(PORT), RunConfig(
                selection="uniform", scenario=scn))
        with pytest.raises(ValueError, match="out of range"):
            Coordinator(_jac(PORT), RunConfig(
                n_workers=2, scenario=tc.FaultScenario().preempt(0.1, 5)))


# --------------------------------------------------------------------- #
# Elastic membership at the coordinator
# --------------------------------------------------------------------- #
def _coord_pair(p=4, accel=True):
    jcfg = dict(mode="async", n_workers=p, compute_time=1e-3)
    tcfg = dict(jcfg)
    if accel:
        jcfg["accel"] = JAnderson(m=3)
        tcfg["accel"] = AndersonConfig(m=3)
    return (JCoordinator(_jac(JAX, 16), JRunConfig(**jcfg)),
            Coordinator(_jac(PORT, 16), RunConfig(**tcfg)))


def _feed(c, plan):
    item = plan.next_item()
    while item is not None:
        c.accel_feed(plan, c.eval_item(item))
        item = plan.next_item()


class TestElasticMembership:
    def test_preempt_join_bookkeeping_matches(self):
        jco, tco = _coord_pair(accel=False)
        for c in (jco, tco):
            c.preempt_worker(1)
            c.preempt_worker(c.block_owner[1])
            c.join_worker(1)
            c.apply_scenario_event(type("E", (), dict(
                kind="pause", worker=None, t=0.0))(), 0.0)
        for f in ("active", "paused", "worker_blocks", "block_owner",
                  "_orphan_blocks", "preempt_gen", "preemptions", "joins",
                  "reassigned_blocks", "_block_moved_at",
                  "_membership_version"):
            assert getattr(tco, f) == getattr(jco, f), f
        assert tco.round_participants() == jco.round_participants() == []

    def test_preempting_every_worker_orphans_then_join_recovers(self):
        """The port's quarantine-only version called min() over an empty
        survivor list here; the reference orphans the blocks."""
        _, c = _coord_pair(p=2, accel=False)
        c.preempt_worker(0)
        c.preempt_worker(1)
        assert not c.active and sorted(c._orphan_blocks) == [0, 1]
        assert c.join_worker(0) == 2
        assert sorted(c.worker_blocks[0]) == [0, 1]
        assert c.block_owner == {0: 0, 1: 0}

    def test_dispatch_and_round_assignment_follow_moved_blocks(self):
        _, c = _coord_pair(accel=False)
        c.preempt_worker(1)
        holder = c.block_owner[1]
        assert {c.next_dispatch(holder)[0] for _ in range(4)} == {holder, 1}
        np.testing.assert_array_equal(
            c.round_assignment(holder),
            np.concatenate([c.blocks[b] for b in c.worker_blocks[holder]]))
        other = next(w for w in sorted(c.active) if w != holder)
        assert c.round_assignment(other) is c.blocks[other]

    def test_fire_across_membership_change_commits_same_bytes(self):
        """A fire whose begin -> commit window crossed a preemption commits
        only to the unmoved blocks, identically in both packages."""
        jco, tco = _coord_pair()
        out = []
        for c in (jco, tco):
            for _ in range(3):  # a window deeper than one triple
                c.maybe_fire_accel()
            plan = c.accel_begin()
            c.preempt_worker(3)
            _feed(c, plan)
            x_pre = c.x.copy()
            verdict = c.accel_commit(plan)
            assert c.accel_partial_commits == 1 and c.accel_discards == 0
            np.testing.assert_array_equal(c.x[c.blocks[3]],
                                          x_pre[c.blocks[3]])
            assert not np.array_equal(c.x, x_pre)
            out.append((verdict, c.x.copy()))
        assert out[1][0] == out[0][0]
        assert _sha(out[1][1]) == _sha(out[0][1])

    def test_fire_with_every_block_moved_is_discarded(self):
        jco, tco = _coord_pair()
        for c in (jco, tco):
            plan = c.accel_begin()
            c.preempt_worker(0)
            c.join_worker(0)
            for w in (1, 2, 3):
                c.preempt_worker(w)
            _feed(c, plan)
            assert c.accel_commit(plan) == "discard"
            assert c.accel_discards == 1 and c.accel_partial_commits == 0
        assert _sha(tco.x) == _sha(jco.x)

    def test_live_profiles_and_sync_plans(self):
        """``set_profile`` overrides reach the BSP round plan's draws."""
        jco, tco = _coord_pair(accel=False)
        draws = []
        for c, F in ((jco, JFault), (tco, FaultProfile)):
            ev = type("E", (), dict(kind="set_profile", worker=2, t=0.0,
                                    profile=F(delay_mean=0.3,
                                              delay_std=0.1)))()
            c.apply_scenario_event(ev, 0.0)
            assert c.fault_for(2).delay_mean == 0.3
            plans = c.plan_round({0, 1, 2, 3}, c.blocks)
            draws.append([(w, d, cr) for w, _, _, d, cr in plans])
        assert draws[0] == draws[1]

    def test_coordinator_crash_event_raises(self):
        _, c = _coord_pair(accel=False)
        from repro_torch.core import CoordinatorCrash

        with pytest.raises(CoordinatorCrash, match="killed the coordinator"):
            c.apply_scenario_event(
                tc.FaultScenario().coordinator_crash(0.5).events[0], 0.5)


# --------------------------------------------------------------------- #
# Traces
# --------------------------------------------------------------------- #
def _capture(pkg, kind="jacobi", **kw):
    cfg = dict(mode="async", tol=1e-6, max_updates=1500, seed=0,
               compute_time=1e-3, capture_trace=True,
               scenario=pkg["chaos"].get_scenario("spot_wave", 4).scaled(0.05),
               accel=pkg["accel"](m=3), fire_every=4)
    cfg.update(kw)
    cfg = pkg["cfg"](**cfg)
    prob = _jac(pkg) if kind == "jacobi" else _vi(pkg)
    return pkg["run"](prob, cfg), cfg


class TestTraces:
    def test_port_virtual_capture_replays_bit_exact(self):
        r, cfg = _capture(PORT)
        counts = r.trace.counts()
        assert counts["arrival"] > 0 and counts["fire"] > 0
        assert counts["scenario"] >= 3
        rep = tc.replay_trace(_jac(PORT), r.trace, cfg)
        ag = tc.trace_agreement(r, rep)
        assert ag["records_compared"] == len(r.history)
        assert ag["mean_abs_log10_ratio"] == 0.0
        assert _sha(rep.x) == _sha(r.x)
        assert (rep.preemptions, rep.preempt_discards) == (
            r.preemptions, r.preempt_discards)

    def test_port_and_reference_capture_the_same_trace(self):
        jr, _ = _capture(JAX)
        tr, _ = _capture(PORT)
        assert tr.trace.meta == jr.trace.meta
        assert tr.trace.events == jr.trace.events

    @pytest.mark.parametrize("kind", ["jacobi", "vi"])
    def test_reference_trace_json_replays_in_the_port(self, kind):
        """The JSON of a trace the JAX package captured loads in the port
        and replays to the JAX run's result (and to the port's own measured
        run, bit for bit)."""
        jr, _ = _capture(JAX, kind, tol=1e-12)
        tr, tcfg = _capture(PORT, kind, tol=1e-12)
        trace = tc.RunTrace.from_json(jr.trace.to_json())
        prob = _jac(PORT) if kind == "jacobi" else _vi(PORT)
        rep = tc.replay_trace(prob, trace, tcfg)
        assert rep.worker_updates == jr.worker_updates == tr.worker_updates
        assert (rep.accel_fires, rep.accel_accepts) == (
            jr.accel_fires, jr.accel_accepts)
        assert rep.preempt_discards == jr.preempt_discards
        assert _sha(rep.x) == _sha(tr.x)
        if kind == "jacobi":
            assert _sha(rep.x) == _sha(jr.x)
        else:
            assert _rel(rep.x, jr.x) <= 1e-12

    def test_port_trace_json_replays_in_the_reference(self):
        tr, _ = _capture(PORT)
        jr, jcfg = _capture(JAX)
        rep = jc.replay_trace(_jac(JAX), jc.RunTrace.from_json(
            tr.trace.to_json()), jcfg)
        assert _sha(rep.x) == _sha(jr.x) == _sha(tr.x)

    def test_thread_capture_replays_bit_exact(self):
        cfg = RunConfig(mode="async", executor="thread", tol=1e-6,
                        max_updates=10**5, seed=0, capture_trace=True,
                        accel=AndersonConfig(m=3), fire_every=4)
        r = run_fixed_point(_jac(PORT, 8), cfg)
        assert r.converged and r.trace.meta["backend"] == "thread"
        rep = tc.replay_trace(_jac(PORT, 8), r.trace, cfg)
        assert tc.trace_agreement(r, rep)["mean_abs_log10_ratio"] == 0.0
        assert _sha(rep.x) == _sha(r.x)

    def test_thread_scenario_capture_replays_bit_exact(self):
        scn = tc.get_scenario("spot_wave", 4, t0=0.02, downtime=0.05,
                              stagger=0.005, slow=0.002)
        cfg = RunConfig(mode="async", executor="thread", tol=1e-8,
                        max_updates=3000, seed=0, capture_trace=True,
                        scenario=scn, accel=AndersonConfig(m=3),
                        fire_every=4,
                        faults=FaultProfile(delay_mean=2e-4))
        r = run_fixed_point(_jac(PORT, 16), cfg)
        rep = tc.replay_trace(_jac(PORT, 16), r.trace, cfg)
        assert rep.worker_updates == r.worker_updates
        assert _sha(rep.x) == _sha(r.x)

    def test_drops_replay_without_rng(self):
        r, cfg = _capture(PORT, scenario=None, accel=None,
                          faults=FaultProfile(drop_prob=0.3))
        assert r.drops > 0
        rep = tc.replay_trace(_jac(PORT), r.trace, cfg)
        assert rep.drops == r.drops and _sha(rep.x) == _sha(r.x)

    def test_guards(self):
        with pytest.raises(ValueError, match="version"):
            tc.RunTrace.from_dict({"version": 999, "meta": {}, "events": []})
        with pytest.raises(ValueError, match="async"):
            tc.replay_trace(_jac(PORT), tc.RunTrace(meta={"mode": "sync"}),
                            RunConfig())
        with pytest.raises(ValueError, match="async"):
            run_fixed_point(_jac(PORT), RunConfig(
                mode="sync", capture_trace=True, compute_time=1e-3))


# --------------------------------------------------------------------- #
# RunResult JSON
# --------------------------------------------------------------------- #
class TestRunResultRoundTrip:
    def test_round_trip_and_reference_dicts(self):
        tr, _ = _case_run(PORT, "spot_wave_accel")
        jr, _ = _case_run(JAX, "spot_wave_accel")
        d = json.loads(json.dumps(tr.to_dict()))
        back = RunResult.from_dict(d)
        for f in _COUNTS + ("residual_norm", "mean_staleness",
                            "error_norm", "coordinator_busy_frac"):
            assert getattr(back, f) == getattr(tr, f), f
        assert back.service_fractions == tr.service_fractions
        assert back.history == tr.history and back.x.size == 0
        # The reference's dict (with its telemetry and controller keys)
        # loads into the port's result: the same run, the same values.
        jback = RunResult.from_dict(json.loads(json.dumps(jr.to_dict())))
        for f in _COUNTS:
            assert getattr(jback, f) == getattr(tr, f), f
        tb = JRunResult.from_dict(json.loads(json.dumps(tr.to_dict())))
        assert tb.preemptions == tr.preemptions

    def test_include_x_and_trace(self):
        r, cfg = _capture(PORT, scenario=None)
        d = json.loads(json.dumps(r.to_dict(include_x=True)))
        back = RunResult.from_dict(d)
        np.testing.assert_array_equal(back.x, r.x)
        assert d["trace"]["meta"]["backend"] == "virtual"
        rep = tc.replay_trace(_jac(PORT), tc.RunTrace.from_dict(back.trace),
                              cfg)
        assert _sha(rep.x) == _sha(r.x)
        d["a_future_field"] = 1
        RunResult.from_dict(d)


# --------------------------------------------------------------------- #
# The real backends under scenarios
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pools():
    yield
    shutdown_pools()


class TestThreadChaos:
    def test_spot_wave(self):
        scn = tc.get_scenario("spot_wave", 4, t0=0.1, downtime=0.3,
                              stagger=0.02, slow=0.02)
        r = run_fixed_point(_jac(PORT, 8), RunConfig(
            mode="async", executor="thread", tol=1e-6, max_updates=10**5,
            seed=0, scenario=scn, faults=FaultProfile(delay_mean=5e-4)))
        assert r.converged
        assert r.preemptions == 2 and r.joins == 2
        assert r.reassigned_blocks == 4

    def test_flash_crowd_with_accel(self):
        scn = tc.get_scenario("flash_crowd", 4, join_at=0.15, stagger=0.02,
                              ramp_from=0.01)
        r = run_fixed_point(_jac(PORT, 8), RunConfig(
            mode="async", executor="thread", tol=1e-6, max_updates=10**5,
            seed=0, scenario=scn, accel=AndersonConfig(m=3), fire_every=4,
            faults=FaultProfile(delay_mean=5e-4)))
        assert r.converged and r.joins == 3

    def test_sync_scenario(self):
        scn = tc.get_scenario("spot_wave", 4, t0=0.002, downtime=0.015,
                              stagger=0.001, slow=0.002)
        r = run_fixed_point(_jac(PORT, 8), RunConfig(
            mode="sync", executor="thread", tol=1e-6, max_updates=10**5,
            seed=0, scenario=scn))
        assert r.converged and r.preemptions == 2

    def test_pause_forever_with_dead_fleet_terminates(self):
        scn = tc.FaultScenario("stuck").pause(0.0, worker=3)
        r = run_fixed_point(_jac(PORT, 8), RunConfig(
            mode="async", executor="thread", tol=1e-10, max_updates=100,
            seed=0, scenario=scn,
            faults={w: FaultProfile(crash_prob=1.0) for w in range(3)}))
        assert not r.converged and r.crashes == 3

    def test_offloaded_eval_under_membership_churn(self):
        scn = (tc.FaultScenario("churn")
               .preempt(0.05, 1).join(0.15, 1)
               .preempt(0.25, 1).join(0.35, 1))
        r = run_fixed_point(_jac(PORT, 16), RunConfig(
            mode="async", executor="thread", n_workers=2,
            accel=AndersonConfig(m=4), fire_every=4, accel_eval="worker",
            scenario=scn, tol=1e-14, max_updates=4000, max_wall=10.0,
            faults=FaultProfile(delay_mean=2e-4)))
        assert r.worker_updates > 0 and r.offloaded_evals > 0
        assert r.preemptions >= 1 and r.joins >= 1
        assert np.isfinite(r.residual_norm)

    def test_worker_errors_propagate_from_the_chaos_loop(self):
        class Flaky(tp.JacobiProblem):
            calls = 0

            def block_update(self, x, indices):
                Flaky.calls += 1
                if Flaky.calls > 8:  # after the warm-up calls
                    raise RuntimeError("kernel launch failed")
                return super().block_update(x, indices)

        with pytest.raises(RuntimeError, match="kernel launch failed"):
            run_fixed_point(Flaky(grid=8, sweeps=1, device="cpu"), RunConfig(
                mode="async", executor="thread", n_workers=2,
                max_updates=200, scenario=tc.FaultScenario().pause(5.0)))


@pytest.mark.usefixtures("pools")
class TestProcessChaos:
    def _cfg(self, scn, **kw):
        base = dict(mode="async", executor="process", n_workers=2, tol=1e-6,
                    max_updates=10**5, seed=0, scenario=scn,
                    faults=FaultProfile(delay_mean=5e-4))
        base.update(kw)
        return RunConfig(**base)

    def test_pause_before_first_dispatch_then_resume(self):
        r = run_fixed_point(_jac(PORT, 8), self._cfg(
            tc.FaultScenario("late").pause(0.0).resume(0.1)))
        assert r.converged and r.worker_updates > 0

    def test_t0_preempt_join_single_stream(self):
        r = run_fixed_point(_jac(PORT, 8), self._cfg(
            tc.FaultScenario("t0").preempt(0.0, 1).join(0.0, 1)))
        assert r.converged
        assert r.preemptions == 1 and r.joins == 1
        assert r.preempt_discards == 0

    def test_preempt_join_and_profile_forwarding(self):
        # Without the script this run converges in well under 0.1 s, so
        # the preemption comes early.
        scn = (tc.FaultScenario("pj")
               .preempt(0.01, 1)
               .set_profile(0.01, FaultProfile(delay_mean=0.01), worker=0)
               .join(0.3, 1))
        r = run_fixed_point(_jac(PORT, 8), self._cfg(
            scn, accel=AndersonConfig(m=3), fire_every=4))
        assert r.converged
        assert r.preemptions == 1 and r.reassigned_blocks >= 1

    def test_sync_scenario(self):
        scn = tc.get_scenario("spot_wave", 2, t0=0.002, downtime=0.015,
                              stagger=0.001, slow=0.002)
        r = run_fixed_point(_jac(PORT, 8), self._cfg(scn, mode="sync",
                                                     faults=None))
        assert r.converged and r.preemptions == 1

    def test_offloaded_eval_under_membership_churn(self):
        scn = (tc.FaultScenario("churn")
               .preempt(0.05, 1).join(0.15, 1)
               .preempt(0.25, 1).join(0.35, 1))
        r = run_fixed_point(_jac(PORT, 8), self._cfg(
            scn, accel=AndersonConfig(m=4), fire_every=4,
            accel_eval="worker", tol=1e-14, max_updates=3000,
            max_wall=10.0))
        assert r.worker_updates > 0 and r.offloaded_evals > 0
        assert r.preemptions >= 1 and r.joins >= 1
        assert np.isfinite(r.residual_norm)

    def test_capture_replays_close(self):
        cfg = self._cfg(None, capture_trace=True, tol=1e-8)
        r = run_fixed_point(_jac(PORT, 8), cfg)
        assert r.trace.meta["backend"] == "process"
        rep = tc.replay_trace(_jac(PORT, 8), r.trace, cfg)
        assert rep.worker_updates == r.worker_updates
        assert tc.trace_agreement(r, rep)["records_compared"] > 0


# --------------------------------------------------------------------- #
# Device-plane resolver
# --------------------------------------------------------------------- #
class TestResolverWithNewKnobs:
    """The reference's resolver (``device_plane.py:62-65``) keeps these runs
    on the host path: a resident block plan cannot follow a reassigned
    block, and a resume cannot restore a resident block."""

    @pytest.mark.parametrize("kw", [
        dict(scenario=tc.FaultScenario().preempt(0.1, 1)),
        dict(capture_trace=True),
        dict(checkpoint_every=10, checkpoint_dir="ckpt"),
        dict(resume_from="ckpt"),
    ])
    @pytest.mark.parametrize("backend", ["thread", "process"])
    def test_new_knobs_take_the_host_path(self, kw, backend):
        p = tp.JacobiProblem(grid=16, sweeps=2, device="cpu")
        cfg = RunConfig(mode="async", n_workers=2, max_updates=40,
                        device_plane="on", **kw)
        assert resolve_device_plane(p, cfg, backend) is None
        base = RunConfig(mode="async", n_workers=2, max_updates=40,
                         device_plane="on")
        assert resolve_device_plane(p, base, backend) == "kernel"

    def test_scenario_runs_count_no_device_dispatches(self):
        r = run_fixed_point(_jac(PORT, 16), RunConfig(
            mode="async", executor="thread", n_workers=2, device_plane="on",
            max_updates=60, scenario=tc.FaultScenario().pause(5.0)))
        assert r.worker_updates == 60 and r.device_dispatches == 0
