"""The port's telemetry layer (``repro_torch.telemetry``) against the JAX
package's, and the engine repairs that ride with it.

The same configurations run through both packages, with ``device="cpu"``
problems on the port's side:

* The taxonomy: ``SPAN_KINDS``, ``METRICS``, ``SCENARIO_SPAN_MAP`` and
  ``TRACE_SPAN_MAP`` equal the reference's, and cover the port's own
  scenario and trace event kinds.
* Virtual runs (Jacobi, async, accelerated and plain; sync; under a
  scenario with crashes; the eval-cost loop): the iterate has the same
  bytes with telemetry off and on and as the reference (tolerance 0.0);
  the capture's summary matches the reference's (span counts by kind,
  staleness percentiles, fire ledger), and every event agrees with the
  reference's in kind, lane and disposition, with times to rtol 1e-12.
  Value iteration: iterates to 1e-12 relative, identical counts and
  summary.
* Results: a reference ``RunResult.to_dict()`` carrying a telemetry
  capture, worker-seconds and controller actions rebuilds through the
  port's ``from_dict`` with all four fields intact.
* Exporters and ``run_report``: the Chrome trace validates with one lane
  per worker incarnation, the JSONL stream and the CLI round-trip.
* The real backends: thread and process (one spawned CPU pool) runs carry
  a lane per worker; process workers ship their span batches; the device
  plane's fused block-local norm lands in ``device_local_norms`` on both
  (numpy oracle ``device_plane="ref"``), equal to the reference's on a
  one-worker run.
* ``apply_scenario_event(source=...)``: only scripted preempts and joins
  touch ``scenario_down``, as in the reference.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chaos as jc  # noqa: E402
import repro.problems as jp  # noqa: E402
import repro.telemetry as jt  # noqa: E402
from repro.autoscale import get_policy as j_get_policy  # noqa: E402
from repro.core import AndersonConfig as JAnderson  # noqa: E402
from repro.core import FaultProfile as JFault  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402
from repro.core.engine.coordinator import Coordinator as JCoordinator  # noqa: E402

import repro_torch.chaos as tc  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
import repro_torch.telemetry as tt  # noqa: E402
from repro_torch.autoscale import get_policy  # noqa: E402
from repro_torch.chaos.scenario import EVENT_KINDS  # noqa: E402
from repro_torch.chaos.trace import TRACE_EVENT_KINDS  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    FaultProfile,
    RunConfig,
    RunResult,
    run_fixed_point,
    shutdown_pools,
)
from repro_torch.core.engine.coordinator import Coordinator  # noqa: E402
from repro_torch.launch.run_report import main as run_report_main  # noqa: E402
from repro_torch.telemetry.export import (  # noqa: E402
    parse_prometheus,
    trace_lanes,
)

JAX = dict(tel=jt, chaos=jc, fault=JFault, cfg=JRunConfig, accel=JAnderson,
           run=j_run, probs=jp, device={})
PORT = dict(tel=tt, chaos=tc, fault=FaultProfile, cfg=RunConfig,
            accel=AndersonConfig, run=run_fixed_point, probs=tp,
            device=dict(device="cpu"))

#: event keys that depend only on the run (host-clock durations excluded)
_EVENT_KEYS = ("k", "lane", "disp", "s", "b", "v", "stale", "moved", "ev",
               "worker", "src", "wu", "tag", "offload", "offloaded")
_TIME_KEYS = ("t", "t0", "t1")


def _jac(pkg, grid=12):
    return pkg["probs"].JacobiProblem(grid=grid, sweeps=4, seed=0,
                                      **pkg["device"])


def _vi(pkg):
    p = pkg["probs"]
    return p.ValueIterationProblem(p.GarnetMDP(S=60, A=4, b=5, gamma=0.9,
                                               seed=0, **pkg["device"]))


def _virt_cfg(pkg, **kw):
    """The reference tests' virtual configuration (compute_time pinned so
    the virtual clock is deterministic)."""
    base = dict(executor="virtual", mode="async", n_workers=4, tol=1e-300,
                max_updates=400, compute_time=1e-3, seed=9,
                faults=pkg["fault"](delay_mean=2e-3, delay_std=1e-3))
    base.update(kw)
    return pkg["cfg"](**base)


def _summary(res):
    """The run-determined part of a telemetry summary (busy_frac_tail is
    a host-clock fraction on the virtual backend)."""
    s = dict(res.telemetry_summary)
    s.pop("busy_frac_tail")
    return s


def _assert_events_match(port_cap, ref_cap):
    assert len(port_cap.events) == len(ref_cap.events)
    for a, b in zip(port_cap.events, ref_cap.events):
        assert {k: a.get(k) for k in _EVENT_KEYS} == \
            {k: b.get(k) for k in _EVENT_KEYS}
        for k in _TIME_KEYS:
            assert (k in a) == (k in b)
            if k in a:
                assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-15)


#: virtual configurations held to the reference, byte for byte (Jacobi)
CASES = {
    "async_plain": dict(),
    "async_accel": dict(accel="m4", fire_every=4),
    "sync_accel": dict(mode="sync", accel="m4", fire_every=2,
                       max_updates=200),
    "scenario_crashes": dict(
        max_updates=1500, scenario="spot_wave",
        faults="crash"),
    "evalmodel_worker": dict(accel="m4", fire_every=4, accel_eval="worker"),
}


def _case_cfg(pkg, case, **extra):
    kw = dict(CASES[case])
    if kw.get("accel") == "m4":
        kw["accel"] = pkg["accel"](m=4)
    if kw.get("scenario") == "spot_wave":
        kw["scenario"] = pkg["chaos"].spot_wave(4).scaled(0.2)
    if kw.get("faults") == "crash":
        kw["faults"] = pkg["fault"](delay_mean=2e-3, crash_prob=0.02,
                                    restart_after=0.01)
    kw.update(extra)
    return _virt_cfg(pkg, **kw)


# --------------------------------------------------------------------- #
class TestTaxonomy:
    def test_registries_equal_the_reference(self):
        assert tt.SPAN_KINDS == jt.SPAN_KINDS
        assert tt.METRICS == jt.METRICS
        assert tt.SCENARIO_SPAN_MAP == jt.SCENARIO_SPAN_MAP
        assert tt.TRACE_SPAN_MAP == jt.TRACE_SPAN_MAP

    def test_port_event_kinds_map(self):
        assert set(EVENT_KINDS) <= set(tt.SCENARIO_SPAN_MAP)
        assert set(TRACE_EVENT_KINDS) <= set(tt.TRACE_SPAN_MAP)
        assert set(tt.SCENARIO_SPAN_MAP.values()) <= set(tt.SPAN_KINDS)
        assert set(tt.TRACE_SPAN_MAP.values()) <= set(tt.SPAN_KINDS)

    def test_emitted_kinds_and_series_are_registered(self):
        res = run_fixed_point(_jac(PORT), _case_cfg(
            PORT, "scenario_crashes", telemetry=True,
            accel=AndersonConfig(m=4), fire_every=4))
        kinds = {ev["k"] for ev in res.telemetry.events}
        assert kinds <= set(tt.SPAN_KINDS)
        assert {"scenario", "restart", "task", "fire", "record"} <= kinds
        assert set(res.telemetry.series) <= set(tt.METRICS)


# --------------------------------------------------------------------- #
class TestVirtualParity:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_bytes_off_on_and_reference(self, case):
        off = run_fixed_point(_jac(PORT), _case_cfg(PORT, case))
        on = run_fixed_point(_jac(PORT), _case_cfg(PORT, case,
                                                   telemetry=True))
        ref = j_run(_jac(JAX), _case_cfg(JAX, case, telemetry=True))
        assert off.telemetry is None and off.telemetry_summary is None
        assert on.x.tobytes() == off.x.tobytes() == ref.x.tobytes()
        assert on.history == off.history == ref.history
        assert on.wall_time == off.wall_time == ref.wall_time
        assert (on.worker_updates, on.accel_fires, on.accel_accepts) == \
            (ref.worker_updates, ref.accel_fires, ref.accel_accepts)
        assert on.fire_window_arrivals == ref.fire_window_arrivals

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_capture_matches_reference(self, case):
        on = run_fixed_point(_jac(PORT), _case_cfg(PORT, case,
                                                   telemetry=True))
        ref = j_run(_jac(JAX), _case_cfg(JAX, case, telemetry=True))
        assert _summary(on) == _summary(ref)
        assert on.telemetry_summary["span_counts"]["task"] > 0
        if on.accel_fires:
            assert sum(on.telemetry_summary["fires"].values()) == \
                on.accel_fires
            assert on.telemetry_summary["fires"].get("accept", 0) == \
                on.accel_accepts
        _assert_events_match(on.telemetry, ref.telemetry)
        assert set(on.telemetry.series) == set(ref.telemetry.series)
        assert on.telemetry.series["staleness"] == \
            ref.telemetry.series["staleness"]
        assert on.telemetry.series["residual"] == \
            ref.telemetry.series["residual"]

    def test_value_iteration_within_tolerance(self):
        on = run_fixed_point(_vi(PORT), _virt_cfg(
            PORT, telemetry=True, accel=AndersonConfig(m=4), fire_every=4))
        ref = j_run(_vi(JAX), _virt_cfg(
            JAX, telemetry=True, accel=JAnderson(m=4), fire_every=4))
        assert (on.worker_updates, on.accel_fires, on.accel_accepts) == \
            (ref.worker_updates, ref.accel_fires, ref.accel_accepts)
        rel = np.max(np.abs(on.x - ref.x)) / np.max(np.abs(ref.x))
        assert rel <= 1e-12
        assert _summary(on) == _summary(ref)

    def test_inline_observability(self):
        """Inline virtual fires meter no busy_s: the recorder's host-clock
        fraction and the open-task count fill coordinator_busy_frac and
        fire_window_arrivals, only when telemetry is on."""
        kw = dict(accel=AndersonConfig(m=4), fire_every=4, max_updates=600)
        off = run_fixed_point(_jac(PORT), _virt_cfg(PORT, **kw))
        on = run_fixed_point(_jac(PORT), _virt_cfg(PORT, telemetry=True,
                                                   **kw))
        assert off.coordinator_busy_frac == 0.0
        assert off.fire_window_arrivals == 0
        assert on.coordinator_busy_frac > 0.0
        assert on.fire_window_arrivals > 0
        assert on.x.tobytes() == off.x.tobytes()

    def test_checkpoint_spans_and_restore_instant(self, tmp_path):
        from repro_torch.recover import (
            SolveCheckpoint,
            list_checkpoints,
            resume_fixed_point,
        )

        kw = dict(telemetry=True, max_updates=300, checkpoint_every=100,
                  checkpoint_dir=str(tmp_path))
        res = run_fixed_point(_jac(PORT), _virt_cfg(PORT, **kw))
        counts = res.telemetry_summary["span_counts"]
        assert counts.get("checkpoint", 0) == res.checkpoints_written == 3
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[0])
        resumed = resume_fixed_point(_jac(PORT), _virt_cfg(PORT, **kw), ck)
        ev = [e for e in resumed.telemetry.events if e["k"] == "restore"]
        assert len(ev) == 1 and ev[0]["tag"] == ck.tag
        assert ev[0]["t"] == ck.t and ev[0]["wu"] == ck.wu
        assert resumed.x.tobytes() == res.x.tobytes()


# --------------------------------------------------------------------- #
class TestResultsRoundTrip:
    def test_reference_result_dict_rebuilds_in_the_port(self):
        """The four fields the port lacked (``worker_seconds``,
        ``controller_actions``, ``telemetry``, ``telemetry_summary``)
        survive a reference ``to_dict`` -> port ``from_dict``."""
        ref = j_run(_jac(JAX), _virt_cfg(
            JAX, telemetry=True, tol=1e-6, max_updates=10 ** 5,
            controller=j_get_policy("static", size=2)))
        d = json.loads(json.dumps(ref.to_dict(include_history=False)))
        assert ref.worker_seconds > 0.0 and ref.controller_actions == 2
        back = RunResult.from_dict(d)
        assert back.worker_seconds == ref.worker_seconds
        assert back.controller_actions == 2
        assert back.telemetry_summary == ref.telemetry_summary
        assert back.telemetry == ref.telemetry.to_dict()
        cap = tt.TelemetryCapture.from_dict(back.telemetry)
        assert cap.events == ref.telemetry.events
        assert cap.summary == ref.telemetry.summary
        assert back.to_dict(include_history=False) == d

    def test_port_result_round_trips_and_tolerates_unknown_keys(self):
        res = run_fixed_point(_jac(PORT), _virt_cfg(
            PORT, telemetry=True, accel=AndersonConfig(m=4), fire_every=4))
        d = res.to_dict(include_history=False)
        assert d["telemetry_summary"] == res.telemetry_summary
        d["telemetry_summary"]["future_field"] = 123
        d["a_key_from_the_future"] = {"x": 1}
        back = RunResult.from_dict(json.loads(json.dumps(d)))
        assert back.telemetry["events"] == res.telemetry.to_dict()["events"]
        assert back.telemetry_summary["future_field"] == 123

    def test_capture_loads_in_both_packages(self):
        cap = run_fixed_point(_jac(PORT), _virt_cfg(
            PORT, telemetry=True)).telemetry
        d = json.loads(json.dumps(cap.to_dict()))
        assert jt.TelemetryCapture.from_dict(d).to_dict() == cap.to_dict()
        with pytest.raises(ValueError):
            tt.TelemetryCapture.from_dict({"version": 999})


# --------------------------------------------------------------------- #
class TestRecorder:
    def _drive(self, pkg):
        rec = pkg["tel"].TelemetryRecorder(
            pkg["tel"].TelemetryConfig(ring_size=6, series_every=2))
        rec.set_time(0.5)
        rec.task_open(0, 1.0)
        rec.task_open(1, 1.5, gen=2, block=3)
        rec.task_close(1, 2.0, disp="applied", staleness=4, gen=2)
        rec.task_close(7, 3.0)  # unknown (worker, gen): no span
        for s in [1] * 60 + [5] * 35 + [9] * 5:
            rec.observe_staleness(s)
        rec.fire_span(1.0, 1.25, "accept", stale=0, moved=0)
        rec.merge_worker_batch(2, [(0.5, 0.2, "compute")], recv_t=3.0)
        for i in range(6):
            rec.instant("restart", "w0", float(i))
        rec.series_point("residual", 1.0, 0.5)
        return rec

    def test_same_emits_same_capture(self):
        j, t = self._drive(JAX), self._drive(PORT)
        assert t.events == j.events and t.dropped == j.dropped == 3
        assert t.summary() == j.summary()
        assert t.open_tasks == j.open_tasks == 1
        assert [t.staleness_percentile(q) for q in (0.5, 0.95, 1.0)] == \
            [1.0, 5.0, 9.0]

    def test_config_validation(self):
        with pytest.raises(ValueError):
            tt.TelemetryConfig(ring_size=0)
        with pytest.raises(ValueError):
            tt.TelemetryConfig(worker_batch=0)
        with pytest.raises(TypeError):
            tt.as_telemetry_config("yes")
        assert tt.as_telemetry_config(True) == tt.TelemetryConfig()
        assert tt.worker_lane(3) == "w3" and tt.worker_lane(3, 2) == "w3#r2"


# --------------------------------------------------------------------- #
class TestExporters:
    def _capture(self):
        return run_fixed_point(_jac(PORT), _case_cfg(
            PORT, "scenario_crashes", telemetry=True)).telemetry

    def test_chrome_trace_schema_and_lanes(self):
        cap = self._capture()
        doc = tt.to_chrome_trace(cap)
        assert tt.validate_chrome_trace(doc) == []
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name"}
        assert names == set(trace_lanes(cap))
        assert {"w0", "w1", "w2", "w3"} <= names
        assert any("#r1" in n for n in names)  # rejoined incarnations
        errs = tt.validate_chrome_trace({"traceEvents": [
            {"ph": "X", "pid": 1, "tid": 0, "ts": 5.0, "dur": -1.0}]})
        assert any("dur" in e for e in errs)

    def test_chrome_and_jsonl_match_the_reference_exporters(self):
        cap = self._capture()
        ref = jt.TelemetryCapture.from_dict(cap.to_dict())
        assert tt.to_chrome_trace(cap) == jt.to_chrome_trace(ref)
        assert tt.to_jsonl(cap) == jt.to_jsonl(ref)

    def test_run_report_round_trips(self, tmp_path, capsys):
        cap = self._capture()
        p = tmp_path / "cap.json"
        cap.save(str(p))
        chrome, jsonl = tmp_path / "out.trace.json", tmp_path / "out.jsonl"
        assert run_report_main([str(p), "--chrome", str(chrome),
                                "--jsonl", str(jsonl), "--validate"]) == 0
        assert tt.validate_chrome_trace(json.loads(chrome.read_text())) == []
        assert jsonl.read_text().count("\n") == len(cap.events) + 2
        assert "chrome trace: valid" in capsys.readouterr().out
        # A RunResult dict carrying a capture loads too; garbage does not.
        res = run_fixed_point(_jac(PORT), _virt_cfg(PORT, telemetry=True))
        p2 = tmp_path / "result.json"
        p2.write_text(json.dumps(res.to_dict(include_history=False)))
        assert run_report_main([str(p2)]) == 0
        p3 = tmp_path / "bad.json"
        p3.write_text('{"no": "telemetry"}')
        assert run_report_main([str(p3)]) == 2

    def test_prometheus_parse_rejects_malformed(self):
        with pytest.raises(ValueError):
            parse_prometheus("this is { not exposition\n")


# --------------------------------------------------------------------- #
class TestScenarioSource:
    @staticmethod
    def _preempt_join(pkg, coord_cls, source, **kw):
        coord = coord_cls(_jac(pkg), _virt_cfg(pkg, **kw))
        coord.apply_scenario_event(
            pkg["chaos"].ScenarioEvent(0.25, "preempt", 2), 0.25,
            source=source)
        after_preempt = set(coord.scenario_down)
        coord.apply_scenario_event(
            pkg["chaos"].ScenarioEvent(0.5, "join", 2), 0.5, source=source)
        return coord, after_preempt

    @pytest.mark.parametrize("source,down", [("script", {2}),
                                             ("controller", set())])
    def test_only_scripted_events_mark_scenario_down(self, source, down):
        (t, t_down), (j, j_down) = (
            self._preempt_join(PORT, Coordinator, source),
            self._preempt_join(JAX, JCoordinator, source))
        assert t_down == j_down == down
        assert t.scenario_down == j.scenario_down == set()
        assert t.active == j.active == {0, 1, 2, 3}
        assert (t.preemptions, t.joins) == (j.preemptions, j.joins) == (1, 1)

    @pytest.mark.parametrize("source", ["script", "controller"])
    def test_scenario_instants_carry_the_source(self, source):
        (t, _), (j, _) = (
            self._preempt_join(PORT, Coordinator, source, telemetry=True),
            self._preempt_join(JAX, JCoordinator, source, telemetry=True))
        assert list(t.telemetry.events) == list(j.telemetry.events)
        assert [e["src"] for e in t.telemetry.events] == [source] * 2

    def test_default_source_is_the_scripts(self):
        coord = Coordinator(_jac(PORT), _virt_cfg(PORT))
        coord.apply_scenario_event(tc.ScenarioEvent(0.1, "preempt", 1), 0.1)
        assert coord.scenario_down == {1}


# --------------------------------------------------------------------- #
def _real_cfg(executor, **kw):
    base = dict(executor=executor, mode="async", n_workers=4, seed=6,
                max_updates=120, tol=1e-300, device_plane="ref",
                telemetry=tt.TelemetryConfig(worker_batch=8))
    base.update(kw)
    return RunConfig(**base)


def _ref_one_worker_norm():
    """The reference's fused block-local norm after a one-worker
    device-plane run (thread backend, numpy oracle)."""
    res_cfg = JRunConfig(executor="thread", mode="async", n_workers=1,
                         seed=6, max_updates=40, tol=1e-300,
                         device_plane="ref")
    captured = {}
    import repro.core.engine.coordinator as jcoord

    orig = jcoord.Coordinator.result

    def spy(self, *a, **k):
        captured.update(self.device_local_norms)
        return orig(self, *a, **k)

    jcoord.Coordinator.result = spy
    try:
        res = j_run(_jac(JAX, grid=16), res_cfg)
    finally:
        jcoord.Coordinator.result = orig
    return captured, res


class TestRealBackends:
    def test_thread_lanes_eval_spans_and_device_norms(self):
        res = run_fixed_point(_jac(PORT, grid=16), _real_cfg(
            "thread", accel=AndersonConfig(m=4), fire_every=4))
        cap = res.telemetry
        assert {"w0", "w1", "w2", "w3"} <= set(trace_lanes(cap))
        assert res.device_dispatches > 0
        counts = res.telemetry_summary["span_counts"]
        assert counts["task"] >= res.worker_updates
        assert sum(res.telemetry_summary["fires"].values()) == \
            res.accel_fires > 0
        assert res.telemetry_summary["staleness_n"] == res.worker_updates
        assert tt.validate_chrome_trace(tt.to_chrome_trace(cap)) == []
        off = run_fixed_point(_jac(PORT, grid=16), _real_cfg(
            "thread", device_plane="off", accel=AndersonConfig(m=4),
            fire_every=4, accel_eval="worker"))
        assert off.telemetry_summary["span_counts"].get("eval", 0) > 0

    @pytest.mark.parametrize("executor", ["thread", "process"])
    def test_device_local_norms(self, executor, monkeypatch):
        """Every active device-plane worker's fused norm is kept (the
        process workers send it in their "okd" messages); with one worker
        (a deterministic trajectory) it equals the reference's."""
        import repro_torch.core.engine.coordinator as tcoord

        seen = {}
        orig = tcoord.Coordinator.result

        def spy(self, *a, **k):
            seen.clear()
            seen.update(self.device_local_norms)
            return orig(self, *a, **k)

        monkeypatch.setattr(tcoord.Coordinator, "result", spy)
        try:
            res = run_fixed_point(_jac(PORT, grid=16),
                                  _real_cfg(executor, telemetry=None))
            assert res.device_dispatches > 0
            assert set(seen) == {0, 1, 2, 3}
            assert all(np.isfinite(v) and v >= 0.0 for v in seen.values())
            one = run_fixed_point(_jac(PORT, grid=16), _real_cfg(
                executor, n_workers=1, max_updates=40, telemetry=None))
            want, ref = _ref_one_worker_norm()
            assert one.x.tobytes() == ref.x.tobytes()
            assert seen == want and set(seen) == {0}
        finally:
            shutdown_pools()

    def test_process_worker_span_batches(self):
        try:
            res = run_fixed_point(_jac(PORT, grid=16), _real_cfg("process"))
        finally:
            shutdown_pools()
        worker = [e for e in res.telemetry.events if e.get("src") == "worker"]
        assert worker and {e["k"] for e in worker} == {"compute"}
        assert {e["lane"] for e in worker} <= {"w0", "w1", "w2", "w3"}
        assert all(e["t1"] >= e["t0"] >= 0.0 for e in worker)
        assert {"pool_leases", "pool_respawns"} <= set(res.telemetry.series)
        assert res.telemetry.series["pool_leases"] == [[0.0, 1.0]]
        assert "pool_runs_served" in res.telemetry.meta


def test_telemetry_config_ships_to_workers():
    """``TelemetryConfig`` rides in the process backend's ``"run"`` task:
    it must pickle from ``repro_torch.telemetry``."""
    import pickle

    cfg = tt.TelemetryConfig(worker_batch=4)
    back = pickle.loads(pickle.dumps(dataclasses.replace(cfg)))
    assert back == cfg and type(back).__module__ == \
        "repro_torch.telemetry.recorder"
