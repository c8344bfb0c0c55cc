"""The port's solver service (``repro_torch.serve``) against the JAX
package's.

* ``FairScheduler``: the same push/pop script gives the reference's
  dispatch order (single-tenant FIFO, weighted drain, no banked credit,
  the bounded family-affinity detour and its zero-slack off switch).
* ``SolverService`` on the virtual backend: each request returns the
  bytes of a solo run of the same problem and of the reference service
  (Jacobi, tolerance 0.0); two problem families (Jacobi and value
  iteration) multiplexed through one service keep their solo results.
* The control surface as ``tests/test_serve.py`` pins it: bounded
  admission, cancellation of queued requests, failure delivery through
  tickets, weighted dispatch order, ``drain``/``close`` semantics,
  request families keyed like the pools, and config validation.
* Crash retries: a scripted ``coordinator_crash`` with checkpoints is
  resumed from the latest checkpoint through the port's ``recover`` and
  ends on the reference service's bytes.
* Telemetry: the serve spans and the Prometheus exposition; the
  ``solver_serve`` launcher runs end to end on the CPU.
"""

import time

import pytest

torch = pytest.importorskip("torch")

import repro.chaos as jc  # noqa: E402
import repro.problems as jp  # noqa: E402
import repro.serve as js  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402

import repro_torch.chaos as tc  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
import repro_torch.serve as ts  # noqa: E402
from repro_torch.core import RunConfig, run_fixed_point  # noqa: E402
from repro_torch.core.engine.coordinator import problem_payload  # noqa: E402
from repro_torch.core.engine.poolreg import payload_key  # noqa: E402
from repro_torch.telemetry import to_prometheus  # noqa: E402
from repro_torch.telemetry.export import parse_prometheus  # noqa: E402

JAX = dict(serve=js, chaos=jc, cfg=JRunConfig, run=j_run, probs=jp,
           device={})
PORT = dict(serve=ts, chaos=tc, cfg=RunConfig, run=run_fixed_point,
            probs=tp, device=dict(device="cpu"))


def _jac(pkg, seed=0, grid=10):
    return pkg["probs"].JacobiProblem(grid=grid, sweeps=4, seed=seed,
                                      **pkg["device"])


def _vi(pkg, seed=0):
    p = pkg["probs"]
    return p.ValueIterationProblem(p.GarnetMDP(S=40, A=3, b=4, gamma=0.9,
                                               seed=seed, **pkg["device"]))


def _virt_cfg(pkg, **kw):
    base = dict(executor="virtual", mode="async", n_workers=4, tol=1e-6,
                max_updates=2000, compute_time=1e-3, seed=0)
    base.update(kw)
    return pkg["cfg"](**base)


class SlowJacobi(tp.JacobiProblem):
    """Each block update sleeps, so a dispatched request occupies its
    dispatcher long enough for queue-shape tests to be deterministic."""

    def __init__(self, sleep_s=0.02):
        super().__init__(grid=4, sweeps=1, seed=0, device="cpu")
        self.sleep_s = sleep_s

    def block_update(self, x, indices):
        time.sleep(self.sleep_s)
        return super().block_update(x, indices)


def _slow_cfg():
    return _virt_cfg(PORT, tol=0.0, max_updates=8, n_workers=1)


def _started(svc, tenant="warmup"):
    """Submit a slow request and wait until a dispatcher holds it."""
    first = svc.submit(SlowJacobi(), _slow_cfg(), tenant=tenant)
    while first.dispatched_s is None:
        time.sleep(0.001)
    return first


# --------------------------------------------------------------------- #
def _sched_script(pkg):
    """One push/pop script through a package's scheduler; returns the
    dispatch order as (tenant, family, seq) tuples."""
    S, Q = pkg["serve"].FairScheduler, pkg["serve"].QueuedRequest
    out = []

    def req(t, fam="f", cost=1.0):
        return Q(t, fam, cost, ticket=None)

    s = S(weights={"a": 3.0, "b": 1.0}, affinity_slack=1.5)
    for k in range(6):
        s.push(req("a", fam=f"fa{k % 2}"))
        s.push(req("b", fam="fb", cost=0.5 + k))
    for _ in range(4):
        r = s.pop(prefer_family="fb")
        out.append((r.tenant, r.family, r.seq))
    s.push(req("idle"))  # no banked credit: starts at the current vtime
    while len(s):
        r = s.pop(prefer_family="fa1")
        out.append((r.tenant, r.family, r.seq))
    return out


class TestFairScheduler:
    def test_dispatch_order_matches_reference(self):
        assert _sched_script(PORT) == _sched_script(JAX)

    def test_single_tenant_is_fifo(self):
        s = ts.FairScheduler()
        reqs = [ts.QueuedRequest("t", "f", 1.0, ticket=None)
                for _ in range(5)]
        for r in reqs:
            s.push(r)
        assert [s.pop() for _ in range(5)] == reqs and s.pop() is None

    def test_weighted_drain_and_affinity(self):
        s = ts.FairScheduler(weights={"a": 3.0, "b": 1.0})
        for _ in range(6):
            s.push(ts.QueuedRequest("a", "f", 1.0, None))
            s.push(ts.QueuedRequest("b", "f", 1.0, None))
        assert [s.pop().tenant for _ in range(4)].count("a") == 3
        cold = ts.QueuedRequest("t", "cold", 1.0, None)
        warm = ts.QueuedRequest("t", "warm", 1.0, None)
        for slack, want in ((10.0, warm), (0.0, cold)):
            s = ts.FairScheduler(affinity_slack=slack)
            s.push(cold)
            s.push(warm)
            assert s.pop(prefer_family="warm") is want
        assert s.remove(cold) is False and s.remove(warm) is True

    def test_invalid_weights_raise(self):
        with pytest.raises(ValueError):
            ts.FairScheduler(weights={"t": 0.0})
        with pytest.raises(ValueError):
            ts.FairScheduler(default_weight=-1.0)


# --------------------------------------------------------------------- #
class TestSolverService:
    def test_results_match_solo_and_reference_service(self):
        cfgs = [_virt_cfg(PORT), _virt_cfg(JAX)]

        def serve(pkg, cfg):
            probs = [_jac(pkg, seed=k) for k in range(3)]
            with pkg["serve"].SolverService(
                    pkg["serve"].ServiceConfig(max_active=2)) as svc:
                tickets = [svc.submit(p, cfg, tenant=f"t{k % 2}")
                           for k, p in enumerate(probs)]
                return [t.result(timeout=120.0) for t in tickets]

        got, ref = serve(PORT, cfgs[0]), serve(JAX, cfgs[1])
        solo = [run_fixed_point(_jac(PORT, seed=k), cfgs[0])
                for k in range(3)]
        for g, r, s in zip(got, ref, solo):
            assert g.x.tobytes() == s.x.tobytes() == r.x.tobytes()
            assert g.history == s.history == r.history
            assert g.worker_updates == r.worker_updates

    def test_two_families_multiplexed(self):
        """Jacobi and value-iteration requests through one service keep
        their solo results (the port's two main-path families)."""
        cfg = _virt_cfg(PORT, tol=1e-8)
        probs = [_jac(PORT, seed=1), _vi(PORT, seed=2), _jac(PORT, seed=3),
                 _vi(PORT, seed=4)]
        with ts.SolverService(ts.ServiceConfig(
                max_active=2, weights={"a": 2.0, "b": 1.0})) as svc:
            tickets = [svc.submit(p, cfg, tenant="ab"[k % 2])
                       for k, p in enumerate(probs)]
            results = [t.result(timeout=120.0) for t in tickets]
            stats = svc.stats()
        assert stats["served"] == {"a": 2, "b": 2} and stats["failed"] == 0
        for p, r in zip(probs, results):
            solo = run_fixed_point(p, cfg)
            assert r.x.tobytes() == solo.x.tobytes()
            assert r.residual_norm < p.residual_norm(p.initial())
        assert len({tk.family for tk in tickets}) == 4

    def test_ticket_timing_stamps(self):
        with ts.SolverService(ts.ServiceConfig(max_active=1)) as svc:
            t = svc.submit(_jac(PORT), _virt_cfg(PORT))
            t.result(timeout=60.0)
        assert t.done()
        assert t.queued_s <= t.dispatched_s <= t.finished_s
        assert t.wait_s >= 0.0 and t.total_s >= t.wait_s

    def test_admission_bound(self):
        svc = ts.SolverService(ts.ServiceConfig(max_active=1,
                                                max_pending=1))
        try:
            _started(svc)
            svc.submit(SlowJacobi(), _slow_cfg())  # fills the queue
            with pytest.raises(ts.AdmissionError):
                svc.submit(SlowJacobi(), _slow_cfg())
            assert svc.stats()["rejected"] == 1
        finally:
            svc.close()

    def test_cancel_pending_request(self):
        svc = ts.SolverService(ts.ServiceConfig(max_active=1))
        try:
            first = _started(svc)
            queued = svc.submit(SlowJacobi(), _slow_cfg())
            assert queued.cancel() is True
            with pytest.raises(RuntimeError, match="cancelled"):
                queued.result(timeout=1.0)
            assert first.cancel() is False  # already dispatched
            first.result(timeout=60.0)
        finally:
            svc.close()

    def test_failure_delivered_through_ticket(self):
        class Exploding(tp.JacobiProblem):
            def block_update(self, x, indices):
                raise ValueError("boom")

        with ts.SolverService(ts.ServiceConfig(max_active=1)) as svc:
            ok = svc.submit(_jac(PORT), _virt_cfg(PORT))
            bad = svc.submit(Exploding(grid=8, device="cpu"),
                             _virt_cfg(PORT))
            with pytest.raises(ValueError, match="boom"):
                bad.result(timeout=60.0)
            ok.result(timeout=60.0)  # the failure did not poison the service
            stats = svc.stats()
        assert stats["failed"] == 1 and sum(stats["served"].values()) == 1

    def test_weighted_dispatch_order(self):
        svc = ts.SolverService(ts.ServiceConfig(
            max_active=1, weights={"a": 3.0, "b": 1.0},
            family_affinity=False))
        try:
            _started(svc)
            tickets = []
            for _ in range(4):
                for tenant in ("a", "b"):
                    tickets.append(svc.submit(SlowJacobi(), _slow_cfg(),
                                              tenant=tenant))
            for t in tickets:
                t.result(timeout=60.0)
        finally:
            svc.close()
        order = sorted(tickets, key=lambda t: t.dispatched_s)
        prefix = [t.tenant for t in order[:4]]
        assert prefix.count("a") == 3 and prefix.count("b") == 1

    def test_drain_and_close_semantics(self):
        svc = ts.SolverService(ts.ServiceConfig(max_active=1))
        t = svc.submit(_jac(PORT), _virt_cfg(PORT))
        assert svc.drain(timeout=60.0) is True and t.done()
        svc.close()
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit(_jac(PORT), _virt_cfg(PORT))

    def test_close_without_drain_cancels_pending(self):
        svc = ts.SolverService(ts.ServiceConfig(max_active=1))
        first = _started(svc)
        queued = svc.submit(SlowJacobi(), _slow_cfg())
        svc.close(drain=False)
        with pytest.raises(RuntimeError, match="cancelled"):
            queued.result(timeout=1.0)
        first.result(timeout=60.0)  # running solves always complete

    def test_request_family_matches_pool_keying(self):
        p, cfg = _jac(PORT), _virt_cfg(PORT)
        assert ts.request_family(p, cfg) == \
            payload_key(problem_payload(p), cfg)
        assert ts.request_family(p, cfg) != ts.request_family(
            p, _virt_cfg(PORT, n_workers=2))
        assert ts.request_family(p, cfg) != ts.request_family(
            _jac(PORT, seed=1), cfg)

    def test_service_config_validation(self):
        with pytest.raises(ValueError):
            ts.ServiceConfig(max_active=0)
        with pytest.raises(ValueError):
            ts.ServiceConfig(max_pending=0)


# --------------------------------------------------------------------- #
class TestCrashRetries:
    def _crash_cfg(self, pkg, d):
        return _virt_cfg(pkg, n_workers=4, seed=7, tol=1e-300,
                         max_updates=1500, checkpoint_every=100,
                         checkpoint_dir=str(d),
                         scenario=pkg["chaos"].FaultScenario()
                         .coordinator_crash(0.2))

    def test_retry_resumes_from_checkpoint_like_the_reference(self,
                                                              tmp_path):
        def serve(pkg, d):
            svc = pkg["serve"].SolverService(pkg["serve"].ServiceConfig(
                max_active=1, crash_retries=1))
            try:
                r = svc.submit(_jac(pkg), self._crash_cfg(pkg, d)).result(
                    timeout=120.0)
                return r, svc.stats()
            finally:
                svc.close()

        (tr, tst), (jr, jst) = (serve(PORT, tmp_path / "port"),
                                serve(JAX, tmp_path / "ref"))
        assert tst["crash_resumes"] == jst["crash_resumes"] == 1
        assert tst["failed"] == 0
        assert tr.worker_updates == jr.worker_updates == 1500
        assert tr.resumed_from == jr.resumed_from is not None
        assert tr.x.tobytes() == jr.x.tobytes()

    def test_without_retries_the_ticket_fails(self, tmp_path):
        from repro_torch.core import CoordinatorCrash

        svc = ts.SolverService(ts.ServiceConfig(max_active=1))
        try:
            t = svc.submit(_jac(PORT), self._crash_cfg(PORT, tmp_path))
            with pytest.raises(CoordinatorCrash):
                t.result(timeout=120.0)
            assert svc.stats()["failed"] == 1
        finally:
            svc.close()


# --------------------------------------------------------------------- #
class TestServeTelemetry:
    def test_prometheus_exposition_and_serve_spans(self):
        cfg = _virt_cfg(PORT, n_workers=2)
        with ts.SolverService(ts.ServiceConfig(max_active=2,
                                               telemetry=True)) as svc:
            tickets = [svc.submit(_jac(PORT, seed=k), cfg,
                                  tenant=f"t{k % 2}") for k in range(3)]
            for t in tickets:
                t.result(timeout=60.0)
            text = to_prometheus(svc)
        parsed = parse_prometheus(text)
        assert parsed['repro_serve_served_total{tenant="t0"}'] == 2.0
        assert parsed['repro_serve_served_total{tenant="t1"}'] == 1.0
        assert 'repro_serve_wait_seconds{quantile="0.5"}' in parsed
        assert 'repro_serve_request_seconds{quantile="0.95"}' in parsed
        assert parsed["repro_serve_queue_depth"] >= 0.0
        spans = [e for e in svc.telemetry.events if e["k"] == "serve"]
        assert len(spans) == 3
        assert {e["lane"] for e in spans} == {"tenant:t0", "tenant:t1"}

    def test_prometheus_without_recorder_still_renders(self):
        with ts.SolverService(ts.ServiceConfig(max_active=1)) as svc:
            assert svc.telemetry is None
            parsed = parse_prometheus(to_prometheus(svc))
        assert parsed["repro_serve_pending"] == 0.0
        assert "repro_serve_queue_depth" not in parsed

    def test_controller_sees_the_service_backlog(self):
        """The service installs its queue depth on a request's controller
        (the serve -> autoscale loop)."""
        from repro_torch.autoscale import Controller

        seen = []

        class Spy(Controller):
            name = "spy"

            def decide(self, sig):
                seen.append(sig.queue_depth)
                return []

        svc = ts.SolverService(ts.ServiceConfig(max_active=1))
        try:
            _started(svc)
            spied = svc.submit(_jac(PORT), _virt_cfg(PORT, controller=Spy()))
            svc.submit(SlowJacobi(), _slow_cfg())
            spied.result(timeout=60.0)
        finally:
            svc.close()
        assert seen and seen[0] == 1


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "--grid", "12", "--requests", "3", "--tenants",
     "a,b"],
    ["--device", "cpu", "--problem", "vi", "--states", "200",
     "--executor", "thread", "--requests", "2", "--max-updates", "40"],
])
def test_solver_serve_launcher_runs_on_the_cpu(argv, capsys):
    from repro_torch.launch.solver_serve import main

    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "requests in" in out and "served by tenant" in out


def test_solver_serve_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.solver_serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--grid", "8", "--requests", "1"])
