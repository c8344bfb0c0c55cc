"""Solver-as-a-service: multiplex solve requests over shared warm pools.

:class:`SolverService` fronts the session engine with a request queue:

- **admission control** — at most ``max_pending`` queued requests; beyond
  that :meth:`SolverService.submit` raises
  :class:`~repro_torch.serve.scheduler.AdmissionError` immediately instead of
  building unbounded backlog (the caller decides whether to retry/shed);
- **weighted-fair scheduling** — dispatch order across tenants comes from
  :class:`~repro_torch.serve.scheduler.FairScheduler` (start-time fair queuing:
  a weight-2 tenant drains twice as fast under contention, single-tenant
  degenerates to FIFO);
- **same-payload batching** — each dispatcher remembers the payload family
  it just served and asks the scheduler for another request of that family
  (within the fairness slack), so back-to-back requests ride one warm
  worker pool.  Pool *sharing* itself is the engine's job: sessions of one
  family hold refcounted leases on a single pool
  (:mod:`repro_torch.core.engine.poolreg`) whichever order they dispatch in —
  affinity just minimizes run-lock interleaving and LRU churn;
- **sessions** — every request executes as its own
  :class:`~repro_torch.core.engine.session.SolveSession` on one of
  ``max_active`` dispatcher threads, so the backends' reentrancy does the
  actual multiplexing.

The service is deliberately in-process (a library object, not a server):
the launch CLI (``repro_torch.launch.solver_serve``) drives it directly,
and anything network-facing can wrap :meth:`submit`/:meth:`Ticket.result`
1:1.  Two requests of different families run as two sessions at once; on
the card their kernels share the one device (each session has its own
problem, device-plane plans and Anderson window).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..core.engine import RunConfig, RunResult, get_executor
from ..core.engine.coordinator import problem_payload
from ..core.engine.poolreg import payload_key
from ..core.engine.types import CoordinatorCrash
from ..recover import latest_checkpoint, resume_config
from .scheduler import AdmissionError, FairScheduler, QueuedRequest

__all__ = ["ServiceConfig", "SolverService", "Ticket"]


@dataclass
class ServiceConfig:
    """Knobs for one :class:`SolverService` instance."""

    max_active: int = 2  # dispatcher threads == concurrently running solves
    max_pending: int = 64  # queue bound; beyond it submit() raises
    weights: Dict[str, float] = field(default_factory=dict)  # tenant -> weight
    default_weight: float = 1.0  # weight for tenants not listed
    family_affinity: bool = True  # batch same-payload requests per dispatcher
    affinity_slack: float = 0.5  # max virtual-tag detour for an affinity pick
    # Coordinator-crash recovery: when a dispatched solve dies with
    # CoordinatorCrash and the request was checkpointing
    # (cfg.checkpoint_dir), resubmit it from the latest checkpoint up to
    # this many times before failing the ticket.  Commits are at-most-once:
    # checkpoints are written at arrival boundaries, so work applied after
    # the snapshot is redone by the resumed run, never double-counted.
    crash_retries: int = 0
    # Service-plane telemetry: a recorder on the service itself collecting
    # one "serve" span per request (admission -> dispatch -> finish, with
    # tenant and queueing delay) and a queue-depth series.  Feeds
    # repro_torch.telemetry.export.to_prometheus; independent of any per-run
    # RunConfig.telemetry the requests may carry.
    telemetry: bool = False

    def __post_init__(self) -> None:
        if self.max_active < 1:
            raise ValueError("max_active must be >= 1")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")


class Ticket:
    """Caller's handle on one submitted request (future-like).

    Timing fields are ``time.monotonic`` stamps: ``queued_s`` at admission,
    ``dispatched_s`` when a dispatcher picked it up, ``finished_s`` when the
    result (or error) landed — ``dispatched_s - queued_s`` is queueing
    delay, ``finished_s - dispatched_s`` is service time.
    """

    def __init__(self, tenant: str, family):
        self.tenant = tenant
        self.family = family
        self.queued_s = time.monotonic()
        self.dispatched_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self._done = threading.Event()
        self._result: Optional[RunResult] = None
        self._exception: Optional[BaseException] = None
        self._cancelled = False
        self._request: Optional[QueuedRequest] = None  # set by the service
        self._service: Optional["SolverService"] = None

    # -- service side -------------------------------------------------- #
    def _finish(self, result=None, exception=None) -> None:
        self._result = result
        self._exception = exception
        self.finished_s = time.monotonic()
        self._done.set()

    # -- caller side --------------------------------------------------- #
    def cancel(self) -> bool:
        """Withdraw the request if it has not been dispatched yet."""
        svc = self._service
        if svc is None:
            return False
        with svc._cond:
            if self._done.is_set() or self.dispatched_s is not None:
                return False
            svc._scheduler.remove(self._request)
            self._cancelled = True
            self._finish()
            svc._cond.notify_all()
        return True

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RunResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not finished after {timeout}s")
        if self._cancelled:
            raise RuntimeError("request was cancelled")
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    @property
    def wait_s(self) -> Optional[float]:
        """Queueing delay (None until dispatched)."""
        if self.dispatched_s is None:
            return None
        return self.dispatched_s - self.queued_s

    @property
    def total_s(self) -> Optional[float]:
        """Admission-to-result latency (None until finished)."""
        if self.finished_s is None:
            return None
        return self.finished_s - self.queued_s


def request_family(problem, cfg: RunConfig):
    """Stable payload-family key for batching/affinity decisions.

    Same key as the engine's pool registry wherever the problem can cross
    process boundaries; problems that cannot (no factory_spec, unpicklable)
    fall back to instance identity — they never pool anyway.
    """
    try:
        return payload_key(problem_payload(problem), cfg)
    except Exception:
        return (f"obj:{id(problem)}", cfg.n_workers, cfg.return_mode)


class SolverService:
    """In-process solve-request multiplexer over the session engine."""

    def __init__(self, config: Optional[ServiceConfig] = None):
        self.config = config or ServiceConfig()
        self._scheduler = FairScheduler(
            weights=self.config.weights,
            default_weight=self.config.default_weight,
            affinity_slack=(self.config.affinity_slack
                            if self.config.family_affinity else 0.0))
        self._cond = threading.Condition()
        self._closed = False
        self._active = 0
        self._served: Dict[str, int] = {}  # tenant -> completed requests
        self._failed = 0
        self._rejected = 0
        self._crash_resumes = 0  # coordinator crashes resumed from checkpoint
        self.telemetry = None
        self._tel_t0 = time.monotonic()
        if self.config.telemetry:
            from ..telemetry import TelemetryRecorder

            self.telemetry = TelemetryRecorder(
                meta={"service": True,
                      "max_active": self.config.max_active})
            self.telemetry.install_clock(
                lambda: time.monotonic() - self._tel_t0)
        self._dispatchers = [
            threading.Thread(target=self._dispatch_loop, args=(i,),
                             name=f"solver-serve-{i}", daemon=True)
            for i in range(self.config.max_active)
        ]
        for th in self._dispatchers:
            th.start()

    # ------------------------------------------------------------------ #
    def submit(self, problem, cfg: RunConfig, tenant: str = "default",
               cost: float = 1.0) -> Ticket:
        """Admit one solve request; returns immediately with a Ticket.

        Raises :class:`AdmissionError` when the pending queue is full and
        RuntimeError after :meth:`close` — submission never blocks.
        """
        family = request_family(problem, cfg)
        ticket = Ticket(tenant, family)
        req = QueuedRequest(tenant, family, cost, ticket)
        req.problem, req.cfg = problem, cfg
        ticket._request = req
        ticket._service = self
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            if len(self._scheduler) >= self.config.max_pending:
                self._rejected += 1
                raise AdmissionError(
                    f"pending queue full ({self.config.max_pending}); "
                    "request rejected")
            self._scheduler.push(req)
            if self.telemetry is not None:
                self.telemetry.series_point(
                    "queue_depth", self.telemetry.now(),
                    len(self._scheduler))
            self._cond.notify()
        return ticket

    def _tel_finish(self, req, ok: bool) -> None:
        """Emit the request's serve span (caller holds ``_cond``).

        Ticket stamps are ``time.monotonic``; the span rebases them onto
        the service clock so every request shares one timeline origin.
        """
        tel = self.telemetry
        if tel is None:
            return
        tk = req.ticket
        t1 = tk.finished_s if tk.finished_s is not None else time.monotonic()
        tel.span("serve", f"tenant:{tk.tenant}",
                 tk.queued_s - self._tel_t0, t1 - self._tel_t0,
                 tenant=tk.tenant, ok=ok,
                 wait_s=tk.wait_s if tk.wait_s is not None else 0.0)
        tel.series_point("queue_depth", tel.now(), len(self._scheduler))

    def _dispatch_loop(self, i: int) -> None:
        last_family = None
        while True:
            with self._cond:
                req = None
                while not self._closed:
                    req = self._scheduler.pop(
                        prefer_family=(last_family
                                       if self.config.family_affinity
                                       else None))
                    if req is not None:
                        break
                    self._cond.wait()
                if req is None:  # closed with an empty queue
                    return
                self._active += 1
                req.ticket.dispatched_s = time.monotonic()
            try:
                if req.cfg.controller is not None:
                    # Close the serve->autoscale loop: the controller's
                    # signal probe reads this service's backlog, so a
                    # policy can scale membership with admission pressure.
                    req.cfg.controller.queue_depth_fn = (
                        lambda: len(self._scheduler))
                result = self._run_request(req)
            except BaseException as e:  # noqa: BLE001 - delivered via ticket
                with self._cond:
                    self._active -= 1
                    self._failed += 1
                    req.ticket._finish(exception=e)
                    self._tel_finish(req, ok=False)
                    self._cond.notify_all()
            else:
                with self._cond:
                    self._active -= 1
                    self._served[req.tenant] = (
                        self._served.get(req.tenant, 0) + 1)
                    req.ticket._finish(result=result)
                    self._tel_finish(req, ok=True)
                    self._cond.notify_all()
            last_family = req.family

    def _run_request(self, req) -> RunResult:
        """Execute one request, resuming through coordinator crashes.

        A dispatched solve that dies with :class:`CoordinatorCrash` is
        resubmitted from the latest checkpoint in ``cfg.checkpoint_dir``
        (``ServiceConfig.crash_retries`` attempts) before the ticket
        fails.  :func:`repro_torch.recover.resume_config` strips the scenario —
        the script's remaining events died with the control plane — so a
        scripted crash cannot re-kill the resumed attempt.
        """
        cfg = req.cfg
        attempt = 0
        while True:
            try:
                session = get_executor(cfg.executor).submit(
                    req.problem, cfg, start=False)
                return session.execute()
            except CoordinatorCrash:
                if (attempt >= self.config.crash_retries
                        or req.cfg.checkpoint_dir is None):
                    raise
                ckpt = latest_checkpoint(req.cfg.checkpoint_dir)
                if ckpt is None:  # crashed before the first checkpoint
                    raise
                attempt += 1
                with self._cond:
                    self._crash_resumes += 1
                cfg = resume_config(req.cfg, ckpt)

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, object]:
        with self._cond:
            return {
                "pending": len(self._scheduler),
                "pending_by_tenant": self._scheduler.pending_by_tenant(),
                "active": self._active,
                "served": dict(self._served),
                "failed": self._failed,
                "rejected": self._rejected,
                "crash_resumes": self._crash_resumes,
                "max_active": self.config.max_active,
                "closed": self._closed,
            }

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until queue and dispatchers are idle; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._scheduler) > 0 or self._active > 0:
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    return False
                self._cond.wait(wait)
            return True

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting requests; by default finish what is queued.

        With ``drain=False`` pending (undispatched) requests are cancelled;
        running solves always complete — sessions have no preemption.
        """
        if drain:
            self.drain(timeout)
        with self._cond:
            self._closed = True
            if not drain:
                while True:
                    req = self._scheduler.pop()
                    if req is None:
                        break
                    req.ticket._cancelled = True
                    req.ticket._finish()
            self._cond.notify_all()
        for th in self._dispatchers:
            th.join(timeout=5.0)

    def __enter__(self) -> "SolverService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
