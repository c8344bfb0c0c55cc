"""Solver-as-a-service layer (paper §4's runtime as a shared resource).

The engine executes one solve per :class:`~repro_torch.core.engine.SolveSession`;
this package multiplexes *many* concurrent requests over it: bounded-queue
admission control, weighted-fair scheduling across tenants, and
same-payload-family batching so concurrent requests share one warm worker
pool with zero respawns.  The port's copy of the reference's package: the
same scheduler, admission, cancel/drain semantics and crash retries.

Quickstart::

    from repro_torch.serve import SolverService, ServiceConfig

    with SolverService(ServiceConfig(max_active=2)) as svc:
        t1 = svc.submit(problem, cfg, tenant="a")
        t2 = svc.submit(problem, cfg, tenant="b")
        r1, r2 = t1.result(), t2.result()
"""

from .scheduler import AdmissionError, FairScheduler, QueuedRequest
from .service import ServiceConfig, SolverService, Ticket, request_family

__all__ = [
    "AdmissionError",
    "FairScheduler",
    "QueuedRequest",
    "ServiceConfig",
    "SolverService",
    "Ticket",
    "request_family",
]
