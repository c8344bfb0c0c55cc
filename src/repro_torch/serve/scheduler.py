"""Weighted-fair request scheduling for the solver service.

Start-time fair queuing (SFQ) over tenants: each request is stamped at
admission with a virtual *finish tag*

    start  = max(scheduler vtime, tenant's last finish tag)
    finish = start + cost / weight

and dispatch always picks the smallest finish tag.  A tenant with weight
2 therefore drains twice as fast as a weight-1 tenant under contention,
an idle tenant's first request starts at the current virtual time (no
banked credit), and requests within one tenant stay FIFO.  With a single
tenant the whole thing degenerates to FIFO.

Family affinity is the scheduler-side half of same-payload batching: when
the caller just finished a request of family F, a pending request of the
same family may be picked ahead of the strict fair-order head as long as
its finish tag is within ``affinity_slack`` of the head's — the warm pool
for F is hot *right now*, and a bounded tag detour trades a sliver of
short-term fairness for zero pool churn.  ``affinity_slack=0`` disables
the detour entirely.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional

__all__ = ["AdmissionError", "FairScheduler", "QueuedRequest"]


class AdmissionError(RuntimeError):
    """The service's pending queue is full; the request was not accepted."""


class QueuedRequest:
    """One schedulable unit: the solve payload plus fair-queuing stamps."""

    __slots__ = ("tenant", "family", "cost", "ticket", "seq", "tag",
                 "problem", "cfg")

    def __init__(self, tenant: str, family, cost: float, ticket):
        self.tenant = tenant
        self.family = family
        self.cost = float(cost)
        self.ticket = ticket
        self.seq = 0  # admission order; tiebreak for equal tags
        self.tag = 0.0  # virtual finish time; set by the scheduler
        self.problem = None  # set by the service at submit()
        self.cfg = None


class FairScheduler:
    """SFQ queue: push stamps, pop picks min-tag (with affinity detours).

    Not thread-safe by itself — the service serializes access under its
    own condition variable (the scheduler is pure bookkeeping, so there is
    nothing to wait on here).
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 affinity_slack: float = 0.0):
        if default_weight <= 0.0:
            raise ValueError("default_weight must be positive")
        for t, w in (weights or {}).items():
            if w <= 0.0:
                raise ValueError(f"weight for tenant {t!r} must be positive")
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        self.affinity_slack = float(affinity_slack)
        self._vtime = 0.0
        self._tenant_tag: Dict[str, float] = {}  # last finish tag per tenant
        self._pending: list = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._pending)

    def weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def pending_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self._pending:
            out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    # ------------------------------------------------------------------ #
    def push(self, req: QueuedRequest) -> None:
        """Stamp and enqueue (tags are final: weights apply at admission)."""
        start = max(self._vtime, self._tenant_tag.get(req.tenant, 0.0))
        req.tag = start + req.cost / self.weight_of(req.tenant)
        req.seq = next(self._seq)
        self._tenant_tag[req.tenant] = req.tag
        self._pending.append(req)

    def pop(self, prefer_family=None) -> Optional[QueuedRequest]:
        """Dequeue the fair-order head (or a close same-family request).

        The linear scan is deliberate: pending queues are bounded by the
        service's admission control (tens, not millions), and a heap
        cannot express the affinity detour without lazy deletion.
        """
        if not self._pending:
            return None
        head = min(self._pending, key=lambda r: (r.tag, r.seq))
        pick = head
        if prefer_family is not None and head.family != prefer_family:
            same = [r for r in self._pending
                    if r.family == prefer_family
                    and r.tag <= head.tag + self.affinity_slack]
            if same:
                pick = min(same, key=lambda r: (r.tag, r.seq))
        self._pending.remove(pick)
        # Virtual time follows the dispatched head's *start*; a detour pick
        # does not advance it past work the head still has to do.
        self._vtime = max(self._vtime, min(pick.tag, head.tag))
        return pick

    def remove(self, req: QueuedRequest) -> bool:
        """Withdraw a pending request (cancellation); False if gone."""
        try:
            self._pending.remove(req)
            return True
        except ValueError:
            return False
