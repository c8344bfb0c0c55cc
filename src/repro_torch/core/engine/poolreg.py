"""LRU registry for persistent worker pools, with refcounted leases.

The process backend keeps its worker fleets alive across ``run()`` calls:
each spawned interpreter pays a torch import, a CUDA context on the card
and its kernel library load before its first task.  The keying,
health-check, LRU-eviction and shutdown logic lives here (a copy of the
reference engine's registry; numpy-free, torch-free):

- a pool is keyed on :func:`payload_key` — the sha256 of the pickled
  problem payload (an identity-keyed cache would go silently stale if a
  caller mutated a problem in place) plus ``(n_workers, return_mode)``;
- :meth:`PoolRegistry.acquire` returns a refcounted :class:`PoolLease` on
  the live pool for a key (creating it via the caller's factory, replacing
  one whose ``healthy()`` went false).  While any lease is outstanding the
  pool is pinned: LRU overflow skips it and :meth:`PoolRegistry.dispose`
  defers the actual ``close()`` until the last lease is released, so a
  concurrent request can never have its serving pool torn down underneath
  it.  Pools beyond ``max_pools`` with no leases are closed oldest-first
  (the capacity bound is therefore soft while requests are in flight and
  re-established as they drain);
- each registry entry also carries a ``run_lock`` — leases on the same key
  share it, so concurrent sessions of one payload family serialize their
  *exclusive* use of the fleet (setup_run/dispatch/drain) while still
  sharing the single warm pool with zero respawns;
- :meth:`PoolRegistry.shutdown` closes everything (the backend registers
  it with ``atexit``), including pools with outstanding leases — at
  interpreter exit the worker fleets must die regardless.

Pool objects only need ``close()`` and ``healthy()``; everything else
(queues, shared memory) is the backend's business.
"""

from __future__ import annotations

import hashlib
import pickle
import threading
from collections import OrderedDict
from typing import Callable, Iterator, List, Tuple

__all__ = ["PoolRegistry", "PoolLease", "payload_key"]


def payload_key(payload, cfg) -> Tuple[str, int, str]:
    """Registry key for a (problem payload, RunConfig) pair.

    The payload is hashed fresh on every ``run()``; the pickle+sha256 of a
    realistic payload (sub-MB) costs ~1-2 ms, noise next to even a warm
    run, and guarantees a mutated problem never reuses a pool built from
    the old operator.
    """
    blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    return (hashlib.sha256(blob).hexdigest(), cfg.n_workers, cfg.return_mode)


class _Entry:
    """One registry slot: the pool plus its lease/eviction bookkeeping."""

    __slots__ = ("pool", "leases", "retired", "run_lock")

    def __init__(self, pool):
        self.pool = pool
        self.leases = 0  # outstanding PoolLease handles
        self.retired = False  # evicted/disposed; close when leases drain
        self.run_lock = threading.Lock()  # exclusive fleet use per session


class PoolLease:
    """Refcounted handle on a registry pool (also a context manager).

    Holding a lease pins the pool: the registry will not close it — not for
    LRU overflow, not for :meth:`PoolRegistry.dispose` — until the lease is
    released.  ``run_lock`` serializes exclusive use of the fleet among
    same-key leases.  The lease holds its entry directly, so a concurrent
    dispose-plus-recreate under the same key can never mis-route a release
    to the replacement pool.
    """

    __slots__ = ("_registry", "key", "_entry", "_released")

    def __init__(self, registry: "PoolRegistry", key, entry: _Entry):
        self._registry = registry
        self.key = key
        self._entry = entry
        self._released = False

    @property
    def pool(self):
        return self._entry.pool

    @property
    def run_lock(self) -> threading.Lock:
        return self._entry.run_lock

    def release(self) -> None:
        """Drop the refcount (idempotent); may close a retired/excess pool."""
        if self._released:
            return
        self._released = True
        self._registry._release(self.key, self._entry)

    def __enter__(self) -> "PoolLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class PoolRegistry:
    """LRU-bounded key -> pool mapping with health-checked, leased reuse."""

    def __init__(self, max_pools: int):
        self.max_pools = max(1, int(max_pools))
        self._lock = threading.RLock()
        self._entries: "OrderedDict" = OrderedDict()
        # Per-key creation locks: concurrent cold boots of *different*
        # families proceed in parallel; of the same family, one factory
        # call runs and the others reuse its pool.
        self._creating: dict = {}
        # Telemetry: how many times each key's pool was built from scratch
        # (respawns = created_count - 1; 0 respawns = pure warm reuse).
        self._created: dict = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def items(self) -> Iterator:
        with self._lock:
            return iter([(k, e.pool) for k, e in self._entries.items()])

    def lease_count(self, key) -> int:
        """Outstanding leases on ``key`` (0 for unknown keys)."""
        with self._lock:
            e = self._entries.get(key)
            return 0 if e is None else e.leases

    def created_count(self, key) -> int:
        """Times a pool was built for ``key`` (0 for never-seen keys)."""
        with self._lock:
            return self._created.get(key, 0)

    # ------------------------------------------------------------------ #
    def acquire(self, key, factory: Callable) -> PoolLease:
        """Lease the live pool for ``key``, creating it via ``factory``.

        A cached pool whose ``healthy()`` is false is retired (closed once
        its leases drain) and replaced.  The leased pool is marked
        most-recently-used; unleased pools beyond ``max_pools`` are closed
        oldest-first.
        """
        entry, stale = self._obtain(key, factory)
        for e in stale:
            e.pool.close()
        return PoolLease(self, key, entry)

    def _obtain(self, key, factory) -> Tuple[_Entry, List[_Entry]]:
        """Return (live entry for key, entries to close outside the lock).

        The refcount is bumped under the registry lock, so the entry can
        never be evicted between lookup and lease creation.
        """
        stale: List[_Entry] = []
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    if entry.pool.healthy():
                        entry.leases += 1
                        self._entries.move_to_end(key)
                        stale.extend(self._evict_excess(protect=key))
                        return entry, stale
                    # Dead pool: retire it (close now if nothing holds it).
                    del self._entries[key]
                    entry.retired = True
                    if entry.leases == 0:
                        stale.append(entry)
                ck = self._creating.setdefault(key, threading.Lock())
            with ck:
                with self._lock:
                    if key in self._entries:
                        continue  # built by a concurrent acquire; re-validate
                # Factory runs outside the registry lock (pool boot is slow)
                # but inside the per-key lock (one boot per family).
                pool = factory()
                with self._lock:
                    self._created[key] = self._created.get(key, 0) + 1
                    entry = _Entry(pool)
                    entry.leases += 1
                    self._entries[key] = entry
                    self._creating.pop(key, None)
                    stale.extend(self._evict_excess(protect=key))
                return entry, stale

    def _evict_excess(self, protect=None) -> List[_Entry]:
        """Pop unleased LRU entries beyond capacity (caller closes them).

        Leased pools are skipped — the capacity bound is soft while
        requests are in flight — and re-checked on release.  Caller holds
        the registry lock.
        """
        out: List[_Entry] = []
        excess = len(self._entries) - self.max_pools
        if excess <= 0:
            return out
        for k in list(self._entries):
            if excess <= 0:
                break
            e = self._entries[k]
            if k == protect or e.leases > 0:
                continue
            del self._entries[k]
            e.retired = True
            out.append(e)
            excess -= 1
        return out

    def _release(self, key, entry: _Entry) -> None:
        close_now: List[_Entry] = []
        with self._lock:
            entry.leases = max(0, entry.leases - 1)
            if entry.leases == 0 and entry.retired:
                close_now.append(entry)
            close_now.extend(self._evict_excess())
        for e in close_now:
            e.pool.close()

    # ------------------------------------------------------------------ #
    def dispose(self, key) -> None:
        """Forget one pool (no-op for unknown keys).

        The pool closes immediately when unleased; with leases outstanding
        it is retired — unreachable for new acquires, closed when the last
        lease releases — so disposing a sick pool never tears it out from
        under a concurrent request.
        """
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                entry.retired = True
                if entry.leases > 0:
                    entry = None
        if entry is not None:
            entry.pool.close()

    def shutdown(self) -> None:
        """Close every pool (oldest first), leased or not (atexit path)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.retired = True
            e.pool.close()
