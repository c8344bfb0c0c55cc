"""Real-parallelism process-pool executor with persistent worker pools.

Workers are separate Python interpreters, so evaluations escape the GIL
entirely — the closest local analogue of the paper's Ray deployment (§4).
Each worker rebuilds its own problem instance from the problem's
``factory_spec()`` recipe, on the device the recipe names: a problem on
the card is rebuilt on the card in every worker (each worker opens its own
CUDA context there, ~0.5 GB each), never quietly on the CPU.  The
coordinator (parent process) keeps the apply/accel/record path of the
thread backend.

CUDA workers
------------
Workers are started with the ``spawn`` method, so a worker never inherits
a CUDA context.  Before it spawns a pool for a problem on the card, the
parent builds and loads the kernel library once, so the workers load the
same build instead of starting ``nvcc`` together; a worker loads it at
boot, and a worker that cannot open CUDA or load the library reports an
error that makes the run raise.  Without NVIDIA's Multi-Process Service
the workers' contexts time-slice the card: kernels of different workers
do not overlap.  Every worker resets its kernel launch counters when a
run starts and sends them back when the run ends (after the drain); the
parent adds them to :func:`repro_torch.kernels.ops.launch_counts`, so a
caller sees every launch the run made, in whichever process.

Persistent pools
----------------
Spawning a worker costs an interpreter start, a torch import, the
problem's construction on its device and the kernel library's load.
Workers are therefore pooled and reused across ``run()`` calls: a pool is
keyed on ``(problem-payload fingerprint, n_workers, return_mode)`` and
survives until :func:`shutdown_pools` (registered via ``atexit``), an LRU
eviction (``REPRO_PROCESS_POOLS`` pools are kept, default 4), or a worker
error.  Each ``run()`` sends a per-run setup message (config, fault seeds,
the worker's block of the coordinator's partition) and reuses the warm
interpreters; a warm run spawns zero new processes.  A worker whose fault
draw says "permanent crash" only *simulates* death for the remainder of
that run — the interpreter stays pooled.  Scripts that use this
backend must guard their entry point with ``if __name__ == "__main__":``
(spawned children re-import the main module).

Shared memory
-------------
The global iterate ``x`` (the coordinator's host numpy contract) travels
to workers through a pool-owned shared-memory block (``shm[0]`` = applied
update counter at the coordinator's last write, ``shm[1:]`` = x; snapshots
are taken under a cross-process lock so there are no torn reads), and each
worker owns a shared-memory *result slot* it writes its returned value
block into — the result queue carries only ``(worker, kind, length,
snapshot_wu)``, so value blocks are never pickled.  Staleness is measured
exactly as in the thread backend: ``coord.wu - wu_at_snapshot``.

Device plane: where :func:`resolve_device_plane` qualifies the run, a
worker keeps its block resident on the problem's device through the
problem's ``device_block_plan`` and reads only the plan's halo/dependency
slices from shared memory per dispatch (the whole block only when the
parent flags it stale), so the fused block kernels run in the workers.

Fault semantics mirror the thread backend: per-worker rngs (spawned from
``cfg.seed``, fresh each run) drive delay and crash draws in async mode,
the coordinator rng plans them in sync mode, and drop/noise filtering
stays coordinator-side in ``apply_return``.  An async restartable crash
reports "crash" immediately, sleeps out its downtime worker-side, then
reports "rejoin"; the parent counts the restart when that rejoin lands.

EvalService (``cfg.accel_eval == "worker"``, async mode): accel-fire and
residual-record evaluations are offloaded to the pool over an ``("eval",
kind)`` message: the coordinator writes the pinned iterate into an idle
worker's result slot, the worker evaluates the full map (written back
into the slot) or the residual norm (a scalar over the queue), and the
coordinator feeds the value through the begin/feed/commit pipeline while
the other workers' arrivals keep being applied.  A simulated eval fault
(``FaultProfile.eval_crash_prob``) reports ``eval_crash`` and the
coordinator evaluates that item itself.

Chaos scenarios, trace capture and autoscale controllers take their own
loops: the parent's result wait is bounded by the next scripted event
time (and by 50 ms under a controller, so its timed ticks fire), preempted
workers
are simply not redispatched (their interpreters stay pooled), a result
that raced its worker's preemption is discarded (``preempt_gen``), and
``set_profile`` events reach the workers as ``("prof", profile)``
messages, applied from the worker's next task on.  A scripted
``coordinator_crash`` drains every in-flight result before it raises, so
the warm pool stays clean for the resumed session.  Checkpoints and
resumes run on the default async loop, through the same pool lease.  A
controller never crosses to the workers: the config shipped to them has
it stripped.

Telemetry: workers time their own evaluations and ship ``("tel", ...)``
span batches over the result channel; the parent anchors them on its
clock.  Device-plane arrivals come back as ``"okd"`` with the kernel's
fused block-local norm, which lands in ``coord.device_local_norms``.

``cfg.compute_time`` is ignored — compute cost is whatever the hardware
takes.  Pool startup and per-run warm-up happen before ``t0``, so measured
wall-clock covers only the iteration itself.
"""

from __future__ import annotations

import atexit
import os
import queue as queue_mod
import time
from collections import deque
from multiprocessing import get_context, shared_memory
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ...kernels import _build, ops
from ..fixedpoint import as_block_slice
from .base import Executor, register_executor
from .coordinator import (
    AccelPlan,
    Coordinator,
    EvalItem,
    RecordPlan,
    on_card,
    problem_payload,
    rebuild_problem,
    warm_problem,
    worker_cfg,
    worker_eval,
)
from .device_plane import resolve_device_plane
from .poolreg import PoolRegistry, payload_key
from .types import CoordinatorCrash, RunConfig, RunResult, _fault_for

__all__ = [
    "ProcessPoolExecutor",
    "problem_payload",
    "rebuild_problem",
    "shutdown_pools",
    "process_pools",
    "pool_stats",
]

_CTX = get_context("spawn")  # fork would copy a live CUDA context
#: grace window (s) a controller gets to revive an empty membership after
#: the script is exhausted, before the chaos loops declare the run dead
#: (the thread backend's constant of the same name).
_CTL_STALL_S = 2.0
_READY_TIMEOUT_S = 300.0  # interpreter + torch import + CUDA context
_POLL_S = 5.0
#: how many idle pools to keep alive (LRU beyond this is closed)
_MAX_POOLS = max(1, int(os.environ.get("REPRO_PROCESS_POOLS", "4")))


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach without registering with the resource tracker.

    Python < 3.13 tracks attached segments too, and the tracker would
    unlink the block when any child exits, destroying it for everyone
    (cpython #39959) — suppress registration during attach; the pool owner
    (the parent) unlinks the segments at pool close.
    """
    from multiprocessing import resource_tracker

    _orig_register = resource_tracker.register
    resource_tracker.register = (
        lambda name, rtype: None if rtype == "shared_memory"
        else _orig_register(name, rtype)
    )
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = _orig_register


def _worker_main(
    w: int, payload, shm_name: str, slot_name: str, n: int,
    shm_lock, task_q, result_q,
) -> None:
    """Persistent worker body: rebuild once, then serve runs until poison.

    Messages in (``task_q``):
      ("run", cfg, seed_seq, my_block)   — per-run setup: reset the launch
                                           counters, warm, reseed
      ("async", idx_or_None)             — snapshot shm, eval, own-rng faults
      ("device", fresh)                  — device-plane dispatch: the block
                                           stays resident worker-side; read
                                           only the plan's halo/dependency
                                           slices from shm (plus the block
                                           itself when ``fresh`` is False)
      ("sync", idx_or_None, delay, crashed) — coordinator-planned faults
      ("eval", kind)                     — EvalService item: the input x is
                                           in this worker's result slot;
                                           kind is "full_map" | "res_norm"
      ("prof", profile)                  — chaos set_profile: delay/crash
                                           draws use ``profile`` from the
                                           next task on
      ("counts",)                        — end of run: send the launch counts
      None                               — shut the interpreter down
    ``my_block`` is this worker's own row of the coordinator's memoized
    partition; ``idx_or_None`` of None means "your own fixed block", so
    fixed-selection dispatches never pickle index arrays.

    Messages out (``result_q``): ``(w, kind, data, snap_wu)`` with kind in
    {"boot", "ready", "ok", "crash", "rejoin", "eval_ok", "eval_crash",
    "okd", "tel", "counts", "error"}; for "ok" the values are in the
    shared result slot and ``data`` is their length; "okd" is a device-plane
    "ok" whose ``data`` is ``(length, block-local residual norm)``; for
    "eval_ok" the full-map result is in the slot (``data`` = its length)
    or ``data`` is the residual-norm scalar; for "counts" ``data`` is the
    run's launch counts.  With ``cfg.telemetry`` set, the worker times its
    own evaluations with a local ``perf_counter`` and ships them as
    ``("tel", [(age_s, dur_s, kind), ...])`` batches over the same channel
    (flushed just before a result once ``worker_batch`` spans accumulate;
    the parent re-anchors them on its clock via
    ``TelemetryRecorder.merge_worker_batch``).  An unflushed tail at run
    end is dropped: span batches are observability, never part of the
    numeric protocol.  An async restartable crash reports "crash" with
    ``data=True`` (it will rejoin), sleeps out its downtime, then reports
    "rejoin".
    """
    shm = slot = None
    try:
        problem = rebuild_problem(payload)
        if on_card(problem):
            _build.load_library()  # raises: no plain-version fallback
        shm = _attach_shm(shm_name)
        slot = _attach_shm(slot_name)
        view = np.ndarray(n + 1, dtype=np.float64, buffer=shm.buf)
        slot_view = np.ndarray(n, dtype=np.float64, buffer=slot.buf)
        result_q.put((w, "boot", None, 0))
        cfg = prof = rng = my_block = dplan = my_read = None
        tel_buf: List[Tuple[float, float, str]] = []  # (end_perf, dur, kind)
        tel_bs = 0  # telemetry batch size; 0 = telemetry off

        def tel_note(kind: str, start_perf: float) -> None:
            if tel_bs:
                end = time.perf_counter()
                tel_buf.append((end, end - start_perf, kind))

        def tel_flush() -> None:
            # Ship a full batch just before a result message, so the
            # parent only ever sees "tel" adjacent to real traffic (the
            # pre-run _await / post-run drain can discard strays safely).
            if tel_bs and len(tel_buf) >= tel_bs:
                now = time.perf_counter()
                result_q.put(
                    (w, "tel",
                     [(now - end, dur, kind) for end, dur, kind in tel_buf],
                     0))
                tel_buf.clear()

        while True:
            task = task_q.get()
            if task is None:
                return
            kind = task[0]
            if kind == "run":
                _, cfg, seed_seq, my_block = task
                tel_bs = (int(getattr(cfg.telemetry, "worker_batch", 32))
                          if cfg.telemetry else 0)
                tel_buf.clear()  # a previous run's unflushed tail
                ops.reset_launch_counts()
                warm_problem(problem, cfg, blocks=[my_block])
                prof = _fault_for(cfg, w)
                rng = np.random.default_rng(seed_seq)
                # Device-resident data plane: same structural resolution
                # as the parent, so whenever the parent dispatches
                # ("device", ...) this plan exists.
                dplan = None
                my_read = my_block
                dmode = resolve_device_plane(problem, cfg, "process")
                if dmode is not None:
                    dplan = problem.device_block_plan(my_block, dmode)
                    if dplan is not None:
                        my_read = as_block_slice(my_block)
                        if my_read is None:
                            my_read = my_block
                        zx = np.zeros(n)  # warm the fused kernel now
                        dplan.refresh(zx[my_read])
                        dplan.step(*[zx[s] for s in dplan.needs])
                result_q.put((w, "ready", None, 0))
                continue
            if kind == "counts":
                result_q.put((w, "counts", ops.launch_counts(), 0))
                continue
            if kind == "prof":
                # Chaos scenario set_profile: applies from the next task.
                prof = task[1]
                continue
            if kind == "eval":
                # Offloaded accel/record evaluation: input x is whatever
                # the coordinator wrote into our (otherwise idle) slot.
                _, ekind = task
                xin = slot_view[:n].copy()
                if (prof.eval_crash_prob > 0.0
                        and rng.random() < prof.eval_crash_prob):
                    tel_flush()
                    result_q.put((w, "eval_crash", None, 0))
                    continue
                e0 = time.perf_counter()
                if ekind == "full_map":
                    slot_view[:n] = np.asarray(problem.full_map(xin),
                                               dtype=np.float64)
                    tel_note("eval", e0)
                    tel_flush()
                    result_q.put((w, "eval_ok", n, 0))
                else:
                    rnorm = float(problem.residual_norm(xin))
                    tel_note("eval", e0)
                    tel_flush()
                    result_q.put((w, "eval_ok", rnorm, 0))
                continue
            if kind == "sync":
                _, idx, delay, crashed = task
                idx = my_block if idx is None else idx
                with shm_lock:
                    snap = view.copy()
                c0 = time.perf_counter()
                vals = worker_eval(problem, cfg, snap[1:], idx)
                tel_note("compute", c0)
                if delay > 0.0:
                    time.sleep(delay)
                if crashed:
                    # BSP: the barrier stalls until the worker restarts;
                    # its in-flight result is lost either way.
                    if prof.restart_after is not None:
                        time.sleep(prof.restart_after)
                    tel_flush()
                    result_q.put((w, "crash", None, int(snap[0])))
                else:
                    slot_view[:len(vals)] = vals
                    tel_flush()
                    result_q.put((w, "ok", len(vals), int(snap[0])))
                continue
            if kind == "device":
                # The resident block advances on the device; only the
                # halo/dependency slices (plus the block itself when the
                # parent flagged it stale) cross from shared memory.
                _, fresh = task
                with shm_lock:
                    snap_wu = int(view[0])
                    blk = None if fresh else np.copy(view[1:][my_read])
                    needs = [np.copy(view[1:][s]) for s in dplan.needs]
                c0 = time.perf_counter()
                if blk is not None:
                    dplan.refresh(blk)
                vals, dnorm = dplan.step(*needs)
                tel_note("compute", c0)
            else:
                _, idx = task
                idx = my_block if idx is None else idx
                with shm_lock:
                    snap = view.copy()
                snap_wu = int(snap[0])
                c0 = time.perf_counter()
                vals = worker_eval(problem, cfg, snap[1:], idx)
                tel_note("compute", c0)
                dnorm = None
            if cfg.async_overhead > 0.0:
                time.sleep(cfg.async_overhead)
            delay = prof.sample_delay(rng)
            if delay > 0.0:
                time.sleep(delay)
            if prof.sample_crash(rng):
                will_rejoin = prof.restart_after is not None
                tel_flush()
                result_q.put((w, "crash", will_rejoin, snap_wu))
                if not will_rejoin:
                    # Simulated permanent crash: dead for the rest of THIS
                    # run (the parent stops dispatching to us) but the
                    # interpreter survives for the next pooled run.
                    continue
                time.sleep(prof.restart_after)  # downtime before next task
                result_q.put((w, "rejoin", None, 0))
                continue
            slot_view[:len(vals)] = vals
            tel_flush()
            if dnorm is None:
                result_q.put((w, "ok", len(vals), snap_wu))
            else:
                # "okd": an "ok" that also carries the fused block-local
                # residual norm the device kernel computed for free.
                result_q.put((w, "okd", (len(vals), dnorm), snap_wu))
    except Exception as e:  # surface rebuild/eval failures to the parent
        import traceback

        result_q.put((w, "error", f"{e!r}\n{traceback.format_exc()}", 0))
    finally:
        if shm is not None:
            shm.close()
        if slot is not None:
            slot.close()


class _WorkerPool:
    """A set of persistent worker interpreters for one (problem, p) pair."""

    def __init__(self, key: Tuple[str, int, str], payload, n: int):
        self.key = key
        self.payload = payload
        self.n = n
        self.n_workers = key[1]
        self.runs_served = 0
        self.shm = shared_memory.SharedMemory(create=True, size=8 * (n + 1))
        self.slots = [
            shared_memory.SharedMemory(create=True, size=8 * max(n, 1))
            for _ in range(self.n_workers)
        ]
        self.view = np.ndarray(n + 1, dtype=np.float64, buffer=self.shm.buf)
        self.slot_views = [
            np.ndarray(n, dtype=np.float64, buffer=s.buf) for s in self.slots
        ]
        self.shm_lock = _CTX.Lock()
        self.task_qs = [_CTX.Queue() for _ in range(self.n_workers)]
        self.result_q = _CTX.Queue()
        self.procs = [
            _CTX.Process(
                target=_worker_main,
                args=(w, payload, self.shm.name, self.slots[w].name, n,
                      self.shm_lock, self.task_qs[w], self.result_q),
                daemon=True, name=f"fp-pool-{w}",
            )
            for w in range(self.n_workers)
        ]
        t0 = time.perf_counter()
        try:
            for p in self.procs:
                p.start()
            self._await(self.n_workers, {"boot"})
        except Exception:
            self.close()  # don't leak half-booted interpreters / segments
            raise
        #: seconds from the first spawn until every worker had rebuilt its
        #: problem (and loaded the kernel library, on the card)
        self.boot_s = time.perf_counter() - t0

    # ----------------------------------------------------------------- #
    def healthy(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def setup_run(self, cfg: RunConfig, blocks) -> None:
        """Per-run worker (re)configuration: warm, reseed, re-profile.

        Each worker receives only its own block row — at large n the full
        partition is O(n) of int64 per queue."""
        seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers)
        cfg = worker_cfg(cfg)
        for w, q in enumerate(self.task_qs):
            q.put(("run", cfg, seeds[w], blocks[w]))
        self._await(self.n_workers, {"ready"})
        self.runs_served += 1

    def merge_launch_counts(self) -> None:
        """End of run (after the drain): add every worker's kernel launches
        to this process's counters."""
        for q in self.task_qs:
            q.put(("counts",))
        deadline = time.monotonic() + _READY_TIMEOUT_S
        seen: Set[int] = set()
        while len(seen) < self.n_workers:
            w, kind, data, _ = self.get_result(deadline)
            if kind == "error":
                raise RuntimeError(f"worker {w} failed: {data}")
            if kind == "tel":
                continue  # stray telemetry batch: observability only
            if kind != "counts":
                raise RuntimeError(f"unexpected end-of-run message {kind!r}")
            ops.add_launch_counts(data)
            seen.add(w)

    def _await(self, count: int, kinds: Set[str]) -> None:
        deadline = time.monotonic() + _READY_TIMEOUT_S
        seen: Set[int] = set()
        while len(seen) < count:
            w, kind, data, _ = self.get_result(deadline)
            if kind == "error":
                raise RuntimeError(f"worker {w} failed during startup: {data}")
            if kind == "tel":
                continue  # stray telemetry batch from a stopped run
            if kind not in kinds:
                raise RuntimeError(f"unexpected pre-run message {kind!r}")
            seen.add(w)

    def drain(self, pending: Set[int], rejoins: Set[int] = frozenset()) -> None:
        """Consume (and discard) in-flight results so the next pooled run
        starts from empty queues.  ``rejoins`` names workers that still owe
        a post-downtime "rejoin" message (a restartable crash whose
        downtime had not ended when the run stopped)."""
        deadline = time.monotonic() + _READY_TIMEOUT_S
        outstanding = set(pending)
        owed = set(rejoins)
        while outstanding or owed:
            w, kind, data, _ = self.get_result(deadline)
            if kind == "error":
                raise RuntimeError(f"worker {w} failed: {data}")
            if kind == "tel":
                continue  # drained telemetry batch: observability only
            if kind == "rejoin":
                owed.discard(w)
            else:
                outstanding.discard(w)
                if kind == "crash" and data:
                    # A drained restartable crash still owes its
                    # post-downtime "rejoin" message.
                    owed.add(w)

    def get_result(self, deadline: float):
        """Blocking result read that notices dead children and timeouts."""
        return self.get_result_wake(deadline, None)

    def get_result_wake(self, deadline: float, wake_s: Optional[float]):
        """:meth:`get_result` that additionally returns None once
        ``wake_s`` seconds (from now) elapse with no result — the chaos
        loop's bounded wait, so scripted events are applied on time even
        while every worker is busy."""
        wake = None if wake_s is None else time.monotonic() + max(wake_s, 0.0)
        while True:
            now = time.monotonic()
            if deadline - now <= 0:
                raise RuntimeError(
                    "timed out waiting for process-backend worker results")
            timeout = min(_POLL_S, deadline - now)
            if wake is not None:
                if wake - now <= 0:
                    return None
                timeout = min(timeout, wake - now)
            try:
                return self.result_q.get(timeout=timeout)
            except queue_mod.Empty:
                if wake is not None and time.monotonic() >= wake:
                    return None
                if not any(p.is_alive() for p in self.procs):
                    try:  # drain results that raced with the exits
                        return self.result_q.get_nowait()
                    except queue_mod.Empty:
                        raise RuntimeError(
                            "all process-backend workers exited unexpectedly"
                        ) from None

    def write_x(self, coord: Coordinator) -> None:
        with self.shm_lock:
            self.view[0] = coord.wu
            self.view[1:] = coord.x

    def write_block(self, coord: Coordinator, ind) -> None:
        """O(block) shared-memory sync: mirror one just-applied block (and
        the update counter) instead of rewriting all of x.  Only valid
        when nothing outside ``ind`` changed since the last sync — i.e.
        identity-projection arrivals; commits and projections still go
        through :meth:`write_x`."""
        with self.shm_lock:
            self.view[0] = coord.wu
            self.view[1:][ind] = coord.x[ind]

    def close(self) -> None:
        for q in self.task_qs:
            try:
                q.put_nowait(None)
            except Exception:
                pass
        deadline = time.monotonic() + 10.0
        for p in self.procs:
            if p._popen is None:  # never started (aborted pool boot)
                continue
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for q in self.task_qs + [self.result_q]:
            q.cancel_join_thread()
            q.close()
        for s in [self.shm] + self.slots:
            s.close()
            try:
                s.unlink()
            except FileNotFoundError:  # pragma: no cover - double close
                pass


# --------------------------------------------------------------------- #
# Pool registry (shared LRU logic in .poolreg, atexit-cleaned)
# --------------------------------------------------------------------- #
_POOLS = PoolRegistry(_MAX_POOLS)


def _acquire_pool(payload, cfg: RunConfig, n: int):
    """Lease the pool for (payload, cfg) — shared, pinned, refcounted.

    Concurrent sessions of the same payload family share one warm pool
    (zero respawn): each takes a lease and serializes its exclusive fleet
    use on the lease's ``run_lock``.
    """
    key = payload_key(payload, cfg)
    return _POOLS.acquire(key, lambda: _WorkerPool(key, payload, n))


def shutdown_pools() -> None:
    """Close every persistent worker pool (also registered via atexit)."""
    _POOLS.shutdown()


class process_pools:
    """Context manager scoping pool lifetime: ``with process_pools(): ...``
    runs any number of process-backend sweeps on warm pools and closes them
    all on exit."""

    def __enter__(self) -> "process_pools":
        return self

    def __exit__(self, *exc) -> None:
        shutdown_pools()


def pool_stats() -> Dict[Tuple[str, int, str], Dict[str, object]]:
    """Live pool inventory per pool key: pids, runs served, leases and the
    seconds the pool took to boot."""
    return {
        key: {"pids": pool.pids(), "runs_served": pool.runs_served,
              "n_workers": pool.n_workers, "healthy": pool.healthy(),
              "leases": _POOLS.lease_count(key), "boot_s": pool.boot_s}
        for key, pool in _POOLS.items()
    }


atexit.register(shutdown_pools)


class _EvalQueue:
    """The EvalService of the offloaded async loops (``cfg.accel_eval ==
    "worker"``): a FIFO of fire and record plans whose evaluation items go,
    one at a time, to an idle worker.  The item's input iterate goes
    through that worker's result slot, which is safe to write exactly when
    the worker's last result has been consumed and it has no queued task;
    the worker is not handed block work until the item returns."""

    def __init__(self, coord: Coordinator, pool: _WorkerPool, elapsed):
        self.coord, self.pool, self.elapsed = coord, pool, elapsed
        self.plans: "deque" = deque()  # front is being served
        self.worker: Optional[int] = None
        self.item: Optional[EvalItem] = None

    def open_fire(self) -> None:
        """One fire in flight at a time; due fires while one is pending
        are coalesced."""
        if not any(isinstance(p, AccelPlan) for p in self.plans):
            plan = self.coord.accel_begin(self.elapsed(), pin="lazy")
            if plan is not None:
                self.plans.append(plan)

    def open_record(self) -> None:
        if not any(isinstance(p, RecordPlan) for p in self.plans):
            self.plans.append(self.coord.record_begin(self.elapsed()))

    def serve(self, w: int) -> bool:
        """Hand idle worker ``w`` the front plan's next item, if any."""
        if self.worker is not None:
            return False
        while self.plans:
            front = self.plans[0]
            if isinstance(front, AccelPlan):
                # Lazy pin: reconstruct the begin-time snapshot now, right
                # before the pinned iterate leaves the (single-threaded)
                # parent through the worker's slot.
                self.coord.materialize_pin(front)
            item = front.next_item()
            if item is None:  # already complete (committed elsewhere)
                self.plans.popleft()
                continue
            self.pool.slot_views[w][:] = item.x
            self.pool.task_qs[w].put(("eval", item.kind))
            self.worker, self.item = w, item
            return True
        return False

    def finish(self, w: int, kind: str, data) -> bool:
        """Feed a returned item ("eval_ok" or "eval_crash") through its
        plan; True when the run should stop."""
        coord = self.coord
        plan, item = self.plans[0], self.item
        self.worker = self.item = None
        if kind == "eval_crash":
            # The offloaded evaluation was lost: the coordinator evaluates
            # the item itself and the pipeline continues.
            val, offloaded = coord.eval_item(item), False
        elif item.kind == EvalItem.FULL_MAP:
            val, offloaded = self.pool.slot_views[w][:data].copy(), True
        else:
            val, offloaded = data, True  # residual-norm scalar
        if isinstance(plan, AccelPlan):
            coord.accel_feed(plan, val, offloaded=offloaded)
            if plan.next_item() is None:
                self.plans.popleft()
                # Across membership changes only unmoved blocks commit.
                coord.accel_commit(plan, t=self.elapsed())
                self.pool.write_x(coord)
            return False
        self.plans.popleft()
        res = coord.record_commit(plan, val, offloaded=offloaded)
        if not np.isfinite(res) or res > 1e60:
            return True
        if coord.converged():
            # The offloaded record judged the pinned iterate: confirm at
            # the live one (inline-mode contract).
            res = coord.record(self.elapsed())
            return (not np.isfinite(res) or res > 1e60
                    or coord.converged())
        return False


def _forward_profile(pool: _WorkerPool, cfg: RunConfig, ev) -> None:
    """Push a scripted ``set_profile`` into the worker interpreters (their
    delay/crash draws are made worker-side)."""
    if ev.kind == "set_profile":
        targets = ([ev.worker] if ev.worker is not None
                   else range(cfg.n_workers))
        for wt in targets:
            pool.task_qs[wt].put(("prof", ev.profile))


# --------------------------------------------------------------------- #
@register_executor
class ProcessPoolExecutor(Executor):
    """Workers in separate interpreters; wall time is real seconds."""

    name = "process"

    def _execute(self, session) -> RunResult:
        problem, cfg = session.problem, session.cfg
        if cfg.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        payload = problem_payload(problem)
        if on_card(problem):
            # Build once here, before any worker could start nvcc.
            _build.load_library()
        coord = Coordinator(problem, cfg)
        coord.measure_fire_windows = True  # real clock: time inline fires
        if cfg.accel is not None:
            problem.full_map(coord.x)  # warm the parent-side accel path
        if cfg.capture_trace and cfg.mode == "async":
            from ...chaos.trace import TraceRecorder

            coord.tracer = TraceRecorder(cfg, self.name, problem)
        lease = _acquire_pool(payload, cfg, problem.n)
        try:
            # Exclusive fleet use: concurrent same-family sessions queue
            # here and pipeline over the one warm pool, zero respawns.
            with lease.run_lock:
                pool = lease.pool
                if coord.telemetry is not None:
                    # Pool-plane counters at acquire time: how contended
                    # the warm pool is and whether this family ever had to
                    # respawn a fleet (0 respawns = pure warm reuse).
                    coord.telemetry.series_point(
                        "pool_leases", 0.0, _POOLS.lease_count(lease.key))
                    coord.telemetry.series_point(
                        "pool_respawns", 0.0,
                        max(0, _POOLS.created_count(lease.key) - 1))
                    coord.telemetry.meta["pool_runs_served"] = (
                        pool.runs_served)
                try:
                    pool.setup_run(cfg, coord.blocks)
                    pool.write_x(coord)
                    if cfg.mode == "sync":
                        if (cfg.scenario is not None
                                or cfg.controller is not None):
                            res = self._run_sync_chaos(cfg, coord, pool)
                        else:
                            res = self._run_sync(cfg, coord, pool)
                    elif (cfg.scenario is not None
                          or cfg.controller is not None):
                        # Hosts both eval placements; offloaded fires
                        # commit only to unmoved blocks.  Controller runs
                        # land here too (an empty ScenarioClock without a
                        # script): only this loop handles elastic
                        # membership.
                        res = self._run_async_chaos(cfg, coord, pool)
                    elif cfg.accel_eval == "worker":
                        res = self._run_async_offload(cfg, coord, pool)
                    elif cfg.capture_trace:
                        res = self._run_async_chaos(cfg, coord, pool)
                    else:
                        res = self._run_async(cfg, coord, pool)
                    pool.merge_launch_counts()
                    return res
                except CoordinatorCrash:
                    # The *control plane* died, not a worker: the loop
                    # drained every in-flight result before unwinding, so
                    # the warm pool is clean for the resumed session.
                    pool.merge_launch_counts()
                    raise
                except Exception:
                    # A worker error (or timeout) leaves queues in an
                    # unknown state: retire the whole pool rather than
                    # reuse it (deferred while other sessions hold leases).
                    _POOLS.dispose(pool.key)
                    raise
        finally:
            lease.release()

    # ----------------------------------------------------------------- #
    def _run_sync(
        self, cfg: RunConfig, coord: Coordinator, pool: _WorkerPool
    ) -> RunResult:
        t0 = time.perf_counter()
        rounds = 0
        alive = set(range(cfg.n_workers))
        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(lambda: time.perf_counter() - t0)
        coord.record(0.0)
        while (coord.wu < cfg.max_updates and alive
               and coord.arrivals < coord.max_arrivals):
            rounds += 1
            pool.write_x(coord)
            plans = coord.plan_round(alive, coord.select_round_indices())
            by_worker: Dict[int, Tuple] = {}
            rs = time.perf_counter() - t0  # round dispatch time
            for w, prof, idx, delay, crashed in plans:
                by_worker[w] = (prof, idx, crashed)
                wire_idx = None if idx is coord.blocks[w] else idx
                pool.task_qs[w].put(("sync", wire_idx, delay, crashed))
            deadline = time.monotonic() + _READY_TIMEOUT_S
            remaining = len(plans)
            while remaining:
                w, kind, data, _snap = pool.get_result(deadline)
                if kind == "error":
                    raise RuntimeError(f"worker {w} failed: {data}")
                if kind == "tel":
                    if tel is not None:
                        tel.merge_worker_batch(
                            w, data, time.perf_counter() - t0)
                    continue
                remaining -= 1
                coord.arrivals += 1
                prof, idx, crashed = by_worker[w]
                if crashed:
                    coord.note_sync_crash(prof, w, alive)
                    if tel is not None:
                        tel.task_open(w, rs)
                        tel.task_close(w, disp="crash")
                    continue
                coord.apply_return(idx, pool.slot_views[w][:data], prof,
                                   staleness=0)
                if tel is not None:
                    tel.task_open(w, rs)
                    tel.task_close(w, disp="applied")
            t, verdict = coord.sync_round_tick(
                rounds, lambda: time.perf_counter() - t0)
            if verdict in ("diverged", "converged"):
                return coord.result(t, rounds, verdict == "converged")
            if verdict == "budget":
                break
        t = time.perf_counter() - t0
        return coord.result(t, rounds, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async(
        self, cfg: RunConfig, coord: Coordinator, pool: _WorkerPool
    ) -> RunResult:
        since_fire = 0
        alive = set(range(cfg.n_workers))
        if cfg.resume_from is not None:
            # Restore the coordinator on the (warm) pool, push the restored
            # iterate into shared memory and continue the wall clock from
            # the checkpoint's time.  The lease taken in _execute is the one
            # any same-payload run takes: zero respawns.
            from ...recover.checkpoint import (
                resolve_checkpoint, restore_coordinator)

            ckpt = resolve_checkpoint(cfg.resume_from)
            restore_coordinator(coord, ckpt)
            loop = ckpt.loop
            if loop.get("kind") != "process_async":
                raise ValueError(
                    f"checkpoint loop state is {loop.get('kind')!r}, not "
                    "resumable on the process backend's async loop")
            since_fire = int(loop.get("since_fire", 0))
            alive = {int(w) for w in loop.get("alive", alive)}
            alive &= {w for w in range(cfg.n_workers)
                      if coord.dispatchable(w)}
            pool.write_x(coord)
            t0 = time.perf_counter() - ckpt.t
        else:
            t0 = time.perf_counter()
            coord.record(0.0)
        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(lambda: time.perf_counter() - t0)
        pending: Dict[int, np.ndarray] = {}  # worker -> dispatched indices
        rejoin_owed: Set[int] = set()  # restartable crashes mid-downtime
        stop = False
        # Device-resident data plane: workers whose block is served by a
        # resident device plan get ("device", fresh) dispatches — only the
        # halo/dependency slices cross shared memory per dispatch, and
        # arrivals sync shm with an O(block) write_block instead of the
        # O(n) write_x (full writes remain only after accel commits).
        # The workers resolve the same structural predicate in their "run"
        # setup, so dispatch kinds and resident plans always agree.
        dmode = resolve_device_plane(coord.problem, cfg, self.name)
        dev_workers: Set[int] = set()
        if dmode is not None:
            dev_workers = {
                w for w in range(cfg.n_workers)
                if coord.problem.device_block_plan(coord.blocks[w], dmode)
                is not None}
        dev_fresh = dict.fromkeys(dev_workers, False)
        dev_cver = dict.fromkeys(dev_workers, -1)

        def _loop_state():
            return ({"kind": "process_async", "since_fire": since_fire,
                     "alive": sorted(alive)}, {})

        def dispatch(w: int) -> None:
            idx = coord.select_indices(w)
            pending[w] = idx
            if tel is not None:
                tel.task_open(w, time.perf_counter() - t0)
            if w in dev_workers:
                fresh = (dev_fresh[w]
                         and coord.commit_version == dev_cver[w])
                coord.device_dispatches += 1
                if not fresh:
                    coord.device_refreshes += 1
                pool.task_qs[w].put(("device", fresh))
            else:
                wire_idx = None if idx is coord.blocks[w] else idx
                pool.task_qs[w].put(("async", wire_idx))

        for w in sorted(alive):
            dispatch(w)
        while alive and not stop:
            deadline = time.monotonic() + _READY_TIMEOUT_S
            w, kind, data, snap_wu = pool.get_result(deadline)
            if kind == "error":
                raise RuntimeError(f"worker {w} failed: {data}")
            if kind == "tel":
                if tel is not None:
                    tel.merge_worker_batch(w, data, time.perf_counter() - t0)
                continue
            if kind == "rejoin":
                # Downtime over: count the restart now (the same
                # downtime-end convention as thread/virtual).
                coord.restarts += 1
                rejoin_owed.discard(w)
                if tel is not None:
                    tel.instant("restart", f"w{w}",
                                time.perf_counter() - t0)
                continue
            with coord.busy():
                prof = _fault_for(cfg, w)
                idx = pending.pop(w)
                redispatch = True
                if kind == "crash":
                    coord.crashes += 1
                    if tel is not None:
                        tel.task_close(w, disp="crash")
                    if w in dev_workers:
                        # The resident block advanced past the lost
                        # return; it no longer mirrors x.
                        dev_fresh[w] = False
                    if not data:  # data=True iff the worker will rejoin
                        alive.discard(w)
                        redispatch = False
                    else:
                        # The restart is counted when the worker's
                        # "rejoin" message lands; its redispatched task
                        # waits out the downtime in its queue.
                        rejoin_owed.add(w)
                else:
                    if kind == "okd":  # device arrival: data carries the
                        vlen, dnorm = data  # fused block-local norm too
                        coord.device_local_norms[w] = float(dnorm)
                    else:
                        vlen = data
                    staleness = coord.wu - snap_wu
                    applied = coord.apply_return(
                        idx, pool.slot_views[w][:vlen], prof,
                        staleness=staleness, worker=w)
                    if tel is not None:
                        # Close before any inline fire below, so its
                        # open-task count covers only the *other* workers.
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness)
                    if w in dev_workers:
                        # Freshness granted before any commit below: a
                        # fire bumps commit_version and invalidates.
                        dev_fresh[w] = applied and coord.last_apply_verbatim
                        dev_cver[w] = coord.commit_version
                    cv0 = coord.commit_version
                    if applied:
                        since_fire += 1
                        if (coord.accel is not None
                                and since_fire >= cfg.fire_every):
                            coord.maybe_fire_accel()
                            since_fire = 0
                    if (coord.commit_version != cv0
                            or (applied and not coord._trivial_project)):
                        # A commit (or projection) rewrote x wholesale.
                        pool.write_x(coord)
                    elif applied:
                        # Identity-projection arrival: only this block
                        # moved — O(block) shared-memory sync.
                        pool.write_block(coord, idx)
                    # Nothing applied, nothing committed: shm already
                    # mirrors x; skip the write entirely.
                    if cfg.sdc_guard and not coord.dispatchable(w):
                        # Quarantined by the k-strikes policy: stop
                        # dispatching to it (the interpreter stays pooled,
                        # exactly like a simulated permanent crash).
                        alive.discard(w)
                        redispatch = False
                stop = coord.arrival_tick(time.perf_counter() - t0)
                if not stop and redispatch:
                    dispatch(w)
                coord.maybe_checkpoint(time.perf_counter() - t0, _loop_state)
        t = time.perf_counter() - t0
        # In-flight evaluations are discarded; draining leaves the pool's
        # queues empty for the next run.
        pool.drain(set(pending), rejoin_owed)
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_sync_chaos(
        self, cfg: RunConfig, coord: Coordinator, pool: _WorkerPool
    ) -> RunResult:
        """BSP loop under a chaos scenario and/or a controller (events at
        round boundaries; see the thread backend's ``_run_sync_chaos`` for
        the semantics)."""
        from ...chaos.scenario import ScenarioClock

        clock = ScenarioClock(cfg.scenario)
        t0 = time.perf_counter()
        rounds = 0
        alive = set(range(cfg.n_workers))

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)
        coord.record(0.0)
        idle_since = 0.0
        while (coord.wu < cfg.max_updates and alive
               and coord.arrivals < coord.max_arrivals):
            now = elapsed()
            for ev in clock.due(now):
                coord.apply_scenario_event(ev, now)
                _forward_profile(pool, cfg, ev)
            for cev in coord.controller_tick(now):
                _forward_profile(pool, cfg, cev)
            parts = [w for w in coord.round_participants() if w in alive]
            if not parts:
                nt = clock.next_time()
                if nt is None:
                    if cfg.controller is None:
                        break  # membership can never recover
                    # A controller may still rejoin workers: a bounded
                    # stall window of timed ticks.
                    now = elapsed()
                    if now - idle_since > _CTL_STALL_S:
                        break
                    if cfg.max_wall is not None and now > cfg.max_wall:
                        break
                    time.sleep(0.01)
                    continue
                time.sleep(max(0.0, nt - elapsed()))
                continue
            idle_since = elapsed()
            rounds += 1
            pool.write_x(coord)
            round_idx = {w: coord.round_assignment(w) for w in parts}
            plans = coord.plan_round(set(parts), round_idx)
            by_worker: Dict[int, Tuple] = {}
            rs = elapsed()  # round dispatch time
            for w, prof, idx, delay, crashed in plans:
                by_worker[w] = (prof, idx, crashed)
                wire_idx = None if idx is coord.blocks[w] else idx
                pool.task_qs[w].put(("sync", wire_idx, delay, crashed))
            deadline = time.monotonic() + _READY_TIMEOUT_S
            remaining = len(plans)
            while remaining:
                w, kind, data, _snap = pool.get_result(deadline)
                if kind == "error":
                    raise RuntimeError(f"worker {w} failed: {data}")
                if kind == "tel":
                    if tel is not None:
                        tel.merge_worker_batch(w, data, elapsed())
                    continue
                remaining -= 1
                coord.arrivals += 1
                prof, idx, crashed = by_worker[w]
                if crashed:
                    coord.note_sync_crash(prof, w, alive)
                    if tel is not None:
                        tel.task_open(w, rs, gen=coord.preempt_gen[w])
                        tel.task_close(w, disp="crash",
                                       gen=coord.preempt_gen[w])
                    continue
                coord.apply_return(idx, pool.slot_views[w][:data], prof,
                                   staleness=0, worker=w)
                if tel is not None:
                    tel.task_open(w, rs, gen=coord.preempt_gen[w])
                    tel.task_close(w, disp="applied",
                                   gen=coord.preempt_gen[w])
            t, verdict = coord.sync_round_tick(rounds, elapsed)
            if verdict in ("diverged", "converged"):
                return coord.result(t, rounds, verdict == "converged")
            if verdict == "budget":
                break
        t = elapsed()
        return coord.result(t, rounds, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async_chaos(
        self, cfg: RunConfig, coord: Coordinator, pool: _WorkerPool
    ) -> RunResult:
        """Async loop with chaos scenarios, trace capture and/or an
        autoscale controller.

        The parent's result wait is bounded by the next scripted event
        time (``get_result_wake``), so events apply on schedule even with
        every worker mid-task.  Preempted workers are simply not
        redispatched; a result that raced its worker's preemption is
        discarded via ``preempt_gen``.  With ``cfg.accel_eval == "worker"``
        fire/record evaluations ride the same single-item-in-flight
        pipeline as :meth:`_run_async_offload` (preempted/paused workers
        never serve evals), and a fire whose begin -> commit window spans
        a membership change commits only to the blocks that did not move.
        A ``coordinator_crash`` stops the loop, drains every in-flight
        result and then raises.  A controller ticks at each arrival and at
        least every 50 ms (the result wait is bounded), and an empty
        membership waits at most ``_CTL_STALL_S`` for it to rebuild.
        """
        from ...chaos.scenario import ScenarioClock

        clock = ScenarioClock(cfg.scenario)
        t0 = time.perf_counter()
        coord.record(0.0)
        since_fire = 0
        alive = set(range(cfg.n_workers))
        pending: Dict[int, Tuple[np.ndarray, int]] = {}  # w -> (idx, gen)
        rejoin_owed: Set[int] = set()
        rejoin_gen: Dict[int, int] = {}  # incarnation that crashed
        parked: Set[int] = set()  # paused workers with no task in flight
        stop = False
        crash_box: List[CoordinatorCrash] = []

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)
        evq = (_EvalQueue(coord, pool, elapsed)
               if cfg.accel_eval == "worker" else None)

        def _loop_state():
            # Chaos-loop checkpoints resume on the default process loop
            # (the script's remaining events die with the control plane).
            return ({"kind": "process_async", "since_fire": since_fire,
                     "alive": sorted(alive)}, {})

        def dispatch(w: int) -> None:
            gen = coord.preempt_gen[w]
            bid, idx = coord.next_dispatch(w)
            pending[w] = (idx, gen)
            wire_idx = None if idx is coord.blocks[w] else idx
            if coord.tracer is not None:
                coord.tracer.dispatch(elapsed(), w, bid, gen)
            if tel is not None:
                tel.task_open(w, elapsed(), gen=gen, block=bid)
            pool.task_qs[w].put(("async", wire_idx))

        def idle_or_park(w: int, allow_eval: bool = True) -> None:
            """Redispatch an idle worker (possibly onto an eval item), or
            park it while paused."""
            if coord.dispatchable(w) and w in alive:
                if evq is not None and allow_eval and evq.serve(w):
                    return
                dispatch(w)
            elif w in coord.active and w in alive:
                parked.add(w)

        def apply_event(ev, now: float) -> None:
            """Apply one scripted event, then its backend-side effects."""
            try:
                coord.apply_scenario_event(ev, now)
            except CoordinatorCrash as e:
                # Let the loop fall through to the drain below: the queues
                # must be empty before the kept-warm pool serves again.
                crash_box.append(e)
                return
            plumb(ev)

        def ctl_tick(now: float) -> bool:
            """Controller tick: ``controller_tick`` applies any admissible
            actions to the coordinator; the backend plumbing happens
            here."""
            actions = coord.controller_tick(now)
            for cev in actions:
                plumb(cev)
            return bool(actions)

        def plumb(ev) -> None:
            """Backend-side effects of a membership event (dispatching,
            parking, profile forwarding): the coordinator-side state was
            already updated by ``apply_scenario_event``."""
            _forward_profile(pool, cfg, ev)
            if ev.kind == "join":
                parked.discard(ev.worker)
                if (ev.worker not in pending and ev.worker in alive
                        and (evq is None or ev.worker != evq.worker)):
                    # An eval-serving worker is redispatched when its item
                    # returns: block work queued behind the eval would let
                    # the block result clobber the eval's result slot.
                    if coord.dispatchable(ev.worker):
                        dispatch(ev.worker)
                    elif ev.worker in coord.active:
                        parked.add(ev.worker)  # joined into a pause
            elif ev.kind == "resume":
                for wt in sorted(parked):
                    if coord.dispatchable(wt):
                        parked.discard(wt)
                        dispatch(wt)
            elif ev.kind == "preempt":
                parked.discard(ev.worker)

        def arrival_tick_either() -> bool:
            """Record-cadence/stop tick (offload opens record plans)."""
            if evq is None:
                return coord.arrival_tick(elapsed())
            tick_stop, record_due = coord.arrival_tick_offload(elapsed())
            if record_due:
                evq.open_record()
            return tick_stop

        for ev in clock.due(0.0):
            apply_event(ev, 0.0)
        if not crash_box:
            ctl_tick(0.0)  # tick 0: fleet shaping before first dispatch
            for w in sorted(alive):
                if w in pending:
                    continue  # a t=0 join event already dispatched it
                if coord.dispatchable(w):
                    dispatch(w)
                elif w in coord.active:
                    parked.add(w)  # paused before first dispatch: resumable
        idle_since = 0.0
        while alive and not stop and not crash_box:
            now = elapsed()
            for ev in clock.due(now):
                apply_event(ev, now)
            if crash_box:
                break
            ctl_tick(now)
            nt = clock.next_time()
            if (not pending and not rejoin_owed
                    and (evq is None or evq.worker is None)):
                if nt is None:
                    if cfg.controller is None:
                        break  # nothing in flight, no event can revive us
                    # A controller can still rejoin workers: a bounded
                    # stall window of timed ticks, then give up.
                    now = elapsed()
                    if now - idle_since > _CTL_STALL_S:
                        break
                    if cfg.max_wall is not None and now > cfg.max_wall:
                        break
                    time.sleep(0.02)
                    if ctl_tick(elapsed()):
                        idle_since = elapsed()
                    continue
                time.sleep(max(0.0, nt - elapsed()))
                continue
            idle_since = elapsed()
            deadline = time.monotonic() + _READY_TIMEOUT_S
            wake = None if nt is None else nt - elapsed()
            if cfg.controller is not None:
                # Bound the wait so timed controller ticks (tick_dt) fire
                # even while every worker is mid-compute.
                wake = 0.05 if wake is None else min(wake, 0.05)
            res = pool.get_result_wake(deadline, wake)
            if res is None:
                continue  # an event/tick came due; handle at the loop top
            w, kind, data, snap_wu = res
            if kind == "error":
                raise RuntimeError(f"worker {w} failed: {data}")
            if kind == "tel":
                if tel is not None:
                    tel.merge_worker_batch(w, data, elapsed())
                continue
            if kind == "rejoin":
                rejoin_owed.discard(w)
                if rejoin_gen.pop(w, -1) == coord.preempt_gen[w]:
                    # Downtime ended inside the same incarnation: the
                    # restart rejoined (a worker preempted mid-downtime
                    # never did).
                    coord.restarts += 1
                    if coord.tracer is not None:
                        coord.tracer.restart(elapsed(), w)
                    if tel is not None:
                        g = coord.preempt_gen[w]
                        tel.instant(
                            "restart",
                            f"w{w}" if g == 0 else f"w{w}#r{g}", elapsed())
                continue
            if kind in ("eval_ok", "eval_crash"):
                with coord.busy():
                    stop = evq.finish(w, kind, data)
                    if not stop and w not in pending:
                        idle_or_park(w)
                continue
            with coord.busy():
                prof = coord.fault_for(w)
                idx, gen = pending.pop(w)
                if kind == "crash":
                    if data:  # data=True iff the worker will rejoin
                        rejoin_owed.add(w)
                        rejoin_gen[w] = gen
                    if gen != coord.preempt_gen[w]:
                        coord.preempt_discards += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w,
                                                 "preempt_discard", gen=gen)
                        if tel is not None:
                            tel.task_close(w, disp="preempt_discard",
                                           gen=gen)
                        # A rejoined worker must get fresh work even though
                        # this (doomed) result was a crash report.
                        idle_or_park(w, allow_eval=False)
                        continue
                    coord.crashes += 1
                    if coord.tracer is not None:
                        coord.tracer.arrival(elapsed(), w, "crash", gen=gen)
                    if tel is not None:
                        tel.task_close(w, disp="crash", gen=gen)
                    stop = arrival_tick_either()
                    if not data:
                        alive.discard(w)
                    elif not stop:
                        # The redispatched task waits out the downtime in
                        # the worker's queue (block work only: parking the
                        # single-slot eval service behind that sleep would
                        # stale-discard fires).
                        idle_or_park(w, allow_eval=False)
                    continue
                if gen != coord.preempt_gen[w]:
                    # Preempted (and possibly rejoined) while in flight:
                    # the result predates the reassignment — discard it.
                    coord.preempt_discards += 1
                    if coord.tracer is not None:
                        coord.tracer.arrival(elapsed(), w, "preempt_discard",
                                             gen=gen)
                    if tel is not None:
                        tel.task_close(w, disp="preempt_discard", gen=gen)
                    idle_or_park(w)
                    continue
                staleness = coord.wu - snap_wu
                applied = coord.apply_return(
                    idx, pool.slot_views[w][:data], prof,
                    staleness=staleness, worker=w)
                if coord.tracer is not None:
                    coord.tracer.arrival(
                        elapsed(), w,
                        "applied" if applied else "filtered", staleness,
                        gen=gen)
                if tel is not None:
                    # Close before any fire below: the open-task count then
                    # covers only the *other* workers' in-flight work.
                    tel.task_close(
                        w, disp="applied" if applied else "filtered",
                        staleness=staleness, gen=gen)
                if applied:
                    since_fire += 1
                    if (coord.accel is not None
                            and since_fire >= cfg.fire_every):
                        since_fire = 0
                        if evq is not None:
                            evq.open_fire()
                        else:
                            coord.maybe_fire_accel()
                pool.write_x(coord)
                stop = arrival_tick_either()
                if not stop:
                    idle_or_park(w)
                coord.maybe_checkpoint(elapsed(), _loop_state)
        t = elapsed()
        outstanding = set(pending)
        if evq is not None and evq.worker is not None:
            outstanding.add(evq.worker)
        pool.drain(outstanding, rejoin_owed)
        if crash_box:
            raise crash_box[0]
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async_offload(
        self, cfg: RunConfig, coord: Coordinator, pool: _WorkerPool
    ) -> RunResult:
        """Async loop with accel/record evaluations offloaded to the pool.

        The coordinator keeps applying arrivals while at most one eval
        item is in flight on one (momentarily idle) worker; an accel fire
        or residual record is a FIFO of such items (``plans``).  The
        serving worker is not redispatched block work until its item
        returns; every other worker's arrive->apply->redispatch loop is
        untouched — fires overlap with arrivals instead of stalling them.
        """
        t0 = time.perf_counter()
        coord.record(0.0)
        since_fire = 0
        alive = set(range(cfg.n_workers))
        pending: Dict[int, np.ndarray] = {}  # worker -> dispatched indices
        rejoin_owed: Set[int] = set()  # restartable crashes mid-downtime
        stop = False

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)
        evq = _EvalQueue(coord, pool, elapsed)

        def dispatch(w: int) -> None:
            bid, idx = coord.next_dispatch(w)
            pending[w] = idx
            wire_idx = None if idx is coord.blocks[w] else idx
            if coord.tracer is not None:
                coord.tracer.dispatch(elapsed(), w, bid)
            if tel is not None:
                tel.task_open(w, elapsed(), block=bid)
            pool.task_qs[w].put(("async", wire_idx))

        for w in sorted(alive):
            dispatch(w)
        while alive and not stop:
            deadline = time.monotonic() + _READY_TIMEOUT_S
            w, kind, data, snap_wu = pool.get_result(deadline)
            if kind == "error":
                raise RuntimeError(f"worker {w} failed: {data}")
            if kind == "tel":
                if tel is not None:
                    tel.merge_worker_batch(w, data, elapsed())
                continue
            if kind == "rejoin":
                coord.restarts += 1
                rejoin_owed.discard(w)
                if coord.tracer is not None:
                    coord.tracer.restart(elapsed(), w)
                if tel is not None:
                    tel.instant("restart", f"w{w}", elapsed())
                continue
            if kind in ("eval_ok", "eval_crash"):
                with coord.busy():
                    stop = evq.finish(w, kind, data)
                    if not stop and not evq.serve(w):
                        dispatch(w)
                continue
            with coord.busy():
                prof = _fault_for(cfg, w)
                idx = pending.pop(w)
                redispatch = True
                if kind == "crash":
                    coord.crashes += 1
                    if coord.tracer is not None:
                        coord.tracer.arrival(elapsed(), w, "crash")
                    if tel is not None:
                        tel.task_close(w, disp="crash")
                    if not data:  # data=True iff the worker will rejoin
                        alive.discard(w)
                        redispatch = False
                    else:
                        rejoin_owed.add(w)
                else:
                    staleness = coord.wu - snap_wu
                    applied = coord.apply_return(
                        idx, pool.slot_views[w][:data], prof,
                        staleness=staleness, worker=w)
                    if coord.tracer is not None:
                        coord.tracer.arrival(
                            elapsed(), w,
                            "applied" if applied else "filtered", staleness)
                    if tel is not None:
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness)
                    if applied:
                        since_fire += 1
                        if (coord.accel is not None
                                and since_fire >= cfg.fire_every):
                            since_fire = 0
                            evq.open_fire()
                    pool.write_x(coord)
                tick_stop, record_due = coord.arrival_tick_offload(elapsed())
                if record_due:
                    evq.open_record()
                if tick_stop:
                    stop = True
                if not stop and redispatch:
                    # A restartable crash redispatches block work only: the
                    # worker sleeps out its downtime before its next task,
                    # and parking the single-slot eval service behind that
                    # sleep would systematically stale-discard fires.
                    if kind == "crash" or not evq.serve(w):
                        dispatch(w)
        t = time.perf_counter() - t0
        outstanding = set(pending)
        if evq.worker is not None:
            outstanding.add(evq.worker)
        pool.drain(outstanding, rejoin_owed)
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())
