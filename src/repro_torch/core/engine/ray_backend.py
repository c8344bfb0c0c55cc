"""Ray-backed executor — the paper's actual §4 runtime.

Workers are Ray actors, each rebuilding the problem from its
``factory_spec()`` recipe in its own Ray worker process (same payload
protocol as the process backend).  The coordinator stays local and keeps
the thread backend's apply/accel/record pattern; iterate snapshots travel
through the Ray object store (``ray.put`` per dispatch), so staleness is
``coord.wu`` at dispatch minus ``coord.wu`` at apply — exactly the thread
backend's accounting.  Fault semantics also mirror the thread backend:
per-actor rngs drive async delay/crash draws, the coordinator rng plans
them in sync mode, drop/noise filtering stays coordinator-side.  Async
crash downtime is enforced by a coordinator-side rejoin schedule (the
actor itself never sleeps through its downtime, so a kill/stop never waits
on it).  The actors run each problem's host-path ``block_update``: the
device-resident data plane is the thread and process backends' only.

CUDA actors
-----------
Ray hides every GPU from an actor that asks for none.  When the problem
is on the card, each actor therefore asks for a share of one, so that
the pool's actors share a card: ``1 / (n_workers * (REPRO_RAY_POOLS +
1))`` of it, so that the pools the registry keeps and the one being
created fit on one card together (with ``1 / n_workers`` a second pool
could never be placed while the first is kept warm, and Ray would leave
its actors pending).  An actor sees the card Ray assigned it as its
``cuda:0``: the actor rebuilds the problem from a recipe whose CUDA
device strings all read ``cuda:0``.  Before it creates such a pool, the
parent builds and loads the kernel library once, so the actors load the
same build instead of starting ``nvcc`` together.  An actor that sees no
card, or cannot load the library, raises at construction: it never
rebuilds the problem on the CPU.  Every actor resets its kernel launch
counters in ``setup_run``; after the run the parent asks each actor for
its counts and adds them to :func:`repro_torch.kernels.ops.launch_counts`,
so a caller sees every launch the run made, in whichever process.

Persistent actor pools
----------------------
Actors are pooled and reused across ``run()`` calls with the same
per-run setup-message protocol as the process backend: a pool is keyed on
``(problem-payload fingerprint, n_workers, return_mode)`` (see
:mod:`repro_torch.core.engine.poolreg`), each ``run()`` calls
``setup_run`` on the already-warm actors (config, fault seed, the
coordinator's memoized block row), and a warm run creates zero new actors.
Lifecycle mirrors ``shutdown_pools``: pools survive until
:func:`shutdown_ray_pools` (atexit-registered), the ``with ray_pools():``
scope exits, an LRU eviction (``REPRO_RAY_POOLS`` pools kept, default 2),
or an actor failure retires the pool.  :func:`ray_pool_stats` reports the
live inventory, with each pool's actor pids and the seconds its actors
took to boot.  These helpers exist (as no-ops) even when ray is absent, so
generic cleanup code never needs to guard the import.

EvalService (``cfg.accel_eval == "worker"``, async mode)
--------------------------------------------------------
Accel-fire and residual-record evaluations dispatch to the actor that
just returned a result (it is idle until its item comes back), exactly
the process backend's discipline: one eval item in flight, coalesced
plans, ``FaultProfile.eval_crash_prob`` losses fall back to
coordinator-side evaluation.

``ray`` is an optional dependency: when it is not importable this module
registers the name as *unavailable* instead of an executor class —
``available_executors()`` omits it (tests and benchmarks skip cleanly) and
``get_executor("ray")`` raises a message that says what to install.

Connecting to a cluster is the caller's business; if Ray is not already
initialized, a local instance is started with defaults.
"""

from __future__ import annotations

import atexit
import heapq
import os
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ...kernels import _build, ops
from .base import Executor, register_executor, register_unavailable
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
from .poolreg import PoolRegistry, payload_key
from .types import RunConfig, RunResult, _fault_for

try:
    import ray
except ImportError:  # pragma: no cover - exercised when ray is installed
    ray = None

#: how many idle actor pools to keep alive (LRU beyond this is closed)
_MAX_RAY_POOLS = max(1, int(os.environ.get("REPRO_RAY_POOLS", "2")))


def _is_cuda(v) -> bool:
    return isinstance(v, str) and (v == "cuda" or v.startswith("cuda:"))


def _visible_payload(payload):
    """``payload`` with every CUDA device string of a recipe read as
    ``cuda:0``: an actor sees only the card Ray assigned it, as device 0.
    A pickled instance (a problem without a recipe) is left as it is."""
    kind, data = payload
    if kind != "factory":
        return payload

    def remap(v):
        if _is_cuda(v):
            return "cuda:0"
        if isinstance(v, dict):
            return {k: remap(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(remap(x) for x in v)
        return v

    factory, args, kwargs = data
    return kind, (factory, remap(args), remap(kwargs))


if ray is None:
    register_unavailable(
        "ray",
        "requires the optional 'ray' package (pip install 'ray>=2.0'); "
        "no other backend depends on it",
    )

    def shutdown_ray_pools() -> None:
        """No-op without ray: there are no actor pools to close."""

    def ray_pool_stats() -> Dict:
        """No-op without ray: there are no actor pools to report."""
        return {}

    class ray_pools:
        """No-op scope without ray (mirrors ``process_pools``)."""

        def __enter__(self) -> "ray_pools":
            return self

        def __exit__(self, *exc) -> None:
            pass

    __all__: List[str] = ["shutdown_ray_pools", "ray_pool_stats", "ray_pools"]
else:  # pragma: no cover - without ray, tested under tests/torch_ray_standin.py
    __all__ = ["RayExecutor", "shutdown_ray_pools", "ray_pool_stats",
               "ray_pools"]

    @ray.remote
    class _RayWorker:
        """One pooled worker actor: rebuilds the problem once, then serves
        any number of runs via per-run ``setup_run`` messages."""

        def __init__(self, w: int, payload):
            self.w = w
            self.problem = rebuild_problem(_visible_payload(payload))
            if on_card(self.problem):
                _build.load_library()  # raises: no plain-version fallback
            self.cfg = self.prof = self.rng = self.block = None

        def ready(self) -> int:
            """The actor's process id (truthy): the pool's identity."""
            return os.getpid()

        def setup_run(self, cfg: RunConfig, seed_seq, block) -> bool:
            """Per-run reconfiguration: reset the launch counters, warm,
            reseed, re-profile.

            The first run pays the kernels' first calls; later runs are
            near-free.
            """
            self.cfg = cfg
            self.block = block
            ops.reset_launch_counts()
            warm_problem(self.problem, cfg, blocks=[block])
            self.prof = _fault_for(cfg, self.w)
            self.rng = np.random.default_rng(seed_seq)
            return True

        def launch_counts(self) -> Dict[str, int]:
            """This actor's kernel launches since the run's ``setup_run``."""
            return ops.launch_counts()

        def set_profile(self, prof) -> bool:
            """Chaos ``set_profile``: delay/crash draws use ``prof`` from
            the next dispatch on."""
            self.prof = prof
            return True

        def eval_sync(self, x, idx, delay: float, crashed: bool):
            vals = worker_eval(self.problem, self.cfg, x, idx)
            if delay > 0.0:
                time.sleep(delay)
            if crashed:
                # BSP: the barrier stalls until the worker restarts.
                if self.prof.restart_after is not None:
                    time.sleep(self.prof.restart_after)
                return ("crash", None)
            return ("ok", vals)

        def eval_async(self, x, idx):
            vals = worker_eval(self.problem, self.cfg, x, idx)
            if self.cfg.async_overhead > 0.0:
                time.sleep(self.cfg.async_overhead)
            delay = self.prof.sample_delay(self.rng)
            if delay > 0.0:
                time.sleep(delay)
            if self.prof.sample_crash(self.rng):
                return ("crash", None)
            return ("ok", vals)

        def eval_item(self, x, kind: str):
            """EvalService item: offloaded full-map / residual-norm."""
            if (self.prof.eval_crash_prob > 0.0
                    and self.rng.random() < self.prof.eval_crash_prob):
                return ("eval_crash", None)
            if kind == EvalItem.FULL_MAP:
                return ("eval_ok", np.asarray(self.problem.full_map(x),
                                              dtype=np.float64))
            return ("eval_ok", float(self.problem.residual_norm(x)))

    class _RayActorPool:
        """A set of persistent worker actors for one (problem, p) pair."""

        def __init__(self, key: Tuple[str, int, str], payload, n_workers: int,
                     card: bool):
            self.key = key
            self.n_workers = n_workers
            self.runs_served = 0
            # On the card the pool's actors share a GPU with each other
            # and with the other pools the registry may hold meanwhile.
            share = 1.0 / (n_workers * (_MAX_RAY_POOLS + 1))
            cls = _RayWorker.options(num_gpus=share) if card else _RayWorker
            t0 = time.perf_counter()
            self.actors = [cls.remote(w, payload) for w in range(n_workers)]
            try:
                self.pids = ray.get([a.ready.remote() for a in self.actors])
            except Exception:
                self.close()  # don't leak half-booted actors
                raise
            #: seconds from the first actor's creation until every actor
            #: had rebuilt its problem (and loaded the kernel library, on
            #: the card)
            self.boot_s = time.perf_counter() - t0

        def setup_run(self, cfg: RunConfig, blocks) -> None:
            seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers)
            cfg = worker_cfg(cfg)
            ray.get([
                a.setup_run.remote(cfg, seeds[w], blocks[w])
                for w, a in enumerate(self.actors)
            ])
            self.runs_served += 1

        def merge_launch_counts(self) -> None:
            """End of run: add every actor's kernel launches to this
            process's counters (each call queues behind the actor's
            in-flight work, so those launches are in)."""
            for counts in ray.get([a.launch_counts.remote()
                                   for a in self.actors]):
                ops.add_launch_counts(counts)

        def healthy(self, timeout: float = 30.0) -> bool:
            try:
                ray.get([a.ready.remote() for a in self.actors],
                        timeout=timeout)
                return True
            except Exception:
                return False

        def close(self) -> None:
            for a in self.actors:
                try:
                    ray.kill(a, no_restart=True)
                except Exception:
                    pass

    _RAY_POOLS = PoolRegistry(_MAX_RAY_POOLS)

    def _acquire_ray_pool(payload, cfg: RunConfig, card: bool):
        """Lease a warm actor pool (refcounted: never LRU-evicted while
        a session holds it — see :mod:`repro_torch.core.engine.poolreg`)."""
        key = payload_key(payload, cfg)
        return _RAY_POOLS.acquire(
            key, lambda: _RayActorPool(key, payload, cfg.n_workers, card))

    def shutdown_ray_pools() -> None:
        """Close every persistent actor pool (also registered via atexit)."""
        _RAY_POOLS.shutdown()

    def ray_pool_stats() -> Dict[Tuple[str, int, str], Dict[str, object]]:
        """Live actor-pool inventory, per pool key.

        A read-only stats call must not hang on a dead pool, so the
        health probe here uses a short timeout (reuse-time checks keep
        the generous one)."""
        return {
            key: {"n_workers": pool.n_workers,
                  "runs_served": pool.runs_served,
                  "healthy": pool.healthy(timeout=1.0),
                  "leases": _RAY_POOLS.lease_count(key),
                  "pids": list(pool.pids), "boot_s": pool.boot_s}
            for key, pool in _RAY_POOLS.items()
        }

    class ray_pools:
        """Scope actor-pool lifetime: ``with ray_pools(): ...`` runs any
        number of ray-backend sweeps on warm actors and closes them all on
        exit (mirrors ``process_pools``)."""

        def __enter__(self) -> "ray_pools":
            return self

        def __exit__(self, *exc) -> None:
            shutdown_ray_pools()

    atexit.register(shutdown_ray_pools)

    @register_executor
    class RayExecutor(Executor):
        """Workers as pooled Ray actors; wall time is real seconds."""

        name = "ray"

        def _execute(self, session) -> RunResult:
            problem, cfg = session.problem, session.cfg
            if cfg.mode not in ("sync", "async"):
                raise ValueError(f"unknown mode {cfg.mode!r}")
            if not ray.is_initialized():
                ray.init(include_dashboard=False, log_to_driver=False)
            payload = problem_payload(problem)
            card = on_card(problem)
            if card:
                # Build once here, before any actor could start nvcc.
                _build.load_library()
            coord = Coordinator(problem, cfg)
            coord.measure_fire_windows = True  # real clock: time inline fires
            if cfg.accel is not None:
                problem.full_map(coord.x)  # warm the accel path off-clock
            if cfg.capture_trace and cfg.mode == "async":
                from ...chaos.trace import TraceRecorder

                coord.tracer = TraceRecorder(cfg, self.name, problem)
            lease = _acquire_ray_pool(payload, cfg, card)
            try:
                # Actors run one fleet at a time: concurrent same-payload
                # sessions pipeline over the warm pool instead of spawning
                # a second actor fleet.
                with lease.run_lock:
                    pool = lease.pool
                    try:
                        # Startup barrier: rebuild + warm-up happens
                        # off-clock (near-free on a warm pool).
                        pool.setup_run(cfg, coord.blocks)
                        actors = pool.actors
                        if cfg.mode == "sync":
                            if cfg.scenario is not None:
                                res = self._run_sync_chaos(cfg, coord, actors)
                            else:
                                res = self._run_sync(cfg, coord, actors)
                        elif cfg.scenario is not None:
                            res = self._run_async_chaos(cfg, coord, actors)
                        elif cfg.accel_eval == "worker":
                            res = self._run_async_offload(cfg, coord, actors)
                        elif cfg.capture_trace:
                            res = self._run_async_chaos(cfg, coord, actors)
                        else:
                            res = self._run_async(cfg, coord, actors)
                        pool.merge_launch_counts()
                        return res
                    except Exception:
                        # An actor error leaves futures in an unknown
                        # state: retire the whole pool rather than reuse
                        # it (closed once every lease drains).
                        _RAY_POOLS.dispose(pool.key)
                        raise
            finally:
                lease.release()

        # ------------------------------------------------------------- #
        def _run_sync(
            self, cfg: RunConfig, coord: Coordinator, actors
        ) -> RunResult:
            t0 = time.perf_counter()
            rounds = 0
            alive: Set[int] = set(range(cfg.n_workers))
            tel = coord.telemetry
            if tel is not None:
                tel.install_clock(lambda: time.perf_counter() - t0)
            coord.record(0.0)
            while (coord.wu < cfg.max_updates and alive
                   and coord.arrivals < coord.max_arrivals):
                rounds += 1
                x_ref = ray.put(np.asarray(coord.x))
                plans = coord.plan_round(alive, coord.select_round_indices())
                rs = time.perf_counter() - t0  # round dispatch time
                futs = [
                    actors[w].eval_sync.remote(x_ref, idx, delay, crashed)
                    for w, _, idx, delay, crashed in plans
                ]
                for (w, prof, idx, _, crashed), fut in zip(plans, futs):
                    kind, vals = ray.get(fut)
                    coord.arrivals += 1
                    if tel is not None:
                        tel.task_open(w, rs)
                        tel.task_close(
                            w, disp="crash" if crashed else "applied")
                    if crashed:
                        coord.note_sync_crash(prof, w, alive)
                        continue
                    coord.apply_return(idx, vals, prof, staleness=0)
                t, verdict = coord.sync_round_tick(
                    rounds, lambda: time.perf_counter() - t0)
                if verdict in ("diverged", "converged"):
                    return coord.result(t, rounds, verdict == "converged")
                if verdict == "budget":
                    break
            t = time.perf_counter() - t0
            return coord.result(t, rounds, coord.converged())

        # ------------------------------------------------------------- #
        def _run_async(
            self, cfg: RunConfig, coord: Coordinator, actors
        ) -> RunResult:
            t0 = time.perf_counter()
            coord.record(0.0)
            since_fire = 0
            alive: Set[int] = set(range(cfg.n_workers))
            futures: Dict = {}  # ObjectRef -> (worker, idx, wu at dispatch)
            rejoin: List[Tuple[float, int]] = []  # heap of (t, worker)
            stop = False

            def elapsed() -> float:
                return time.perf_counter() - t0

            tel = coord.telemetry
            if tel is not None:
                tel.install_clock(elapsed)

            def dispatch(w: int) -> None:
                idx = coord.select_indices(w)
                x_ref = ray.put(np.asarray(coord.x))  # object-store snapshot
                if tel is not None:
                    tel.task_open(w, elapsed())
                fut = actors[w].eval_async.remote(x_ref, idx)
                futures[fut] = (w, idx, coord.wu)

            for w in sorted(alive):
                dispatch(w)
            while not stop and alive and (futures or rejoin):
                now = elapsed()
                while rejoin and rejoin[0][0] <= now:
                    _, w = heapq.heappop(rejoin)
                    coord.restarts += 1
                    if tel is not None:
                        tel.instant("restart", f"w{w}", now)
                    dispatch(w)
                if not futures:  # every live worker is in downtime
                    time.sleep(max(0.0, rejoin[0][0] - now))
                    continue
                timeout = (max(0.0, rejoin[0][0] - now) if rejoin else None)
                done, _ = ray.wait(list(futures), num_returns=1,
                                   timeout=timeout)
                if not done:
                    continue  # a rejoin came due first
                fut = done[0]
                w, idx, launch_wu = futures.pop(fut)
                kind, vals = ray.get(fut)
                with coord.busy():
                    prof = _fault_for(cfg, w)
                    redispatch = True
                    if kind == "crash":
                        coord.crashes += 1
                        if tel is not None:
                            tel.task_close(w, disp="crash")
                        redispatch = False
                        if prof.restart_after is None:
                            alive.discard(w)
                        else:
                            heapq.heappush(
                                rejoin, (elapsed() + prof.restart_after, w))
                    else:
                        staleness = coord.wu - launch_wu
                        applied = coord.apply_return(
                            idx, vals, prof, staleness=staleness,
                            worker=w)
                        if tel is not None:
                            # Close before the fire below: the open-task
                            # count covers only the *other* workers.
                            tel.task_close(
                                w,
                                disp="applied" if applied else "filtered",
                                staleness=staleness)
                        if applied:
                            since_fire += 1
                            if (coord.accel is not None
                                    and since_fire >= cfg.fire_every):
                                coord.maybe_fire_accel()
                                since_fire = 0
                    stop = coord.arrival_tick(elapsed())
                    if not stop and redispatch:
                        dispatch(w)
            t = elapsed()
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())

        # ------------------------------------------------------------- #
        def _run_sync_chaos(
            self, cfg: RunConfig, coord: Coordinator, actors
        ) -> RunResult:
            """BSP loop under a chaos scenario: events at round
            boundaries, preempted workers out of the round set, their
            blocks served by survivors (mirrors the process backend)."""
            from ...chaos.scenario import ScenarioClock

            clock = ScenarioClock(cfg.scenario)
            t0 = time.perf_counter()
            rounds = 0
            alive: Set[int] = set(range(cfg.n_workers))
            def elapsed() -> float:
                return time.perf_counter() - t0

            tel = coord.telemetry
            if tel is not None:
                tel.install_clock(elapsed)
            coord.record(0.0)

            def apply_event(ev, now: float) -> None:
                coord.apply_scenario_event(ev, now)
                if ev.kind == "set_profile":
                    targets = ([ev.worker] if ev.worker is not None
                               else range(cfg.n_workers))
                    ray.get([actors[wt].set_profile.remote(ev.profile)
                             for wt in targets])

            while (coord.wu < cfg.max_updates and alive
                   and coord.arrivals < coord.max_arrivals):
                now = elapsed()
                for ev in clock.due(now):
                    apply_event(ev, now)
                parts = [w for w in coord.round_participants() if w in alive]
                if not parts:
                    nt = clock.next_time()
                    if nt is None:
                        break  # membership can never recover
                    time.sleep(max(0.0, nt - elapsed()))
                    continue
                rounds += 1
                x_ref = ray.put(np.asarray(coord.x))
                round_idx = {w: coord.round_assignment(w) for w in parts}
                plans = coord.plan_round(set(parts), round_idx)
                rs = elapsed()  # round dispatch time
                futs = [
                    actors[w].eval_sync.remote(x_ref, idx, delay, crashed)
                    for w, _, idx, delay, crashed in plans
                ]
                for (w, prof, idx, _, crashed), fut in zip(plans, futs):
                    kind, vals = ray.get(fut)
                    coord.arrivals += 1
                    if tel is not None:
                        g = coord.preempt_gen[w]
                        tel.task_open(w, rs, gen=g)
                        tel.task_close(
                            w, disp="crash" if crashed else "applied", gen=g)
                    if crashed:
                        coord.note_sync_crash(prof, w, alive)
                        continue
                    coord.apply_return(idx, vals, prof, staleness=0,
                                       worker=w)
                t, verdict = coord.sync_round_tick(rounds, elapsed)
                if verdict in ("diverged", "converged"):
                    return coord.result(t, rounds, verdict == "converged")
                if verdict == "budget":
                    break
            t = elapsed()
            return coord.result(t, rounds, coord.converged())

        # ------------------------------------------------------------- #
        def _run_async_chaos(
            self, cfg: RunConfig, coord: Coordinator, actors
        ) -> RunResult:
            """Async loop with chaos scenarios and/or trace capture.

            ``ray.wait`` timeouts are bounded by the next scripted event
            (and the next crash rejoin), so events apply on schedule;
            preempted actors are simply not redispatched, and a result
            that raced its worker's preemption is discarded via
            ``preempt_gen`` (mirrors the process backend's chaos loop).

            With ``cfg.accel_eval == "worker"`` the offload loop's
            EvalService rides along: the actor that just returned serves
            the front plan's next eval item (one in flight, coalesced
            plans), and fires whose begin->commit window crossed a
            membership change commit restricted to unmoved blocks
            (``accel_commit``'s ``mver`` guard).
            """
            from ...chaos.scenario import ScenarioClock

            clock = ScenarioClock(cfg.scenario)
            offload = cfg.accel_eval == "worker"
            t0 = time.perf_counter()
            coord.record(0.0)
            since_fire = 0
            alive: Set[int] = set(range(cfg.n_workers))
            # ObjectRef -> ("block", w, idx, wu, gen) | ("eval", w)
            futures: Dict = {}
            rejoin: List[Tuple[float, int, int]] = []  # (t, worker, gen)
            parked: Set[int] = set()
            plans: List = []  # eval pipelines; front is being served
            eval_inflight: Optional[EvalItem] = None
            eval_worker: Optional[int] = None
            stop = False

            def elapsed() -> float:
                return time.perf_counter() - t0

            tel = coord.telemetry
            if tel is not None:
                tel.install_clock(elapsed)

            def dispatch(w: int) -> None:
                gen = coord.preempt_gen[w]
                bid, idx = coord.next_dispatch(w)
                x_ref = ray.put(np.asarray(coord.x))
                if coord.tracer is not None:
                    coord.tracer.dispatch(elapsed(), w, bid, gen)
                if tel is not None:
                    tel.task_open(w, elapsed(), gen=gen, block=bid)
                fut = actors[w].eval_async.remote(x_ref, idx)
                futures[fut] = ("block", w, idx, coord.wu, gen)

            def service_eval(w: int) -> bool:
                """Hand the idle actor ``w`` the front plan's next item."""
                nonlocal eval_inflight, eval_worker
                if eval_inflight is not None:
                    return False
                while plans:
                    item = plans[0].next_item()
                    if item is None:
                        plans.pop(0)
                        continue
                    fut = actors[w].eval_item.remote(item.x, item.kind)
                    futures[fut] = ("eval", w)
                    eval_inflight = item
                    eval_worker = w
                    return True
                return False

            def idle_or_park(w: int, allow_eval: bool = True) -> None:
                if coord.dispatchable(w) and w in alive:
                    if allow_eval and offload and service_eval(w):
                        return
                    dispatch(w)
                elif w in coord.active and w in alive:
                    parked.add(w)

            def arrival_tick_either() -> bool:
                if not offload:
                    return coord.arrival_tick(elapsed())
                tick_stop, record_due = coord.arrival_tick_offload(
                    elapsed())
                if record_due and not any(isinstance(p, RecordPlan)
                                          for p in plans):
                    plans.append(coord.record_begin(elapsed()))
                return tick_stop

            def apply_event(ev, now: float) -> None:
                coord.apply_scenario_event(ev, now)
                if ev.kind == "set_profile":
                    targets = ([ev.worker] if ev.worker is not None
                               else range(cfg.n_workers))
                    ray.get([actors[wt].set_profile.remote(ev.profile)
                             for wt in targets])
                elif ev.kind == "join":
                    parked.discard(ev.worker)
                    inflight = {t[1] for t in futures.values()
                                if t[0] == "block"}
                    # A join never queues block work behind an in-flight
                    # eval on the same actor: the eval server picks its
                    # next task when its item returns.
                    if (ev.worker not in inflight and ev.worker in alive
                            and ev.worker != eval_worker):
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

            for ev in clock.due(0.0):
                apply_event(ev, 0.0)
            inflight0 = {t[1] for t in futures.values() if t[0] == "block"}
            for w in sorted(alive):
                if w in inflight0:
                    continue  # a t=0 join event already dispatched it
                if coord.dispatchable(w):
                    dispatch(w)
                elif w in coord.active:
                    parked.add(w)  # paused before first dispatch: resumable
            while not stop and alive:
                now = elapsed()
                for ev in clock.due(now):
                    apply_event(ev, now)
                while rejoin and rejoin[0][0] <= now:
                    _, w, gen = heapq.heappop(rejoin)
                    if gen != coord.preempt_gen[w]:
                        # Preempted during its downtime: the rejoin
                        # belongs to the dead incarnation — no restart,
                        # and no second dispatch stream.
                        continue
                    coord.restarts += 1
                    if coord.tracer is not None:
                        coord.tracer.restart(now, w)
                    if tel is not None:
                        g = coord.preempt_gen[w]
                        tel.instant(
                            "restart",
                            f"w{w}" if g == 0 else f"w{w}#r{g}", now)
                    idle_or_park(w)
                if not futures and not rejoin:
                    nt = clock.next_time()
                    if nt is None:
                        break  # nothing in flight, no event can revive us
                    time.sleep(max(0.0, nt - elapsed()))
                    continue
                bounds = [b for b in (
                    rejoin[0][0] - now if rejoin else None,
                    (clock.next_time() - now
                     if clock.next_time() is not None else None),
                ) if b is not None]
                timeout = max(0.0, min(bounds)) if bounds else None
                if not futures:
                    time.sleep(min(b for b in bounds))
                    continue
                done, _ = ray.wait(list(futures), num_returns=1,
                                   timeout=timeout)
                if not done:
                    continue  # a rejoin or scripted event came due first
                fut = done[0]
                tag = futures.pop(fut)
                if tag[0] == "eval":
                    _, w = tag
                    kind, value = ray.get(fut)
                    with coord.busy():
                        plan = plans[0]
                        item = eval_inflight
                        eval_inflight = None
                        eval_worker = None
                        if kind == "eval_crash":
                            value = coord.eval_item(item)  # crash fallback
                            offloaded = False
                        else:
                            offloaded = True
                        if isinstance(plan, AccelPlan):
                            coord.accel_feed(plan, value,
                                             offloaded=offloaded)
                            if plan.next_item() is None:
                                plans.pop(0)
                                # mver guard inside: a fire whose window
                                # crossed a preempt/join commits only to
                                # blocks whose ownership did not move.
                                coord.accel_commit(plan, t=elapsed())
                        else:
                            plans.pop(0)
                            res = coord.record_commit(plan, value,
                                                      offloaded=offloaded)
                            if not np.isfinite(res) or res > 1e60:
                                stop = True
                            elif coord.converged():
                                res = coord.record(elapsed())
                                if (not np.isfinite(res) or res > 1e60
                                        or coord.converged()):
                                    stop = True
                        if not stop:
                            idle_or_park(w)
                    continue
                _, w, idx, launch_wu, gen = tag
                kind, vals = ray.get(fut)
                with coord.busy():
                    prof = coord.fault_for(w)
                    if gen != coord.preempt_gen[w]:
                        coord.preempt_discards += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w,
                                                 "preempt_discard", gen=gen)
                        if tel is not None:
                            tel.task_close(w, disp="preempt_discard",
                                           gen=gen)
                        idle_or_park(w)
                        continue
                    if kind == "crash":
                        coord.crashes += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w, "crash",
                                                 gen=gen)
                        if tel is not None:
                            tel.task_close(w, disp="crash", gen=gen)
                        if prof.restart_after is None:
                            alive.discard(w)
                        else:
                            heapq.heappush(
                                rejoin,
                                (elapsed() + prof.restart_after, w, gen))
                        stop = arrival_tick_either()
                        continue
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w)
                    if coord.tracer is not None:
                        coord.tracer.arrival(
                            elapsed(), w,
                            "applied" if applied else "filtered", staleness,
                            gen=gen)
                    if tel is not None:
                        # Close before any fire below (open-task count
                        # then covers only the other workers).
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness, gen=gen)
                    if applied:
                        since_fire += 1
                        if (coord.accel is not None
                                and since_fire >= cfg.fire_every):
                            since_fire = 0
                            if offload:
                                if not any(isinstance(p, AccelPlan)
                                           for p in plans):
                                    plan = coord.accel_begin(elapsed())
                                    if plan is not None:
                                        plans.append(plan)
                            else:
                                coord.maybe_fire_accel()
                    stop = arrival_tick_either()
                    if not stop:
                        idle_or_park(w)
            t = elapsed()
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())

        # ------------------------------------------------------------- #
        def _run_async_offload(
            self, cfg: RunConfig, coord: Coordinator, actors
        ) -> RunResult:
            """Async loop with accel/record evaluations on the actors.

            Mirrors the process backend's offload loop: the actor that
            just returned is idle, so it serves the front plan's next eval
            item instead of being redispatched block work; every other
            actor's arrive->apply->redispatch loop is untouched.
            """
            t0 = time.perf_counter()
            coord.record(0.0)
            since_fire = 0
            alive: Set[int] = set(range(cfg.n_workers))
            futures: Dict = {}  # ObjectRef -> ("block", w, idx, wu) | ("eval", w)
            rejoin: List[Tuple[float, int]] = []
            plans: List = []  # eval pipelines; front is being served
            eval_inflight: Optional[EvalItem] = None
            stop = False

            def elapsed() -> float:
                return time.perf_counter() - t0

            tel = coord.telemetry
            if tel is not None:
                tel.install_clock(elapsed)

            def dispatch(w: int) -> None:
                idx = coord.select_indices(w)
                x_ref = ray.put(np.asarray(coord.x))
                if tel is not None:
                    tel.task_open(w, elapsed())
                fut = actors[w].eval_async.remote(x_ref, idx)
                futures[fut] = ("block", w, idx, coord.wu)

            def service_eval(w: int) -> bool:
                """Hand the idle actor ``w`` the front plan's next item."""
                nonlocal eval_inflight
                if eval_inflight is not None:
                    return False
                while plans:
                    item = plans[0].next_item()
                    if item is None:
                        plans.pop(0)
                        continue
                    fut = actors[w].eval_item.remote(item.x, item.kind)
                    futures[fut] = ("eval", w)
                    eval_inflight = item
                    return True
                return False

            for w in sorted(alive):
                dispatch(w)
            while not stop and alive and (futures or rejoin):
                now = elapsed()
                while rejoin and rejoin[0][0] <= now:
                    _, w = heapq.heappop(rejoin)
                    coord.restarts += 1
                    if tel is not None:
                        tel.instant("restart", f"w{w}", now)
                    dispatch(w)
                if not futures:
                    time.sleep(max(0.0, rejoin[0][0] - now))
                    continue
                timeout = (max(0.0, rejoin[0][0] - now) if rejoin else None)
                done, _ = ray.wait(list(futures), num_returns=1,
                                   timeout=timeout)
                if not done:
                    continue
                fut = done[0]
                tag = futures.pop(fut)
                if tag[0] == "eval":
                    _, w = tag
                    kind, value = ray.get(fut)
                    with coord.busy():
                        plan = plans[0]
                        item = eval_inflight
                        eval_inflight = None
                        if kind == "eval_crash":
                            value = coord.eval_item(item)  # crash fallback
                            offloaded = False
                        else:
                            offloaded = True
                        if isinstance(plan, AccelPlan):
                            coord.accel_feed(plan, value, offloaded=offloaded)
                            if plan.next_item() is None:
                                plans.pop(0)
                                coord.accel_commit(plan, t=elapsed())
                        else:
                            plans.pop(0)
                            res = coord.record_commit(plan, value,
                                                      offloaded=offloaded)
                            if not np.isfinite(res) or res > 1e60:
                                stop = True
                            elif coord.converged():
                                res = coord.record(elapsed())
                                if (not np.isfinite(res) or res > 1e60
                                        or coord.converged()):
                                    stop = True
                        if not stop and not service_eval(w):
                            dispatch(w)
                    continue
                _, w, idx, launch_wu = tag
                kind, vals = ray.get(fut)
                with coord.busy():
                    prof = _fault_for(cfg, w)
                    redispatch = True
                    if kind == "crash":
                        coord.crashes += 1
                        if tel is not None:
                            tel.task_close(w, disp="crash")
                        redispatch = False
                        if prof.restart_after is None:
                            alive.discard(w)
                        else:
                            heapq.heappush(
                                rejoin, (elapsed() + prof.restart_after, w))
                    else:
                        staleness = coord.wu - launch_wu
                        applied = coord.apply_return(
                            idx, vals, prof, staleness=staleness,
                            worker=w)
                        if tel is not None:
                            tel.task_close(
                                w,
                                disp="applied" if applied else "filtered",
                                staleness=staleness)
                        if applied:
                            since_fire += 1
                            if (coord.accel is not None
                                    and since_fire >= cfg.fire_every):
                                since_fire = 0
                                if not any(isinstance(p, AccelPlan)
                                           for p in plans):
                                    plan = coord.accel_begin(elapsed())
                                    if plan is not None:
                                        plans.append(plan)
                    tick_stop, record_due = coord.arrival_tick_offload(
                        elapsed())
                    if record_due and not any(isinstance(p, RecordPlan)
                                              for p in plans):
                        plans.append(coord.record_begin(elapsed()))
                    if tick_stop:
                        stop = True
                    if not stop and redispatch:
                        if not service_eval(w):
                            dispatch(w)
            t = elapsed()
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())
