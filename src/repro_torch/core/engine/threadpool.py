"""Real-concurrency thread-pool executor.

Workers are OS threads evaluating ``block_update`` concurrently; straggler
delays are injected with real ``time.sleep`` and wall time is measured with
``time.perf_counter``.  This measures the paper's sync-vs-async speedups on
actual hardware; the virtual-time simulator predicts them.

Coordinator state is protected by a single lock; worker evaluations (CUDA
kernels launched from each worker thread, which release the GIL while the
host waits for the device) and injected sleeps run outside it, so workers
genuinely overlap.  ``cfg.compute_time`` is ignored.  Runs are not
bit-reproducible across invocations (arrival order is real scheduling),
but with ``n_workers=1`` the trajectory matches the synchronous one and
converges to the same fixed point.

Device plane (``cfg.device_plane``): when the run shape qualifies (see
:mod:`repro_torch.core.engine.device_plane`), each worker keeps its block
resident on the problem's device and per dispatch ships only the halo or
dependency slices its fused kernel reads.

EvalService (``cfg.accel_eval == "worker"``, async mode): accel fires and
residual records run through the coordinator's begin/feed/commit pipeline
on a dedicated eval thread instead of inline under the lock.  A simulated
eval-service fault (``FaultProfile.eval_crash_prob``) makes the pipeline
fall back to coordinator-side evaluation for that item.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor as _Pool
from typing import Optional

import numpy as np

from ..fixedpoint import FixedPointProblem
from .base import Executor, register_executor
from .coordinator import (
    LAZY_PIN_MIN_N,
    Coordinator,
    warm_problem,
    worker_eval,
)
from .device_plane import resolve_device_plane
from .types import FaultProfile, RunConfig, RunResult, _fault_for

__all__ = ["ThreadPoolExecutor"]


@register_executor
class ThreadPoolExecutor(Executor):
    """Concurrent workers in a thread pool; wall time is real seconds."""

    name = "thread"

    def _execute(self, session) -> RunResult:
        problem, cfg = session.problem, session.cfg
        coord = Coordinator(problem, cfg)
        coord.measure_fire_windows = True  # real clock: time inline fires
        # Run every block shape and the accel/residual full-map path once
        # before the clock starts (the first kernel call builds the CUDA
        # library), so set-up never skews wall-clock.
        warm_problem(problem, cfg, blocks=coord.blocks)
        if cfg.accel is not None:
            problem.full_map(coord.x)
        problem.residual_norm(coord.x)
        if cfg.mode == "sync":
            return self._run_sync(problem, cfg, coord)
        if cfg.mode == "async":
            if cfg.accel_eval == "worker":
                return self._run_async_offload(problem, cfg, coord)
            return self._run_async(problem, cfg, coord)
        raise ValueError(f"unknown mode {cfg.mode!r}")

    # ----------------------------------------------------------------- #
    @staticmethod
    def _sync_task(
        problem: FixedPointProblem, cfg: RunConfig, x_snap: np.ndarray,
        idx: np.ndarray, delay: float, crashed: bool,
        profile: FaultProfile,
    ) -> Optional[np.ndarray]:
        vals = worker_eval(problem, cfg, x_snap, idx)
        if delay > 0.0:
            time.sleep(delay)
        if crashed:
            # BSP: the barrier stalls until the worker restarts; its
            # in-flight result is lost either way.
            if profile.restart_after is not None:
                time.sleep(profile.restart_after)
            return None
        return vals

    def _run_sync(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator
    ) -> RunResult:
        t0 = time.perf_counter()
        rounds = 0
        alive = set(range(cfg.n_workers))
        coord.record(0.0)
        with _Pool(max_workers=cfg.n_workers) as pool:
            while (coord.wu < cfg.max_updates and alive
                   and coord.arrivals < coord.max_arrivals):
                rounds += 1
                x_snap = coord.x.copy()
                plans = coord.plan_round(alive, coord.select_round_indices())
                futs = [
                    pool.submit(self._sync_task, problem, cfg, x_snap, idx,
                                delay, crashed, prof)
                    for _, prof, idx, delay, crashed in plans
                ]
                for (w, prof, idx, _, crashed), fut in zip(plans, futs):
                    vals = fut.result()
                    coord.arrivals += 1
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

    # ----------------------------------------------------------------- #
    def _run_async(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator
    ) -> RunResult:
        lock = threading.Lock()
        stop = threading.Event()
        state = {"since_fire": 0}  # arrival/record counters live on coord
        # Per-worker generators for delay/crash draws keep the coordinator
        # rng (drop/noise/selection) behind the lock and everything else out.
        seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers)
        worker_rngs = [np.random.default_rng(s) for s in seeds]

        dmode = resolve_device_plane(problem, cfg, self.name)
        dplans = {}
        if dmode is not None:
            for dw in range(cfg.n_workers):
                dp = problem.device_block_plan(coord.blocks[dw], dmode)
                if dp is not None:
                    dplans[dw] = dp
            # Warm the fused-kernel path before the clock starts.
            zx = np.zeros(problem.n)
            for dw, dp in dplans.items():
                dp.refresh(zx[coord.blocks[dw]])
                dp.step(*[zx[s] for s in dp.needs])

        t0 = time.perf_counter()
        coord.record(0.0)
        errors: list = []

        def elapsed() -> float:
            return time.perf_counter() - t0

        def worker_loop(w: int) -> None:
            prof = _fault_for(cfg, w)
            rng = worker_rngs[w]
            dp = dplans.get(w)
            dev_fresh = False  # resident block mirrors x[block]?
            dev_cver = -1  # commit_version at the last freshness grant
            while not stop.is_set():
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    if not coord.dispatchable(w):
                        return  # quarantined by the k-strikes SDC policy
                    launch_wu = coord.wu
                    idx = coord.select_indices(w)
                    if dp is not None:
                        # Fresh resident block: ship only the halo slices
                        # (O(needs)); stale: re-ship the block (O(block)).
                        blk_vals = None
                        if not (dev_fresh
                                and coord.commit_version == dev_cver):
                            blk_vals = np.copy(coord.x[idx])
                        need_vals = [np.copy(coord.x[s]) for s in dp.needs]
                    else:
                        x_snap = coord.x.copy()
                if dp is not None:
                    if blk_vals is not None:
                        dp.refresh(blk_vals)
                    vals, _ = dp.step(*need_vals)
                else:
                    vals = worker_eval(problem, cfg, x_snap, idx)
                if cfg.async_overhead > 0.0:
                    time.sleep(cfg.async_overhead)
                delay = prof.sample_delay(rng)
                if delay > 0.0:
                    time.sleep(delay)
                if prof.sample_crash(rng):
                    # A crash is still an arrival (record cadence and stop
                    # checks run).  The resident block advanced past the
                    # lost return, so it no longer mirrors x.
                    dev_fresh = False
                    with lock:
                        coord.crashes += 1
                        if coord.arrival_tick(elapsed()):
                            stop.set()
                    if prof.restart_after is None or stop.is_set():
                        return  # permanent crash (or run over): thread exits
                    time.sleep(prof.restart_after)
                    with lock:
                        if stop.is_set():
                            return  # run ended mid-downtime: never rejoined
                        coord.restarts += 1
                    continue
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w
                    )
                    if dp is not None:
                        coord.device_dispatches += 1
                        if blk_vals is not None:
                            coord.device_refreshes += 1
                        # Fresh iff our values landed verbatim; any commit
                        # after this point bumps commit_version.
                        dev_fresh = applied and coord.last_apply_verbatim
                        dev_cver = coord.commit_version
                    if applied:
                        state["since_fire"] += 1
                        if (coord.accel is not None
                                and state["since_fire"] >= cfg.fire_every):
                            coord.maybe_fire_accel()
                            state["since_fire"] = 0
                    if coord.arrival_tick(elapsed()):
                        stop.set()

        def guarded(w: int) -> None:
            # A worker that raises (a failed kernel launch) stops the run;
            # the error re-raises on the calling thread below.
            try:
                worker_loop(w)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                stop.set()

        threads = [
            threading.Thread(target=guarded, args=(w,), daemon=True,
                             name=f"fp-worker-{w}")
            for w in range(cfg.n_workers)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        t = elapsed()
        with lock:
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async_offload(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator
    ) -> RunResult:
        """Async loop with the EvalService on a dedicated eval thread.

        Worker threads behave as in :meth:`_run_async` (host path), but a
        due fire only *opens* an :class:`AccelPlan` under the lock; its
        full-map/safeguard evaluations run on the eval thread, which feeds
        results back and commits with the staleness guard.  Residual
        records take the same path.  At most one fire and one record are
        in flight; further due fires/records are coalesced.
        """
        lock = threading.Lock()
        stop = threading.Event()
        state = {"since_fire": 0, "fire_plan": None, "rec_plan": None}
        seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers + 1)
        worker_rngs = [np.random.default_rng(s) for s in seeds[:-1]]
        eval_rng = np.random.default_rng(seeds[-1])
        eval_pool = _Pool(max_workers=1, thread_name_prefix="fp-eval")
        errors: list = []
        t0 = time.perf_counter()
        coord.record(0.0)

        def elapsed() -> float:
            return time.perf_counter() - t0

        def eval_one(item, prof: FaultProfile):
            """Evaluate one pipeline item, simulating eval-service loss:
            a lost evaluation falls back to the coordinator side."""
            offloaded = not (prof.eval_crash_prob > 0.0
                             and eval_rng.random() < prof.eval_crash_prob)
            return coord.eval_item(item), offloaded

        def run_fire(plan, prof: FaultProfile) -> None:
            if plan._pin_lazy:
                # Lazy pin: snapshot atomically with arrivals, right before
                # the full-map item leaves the lock for the eval thread.
                with lock, coord.busy():
                    coord.materialize_pin(plan)
            item = plan.next_item()
            while item is not None:
                val, offloaded = eval_one(item, prof)
                with lock, coord.busy():
                    coord.accel_feed(plan, val, offloaded=offloaded)
                item = plan.next_item()
            with lock, coord.busy():
                if not stop.is_set():
                    coord.accel_commit(plan, t=elapsed())
                state["fire_plan"] = None

        def run_record(plan, prof: FaultProfile) -> None:
            val, offloaded = eval_one(plan.next_item(), prof)
            with lock, coord.busy():
                state["rec_plan"] = None
                if stop.is_set():
                    return
                res = coord.record_commit(plan, val, offloaded=offloaded)
                if not np.isfinite(res) or res > 1e60:
                    stop.set()
                elif coord.converged():
                    # The offloaded record judged the *pinned* iterate;
                    # confirm at the live iterate.
                    res = coord.record(elapsed())
                    if (not np.isfinite(res) or res > 1e60
                            or coord.converged()):
                        stop.set()

        def submit(fn, plan, prof) -> None:
            def job():
                try:
                    fn(plan, prof)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
                    stop.set()
            eval_pool.submit(job)

        def tick(prof: FaultProfile) -> bool:
            """Record-cadence/stop tick; caller holds the lock."""
            tick_stop, record_due = coord.arrival_tick_offload(elapsed())
            if record_due and state["rec_plan"] is None:
                state["rec_plan"] = coord.record_begin(elapsed())
                submit(run_record, state["rec_plan"], prof)
            return tick_stop

        def worker_loop(w: int) -> None:
            prof = _fault_for(cfg, w)
            rng = worker_rngs[w]
            while not stop.is_set():
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    if not coord.dispatchable(w):
                        return  # quarantined by the k-strikes SDC policy
                    x_snap = coord.x.copy()
                    launch_wu = coord.wu
                    _, idx = coord.next_dispatch(w)
                vals = worker_eval(problem, cfg, x_snap, idx)
                if cfg.async_overhead > 0.0:
                    time.sleep(cfg.async_overhead)
                delay = prof.sample_delay(rng)
                if delay > 0.0:
                    time.sleep(delay)
                if prof.sample_crash(rng):
                    with lock, coord.busy():
                        coord.crashes += 1
                        if tick(prof):
                            stop.set()
                    if prof.restart_after is None or stop.is_set():
                        return
                    time.sleep(prof.restart_after)
                    with lock:
                        if stop.is_set():
                            return  # run ended mid-downtime: never rejoined
                        coord.restarts += 1
                    continue
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w
                    )
                    if applied:
                        state["since_fire"] += 1
                        if (coord.accel is not None
                                and state["since_fire"] >= cfg.fire_every):
                            state["since_fire"] = 0
                            if state["fire_plan"] is None:
                                plan = coord.accel_begin(
                                    elapsed(),
                                    pin=("lazy" if coord.x.size
                                         >= LAZY_PIN_MIN_N else "copy"))
                                if plan is not None:
                                    state["fire_plan"] = plan
                                    submit(run_fire, plan, prof)
                    if tick(prof):
                        stop.set()

        def guarded(w: int) -> None:
            try:
                worker_loop(w)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                stop.set()

        threads = [
            threading.Thread(target=guarded, args=(w,), daemon=True,
                             name=f"fp-worker-{w}")
            for w in range(cfg.n_workers)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        stop.set()  # in-flight plans must not commit after the final record
        eval_pool.shutdown(wait=True)
        if errors:
            raise errors[0]
        t = elapsed()
        with lock:
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())
