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

Chaos scenarios, trace capture and autoscale controllers take their own
loops: a driver thread applies scripted events on the wall clock (and
ticks the controller on a timer), workers park while preempted or paused,
and a result computed across its worker's preemption is discarded
(``preempt_gen``).  Those runs take the host path (the device plane
cannot follow a reassigned block).  Telemetry spans read the loop's
``elapsed()`` clock.  A worker thread that raises (a
failed kernel launch) stops the run and the error re-raises on the caller.
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
from .types import (
    CoordinatorCrash,
    FaultProfile,
    RunConfig,
    RunResult,
    _fault_for,
)

__all__ = ["ThreadPoolExecutor"]

# With an autoscale controller and the script drained, an empty/paused
# membership is not necessarily final: the controller may join a spare or
# resume a pause at a later timed tick.  This is how long the loops wait
# for it before declaring the run wedged and stopping; without a
# controller they stop immediately.
_CTL_STALL_S = 2.0


def _run_threads(worker_loop, n: int, errors: list,
                 stop: threading.Event) -> None:
    """Run ``worker_loop(w)`` on ``n`` worker threads and join them.  A
    worker that raises (a failed kernel launch) records the error and
    stops the run; the caller re-raises it."""

    def guarded(w: int) -> None:
        try:
            worker_loop(w)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors.append(e)
            stop.set()

    threads = [
        threading.Thread(target=guarded, args=(w,), daemon=True,
                         name=f"fp-worker-{w}")
        for w in range(n)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


class _EvalThread:
    """The EvalService of the offloaded async loops (``cfg.accel_eval ==
    "worker"``).  A due fire or record only opens its plan under the
    coordinator lock; one eval thread evaluates it, feeds the values back
    under the lock and commits (a fire with the staleness guard).  At most
    one fire and one record are in flight; further due ones are coalesced.
    A simulated eval-service fault (``FaultProfile.eval_crash_prob``, drawn
    from ``rng``) makes that item fall back to coordinator-side evaluation.
    An error on the eval thread stops the run; the caller re-raises it."""

    def __init__(self, coord: Coordinator, lock, stop: threading.Event,
                 errors: list, rng: np.random.Generator, elapsed):
        self.coord, self.lock, self.stop = coord, lock, stop
        self.errors, self.rng, self.elapsed = errors, rng, elapsed
        self.fire_plan = self.rec_plan = None
        self.pool = _Pool(max_workers=1, thread_name_prefix="fp-eval")

    def fire(self, prof: FaultProfile) -> None:
        """Open a fire unless one is in flight; caller holds the lock."""
        if self.fire_plan is None:
            coord = self.coord
            plan = coord.accel_begin(
                self.elapsed(),
                pin="lazy" if coord.x.size >= LAZY_PIN_MIN_N else "copy")
            if plan is not None:
                self.fire_plan = plan
                self._submit(self._run_fire, plan, prof)

    def tick(self, prof: FaultProfile) -> bool:
        """Record-cadence/stop tick that opens a due record; caller holds
        the lock.  Returns True when the run should stop."""
        tick_stop, record_due = self.coord.arrival_tick_offload(
            self.elapsed())
        if record_due and self.rec_plan is None:
            self.rec_plan = self.coord.record_begin(self.elapsed())
            self._submit(self._run_record, self.rec_plan, prof)
        return tick_stop

    def shutdown(self) -> None:
        self.pool.shutdown(wait=True)

    def _submit(self, fn, plan, prof) -> None:
        def job():
            try:
                fn(plan, prof)
            except BaseException as e:  # noqa: BLE001 - re-raised by caller
                self.errors.append(e)
                self.stop.set()
        self.pool.submit(job)

    def _eval_one(self, item, prof: FaultProfile):
        e0 = self.elapsed()
        offloaded = not (prof.eval_crash_prob > 0.0
                         and self.rng.random() < prof.eval_crash_prob)
        val = self.coord.eval_item(item)
        tel = self.coord.telemetry
        if tel is not None:
            tel.span("eval", "eval", e0, self.elapsed(), offload=offloaded)
        return val, offloaded

    def _run_fire(self, plan, prof: FaultProfile) -> None:
        coord, lock = self.coord, self.lock
        if plan._pin_lazy:
            # Lazy pin: snapshot atomically with arrivals, right before the
            # full-map item leaves the lock for the eval thread.
            with lock, coord.busy():
                coord.materialize_pin(plan)
        item = plan.next_item()
        while item is not None:
            val, offloaded = self._eval_one(item, prof)
            with lock, coord.busy():
                coord.accel_feed(plan, val, offloaded=offloaded)
            item = plan.next_item()
        with lock, coord.busy():
            if not self.stop.is_set():
                coord.accel_commit(plan, t=self.elapsed())
            self.fire_plan = None

    def _run_record(self, plan, prof: FaultProfile) -> None:
        coord = self.coord
        val, offloaded = self._eval_one(plan.next_item(), prof)
        with self.lock, coord.busy():
            self.rec_plan = None
            if self.stop.is_set():
                return
            res = coord.record_commit(plan, val, offloaded=offloaded)
            if not np.isfinite(res) or res > 1e60:
                self.stop.set()
            elif coord.converged():
                # The offloaded record judged the *pinned* iterate; confirm
                # at the live iterate.
                res = coord.record(self.elapsed())
                if (not np.isfinite(res) or res > 1e60
                        or coord.converged()):
                    self.stop.set()


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
        if cfg.capture_trace and cfg.mode == "async":
            from ...chaos.trace import TraceRecorder

            coord.tracer = TraceRecorder(cfg, self.name, problem)
        if cfg.mode == "sync":
            if cfg.scenario is not None or cfg.controller is not None:
                return self._run_sync_chaos(problem, cfg, coord)
            return self._run_sync(problem, cfg, coord)
        if cfg.mode == "async":
            if cfg.scenario is not None or cfg.controller is not None:
                # Hosts both eval placements; offloaded fires commit only
                # to blocks whose ownership did not move.  Controller runs
                # land here too (an empty ScenarioClock without a script):
                # only this loop handles a membership that changes mid-run.
                return self._run_async_chaos(problem, cfg, coord)
            if cfg.accel_eval == "worker":
                return self._run_async_offload(problem, cfg, coord)
            if cfg.capture_trace:
                return self._run_async_chaos(problem, cfg, coord)
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
        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(lambda: time.perf_counter() - t0)
        coord.record(0.0)
        with _Pool(max_workers=cfg.n_workers) as pool:
            while (coord.wu < cfg.max_updates and alive
                   and coord.arrivals < coord.max_arrivals):
                rounds += 1
                x_snap = coord.x.copy()
                rs = time.perf_counter() - t0
                plans = coord.plan_round(alive, coord.select_round_indices())
                futs = [
                    pool.submit(self._sync_task, problem, cfg, x_snap, idx,
                                delay, crashed, prof)
                    for _, prof, idx, delay, crashed in plans
                ]
                for (w, prof, idx, _, crashed), fut in zip(plans, futs):
                    vals = fut.result()
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

        if cfg.resume_from is not None:
            # Restore the coordinator (iterate, rng, Anderson window,
            # counters) and continue the wall clock from the checkpoint's
            # time.  Worker rngs re-derive from the seed, so a one-worker
            # fault-free run continues bit-identically.
            from ...recover.checkpoint import (
                resolve_checkpoint, restore_coordinator)

            ckpt = resolve_checkpoint(cfg.resume_from)
            restore_coordinator(coord, ckpt)
            loop = ckpt.loop
            if loop.get("kind") != "thread_async":
                raise ValueError(
                    f"checkpoint loop state is {loop.get('kind')!r}, not "
                    "resumable on the thread backend's async loop")
            state["since_fire"] = int(loop.get("since_fire", 0))
            t0 = time.perf_counter() - ckpt.t
        else:
            t0 = time.perf_counter()
            coord.record(0.0)
        errors: list = []

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)

        def _loop_state():
            return ({"kind": "thread_async",
                     "since_fire": state["since_fire"]}, {})

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
                        # Quarantined by the k-strikes SDC policy, or out of
                        # a resumed membership: this thread is done.
                        return
                    launch_wu = coord.wu
                    idx = coord.select_indices(w)
                    if tel is not None:
                        tel.task_open(w, elapsed())
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
                    vals, dev_norm = dp.step(*need_vals)
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
                        if tel is not None:
                            tel.task_close(w, disp="crash")
                        if coord.arrival_tick(elapsed()):
                            stop.set()
                    if prof.restart_after is None or stop.is_set():
                        return  # permanent crash (or run over): thread exits
                    time.sleep(prof.restart_after)
                    with lock:
                        if stop.is_set():
                            return  # run ended mid-downtime: never rejoined
                        coord.restarts += 1
                        if tel is not None:
                            tel.instant("restart", f"w{w}")
                    continue
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w
                    )
                    if tel is not None:
                        # Before any inline fire below: its open-task count
                        # must cover only the *other* workers in flight.
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness)
                    if dp is not None:
                        coord.device_dispatches += 1
                        coord.device_local_norms[w] = dev_norm
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
                    coord.maybe_checkpoint(elapsed(), _loop_state)

        _run_threads(worker_loop, cfg.n_workers, errors, stop)
        if errors:
            raise errors[0]
        t = elapsed()
        with lock:
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_sync_chaos(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator
    ) -> RunResult:
        """BSP loop under a chaos scenario and/or a controller: events apply
        at round boundaries; preempted workers leave the round set with
        their blocks served by survivors, paused workers idle, and when
        nobody can take a round the loop sleeps to the next scripted event
        (or, with a controller, gives it ``_CTL_STALL_S`` of timed ticks to
        rebuild the membership)."""
        from ...chaos.scenario import ScenarioClock

        clock = ScenarioClock(cfg.scenario)
        t0 = time.perf_counter()
        rounds = 0
        idle_since = 0.0  # last time a round actually ran (stall window)
        alive = set(range(cfg.n_workers))

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)
        coord.record(0.0)
        with _Pool(max_workers=cfg.n_workers) as pool:
            while (coord.wu < cfg.max_updates and alive
                   and coord.arrivals < coord.max_arrivals):
                now = elapsed()
                for ev in clock.due(now):
                    coord.apply_scenario_event(ev, now)
                # Controller decisions land at round boundaries; the round
                # set below is re-derived from the membership.
                coord.controller_tick(now)
                parts = [w for w in coord.round_participants() if w in alive]
                if not parts:
                    nt = clock.next_time()
                    if nt is None:
                        if cfg.controller is None:
                            break  # membership can never recover
                        # A controller may still rebuild the membership:
                        # a bounded stall window of timed ticks.
                        if now - idle_since > _CTL_STALL_S:
                            break
                        if (cfg.max_wall is not None
                                and elapsed() > cfg.max_wall):
                            break
                        time.sleep(0.01)
                        continue
                    time.sleep(max(0.0, nt - elapsed()))
                    continue
                idle_since = elapsed()
                rounds += 1
                x_snap = coord.x.copy()
                rs = elapsed()
                round_idx = {w: coord.round_assignment(w) for w in parts}
                plans = coord.plan_round(set(parts), round_idx)
                futs = [
                    pool.submit(self._sync_task, problem, cfg, x_snap, idx,
                                delay, crashed, prof)
                    for _, prof, idx, delay, crashed in plans
                ]
                for (w, prof, idx, _, crashed), fut in zip(plans, futs):
                    vals = fut.result()
                    coord.arrivals += 1
                    if tel is not None:
                        tel.task_open(w, rs, gen=coord.preempt_gen[w])
                        tel.task_close(
                            w, disp="crash" if crashed else "applied",
                            gen=coord.preempt_gen[w])
                    if crashed:
                        coord.note_sync_crash(prof, w, alive)
                        continue
                    coord.apply_return(idx, vals, prof, staleness=0, worker=w)
                t, verdict = coord.sync_round_tick(rounds, elapsed)
                if verdict in ("diverged", "converged"):
                    return coord.result(t, rounds, verdict == "converged")
                if verdict == "budget":
                    break
        t = elapsed()
        return coord.result(t, rounds, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async_chaos(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator
    ) -> RunResult:
        """Async loop with chaos scenarios, trace capture and/or an
        autoscale controller.

        A chaos-driver thread wakes at each scripted event time and
        applies it under the coordinator lock; worker threads park on a
        condition while they are preempted or paused (and exit once no
        future join can revive them).  A result computed across its
        worker's preemption is discarded at the apply point
        (``preempt_gen`` recognizes the stale incarnation).  A scripted
        ``coordinator_crash`` stops every worker and raises
        :class:`CoordinatorCrash` on the caller.

        With ``cfg.accel_eval == "worker"`` due fires/records only *open*
        plans under the lock and evaluate on a dedicated eval thread (as
        in :meth:`_run_async_offload`); a fire whose begin -> commit
        window spans a membership change commits only to the blocks that
        did not move.

        With ``cfg.controller`` the driver doubles as the controller's timed
        ticker (arrivals stall while every member is down), and workers
        tick it at each arrival; an empty membership waits at most
        ``_CTL_STALL_S`` for the controller to rebuild it.
        """
        from ...chaos.scenario import ScenarioClock

        lock = threading.Lock()
        cond = threading.Condition(lock)
        stop = threading.Event()
        state = {"since_fire": 0, "crash": None}
        errors: list = []
        clock = ScenarioClock(cfg.scenario)
        seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers + 1)
        worker_rngs = [np.random.default_rng(s) for s in seeds[:-1]]
        t0 = time.perf_counter()
        with cond:
            for ev in clock.due(0.0):
                coord.apply_scenario_event(ev, 0.0)
            # Initial controller decision (tick 0) shapes the membership
            # before worker threads take their first dispatch; threads
            # park/dispatch off coord.dispatchable, so no plumbing.
            coord.controller_tick(0.0)
        coord.record(0.0)

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)

        evals = (_EvalThread(coord, cond, stop, errors,
                             np.random.default_rng(seeds[-1]), elapsed)
                 if cfg.accel_eval == "worker" else None)

        def tick(prof: FaultProfile) -> bool:
            """Record-cadence/stop tick; caller holds the lock."""
            if evals is None:
                return coord.arrival_tick(elapsed())
            return evals.tick(prof)

        def chaos_driver() -> None:
            # With a controller the driver doubles as its timed ticker:
            # arrivals normally drive decisions, but when every member is
            # down arrivals stall, and only these timed ticks let the
            # controller rebuild the membership (bounded by _CTL_STALL_S
            # once the script is drained and nothing is live).
            ctl = cfg.controller is not None
            idle_since: Optional[float] = None
            while not stop.is_set():
                nt = clock.next_time()
                if nt is None and not ctl:
                    with cond:
                        if not (coord.active - coord.paused):
                            # Nobody can ever take work again: the script
                            # ended with the membership empty/paused.
                            stop.set()
                            cond.notify_all()
                    return
                if nt is None and ctl:
                    if stop.wait(0.02):
                        return
                    with cond:
                        now = elapsed()
                        acted = bool(coord.controller_tick(now))
                        if acted:
                            cond.notify_all()
                        if (coord.active - coord.paused) or acted:
                            idle_since = None
                        elif idle_since is None:
                            idle_since = now
                        elif now - idle_since > _CTL_STALL_S:
                            stop.set()
                            cond.notify_all()
                            return
                        if cfg.max_wall is not None and now > cfg.max_wall:
                            stop.set()
                            cond.notify_all()
                            return
                    continue
                while True:
                    wait = nt - elapsed()
                    if wait <= 0:
                        break
                    if stop.wait(min(wait, 0.02) if ctl else wait):
                        return
                    if ctl:
                        with cond:
                            if coord.controller_tick(elapsed()):
                                cond.notify_all()
                with cond:
                    now = elapsed()
                    try:
                        for ev in clock.due(now):
                            coord.apply_scenario_event(ev, now)
                    except CoordinatorCrash as e:
                        # The control plane just died: stop every worker
                        # (nothing commits past this point) and hand the
                        # crash to the calling thread.
                        state["crash"] = e
                        stop.set()
                        cond.notify_all()
                        return
                    if ctl:
                        coord.controller_tick(now)
                    cond.notify_all()

        def worker_loop(w: int) -> None:
            rng = worker_rngs[w]
            while not stop.is_set():
                with cond:
                    while not stop.is_set() and not coord.dispatchable(w):
                        if clock.exhausted and cfg.controller is None:
                            # join/resume only come from the script: an
                            # undispatchable worker with the script drained
                            # can never work again.  (A controller can
                            # revive it at any later tick, so keep parking;
                            # the driver's stall window bounds the wait.)
                            return
                        cond.wait(0.05)
                    if stop.is_set():
                        return
                    gen = coord.preempt_gen[w]
                    x_snap = coord.x.copy()
                    launch_wu = coord.wu
                    bid, idx = coord.next_dispatch(w)
                    prof = coord.fault_for(w)
                    if coord.tracer is not None:
                        coord.tracer.dispatch(elapsed(), w, bid, gen)
                    if tel is not None:
                        tel.task_open(w, elapsed(), gen=gen, block=bid)
                vals = worker_eval(problem, cfg, x_snap, idx)
                if cfg.async_overhead > 0.0:
                    time.sleep(cfg.async_overhead)
                delay = prof.sample_delay(rng)
                if delay > 0.0:
                    time.sleep(delay)
                if prof.sample_crash(rng):
                    with cond, coord.busy():
                        if stop.is_set():
                            return
                        if gen != coord.preempt_gen[w]:
                            coord.preempt_discards += 1
                            if coord.tracer is not None:
                                coord.tracer.arrival(elapsed(), w,
                                                     "preempt_discard",
                                                     gen=gen)
                            if tel is not None:
                                tel.task_close(w, disp="preempt_discard",
                                               gen=gen)
                            continue  # park at loop top until join
                        coord.crashes += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w, "crash",
                                                 gen=gen)
                        if tel is not None:
                            tel.task_close(w, disp="crash", gen=gen)
                        if tick(prof):
                            stop.set()
                            cond.notify_all()
                        elif coord.controller_tick(elapsed()):
                            cond.notify_all()  # wake workers a join freed
                    if prof.restart_after is None or stop.is_set():
                        return  # permanent crash (or run over): thread exits
                    time.sleep(prof.restart_after)
                    with cond:
                        if stop.is_set():
                            return
                        if gen == coord.preempt_gen[w]:
                            # Downtime ended inside the same incarnation:
                            # the restart rejoins.
                            coord.restarts += 1
                            if coord.tracer is not None:
                                coord.tracer.restart(elapsed(), w)
                            if tel is not None:
                                tel.instant(
                                    "restart",
                                    f"w{w}" if gen == 0 else f"w{w}#r{gen}")
                    continue
                with cond, coord.busy():
                    if stop.is_set():
                        return
                    if gen != coord.preempt_gen[w]:
                        coord.preempt_discards += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w,
                                                 "preempt_discard", gen=gen)
                        if tel is not None:
                            tel.task_close(w, disp="preempt_discard",
                                           gen=gen)
                        continue
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w
                    )
                    if coord.tracer is not None:
                        coord.tracer.arrival(
                            elapsed(), w,
                            "applied" if applied else "filtered", staleness,
                            gen=gen)
                    if tel is not None:
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness, gen=gen)
                    if applied:
                        state["since_fire"] += 1
                        if (coord.accel is not None
                                and state["since_fire"] >= cfg.fire_every):
                            state["since_fire"] = 0
                            if evals is not None:
                                evals.fire(prof)
                            else:
                                coord.maybe_fire_accel()
                    if tick(prof):
                        stop.set()
                        cond.notify_all()
                    elif coord.controller_tick(elapsed()):
                        # The controller acted at this arrival: a preempt
                        # of this very worker parks it at the loop top (its
                        # gen is stale now); a join frees a parked worker.
                        cond.notify_all()
                    coord.maybe_checkpoint(
                        elapsed(),
                        lambda: ({"kind": "thread_async",
                                  "since_fire": state["since_fire"]}, {}))

        driver = threading.Thread(target=chaos_driver, daemon=True,
                                  name="fp-chaos-driver")
        driver.start()
        _run_threads(worker_loop, cfg.n_workers, errors, stop)
        stop.set()  # in-flight plans must not commit after the final record
        driver.join(timeout=5.0)
        if evals is not None:
            evals.shutdown()
        if errors:
            raise errors[0]
        if state["crash"] is not None:
            raise state["crash"]
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
        state = {"since_fire": 0}
        seeds = np.random.SeedSequence(cfg.seed).spawn(cfg.n_workers + 1)
        worker_rngs = [np.random.default_rng(s) for s in seeds[:-1]]
        errors: list = []
        t0 = time.perf_counter()
        coord.record(0.0)

        def elapsed() -> float:
            return time.perf_counter() - t0

        tel = coord.telemetry
        if tel is not None:
            tel.install_clock(elapsed)
        evals = _EvalThread(coord, lock, stop, errors,
                            np.random.default_rng(seeds[-1]), elapsed)

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
                    bid, idx = coord.next_dispatch(w)
                    if coord.tracer is not None:
                        coord.tracer.dispatch(elapsed(), w, bid)
                    if tel is not None:
                        tel.task_open(w, elapsed(), block=bid)
                vals = worker_eval(problem, cfg, x_snap, idx)
                if cfg.async_overhead > 0.0:
                    time.sleep(cfg.async_overhead)
                delay = prof.sample_delay(rng)
                if delay > 0.0:
                    time.sleep(delay)
                if prof.sample_crash(rng):
                    with lock, coord.busy():
                        coord.crashes += 1
                        if coord.tracer is not None:
                            coord.tracer.arrival(elapsed(), w, "crash")
                        if tel is not None:
                            tel.task_close(w, disp="crash")
                        if evals.tick(prof):
                            stop.set()
                    if prof.restart_after is None or stop.is_set():
                        return
                    time.sleep(prof.restart_after)
                    with lock:
                        if stop.is_set():
                            return  # run ended mid-downtime: never rejoined
                        coord.restarts += 1
                        if coord.tracer is not None:
                            coord.tracer.restart(elapsed(), w)
                        if tel is not None:
                            tel.instant("restart", f"w{w}")
                    continue
                with lock, coord.busy():
                    if stop.is_set():
                        return
                    staleness = coord.wu - launch_wu
                    applied = coord.apply_return(
                        idx, vals, prof, staleness=staleness, worker=w
                    )
                    if coord.tracer is not None:
                        coord.tracer.arrival(
                            elapsed(), w,
                            "applied" if applied else "filtered", staleness)
                    if tel is not None:
                        tel.task_close(
                            w, disp="applied" if applied else "filtered",
                            staleness=staleness)
                    if applied:
                        state["since_fire"] += 1
                        if (coord.accel is not None
                                and state["since_fire"] >= cfg.fire_every):
                            state["since_fire"] = 0
                            evals.fire(prof)
                    if evals.tick(prof):
                        stop.set()

        _run_threads(worker_loop, cfg.n_workers, errors, stop)
        stop.set()  # in-flight plans must not commit after the final record
        evals.shutdown()
        if errors:
            raise errors[0]
        t = elapsed()
        with lock:
            coord.record(t)
            return coord.result(t, coord.wu, coord.converged())
