"""Deterministic virtual-time executor (discrete-event simulator).

This is the paper-faithful analogue of the Ray framework (§4): ``p`` virtual
workers evaluate block updates, an event queue advances a virtual clock, and
the coordinator applies returns in arrival order.  Synchronous mode is the
same engine with a barrier (round wall time = max over workers), so
sync/async speedups are directly comparable — the paper's headline metric.

The event loops are the reference engine's, so a fixed-seed run consumes
the random streams in the same order and, given the same block-update
values, applies the same updates at the same virtual times.  That is what
lets the port's tests hold whole trajectories against the JAX package's
golden runs.

Evaluation-cost model (opt-in)
------------------------------
The default async loop charges *zero* virtual time for coordinator work.
Setting ``cfg.eval_time`` or ``cfg.accel_eval="worker"`` opts into a second
event loop that models the evaluation pipeline explicitly:

- ``accel_eval="coordinator"``: each fire/record blocks the coordinator
  for its items' total eval time; arrivals popping inside that window are
  applied only when it ends.
- ``accel_eval="worker"``: eval items run on a modeled single-server eval
  queue that never blocks the coordinator; fires commit (with the
  staleness guard) when their last item completes, and due fires/records
  are coalesced while one is in flight.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

from ..fixedpoint import FixedPointProblem
from .base import Executor, register_executor
from .coordinator import (
    AccelPlan,
    Coordinator,
    RecordPlan,
    measure_compute,
    worker_eval,
)
from .types import RunConfig, RunResult, _fault_for

__all__ = ["VirtualTimeExecutor"]


@register_executor
class VirtualTimeExecutor(Executor):
    """Deterministic simulator; wall time is virtual seconds."""

    name = "virtual"

    def _execute(self, session) -> RunResult:
        problem, cfg = session.problem, session.cfg
        if cfg.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {cfg.mode!r}")
        coord = Coordinator(problem, cfg)
        compute = (
            cfg.compute_time if cfg.compute_time is not None
            else measure_compute(problem, coord.blocks)  # memoized partition
        )
        if cfg.mode == "sync":
            return self._run_sync(problem, cfg, coord, compute)
        if cfg.accel_eval == "worker" or cfg.eval_time is not None:
            return self._run_async_evalmodel(problem, cfg, coord, compute)
        return self._run_async(problem, cfg, coord, compute)

    # ----------------------------------------------------------------- #
    def _run_sync(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator,
        compute: float
    ) -> RunResult:
        t = 0.0
        rounds = 0
        arrivals = 0
        alive = set(range(cfg.n_workers))
        coord.record(t)
        while (coord.wu < cfg.max_updates and alive
               and arrivals < coord.max_arrivals):
            rounds += 1
            round_time = 0.0
            updates = []
            round_idx = coord.select_round_indices()
            for w in sorted(alive):
                prof = _fault_for(cfg, w)
                idx = round_idx[w]
                vals = worker_eval(problem, cfg, coord.x, idx)
                arrivals += 1
                cost = compute + prof.sample_delay(coord.rng)
                if prof.sample_crash(coord.rng):
                    # In-flight result lost; BSP barrier waits for the
                    # restart (or the worker leaves the round set forever).
                    coord.crashes += 1
                    if prof.restart_after is None:
                        alive.discard(w)
                    else:
                        coord.restarts += 1
                        cost += prof.restart_after
                    round_time = max(round_time, cost)
                    continue
                round_time = max(round_time, cost)
                updates.append((idx, vals, prof))
            t += round_time + cfg.sync_overhead
            for idx, vals, prof in updates:  # barrier: all computed on same x
                coord.apply_return(idx, vals, prof, staleness=0)
            if coord.accel is not None and rounds % cfg.fire_every == 0:
                coord.maybe_fire_accel()
            res = coord.record(t)
            if not np.isfinite(res) or res > 1e60:
                return coord.result(t, rounds, False)
            if coord.converged():
                return coord.result(t, rounds, True)
            if cfg.max_wall is not None and t > cfg.max_wall:
                break
        return coord.result(t, rounds, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator,
        compute: float
    ) -> RunResult:
        t = 0.0
        # Event tuples: (done, seq, worker, launch_wu, idx, vals); a restart
        # marker has idx=None and performs the relaunch when *popped*, so
        # the restarted worker snapshots x after its downtime.
        heap: List[Tuple[float, int, int, int, object, object]] = []
        seq = 0

        def launch(worker: int, now: float) -> None:
            nonlocal seq
            prof = _fault_for(cfg, worker)
            idx = coord.select_indices(worker)
            vals = worker_eval(problem, cfg, coord.x, idx)
            done = now + compute + cfg.async_overhead + prof.sample_delay(coord.rng)
            heapq.heappush(heap, (done, seq, worker, coord.wu, idx, vals))
            seq += 1

        def schedule_restart(worker: int, at: float) -> None:
            nonlocal seq
            heapq.heappush(heap, (at, seq, worker, coord.wu, None, None))
            seq += 1

        coord.record(t)
        for w in range(cfg.n_workers):
            launch(w, 0.0)
        since_record = 0  # arrivals (applied or not) since last record
        since_fire = 0
        arrivals = 0

        while (heap and coord.wu < cfg.max_updates
               and arrivals < coord.max_arrivals):
            t, _, worker, launch_wu, idx, vals = heapq.heappop(heap)
            prof = _fault_for(cfg, worker)
            if idx is None:  # restart marker: worker rejoins now
                coord.restarts += 1
                if coord.dispatchable(worker):
                    launch(worker, t)
                continue
            if cfg.sdc_guard and worker not in coord.active:
                # In-flight result of a worker the k-strikes policy already
                # quarantined: discard.
                coord.preempt_discards += 1
                continue
            arrivals += 1
            crashed = prof.sample_crash(coord.rng)
            if crashed:
                coord.crashes += 1
            else:
                staleness = coord.wu - launch_wu
                applied = coord.apply_return(
                    idx, vals, prof, staleness=staleness,
                    worker=worker if cfg.sdc_guard else None,
                )
                if applied:
                    since_fire += 1
                    if coord.accel is not None and since_fire >= cfg.fire_every:
                        coord.maybe_fire_accel()
                        since_fire = 0
            since_record += 1
            if since_record >= coord.record_every:
                res = coord.record(t)
                since_record = 0
                if not np.isfinite(res) or res > 1e60:
                    return coord.result(t, coord.wu, False)
                if coord.converged():
                    return coord.result(t, coord.wu, True)
            if cfg.max_wall is not None and t > cfg.max_wall:
                break
            if crashed:
                if prof.restart_after is not None:
                    schedule_restart(worker, t + prof.restart_after)
            elif coord.dispatchable(worker):
                launch(worker, t)
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_async_evalmodel(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator,
        compute: float
    ) -> RunResult:
        """Async loop with the opt-in evaluation-cost model (see module
        docstring).  Deterministic for a fixed seed, but not bit-identical
        to the default loop — it charges virtual time for evaluations the
        default loop treats as free.  Eval items cost ``cfg.eval_time``
        (default: the per-update compute cost) each; eval-service faults
        (``eval_crash_prob``) are not modeled here.
        """
        eval_cost = cfg.eval_time if cfg.eval_time is not None else compute
        worker_eval_mode = cfg.accel_eval == "worker"
        t = 0.0
        coord.record(0.0)
        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0
        coord_free = 0.0  # coordinator busy until (coordinator placement)
        server_free = 0.0  # eval-server busy until (worker placement)
        plans: List = []  # in-flight/queued eval pipelines (worker mode)
        since_fire = 0

        def push(done: float, tag: str, data: tuple) -> None:
            nonlocal seq
            heapq.heappush(heap, (done, seq, tag, data))
            seq += 1

        def launch(worker: int, now: float) -> None:
            prof = _fault_for(cfg, worker)
            idx = coord.select_indices(worker)
            vals = worker_eval(problem, cfg, coord.x, idx)
            done = (now + compute + cfg.async_overhead
                    + prof.sample_delay(coord.rng))
            push(done, "work", (worker, coord.wu, idx, vals))

        def submit_next_eval(now: float) -> None:
            """Start the front plan's next item on the eval server."""
            nonlocal server_free
            while plans:
                item = plans[0].next_item()
                if item is None:
                    plans.pop(0)
                    continue
                start = max(now, server_free)
                server_free = start + eval_cost
                push(server_free, "eval", ())
                return

        def fire_inline(now: float) -> float:
            """Coordinator-placement fire: evaluate inline, charge time."""
            plan = coord.accel_begin(now, pin="ref")
            if plan is None:
                return now
            items = 0
            item = plan.next_item()
            while item is not None:
                coord.accel_feed(plan, coord.eval_item(item))
                items += 1
                item = plan.next_item()
            coord.busy_s += items * eval_cost
            coord.accel_commit(plan, t=now + items * eval_cost)
            return now + items * eval_cost

        def begin_fire(now: float) -> None:
            if worker_eval_mode:
                if any(isinstance(p, AccelPlan) for p in plans):
                    return  # coalesce: one fire in flight at a time
                plan = coord.accel_begin(now)
                if plan is not None:
                    plans.append(plan)
                    if len(plans) == 1:
                        submit_next_eval(now)
            else:
                nonlocal coord_free
                coord_free = fire_inline(now)

        for w in range(cfg.n_workers):
            launch(w, 0.0)

        arrivals = 0
        while (heap and coord.wu < cfg.max_updates
               and arrivals < coord.max_arrivals):
            te, _, tag, data = heapq.heappop(heap)
            if tag == "eval":
                # One eval-server item finished (worker placement only).
                t = te
                plan = plans[0]
                value = coord.eval_item(plan.next_item())
                if isinstance(plan, AccelPlan):
                    coord.accel_feed(plan, value, offloaded=True)
                    if plan.next_item() is None:
                        plans.pop(0)
                        coord.accel_commit(plan, t=te)
                else:
                    plans.pop(0)
                    coord.record_commit(plan, value, offloaded=True)
                    if not np.isfinite(coord.res_norm) or coord.res_norm > 1e60:
                        break
                    if coord.converged():
                        # Confirm at the live iterate (inline contract).
                        res = coord.record(te)
                        if (not np.isfinite(res) or res > 1e60
                                or coord.converged()):
                            break
                submit_next_eval(te)
                continue
            if tag == "restart":
                (worker,) = data
                t = te
                coord.restarts += 1
                launch(worker, te)
                continue
            worker, launch_wu, idx, vals = data
            prof = _fault_for(cfg, worker)
            # Coordinator-placement evals serialize arrival processing.
            t_eff = max(te, coord_free) if not worker_eval_mode else te
            t = t_eff
            arrivals += 1
            crashed = prof.sample_crash(coord.rng)
            if crashed:
                coord.crashes += 1
            else:
                staleness = coord.wu - launch_wu
                applied = coord.apply_return(
                    idx, vals, prof, staleness=staleness
                )
                if applied:
                    since_fire += 1
                    if coord.accel is not None and since_fire >= cfg.fire_every:
                        since_fire = 0
                        begin_fire(t_eff)
                        t_eff = t = max(t_eff, coord_free)
            tick_stop, record_due = coord.arrival_tick_offload(t_eff)
            if record_due:
                if worker_eval_mode:
                    if not any(isinstance(p, RecordPlan) for p in plans):
                        plans.append(coord.record_begin(t_eff))
                        if len(plans) == 1:
                            submit_next_eval(t_eff)
                else:
                    coord.busy_s += eval_cost
                    coord_free = t_eff + eval_cost
                    t_eff = t = coord_free
                    res = coord.record(coord_free)
                    if not np.isfinite(res) or res > 1e60:
                        break
                    if coord.converged():
                        break
            if tick_stop:
                break
            if cfg.max_wall is not None and t > cfg.max_wall:
                break
            if crashed:
                if prof.restart_after is not None:
                    push(t_eff + prof.restart_after, "restart", (worker,))
                continue  # permanent crash: worker never relaunches
            launch(worker, t_eff)
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())
