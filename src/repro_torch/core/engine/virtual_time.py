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
golden runs.  Chaos scenarios, trace capture and autoscale controllers
take their own event loops (:meth:`VirtualTimeExecutor._run_async_chaos`,
:meth:`~VirtualTimeExecutor._run_sync_chaos`); runs without them never
enter those loops.  Checkpoints carry the default loop's event heap, so a
resumed run continues bit-identically.  Telemetry hooks read the virtual
clock and change nothing the loops compute.

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
            if cfg.scenario is not None or cfg.controller is not None:
                return self._run_sync_chaos(problem, cfg, coord, compute)
            return self._run_sync(problem, cfg, coord, compute)
        if (cfg.scenario is not None or cfg.capture_trace
                or cfg.controller is not None):
            # Scenarios, trace capture and controllers take their own
            # event loop; runs without them never enter it.
            return self._run_async_chaos(problem, cfg, coord, compute)
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
        tel = coord.telemetry  # None by default: loop below is untouched
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
                    if tel is not None:
                        tel.task_open(w, t)
                        tel.task_close(w, t + cost, disp="crash")
                    continue
                round_time = max(round_time, cost)
                updates.append((idx, vals, prof))
                if tel is not None:
                    tel.task_open(w, t)
                    tel.task_close(w, t + cost)
            t += round_time + cfg.sync_overhead
            if tel is not None:
                tel.set_time(t)
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
        tel = coord.telemetry  # None by default: loop below is untouched

        def launch(worker: int, now: float) -> None:
            nonlocal seq
            prof = _fault_for(cfg, worker)
            idx = coord.select_indices(worker)
            vals = worker_eval(problem, cfg, coord.x, idx)
            done = now + compute + cfg.async_overhead + prof.sample_delay(coord.rng)
            heapq.heappush(heap, (done, seq, worker, coord.wu, idx, vals))
            seq += 1
            if tel is not None:
                tel.task_open(worker, now)

        def schedule_restart(worker: int, at: float) -> None:
            nonlocal seq
            heapq.heappush(heap, (at, seq, worker, coord.wu, None, None))
            seq += 1

        def loop_state():
            """Resumable loop state for a SolveCheckpoint: the event heap
            (block ids where possible; payload arrays in the npz), the
            cadence counters and the compute cost (reused on resume so the
            ``done`` arithmetic replays exactly)."""
            block_ids = {id(blk): b for b, blk in enumerate(coord.blocks)}
            meta = {"kind": "virtual_async", "t": t, "seq": seq,
                    "compute": compute, "since_record": since_record,
                    "since_fire": since_fire, "arrivals": arrivals,
                    "heap": []}
            arrays = {}
            for k, (done, s, w, lwu, idx, vals) in enumerate(heap):
                ent = {"done": done, "seq": s, "worker": w, "launch_wu": lwu}
                if idx is None:
                    ent["kind"] = "restart"
                else:
                    ent["kind"] = "work"
                    bid = block_ids.get(id(idx))
                    if bid is not None:
                        ent["block"] = bid
                    else:  # dynamic selection: store the index set itself
                        arrays[f"heap_idx_{k}"] = np.asarray(idx)
                    arrays[f"heap_vals_{k}"] = np.asarray(vals)
                meta["heap"].append(ent)
            return meta, arrays

        if cfg.resume_from is not None:
            # Restore the coordinator, rebuild the event heap against this
            # coordinator's memoized block objects (the id-keyed slice
            # cache must recognize them) and skip the initial record and
            # launches, which happened before the snapshot.
            from ...recover.checkpoint import (
                resolve_checkpoint, restore_coordinator)

            ckpt = resolve_checkpoint(cfg.resume_from)
            restore_coordinator(coord, ckpt)
            loop = ckpt.loop
            if loop.get("kind") != "virtual_async":
                raise ValueError(
                    f"checkpoint loop state is {loop.get('kind')!r}, not "
                    "resumable on the virtual backend's default async loop")
            t = float(loop["t"])
            seq = int(loop["seq"])
            compute = float(loop["compute"])
            since_record = int(loop["since_record"])
            since_fire = int(loop["since_fire"])
            arrivals = int(loop["arrivals"])
            for k, ent in enumerate(loop["heap"]):
                if ent["kind"] == "restart":
                    idx = vals = None
                elif "block" in ent:
                    idx = coord.blocks[int(ent["block"])]
                    vals = ckpt.arrays[f"heap_vals_{k}"]
                else:
                    idx = ckpt.arrays[f"heap_idx_{k}"]
                    vals = ckpt.arrays[f"heap_vals_{k}"]
                heap.append((float(ent["done"]), int(ent["seq"]),
                             int(ent["worker"]), int(ent["launch_wu"]),
                             idx, vals))
            heapq.heapify(heap)
        else:
            coord.record(t)
            for w in range(cfg.n_workers):
                launch(w, 0.0)
            since_record = 0  # arrivals (applied or not) since last record
            since_fire = 0
            arrivals = 0

        while (heap and coord.wu < cfg.max_updates
               and arrivals < coord.max_arrivals):
            t, _, worker, launch_wu, idx, vals = heapq.heappop(heap)
            if tel is not None:
                tel.set_time(t)
            prof = _fault_for(cfg, worker)
            if idx is None:  # restart marker: worker rejoins now
                coord.restarts += 1
                if tel is not None:
                    tel.instant("restart", f"w{worker}", t)
                if coord.dispatchable(worker):
                    launch(worker, t)
                continue
            if cfg.sdc_guard and worker not in coord.active:
                # In-flight result of a worker the k-strikes policy already
                # quarantined: discard.
                coord.preempt_discards += 1
                if tel is not None:
                    tel.task_close(worker, t, disp="preempt_discard")
                continue
            arrivals += 1
            crashed = prof.sample_crash(coord.rng)
            if crashed:
                coord.crashes += 1
                if tel is not None:
                    tel.task_close(worker, t, disp="crash")
            else:
                staleness = coord.wu - launch_wu
                applied = coord.apply_return(
                    idx, vals, prof, staleness=staleness,
                    worker=worker if cfg.sdc_guard else None,
                )
                if tel is not None:
                    # Close before any fire below, so an inline fire's
                    # open-task count covers only the *other* workers.
                    tel.task_close(
                        worker, t, disp="applied" if applied else "filtered",
                        staleness=staleness)
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
            coord.maybe_checkpoint(t, loop_state)
        coord.record(t)
        return coord.result(t, coord.wu, coord.converged())

    # ----------------------------------------------------------------- #
    def _run_sync_chaos(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator,
        compute: float
    ) -> RunResult:
        """BSP loop under a chaos scenario (``cfg.scenario``) and/or an
        autoscale controller (``cfg.controller``).

        Events apply at round boundaries: preempted workers leave the
        round set and their blocks are served by the survivors (a survivor
        holding two blocks pays 2x compute that round), paused workers
        idle with their blocks parked, and ``set_profile`` changes the
        delay/crash draws from the next round on.  When every worker is
        out of the membership the clock jumps to the next event.
        """
        from ...chaos.scenario import ScenarioClock

        clock = ScenarioClock(cfg.scenario)
        t = 0.0
        rounds = 0
        arrivals = 0
        alive = set(range(cfg.n_workers))
        tel = coord.telemetry
        coord.record(t)
        while (coord.wu < cfg.max_updates
               and arrivals < coord.max_arrivals):
            if tel is not None:
                tel.set_time(t)
            for ev in clock.due(t):
                coord.apply_scenario_event(ev, t)
            # Controller decisions land at round boundaries (the BSP
            # granularity); the round set below is re-derived from the
            # membership every round, so actions need no plumbing.
            coord.controller_tick(t, arrivals)
            parts = [w for w in coord.round_participants() if w in alive]
            if not parts:
                nt = clock.next_time()
                if nt is None or not alive:
                    break  # membership can never recover
                t = max(t, nt)
                continue
            rounds += 1
            round_time = 0.0
            updates = []
            for w in parts:
                prof = coord.fault_for(w)
                idx = coord.round_assignment(w)
                vals = worker_eval(problem, cfg, coord.x, idx)
                arrivals += 1
                # A multi-block assignment costs one compute per block.
                blocks_held = max(len(coord.worker_blocks.get(w, [])), 1)
                cost = blocks_held * compute + prof.sample_delay(coord.rng)
                if prof.sample_crash(coord.rng):
                    coord.crashes += 1
                    if prof.restart_after is None:
                        alive.discard(w)
                    else:
                        coord.restarts += 1
                        cost += prof.restart_after
                    round_time = max(round_time, cost)
                    if tel is not None:
                        tel.task_open(w, t, gen=coord.preempt_gen[w])
                        tel.task_close(w, t + cost, disp="crash",
                                       gen=coord.preempt_gen[w])
                    continue
                round_time = max(round_time, cost)
                updates.append((w, idx, vals, prof))
                if tel is not None:
                    tel.task_open(w, t, gen=coord.preempt_gen[w])
                    tel.task_close(w, t + cost, gen=coord.preempt_gen[w])
            t += round_time + cfg.sync_overhead
            if tel is not None:
                tel.set_time(t)
            for w, idx, vals, prof in updates:
                coord.apply_return(idx, vals, prof, staleness=0, worker=w)
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
    def _run_async_chaos(
        self, problem: FixedPointProblem, cfg: RunConfig, coord: Coordinator,
        compute: float
    ) -> RunResult:
        """Async event loop with chaos scenarios, trace capture and/or an
        autoscale controller.

        Scenario events are heap-scheduled alongside worker completions,
        so a ``join`` launches its worker at exactly the scripted virtual
        time and a ``set_profile`` governs every later dispatch.  A worker
        preempted with a result in flight has that result *discarded* on
        arrival (``preempt_gen`` recognizes the stale incarnation);
        paused workers' results apply but the worker parks until resume.
        Deterministic for a fixed seed.
        """
        from ...chaos.scenario import ScenarioClock
        from ...chaos.trace import TraceRecorder

        if cfg.capture_trace:
            coord.tracer = TraceRecorder(cfg, self.name, problem)
        clock = ScenarioClock(cfg.scenario)
        t = 0.0
        tel = coord.telemetry
        # Events before the first dispatch (flash_crowd's t=0 preempts)
        # shape the initial membership.
        for ev in clock.due(0.0):
            coord.apply_scenario_event(ev, 0.0)
        coord.record(0.0)
        heap: List[Tuple[float, int, str, tuple]] = []
        seq = 0
        parked: set = set()  # paused workers whose last result has landed

        def push(done: float, tag: str, data: tuple) -> None:
            nonlocal seq
            heapq.heappush(heap, (done, seq, tag, data))
            seq += 1

        def launch(worker: int, now: float) -> None:
            parked.discard(worker)  # in flight now: parked means awaiting
            prof = coord.fault_for(worker)
            gen = coord.preempt_gen[worker]
            bid, idx = coord.next_dispatch(worker)
            vals = worker_eval(problem, cfg, coord.x, idx)
            done = (now + compute + cfg.async_overhead
                    + prof.sample_delay(coord.rng))
            if coord.tracer is not None:
                coord.tracer.dispatch(now, worker, bid, gen)
            if tel is not None:
                tel.task_open(worker, now, gen=gen, block=bid)
            push(done, "work", (worker, gen, coord.wu, idx, vals))

        def plumb_controller(actions, now: float) -> None:
            """Backend plumbing for applied controller actions: launch
            joined workers, relaunch parked ones a resume freed."""
            for cev in actions:
                if cev.kind == "join":
                    if coord.dispatchable(cev.worker):
                        launch(cev.worker, now)
                    elif cev.worker in coord.active:
                        parked.add(cev.worker)  # joined into a pause
                elif cev.kind == "resume":
                    for pw in sorted(parked):
                        if coord.dispatchable(pw):
                            launch(pw, now)

        # Initial controller decision (tick 0) shapes the membership
        # before the first dispatches: joins/preempts here determine which
        # workers the launch loop below starts.
        coord.controller_tick(0.0)
        for ev in clock.drain():
            push(ev.t, "chaos", (ev,))
        for w in range(cfg.n_workers):
            if coord.dispatchable(w):
                launch(w, 0.0)
            elif w in coord.active:
                parked.add(w)  # paused before first dispatch: resumable

        since_record = 0
        since_fire = 0
        arrivals = 0
        t_now = 0.0

        def loop_state():
            """Chaos-loop checkpoints resume on the *default* loop (the
            scenario's remaining events die with the control plane), so
            the state is emitted in the default loop's ``virtual_async``
            format: pending chaos events are dropped, and so are in-flight
            results/restarts of preempted incarnations — the live loop
            would discard them anyway."""
            block_ids = {id(blk): b for b, blk in enumerate(coord.blocks)}
            meta = {"kind": "virtual_async", "t": t_now, "seq": seq,
                    "compute": compute, "since_record": since_record,
                    "since_fire": since_fire, "arrivals": arrivals,
                    "heap": []}
            arrays = {}
            for done, s, tag, data in heap:
                k = len(meta["heap"])  # arrays key by *kept* position
                if tag == "chaos":
                    continue
                if tag == "restart":
                    w, gen = data
                    if gen != coord.preempt_gen[w]:
                        continue
                    meta["heap"].append(
                        {"done": done, "seq": s, "worker": w,
                         "launch_wu": coord.wu, "kind": "restart"})
                    continue
                w, gen, lwu, idx, vals = data
                if gen != coord.preempt_gen[w]:
                    continue
                ent = {"done": done, "seq": s, "worker": w,
                       "launch_wu": lwu, "kind": "work"}
                bid = block_ids.get(id(idx))
                if bid is not None:
                    ent["block"] = bid
                else:
                    arrays[f"heap_idx_{k}"] = np.asarray(idx)
                arrays[f"heap_vals_{k}"] = np.asarray(vals)
                meta["heap"].append(ent)
            return meta, arrays

        while (heap and coord.wu < cfg.max_updates
               and arrivals < coord.max_arrivals):
            t, _, tag, data = heapq.heappop(heap)
            t_now = t
            if tel is not None:
                tel.set_time(t)
            if tag == "chaos":
                (ev,) = data
                was_paused = set(coord.paused)
                coord.apply_scenario_event(ev, t)
                if ev.kind == "join":
                    if coord.dispatchable(ev.worker):
                        launch(ev.worker, t)
                    elif ev.worker in coord.active:
                        parked.add(ev.worker)  # joined into a pause
                elif ev.kind == "resume":
                    for w in sorted(was_paused - coord.paused):
                        if w in parked and coord.dispatchable(w):
                            parked.discard(w)
                            launch(w, t)
                continue
            if tag == "restart":
                worker, gen = data
                if gen != coord.preempt_gen[worker]:
                    # The crashed incarnation was preempted during its
                    # downtime: no restart, and no second dispatch stream.
                    continue
                coord.restarts += 1
                if coord.tracer is not None:
                    coord.tracer.restart(t, worker)
                if tel is not None:
                    tel.instant("restart", f"w{worker}" if gen == 0
                                else f"w{worker}#r{gen}", t)
                if coord.dispatchable(worker):
                    launch(worker, t)
                elif worker in coord.active:  # rejoined into a pause
                    parked.add(worker)
                continue
            worker, gen, launch_wu, idx, vals = data
            if gen != coord.preempt_gen[worker]:
                # Preempted while in flight: the result is discarded and
                # the old incarnation never relaunches.
                coord.preempt_discards += 1
                if coord.tracer is not None:
                    coord.tracer.arrival(t, worker, "preempt_discard",
                                         gen=gen)
                if tel is not None:
                    tel.task_close(worker, t, disp="preempt_discard",
                                   gen=gen)
                continue
            prof = coord.fault_for(worker)
            arrivals += 1
            crashed = prof.sample_crash(coord.rng)
            if crashed:
                coord.crashes += 1
                if coord.tracer is not None:
                    coord.tracer.arrival(t, worker, "crash", gen=gen)
                if tel is not None:
                    tel.task_close(worker, t, disp="crash", gen=gen)
            else:
                staleness = coord.wu - launch_wu
                applied = coord.apply_return(
                    idx, vals, prof, staleness=staleness, worker=worker
                )
                if coord.tracer is not None:
                    coord.tracer.arrival(
                        t, worker, "applied" if applied else "filtered",
                        staleness, gen=gen)
                if tel is not None:
                    tel.task_close(
                        worker, t, disp="applied" if applied else "filtered",
                        staleness=staleness, gen=gen)
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
            # Controller decision opportunity at the arrival tick: a
            # preempt of this very worker suppresses its relaunch below.
            plumb_controller(coord.controller_tick(t, arrivals), t)
            if crashed:
                if prof.restart_after is not None:
                    push(t + prof.restart_after, "restart", (worker, gen))
            elif coord.dispatchable(worker):
                launch(worker, t)
            elif worker in coord.active:  # paused mid-flight: park
                parked.add(worker)
            coord.maybe_checkpoint(t, loop_state)
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
        tel = coord.telemetry

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
            if tel is not None:
                tel.task_open(worker, now)

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
            if tel is not None:
                tel.set_time(te)
            if tag == "eval":
                # One eval-server item finished (worker placement only).
                t = te
                if tel is not None:
                    tel.span("eval", "eval", te - eval_cost, te,
                             offload=True)
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
                if tel is not None:
                    tel.instant("restart", f"w{worker}", te)
                launch(worker, te)
                continue
            worker, launch_wu, idx, vals = data
            prof = _fault_for(cfg, worker)
            # Coordinator-placement evals serialize arrival processing.
            t_eff = max(te, coord_free) if not worker_eval_mode else te
            t = t_eff
            if tel is not None:
                tel.set_time(t_eff)
            arrivals += 1
            crashed = prof.sample_crash(coord.rng)
            if crashed:
                coord.crashes += 1
                if tel is not None:
                    tel.task_close(worker, t_eff, disp="crash")
            else:
                staleness = coord.wu - launch_wu
                applied = coord.apply_return(
                    idx, vals, prof, staleness=staleness
                )
                if tel is not None:
                    tel.task_close(
                        worker, t_eff,
                        disp="applied" if applied else "filtered",
                        staleness=staleness)
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
