"""Autoscaling policies: controllers that close the observation loop.

A :class:`Controller` consumes :class:`~repro_torch.autoscale.signals.ControlSignals`
snapshots and returns :class:`~repro_torch.chaos.ScenarioEvent` actions — the very
same ``join`` / ``preempt`` / ``pause`` / ``resume`` / ``set_profile`` events
:class:`~repro_torch.chaos.ScenarioClock` already interprets.  That reuse is the
whole design: the coordinator applies controller actions through
``apply_scenario_event`` exactly like scripted ones, so policies run
uniformly on the virtual, thread, and process backends, compose with
scripted scenarios (the script is the *weather*, the controller the
*pilot*), and get recorded into capture traces for free.

The coordinator — not the policy — enforces the safety rails
(``Coordinator.controller_admissible``): a controller can never preempt or
pause away the last dispatchable worker, and can never "resurrect" a worker
the *script* took down (``scenario_down``) — scripted preemptions model
reclaimed infrastructure, and a pilot cannot conjure instances the provider
reclaimed.  Policies therefore return *intents*; the applied subset lands in
``Controller.decision_log``, which is deterministic on the virtual backend
for a fixed seed.

Registry: policies register with the :func:`policy` decorator (mirroring
``repro_torch.chaos.library``); ``policy_library()`` lists them and
:func:`get_policy` is the string entry point scripts and CLIs use.

Cost model: :func:`run_cost` scores a finished run as
``worker_seconds × time-to-solution`` — provisioned capacity times how long
you waited.  Lower is better; a policy Pareto-dominates a static membership
when it is no worse on both factors and >1x better on the product.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

from ..chaos.scenario import ScenarioEvent
from .signals import ControlSignals

__all__ = [
    "Controller", "StaticPolicy", "TargetStalenessPolicy", "DrainAheadPolicy",
    "policy", "policy_library", "get_policy", "run_cost",
]


class Controller:
    """Base controller: observe :class:`ControlSignals`, emit scenario events.

    Subclasses override :meth:`decide`.  Attributes read by the engine:

    - ``tick_every`` — arrivals between decisions (None => one fleet's worth);
    - ``tick_dt`` — optional wall/virtual-seconds decision cadence, used by
      the real backends' driver threads so a controller still gets ticks
      while arrivals are stalled (e.g. every member scripted away);
    - ``lookahead`` — seconds of scenario visibility requested in
      ``ControlSignals.upcoming`` (0 = the script is invisible);
    - ``queue_depth_fn`` — optional callable the serve layer installs so
      ``ControlSignals.queue_depth`` reflects pending requests;
    - ``decision_log`` — the applied actions, in order: a list of
      ``{"tick", "t", "kind", "worker"}`` dicts.  Deterministic on the
      virtual backend for a fixed seed.
    """

    name = "controller"
    tick_every: Optional[int] = None
    tick_dt: Optional[float] = None
    lookahead: float = 0.0

    def __init__(self) -> None:
        self.decision_log: List[dict] = []
        self.queue_depth_fn: Optional[Callable[[], int]] = None

    def reset(self, cfg) -> None:
        """Called once per run by the coordinator; clears per-run state."""
        self.decision_log = []

    def decide(self, sig: ControlSignals) -> List[ScenarioEvent]:
        """Return the actions to take at this decision point (may be [])."""
        return []

    # -- helpers shared by the shipped policies ------------------------- #
    @staticmethod
    def _shrink_to(sig: ControlSignals, size: int) -> List[ScenarioEvent]:
        """Preempt the highest-id active workers down to ``size`` members."""
        keep = sorted(sig.active)[:max(1, size)]
        return [ScenarioEvent(sig.t, "preempt", w)
                for w in sorted(sig.active, reverse=True) if w not in keep]

    @staticmethod
    def _joinable(sig: ControlSignals) -> List[int]:
        """Fleet ids a controller may bring in, lowest first."""
        return [w for w in range(sig.n_workers)
                if w not in sig.active and w not in sig.scenario_down]


# --------------------------------------------------------------------- #
# Registry (same shape as repro_torch.chaos.library: name -> factory + blurb)
# --------------------------------------------------------------------- #
_POLICIES: Dict[str, dict] = {}


def policy(name: str, description: str):
    """Register a controller factory under ``name`` (decorator)."""

    def deco(factory):
        _POLICIES[name] = {"factory": factory, "description": description}
        return factory

    return deco


def policy_library() -> Dict[str, str]:
    """Registered policy names -> one-line descriptions."""
    return {name: meta["description"] for name, meta in _POLICIES.items()}


def get_policy(name: str, **kwargs) -> Controller:
    """Instantiate a registered policy by name."""
    try:
        meta = _POLICIES[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; known: {sorted(_POLICIES)}") from None
    return meta["factory"](**kwargs)


# --------------------------------------------------------------------- #
# Cost model
# --------------------------------------------------------------------- #
def run_cost(result) -> float:
    """Cost of a finished run: worker-seconds × time-to-solution.

    ``worker_seconds`` integrates ``|active - paused|`` over the run (the
    capacity you paid for), ``wall_time`` is how long you waited; their
    product penalizes both over-provisioning and slow solutions, so a
    controller only wins by matching the full fleet's time-to-solution with
    fewer provisioned worker-seconds.  Runs without a controller never
    meter worker-seconds; fall back to ``n/a`` semantics via inf.
    """
    ws = getattr(result, "worker_seconds", 0.0)
    if ws <= 0.0 or result.wall_time <= 0.0:
        return math.inf
    return ws * result.wall_time


# --------------------------------------------------------------------- #
# Shipped policies
# --------------------------------------------------------------------- #
@policy("static",
        "fixed membership of `size` workers, no reactions — the baseline "
        "arm of the cost model (metered worker-seconds, zero decisions "
        "after the initial shaping)")
class StaticPolicy(Controller):
    """Hold a fixed membership: shrink to ``size`` at tick 0, then nothing.

    ``size=None`` keeps the full fleet — a pure metering run, whose
    worker-seconds come from the same accounting path as a reactive
    policy's.
    """

    name = "static"

    def __init__(self, size: Optional[int] = None):
        super().__init__()
        self.size = size

    def decide(self, sig: ControlSignals) -> List[ScenarioEvent]:
        if sig.tick > 0 or self.size is None:
            return []
        return self._shrink_to(sig, self.size)


@policy("target_staleness",
        "PI controller holding p95 applied-update staleness at a target "
        "under `accel_stale_limit`: joins spares when staleness (and hence "
        "parallel headroom) is low, sheds workers when the bound is "
        "threatened")
class TargetStalenessPolicy(Controller):
    """Hold the observed staleness distribution at a setpoint.

    In an async run, each applied update's staleness counts the updates
    applied while it was in flight, so p95 staleness ≈ (dispatchable
    members − 1) once the loop saturates: staleness *is* the concurrency
    the coordinator actually absorbs.  Feyzmahdavian & Johansson's bounds
    sharpen as the staleness bound shrinks, and Hannah & Yin's speedups
    are throughput-driven — so the setpoint says "run the largest
    membership whose staleness stays inside the budget".  A wave that
    scripts members away collapses observed staleness toward 0 → the PI
    error turns positive → the controller joins spare fleet ids; when the
    script rejoins the originals, staleness overshoots the target → it
    sheds back down.

    Shedding is ranked by observed throughput (lowest service fraction
    first), so when a straggler inflates the staleness tail the controller
    evicts *the straggler itself* and the coordinator migrates its blocks
    to fast survivors — membership-level straggler mitigation, the
    closed-loop version of the paper's async-over-sync argument.  Joins
    prefer fleet ids the controller never shed, so an evicted straggler is
    not immediately re-admitted while fresh spares exist.

    Velocity-form PI on ``err = target − p95``: per decision,
    ``Δu = kp·(err − prev_err) + ki·err`` accumulates into a fractional
    actuator; whole units become join/preempt events.  ``target=None``
    derives the setpoint as ``target_frac × accel_stale_limit``.

    Two anti-thrash guards keep the loop from bouncing membership (every
    join/preempt reassigns blocks and resets the Anderson window, so
    oscillation has a real price): errors inside ``deadband`` (relative to
    the target) zero the actuator instead of integrating, and after any
    membership action the controller sits out ``cooldown`` decision ticks
    so the staleness window can re-fill with post-change samples before it
    reacts again.
    """

    name = "target_staleness"

    def __init__(self, target: Optional[float] = None,
                 target_frac: float = 0.25,
                 kp: float = 0.4, ki: float = 0.6,
                 initial_size: Optional[int] = None,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 deadband: float = 0.25,
                 cooldown: int = 3,
                 tick_every: Optional[int] = None,
                 tick_dt: Optional[float] = 0.05):
        super().__init__()
        self.target = target
        self.target_frac = target_frac
        self.kp = kp
        self.ki = ki
        self.initial_size = initial_size
        self.min_workers = max(1, min_workers)
        self.max_workers = max_workers
        self.deadband = float(deadband)
        self.cooldown = max(0, int(cooldown))
        self.tick_every = tick_every
        self.tick_dt = tick_dt
        self._acc = 0.0
        self._prev_err: Optional[float] = None
        self._cool = 0
        self._shed: set = set()

    def reset(self, cfg) -> None:
        super().reset(cfg)
        self._acc = 0.0
        self._prev_err = None
        self._cool = 0
        self._shed = set()

    def decide(self, sig: ControlSignals) -> List[ScenarioEvent]:
        if sig.tick == 0:
            if self.initial_size is not None:
                self._cool = self.cooldown
                return self._shrink_to(sig, self.initial_size)
            return []
        if self._cool > 0:
            # Post-action settling: the staleness window still carries
            # samples from the previous membership — acting on them would
            # oscillate.  PI state is frozen, not integrated.
            self._cool -= 1
            return []
        target = (self.target if self.target is not None
                  else self.target_frac * sig.stale_limit)
        target = max(target, 1e-9)
        if not sig.staleness_window:
            # No applied arrivals since the window started filling — either
            # the run just began or the membership was wiped.  Treat as
            # maximal headroom so the controller refills capacity.
            err = 1.0
        else:
            err = (target - sig.staleness_p95) / target
        if abs(err) <= self.deadband:
            # Close enough: quiesce rather than integrate toward a flap.
            self._acc = 0.0
            self._prev_err = err
            return []
        prev = self._prev_err if self._prev_err is not None else err
        self._acc += self.kp * (err - prev) + self.ki * err
        self._prev_err = err
        step = int(self._acc)  # truncate toward zero: whole units actuate
        if step == 0:
            return []
        cur = len(sig.active - sig.paused)
        cap = self.max_workers if self.max_workers is not None \
            else sig.n_workers
        desired = max(self.min_workers, min(cap, cur + step))
        actions: List[ScenarioEvent] = []
        if desired > cur:
            # Prefer fleet ids this controller never shed (fresh spares)
            # over re-admitting a worker it just deemed unproductive.
            ranked = sorted(self._joinable(sig),
                            key=lambda w: (w in self._shed, w))
            for w in ranked[:desired - cur]:
                actions.append(ScenarioEvent(sig.t, "join", w))
        elif desired < cur:
            # Shed the members contributing least throughput first — under
            # a straggler that is the straggler itself, whose blocks then
            # migrate to fast survivors (membership-level straggler
            # mitigation); ties break toward the highest id.
            frac = sig.service_fractions
            sheddable = sorted(sig.active - sig.paused,
                               key=lambda w: (frac.get(w, 0.0), -w))
            for w in sheddable[:cur - desired]:
                self._shed.add(w)
                actions.append(ScenarioEvent(sig.t, "preempt", w))
        # Consume only what was actuated; the rest stays banked (clamped so
        # a long saturation at the rail cannot wind up unboundedly).
        self._acc -= step
        self._acc = max(-2.0, min(2.0, self._acc))
        if actions:
            self._cool = self.cooldown
        return actions


@policy("drain_ahead",
        "scenario-lookahead drainer: pauses workers shortly before their "
        "scripted preemption so in-flight work lands before the instance "
        "is reclaimed (zero preempt discards when the script is visible)")
class DrainAheadPolicy(Controller):
    """Drain before visible preemption waves.

    When the scenario script is visible (spot reclamation warnings, planned
    maintenance), pausing a worker ``lookahead`` seconds before its scripted
    ``preempt`` lets its in-flight update apply and stops new dispatches —
    the preemption then discards nothing.  Workers return via the script's
    own ``join`` events (preempting clears the pause flag).
    """

    name = "drain_ahead"

    def __init__(self, lookahead: float = 0.25,
                 tick_every: Optional[int] = None,
                 tick_dt: Optional[float] = 0.02):
        super().__init__()
        self.lookahead = float(lookahead)
        self.tick_every = tick_every if tick_every is not None else 1
        self.tick_dt = tick_dt
        self._draining: set = set()

    def reset(self, cfg) -> None:
        super().reset(cfg)
        self._draining = set()

    def decide(self, sig: ControlSignals) -> List[ScenarioEvent]:
        # Forget drains whose preemption has landed (worker left active).
        self._draining &= set(sig.active)
        actions: List[ScenarioEvent] = []
        for t_ev, kind, worker in sig.upcoming:
            if kind != "preempt" or worker is None:
                continue
            if (worker in sig.active and worker not in sig.paused
                    and worker not in self._draining):
                self._draining.add(worker)
                actions.append(ScenarioEvent(sig.t, "pause", worker))
        return actions
