"""Registered library of chaos scenarios.

Each scenario is a factory ``(n_workers, **knobs) -> FaultScenario``
registered under a stable name: the port's copy of the reference's
library, with the same names, knobs and defaults, so one name builds the
same script in both packages.

Default timings assume a run lasting a few seconds on the target backend;
use :meth:`FaultScenario.scaled` to stretch a script to slower problems.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.engine.types import FaultProfile
from .scenario import FaultScenario

__all__ = ["scenario", "scenario_library", "get_scenario",
           "spot_wave", "rolling_restart", "bimodal_stragglers",
           "flash_crowd", "sdc_storm"]

_LIBRARY: Dict[str, dict] = {}


def scenario(name: str, description: str) -> Callable:
    """Register a scenario factory under ``name`` (decorator)."""

    def deco(fn: Callable) -> Callable:
        _LIBRARY[name] = {"factory": fn, "description": description}
        return fn

    return deco


def scenario_library() -> Dict[str, str]:
    """Registered scenario names -> one-line descriptions."""
    return {name: info["description"] for name, info in
            sorted(_LIBRARY.items())}


def get_scenario(name: str, n_workers: int, **kw) -> FaultScenario:
    """Build a registered scenario for a ``n_workers``-worker run."""
    try:
        info = _LIBRARY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; registered: {sorted(_LIBRARY)}"
        ) from None
    scn = info["factory"](n_workers, **kw)
    scn.validate(n_workers)
    return scn


# --------------------------------------------------------------------- #
# The library
# --------------------------------------------------------------------- #
@scenario("spot_wave",
          "spot-instance reclamation: half the fleet is preempted in a "
          "staggered wave and rejoins after a downtime window, while a "
          "surviving worker straggles on the crunched capacity")
def spot_wave(n_workers: int, *, t0: float = 0.5, downtime: float = 1.5,
              stagger: float = 0.1, slow: float = 0.1) -> FaultScenario:
    s = FaultScenario(
        "spot_wave",
        "preemption wave over half the fleet + a straggling survivor")
    lost = list(range(1, max(2, n_workers // 2 + 1)))
    # Capacity crunch: worker 0 survives but straggles from the wave on.
    s.set_profile(t0, FaultProfile(delay_mean=slow), worker=0)
    for k, w in enumerate(lost):
        s.preempt(t0 + k * stagger, w)
    for k, w in enumerate(lost):
        s.join(t0 + downtime + k * stagger, w)
    return s


@scenario("rolling_restart",
          "rolling maintenance: each worker in turn is preempted and "
          "rejoins one downtime later, so the membership is always one "
          "short but never collapses")
def rolling_restart(n_workers: int, *, start: float = 0.3,
                    period: float = 0.6,
                    downtime: float = 0.45) -> FaultScenario:
    if downtime >= period:
        raise ValueError("rolling_restart needs downtime < period "
                         "(windows must not overlap into a full outage)")
    s = FaultScenario("rolling_restart",
                      "one-at-a-time preempt/join across the fleet")
    for w in range(n_workers):
        t = start + w * period
        s.preempt(t, w)
        s.join(t + downtime, w)
    return s


@scenario("bimodal_stragglers",
          "bimodal delay regime: one worker alternates between fast and "
          "100 ms-straggler service periods (time-varying heterogeneous "
          "delays, Hannah & Yin's async-speedup regime)")
def bimodal_stragglers(n_workers: int, *, t0: float = 0.2, t1: float = 4.0,
                       period: float = 0.5,
                       slow: float = 0.1) -> FaultScenario:
    s = FaultScenario("bimodal_stragglers",
                      "alternating fast/slow service on worker 0")
    s.bimodal_delay(t0, t1, period, FaultProfile(delay_mean=slow), worker=0)
    return s


@scenario("sdc_storm",
          "silent-data-corruption storm: a growing fraction of returns "
          "from half the fleet is corrupted (bit-flips ramping in "
          "probability), exercising the coordinator-side SDC guard and "
          "the k-strikes quarantine")
def sdc_storm(n_workers: int, *, t0: float = 0.3, t1: float = 3.0,
              p0: float = 0.02, p1: float = 0.25, steps: int = 4,
              mode: str = "bitflip") -> FaultScenario:
    s = FaultScenario(
        "sdc_storm",
        "ramped corrupt_prob across half the fleet (bit-flip SDC)")
    dirty = list(range(1, max(2, n_workers // 2 + 1)))
    # Piecewise-constant ramp: each step raises corrupt_prob on the dirty
    # subset; clean workers keep the run's baseline profile throughout.
    for k in range(steps + 1):
        frac = k / steps
        prof = FaultProfile(corrupt_prob=p0 + frac * (p1 - p0),
                            corrupt_mode=mode)
        for w in dirty:
            s.set_profile(t0 + frac * (t1 - t0), prof, worker=w)
    return s


@scenario("flash_crowd",
          "elastic scale-up: the run starts on a single worker (the rest "
          "preempted at t=0) and the full fleet joins in a burst, with the "
          "incumbent ramping out of an initial straggle")
def flash_crowd(n_workers: int, *, join_at: float = 0.8,
                stagger: float = 0.05, ramp_from: float = 0.05) -> FaultScenario:
    s = FaultScenario("flash_crowd", "solo start, burst join of the fleet")
    for w in range(1, n_workers):
        s.preempt(0.0, w)
    # The incumbent starts overloaded and ramps back to clean service as
    # the crowd absorbs the load.
    s.ramp_delay(0.0, join_at + 0.5, ramp_from, 0.0, steps=4, worker=0)
    for k, w in enumerate(range(1, n_workers)):
        s.join(join_at + k * stagger, w)
    return s
