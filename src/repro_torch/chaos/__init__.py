"""Chaos scenarios: scripted time-varying faults, elastic worker
membership, and deterministic trace capture/replay (the port's copy of
the reference's ``chaos`` package).

Declarative :class:`FaultScenario` scripts (timestamped profile changes,
preemptions, joins, pauses, coordinator crashes and delay-trace segments)
are interpreted identically by every engine backend (virtual seconds on
the simulator, wall seconds on thread/process), a registered library
(``spot_wave``, ``rolling_restart``, ``bimodal_stragglers``,
``flash_crowd``, ``sdc_storm``) builds the standard ones, and trace
capture/replay compares a measured run against its deterministic virtual
re-execution.

Entry points:

- attach a scenario:  ``RunConfig(scenario=get_scenario("spot_wave", p))``
- capture a trace:    ``RunConfig(capture_trace=True)`` -> ``RunResult.trace``
- replay it:          ``replay_trace(problem, trace, cfg)``
- compare:            ``trace_agreement(measured, replayed)``
"""

from .library import (
    bimodal_stragglers,
    flash_crowd,
    get_scenario,
    rolling_restart,
    scenario,
    scenario_library,
    sdc_storm,
    spot_wave,
)
from .scenario import EVENT_KINDS, FaultScenario, ScenarioClock, ScenarioEvent
from .trace import RunTrace, TraceRecorder, replay_trace, trace_agreement

__all__ = [
    "ScenarioEvent",
    "FaultScenario",
    "ScenarioClock",
    "EVENT_KINDS",
    "scenario",
    "scenario_library",
    "get_scenario",
    "spot_wave",
    "rolling_restart",
    "bimodal_stragglers",
    "flash_crowd",
    "sdc_storm",
    "RunTrace",
    "TraceRecorder",
    "replay_trace",
    "trace_agreement",
]
