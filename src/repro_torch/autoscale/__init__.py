"""Closed-loop autoscaling on the chaos substrate (paper §4 "flexible
computing infrastructure", made reactive).

The chaos layer makes worker membership *scriptable*; this package makes
it a control loop: a :class:`SignalProbe` samples observation snapshots
(:class:`ControlSignals`) at arrival ticks, a :class:`Controller` policy
turns them into the same ``join``/``preempt``/``pause``/``set_profile``
:class:`~repro_torch.chaos.ScenarioEvent` actions scripted scenarios use, and the
coordinator actuates them — uniformly across the virtual, thread, and
process backends, composing with scripted scenarios (script = weather,
controller = pilot).  Enable by setting ``RunConfig.controller`` to a
policy instance (or ``get_policy(name)``); runs without one pay nothing.

This is the port's copy of the reference's package: the same policies,
registry names, signals and cost model, so a policy takes the same
decisions in both packages on the same run.
"""

from .policies import (Controller, DrainAheadPolicy, StaticPolicy,
                       TargetStalenessPolicy, get_policy, policy,
                       policy_library, run_cost)
from .signals import ControlSignals, SignalProbe

__all__ = [
    "ControlSignals",
    "SignalProbe",
    "Controller",
    "StaticPolicy",
    "TargetStalenessPolicy",
    "DrainAheadPolicy",
    "policy",
    "policy_library",
    "get_policy",
    "run_cost",
]
