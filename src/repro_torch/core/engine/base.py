"""Executor abstraction: pluggable execution backends for the engine.

An :class:`Executor` turns a (problem, config) pair into a
:class:`~repro_torch.core.engine.types.RunResult`.  Executor instances are
stateless and reentrant: all per-request state lives in the
:class:`~repro_torch.core.engine.session.SolveSession` that
:meth:`Executor.submit` creates, so any number of sessions may execute
concurrently against one backend (``run()`` is the one-shot wrapper:
submit + execute inline).  Backends registered here are addressed by
``RunConfig.executor``:

- ``"virtual"`` — deterministic discrete-event simulator (virtual seconds);
- ``"thread"``  — real concurrent workers in a thread pool (wall seconds);
- ``"process"`` — persistent pools of spawned worker interpreters, each
  with its own CUDA context when the problem is on the card (wall
  seconds);
- ``"ray"``     — Ray actors, the paper's §4 runtime (optional dependency;
  actors ask Ray for a share of the card when the problem is on it).

Backends with an unsatisfied dependency register through
:func:`register_unavailable` instead: they stay out of
:func:`available_executors` (so parameterized tests and benchmarks skip
them cleanly) but :func:`get_executor` explains what is missing rather
than claiming the name is unknown.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Type

from ..fixedpoint import FixedPointProblem
from .session import SolveSession
from .types import RunConfig, RunResult

__all__ = [
    "Executor",
    "SolveSession",
    "register_executor",
    "register_unavailable",
    "get_executor",
    "available_executors",
    "known_executors",
]


class Executor(abc.ABC):
    """An execution backend for (a)synchronous fixed-point runs.

    Subclasses implement :meth:`_execute`, which reads everything it needs
    from the session and must keep all mutable state local to the call so
    overlapping sessions never interfere.
    """

    #: registry key; subclasses must override
    name: str = ""

    def submit(self, problem: FixedPointProblem, cfg: RunConfig,
               *, start: bool = True) -> SolveSession:
        """Create a :class:`SolveSession` for (problem, cfg).

        With ``start`` (the default) the session begins executing on a
        background thread immediately; ``start=False`` returns it PENDING
        so the caller decides where and when it runs (the service layer's
        dispatcher threads, or ``run()`` inline).
        """
        session = SolveSession(self, problem, cfg)
        if start:
            session.start()
        return session

    def run(self, problem: FixedPointProblem, cfg: RunConfig) -> RunResult:
        """Execute one run of ``problem`` under ``cfg`` and return the result.

        Thin wrapper: one session executed inline on the calling thread —
        byte-identical behaviour (including exceptions) to the pre-session
        engine.
        """
        return self.submit(problem, cfg, start=False).execute()

    @abc.abstractmethod
    def _execute(self, session: SolveSession) -> RunResult:
        """Backend entry point: run ``session.problem`` under ``session.cfg``."""


_REGISTRY: Dict[str, Type[Executor]] = {}
_UNAVAILABLE: Dict[str, str] = {}


def register_executor(cls: Type[Executor]) -> Type[Executor]:
    """Register an Executor subclass under ``cls.name`` (decorator-friendly)."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must define a non-empty .name")
    _REGISTRY[cls.name] = cls
    _UNAVAILABLE.pop(cls.name, None)
    return cls


def register_unavailable(name: str, reason: str) -> None:
    """Declare a known backend whose dependency is missing in this env."""
    if name not in _REGISTRY:
        _UNAVAILABLE[name] = reason


def get_executor(name: str) -> Executor:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        if name in _UNAVAILABLE:
            raise ValueError(
                f"executor {name!r} is unavailable: {_UNAVAILABLE[name]}"
            ) from None
        raise ValueError(
            f"unknown executor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls()


def available_executors() -> List[str]:
    """Names that :func:`get_executor` will actually instantiate here."""
    return sorted(_REGISTRY)


def known_executors() -> Dict[str, str]:
    """All known backends: name -> "available" or the unavailability reason."""
    out = {n: "available" for n in _REGISTRY}
    out.update(_UNAVAILABLE)
    return dict(sorted(out.items()))
