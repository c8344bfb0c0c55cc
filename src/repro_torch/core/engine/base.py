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
  seconds).

The reference's Ray backend is not ported yet (``RunConfig`` refuses it).
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


def register_executor(cls: Type[Executor]) -> Type[Executor]:
    """Register an Executor subclass under ``cls.name`` (decorator-friendly)."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must define a non-empty .name")
    _REGISTRY[cls.name] = cls
    return cls


def get_executor(name: str) -> Executor:
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls()


def available_executors() -> List[str]:
    """Names that :func:`get_executor` will actually instantiate here."""
    return sorted(_REGISTRY)


def known_executors() -> Dict[str, str]:
    """All known backends: name -> "available" or why it is not (the
    reference's backends this port has not ported yet)."""
    from .types import _UNPORTED_EXECUTORS

    out = {n: "available" for n in _REGISTRY}
    for name, item in _UNPORTED_EXECUTORS.items():
        out.setdefault(name, f"not ported to repro_torch yet: {item}")
    return dict(sorted(out.items()))
