"""Solve sessions: one in-flight request against an executor backend.

A :class:`SolveSession` is one request against a backend: it owns
every piece of per-request state (problem, config, lifecycle, result or
error) so that executor *instances* stay stateless and reentrant — any
number of sessions may execute concurrently against the same backend.

Lifecycle::

    PENDING --start()/execute()--> RUNNING --+--> DONE    (result set)
        |                                    +--> FAILED  (exception set)
        +--cancel()--> CANCELLED   (never started)

``Executor.run()`` is a thin wrapper — ``submit(..., start=False)`` plus an
inline :meth:`SolveSession.execute` on the calling thread — so the default
single-run path goes through exactly the same code as a multiplexed one
(and stays bit-identical to the pre-session engine).  ``start()`` instead
executes on a daemon thread; :meth:`result` joins it.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from .types import RunConfig, RunResult

__all__ = ["SolveSession", "SessionState"]


class SessionState:
    """String states of a session (kept simple for JSON-friendly stats)."""

    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


_session_ids = itertools.count(1)


class SolveSession:
    """One solve request: per-run state split out of the executor.

    Created by ``Executor.submit``; not intended for direct construction.
    Thread-safe: any thread may poll :meth:`done`, wait on :meth:`result`,
    or :meth:`cancel` a not-yet-started session while another executes it.
    """

    def __init__(self, executor, problem, cfg: RunConfig):
        self.session_id = next(_session_ids)
        self.executor = executor
        self.problem = problem
        self.cfg = cfg
        self.state = SessionState.PENDING
        self.submitted_s = time.monotonic()
        self.started_s: Optional[float] = None
        self.finished_s: Optional[float] = None
        self._result: Optional[RunResult] = None
        self._exception: Optional[BaseException] = None
        self._finished = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def start(self) -> "SolveSession":
        """Execute on a background daemon thread (idempotent error on reuse)."""
        self._transition_to_running()
        self._thread = threading.Thread(
            target=self._execute_locked_stage,
            name=f"solve-session-{self.session_id}", daemon=True)
        self._thread.start()
        return self

    def execute(self) -> RunResult:
        """Execute inline on the calling thread; raises on failure.

        This is the ``run()`` path: no extra thread, identical semantics to
        the pre-session engine including exception propagation.
        """
        self._transition_to_running()
        self._execute_locked_stage()
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    def _transition_to_running(self) -> None:
        with self._lock:
            if self.state != SessionState.PENDING:
                raise RuntimeError(
                    f"session #{self.session_id} already {self.state}; "
                    "sessions execute exactly once")
            self.state = SessionState.RUNNING
            self.started_s = time.monotonic()

    def _execute_locked_stage(self) -> None:
        """Run the backend; record result/exception; never raises itself."""
        try:
            res = self.executor._execute(self)
        except BaseException as e:  # noqa: BLE001 - stored, re-raised in result()
            with self._lock:
                self._exception = e
                self.state = SessionState.FAILED
                self.finished_s = time.monotonic()
        else:
            with self._lock:
                self._result = res
                self.state = SessionState.DONE
                self.finished_s = time.monotonic()
        self._finished.set()

    # ------------------------------------------------------------------ #
    def cancel(self) -> bool:
        """Cancel a session that has not started; True on success."""
        with self._lock:
            if self.state != SessionState.PENDING:
                return False
            self.state = SessionState.CANCELLED
            self.finished_s = time.monotonic()
        self._finished.set()
        return True

    def done(self) -> bool:
        return self._finished.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> RunResult:
        """Block until finished and return the RunResult (or re-raise)."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"session #{self.session_id} not finished after {timeout}s")
        if self.state == SessionState.CANCELLED:
            raise RuntimeError(f"session #{self.session_id} was cancelled")
        if self._exception is not None:
            raise self._exception
        return self._result  # type: ignore[return-value]

    def exception(self, timeout: Optional[float] = None):
        """Block until finished; return the stored exception (None if ok)."""
        if not self._finished.wait(timeout):
            raise TimeoutError(
                f"session #{self.session_id} not finished after {timeout}s")
        return self._exception

    @property
    def elapsed_s(self) -> Optional[float]:
        """Execution time (None before start; running time while RUNNING)."""
        if self.started_s is None:
            return None
        end = self.finished_s if self.finished_s is not None else time.monotonic()
        return end - self.started_s

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SolveSession(#{self.session_id} {self.state} "
                f"executor={getattr(self.executor, 'name', '?')!r} "
                f"mode={self.cfg.mode!r})")
