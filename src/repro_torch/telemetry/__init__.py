"""Unified telemetry plane: spans, metric series, and timeline export.

The port's copy of the reference's telemetry package (stdlib only): the
same span kinds, metric names, capture JSON and exporters.

One recorder (:class:`TelemetryRecorder`), owned by the coordinator when
``RunConfig.telemetry`` is set, collects typed spans (worker task
dispatch→arrival, accel fire begin→commit, offloaded evaluations,
checkpoint writes, SDC screens, serve admission→finish, scenario events)
and metric series (applied-staleness histogram, residual vs clock,
coordinator busy fraction, pool lease/respawn counts, serve queue depth)
from every backend and service layer.  Exporters (:mod:`.export`) render
a capture as a JSONL event stream, a Chrome trace-event JSON viewable in
Perfetto (one timeline lane per worker incarnation), or Prometheus text
exposition for the serve layer; ``python -m repro_torch.launch.run_report``
renders a terminal summary from a captured run.

Zero-overhead when off: the default ``RunConfig.telemetry=None`` never
constructs a recorder, every hook is a single ``if ... is not None``
guard, and the recorder consumes no rng and touches no floats — virtual
runs stay byte-identical with telemetry off *or on*.

The LM serving path has its own spans and counters (:mod:`.serving`:
``SERVE_SPANS``, ``SERVE_COUNTERS``), recorded only while
``torch.profiler`` records, as ranges on the profiler's clock.
"""

from .recorder import (
    METRICS,
    SCENARIO_SPAN_MAP,
    SPAN_KINDS,
    TRACE_SPAN_MAP,
    TelemetryCapture,
    TelemetryConfig,
    TelemetryRecorder,
    as_telemetry_config,
    worker_lane,
)
from .serving import SERVE_COUNTERS, SERVE_SPANS
from .export import (
    to_chrome_trace,
    to_jsonl,
    to_prometheus,
    validate_chrome_trace,
)

__all__ = [
    "METRICS",
    "SCENARIO_SPAN_MAP",
    "SPAN_KINDS",
    "SERVE_SPANS",
    "SERVE_COUNTERS",
    "TRACE_SPAN_MAP",
    "TelemetryCapture",
    "TelemetryConfig",
    "TelemetryRecorder",
    "as_telemetry_config",
    "worker_lane",
    "to_chrome_trace",
    "to_jsonl",
    "to_prometheus",
    "validate_chrome_trace",
]
