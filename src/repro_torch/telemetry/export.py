"""Telemetry exporters: JSONL, Chrome trace-event JSON, Prometheus text.

Three render targets for one :class:`~repro_torch.telemetry.TelemetryCapture`:

- :func:`to_jsonl` — a line-delimited event stream (first line is the
  capture meta, then one JSON object per event, then one ``series``
  object), greppable and streamable;
- :func:`to_chrome_trace` — the Chrome trace-event format
  (``{"traceEvents": [...]}``; ``ph`` "X" complete spans in microseconds,
  "M" thread-name metadata, "i" instants, "C" counters), loadable in
  Perfetto / ``chrome://tracing``.  Every worker *incarnation* gets its
  own timeline lane, so a straggler shows as long task spans and an
  eviction as a lane that stops — :func:`validate_chrome_trace` is its
  schema check (``run_report --validate``);
- :func:`to_prometheus` — text exposition for the serve layer
  (``SolverService.stats()`` counters plus wait-time quantiles from the
  serve spans when the service carries a recorder).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

from .recorder import TelemetryCapture, percentile_of

__all__ = [
    "to_chrome_trace",
    "to_jsonl",
    "to_prometheus",
    "validate_chrome_trace",
    "trace_lanes",
]

_US = 1e6  # capture clocks are seconds; trace-event ts/dur are microseconds


def to_jsonl(capture: TelemetryCapture) -> str:
    """Line-delimited JSON: meta, then events in order, then series."""
    lines = [json.dumps({"meta": capture.meta})]
    lines.extend(json.dumps(ev) for ev in capture.events)
    lines.append(json.dumps({"series": capture.series}))
    return "\n".join(lines) + "\n"


def _lane_order(lane: str):
    """Stable lane ordering: coord, then workers by (id, incarnation),
    then eval/serve lanes."""
    if lane == "coord":
        return (0, 0, 0, "")
    m = re.match(r"^w(\d+)(?:#r(\d+))?$", lane)
    if m:
        return (1, int(m.group(1)), int(m.group(2) or 0), "")
    return (2, 0, 0, lane)


def trace_lanes(capture: TelemetryCapture) -> List[str]:
    """Every lane referenced by the capture, in display order."""
    lanes = {ev["lane"] for ev in capture.events if "lane" in ev}
    return sorted(lanes, key=_lane_order)


def to_chrome_trace(capture: TelemetryCapture) -> dict:
    """Render a capture as a Chrome trace-event document.

    One pid (the run), one tid per lane, ``ts`` sorted non-decreasing
    (Perfetto does not require it; :func:`validate_chrome_trace` does, so
    exports are canonical).
    """
    lanes = trace_lanes(capture)
    tid = {lane: i for i, lane in enumerate(lanes)}
    events: List[dict] = []
    for lane in lanes:
        events.append({"ph": "M", "pid": 1, "tid": tid[lane],
                       "name": "thread_name", "args": {"name": lane}})
        events.append({"ph": "M", "pid": 1, "tid": tid[lane],
                       "name": "thread_sort_index",
                       "args": {"sort_index": tid[lane]}})
    body: List[dict] = []
    for ev in capture.events:
        lane = ev.get("lane", "coord")
        args = {k: v for k, v in ev.items()
                if k not in ("k", "lane", "t", "t0", "t1")}
        if "t0" in ev:
            body.append({"ph": "X", "pid": 1, "tid": tid.get(lane, 0),
                         "name": ev["k"], "cat": ev["k"],
                         "ts": ev["t0"] * _US,
                         "dur": max(0.0, (ev["t1"] - ev["t0"]) * _US),
                         "args": args})
        else:
            body.append({"ph": "i", "pid": 1, "tid": tid.get(lane, 0),
                         "name": ev["k"], "cat": ev["k"], "s": "t",
                         "ts": ev.get("t", 0.0) * _US, "args": args})
    for metric, points in capture.series.items():
        if metric == "staleness":
            continue  # a histogram, not a time series
        for t, v in points:
            body.append({"ph": "C", "pid": 1, "tid": 0, "name": metric,
                         "ts": t * _US, "args": {metric: v}})
    body.sort(key=lambda e: e["ts"])
    meta = dict(capture.meta)
    meta["staleness_hist"] = capture.series.get("staleness", [])
    return {"traceEvents": events + body, "displayTimeUnit": "ms",
            "otherData": meta}


def validate_chrome_trace(doc: dict) -> List[str]:
    """Schema check of a Chrome trace document.

    Returns a list of problems (empty == valid): traceEvents present,
    every event carries pid/tid/ph, complete spans have ts >= 0 and
    dur >= 0 with non-decreasing ts, every referenced tid has exactly
    one thread_name metadata entry (one lane per worker incarnation).
    """
    errs: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    names: Dict[int, List[str]] = {}
    used_tids = set()
    last_ts = None
    for i, ev in enumerate(evs):
        for key in ("ph", "pid", "tid"):
            if key not in ev:
                errs.append(f"event {i} missing {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                names.setdefault(ev["tid"], []).append(
                    ev.get("args", {}).get("name", ""))
            continue
        used_tids.add(ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i} has bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i} ts {ts} < previous {last_ts} "
                        "(not monotone)")
        last_ts = ts
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i} has bad dur {dur!r}")
    for tid, lane_names in names.items():
        if len(lane_names) != 1:
            errs.append(f"tid {tid} has {len(lane_names)} thread_name "
                        f"entries {lane_names} (want exactly one lane)")
    for tid in used_tids:
        if tid not in names:
            errs.append(f"tid {tid} has events but no thread_name lane")
    return errs


# --------------------------------------------------------------------- #
# Prometheus text exposition (serve layer)
# --------------------------------------------------------------------- #
_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?\s[0-9eE+.\-]+$")


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def to_prometheus(service, prefix: str = "repro_serve") -> str:
    """Text exposition for one :class:`repro_torch.serve.SolverService`.

    Counters come from ``service.stats()``; wait/service-time quantiles
    from the service's serve spans when it carries a recorder
    (``ServiceConfig.telemetry=True``).
    """
    st = service.stats()
    out: List[str] = []

    def emit(name: str, kind: str, help_: str, samples) -> None:
        out.append(f"# HELP {prefix}_{name} {help_}")
        out.append(f"# TYPE {prefix}_{name} {kind}")
        for labels, value in samples:
            lab = ""
            if labels:
                inner = ",".join(f'{k}="{_prom_escape(str(v))}"'
                                 for k, v in sorted(labels.items()))
                lab = "{" + inner + "}"
            out.append(f"{prefix}_{name}{lab} {value:g}")

    emit("pending", "gauge", "queued requests awaiting dispatch",
         [({}, st["pending"])])
    emit("active", "gauge", "requests currently executing",
         [({}, st["active"])])
    emit("served_total", "counter", "completed requests per tenant",
         [({"tenant": t}, n) for t, n in sorted(st["served"].items())]
         or [({}, 0)])
    emit("failed_total", "counter", "requests that raised",
         [({}, st["failed"])])
    emit("rejected_total", "counter", "admission-control rejections",
         [({}, st["rejected"])])
    emit("crash_resumes_total", "counter",
         "coordinator crashes resumed from checkpoint",
         [({}, st["crash_resumes"])])
    tel = getattr(service, "telemetry", None)
    if tel is not None:
        spans = [ev for ev in tel.events if ev.get("k") == "serve"]
        waits = [ev.get("wait_s", 0.0) for ev in spans]
        totals = [ev["t1"] - ev["t0"] for ev in spans]
        if spans:
            emit("wait_seconds", "summary", "admission-to-dispatch delay",
                 [({"quantile": "0.5"}, percentile_of(waits, 0.5)),
                  ({"quantile": "0.95"}, percentile_of(waits, 0.95))])
            emit("request_seconds", "summary", "admission-to-finish latency",
                 [({"quantile": "0.5"}, percentile_of(totals, 0.5)),
                  ({"quantile": "0.95"}, percentile_of(totals, 0.95))])
        depth = tel.series.get("queue_depth")
        if depth:
            emit("queue_depth", "gauge",
                 "pending queue depth at the last sample",
                 [({}, depth[-1][1])])
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal exposition parser (the format check the tests use).

    Returns ``{metric{labels}: value}``; raises ValueError on any
    malformed non-comment line.
    """
    out: Dict[str, float] = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        if not _PROM_LINE.match(ln):
            raise ValueError(f"malformed exposition line: {ln!r}")
        name, value = ln.rsplit(" ", 1)
        out[name] = float(value)
    return out
