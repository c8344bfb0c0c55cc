"""Render a saved telemetry capture into reports: summary, trace, JSONL.

``python -m repro_torch.launch.run_report capture.json`` prints a compact run
digest (span counts, staleness percentiles, fire ledger, lane inventory);
``--chrome out.trace.json`` additionally writes a Chrome trace-event file
loadable in Perfetto / ``chrome://tracing`` (one timeline lane per worker
incarnation), ``--jsonl out.jsonl`` the line-delimited event stream, and
``--validate`` schema-checks the Chrome render and exits nonzero on any
violation.

The input is either a :class:`repro_torch.telemetry.TelemetryCapture` JSON
(``capture.save(path)``) or a serialized ``RunResult.to_dict()`` that
carries a ``telemetry`` payload — both shapes round-trip through
``TelemetryCapture.from_dict``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..telemetry import (
    TelemetryCapture,
    to_chrome_trace,
    to_jsonl,
    validate_chrome_trace,
)
from ..telemetry.export import trace_lanes

__all__ = ["load_capture", "render_summary", "main"]


def load_capture(path: str) -> TelemetryCapture:
    """Load a capture from its own JSON or a RunResult dict carrying one."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if isinstance(doc.get("events"), list):
        return TelemetryCapture.from_dict(doc)
    if isinstance(doc.get("telemetry"), dict):
        return TelemetryCapture.from_dict(doc["telemetry"])
    raise ValueError(
        f"{path}: neither a telemetry capture nor a RunResult dict with a "
        "'telemetry' payload (was the run configured with telemetry?)")


def render_summary(cap: TelemetryCapture) -> str:
    """Human-readable digest of one capture."""
    s = cap.summary
    lines: List[str] = ["# run report"]
    for k in ("executor", "mode", "n_workers", "seed", "accel",
              "accel_eval", "t_end", "host_elapsed_s"):
        if k in cap.meta:
            v = cap.meta[k]
            vs = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"{k:>16}: {vs}")
    lines.append(f"{'events':>16}: {len(cap.events)}"
                 f" (dropped {s.get('events_dropped', 0)})")
    lines.append(f"{'lanes':>16}: {', '.join(trace_lanes(cap))}")
    counts = s.get("span_counts", {})
    lines.append(f"{'span_counts':>16}: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items())) or "-")
    lines.append(f"{'staleness':>16}: p50={s.get('staleness_p50', 0):g} "
                 f"p95={s.get('staleness_p95', 0):g} "
                 f"n={s.get('staleness_n', 0)}")
    fires = s.get("fires", {})
    if fires:
        lines.append(f"{'fires':>16}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(fires.items())))
    busy = s.get("busy_frac_tail", [])
    if busy:
        lines.append(f"{'busy_frac_tail':>16}: "
                     + ", ".join(f"{v:.3f}" for v in busy))
    for name, points in sorted(cap.series.items()):
        lines.append(f"{'series':>16}: {name} ({len(points)} points)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.run_report",
        description="Render a telemetry capture: summary, Chrome trace, "
                    "JSONL.")
    ap.add_argument("capture", help="capture JSON (TelemetryCapture.save or "
                                    "a RunResult dict with telemetry)")
    ap.add_argument("--chrome", metavar="PATH",
                    help="write a Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--jsonl", metavar="PATH",
                    help="write the line-delimited event stream")
    ap.add_argument("--validate", action="store_true",
                    help="schema-check the Chrome render; exit 1 on errors")
    args = ap.parse_args(argv)
    try:
        cap = load_capture(args.capture)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(render_summary(cap))
    if args.chrome or args.validate:
        doc = to_chrome_trace(cap)
        if args.chrome:
            with open(args.chrome, "w") as f:
                json.dump(doc, f)
            print(f"chrome trace -> {args.chrome} "
                  f"({len(doc['traceEvents'])} events)")
        if args.validate:
            errs = validate_chrome_trace(doc)
            for e in errs:
                print(f"invalid: {e}", file=sys.stderr)
            if errs:
                return 1
            print("chrome trace: valid")
    if args.jsonl:
        with open(args.jsonl, "w") as f:
            f.write(to_jsonl(cap))
        print(f"jsonl -> {args.jsonl}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI smoke test
    sys.exit(main())
