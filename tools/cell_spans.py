"""Run one benchmark cell traced and put its device time and idle gaps
down to the program's own spans, with the serving counters.

  python3 tools/cell_spans.py --workload <cell> --seed <n> --seconds <s> \\
      [--out FILE]

from the root of a checkout, on a machine with the cell's CUDA card.
The cell runs exactly as ``bench/run.py --trace 1`` runs it
(``harness.cell.run_cell``: set-up, warm-up, the traced window, the
comparison with the reference); the window's profiler is kept, and the
serving counters (``repro_torch.telemetry.serving``) are zeroed as it
starts and read as it ends.  Then ``harness.spans`` reads the trace and
this prints, after the run's own lines:

* ``[span-cost]``: host ns a ``span()`` with no profiler recording, an
  unused ``record_function`` and a bare flag check;
* ``[spans]``: self and total device ms a call or step by span name;
* ``[span-groups]``: each span's self device ms by kernel group;
* ``[gaps]``: idle ms a call or step by the host's innermost open span,
  the program's share, and the ten longest gaps;
* ``[links]``: how each device operation was linked to the host, the
  share of device time under a span, and under ``lm.*`` spans;
* ``[counters]``: the counters over the window, and the MoE slot fill;
* ``[rate]``: prompt or generated tokens a second over the traced window;

and last one JSON object with all of it (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import timeit
from pathlib import Path
from typing import Callable, Dict

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT / "bench"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


class _Window:
    """A profiler whose ``with`` also zeroes the serving counters at the
    start and reads them at the end (after the window's synchronise)."""

    def __init__(self, prof):
        self.prof, self.counters = prof, None

    def __getattr__(self, name):
        return getattr(self.prof, name)

    def __enter__(self):
        from repro_torch.telemetry import serving

        serving.reset_serve_counters()
        return self.prof.__enter__()

    def __exit__(self, *exc):
        from repro_torch.telemetry import serving

        out = self.prof.__exit__(*exc)
        self.counters = serving.serve_counters()
        return out


def span_cost_ns(n: int = 200_000) -> Dict[str, float]:
    """Host ns a call with no profiler recording: a ``span()`` entered
    and left, an unused ``record_function`` entered and left, the flag
    check alone."""
    import torch
    from torch.autograd import profiler

    from repro_torch.telemetry.serving import span

    def off():
        with span("lm.layer"):
            pass

    def unused():
        with torch.profiler.record_function("lm.layer"):
            pass

    def flag():
        return profiler._is_profiler_enabled

    return {k: min(timeit.repeat(f, number=n, repeat=3)) / n * 1e9
            for k, f in (("span_off", off), ("record_function", unused),
                         ("flag", flag))}


def slot_fill(counters: Dict[str, int]):
    """100 x kept assignments / expert rows computed (None without
    capacity-dispatched MoE layers)."""
    slots = counters.get("moe.slots", 0)
    if not slots:
        return None
    kept = counters["moe.assignments"] - counters.get("moe.dropped", 0)
    return 100.0 * kept / slots


def run(cell, seed: int, seconds: float, device, port=None,
        log: Callable = print) -> Dict:
    """Run ``cell`` traced; returns the spans' summary
    (``harness.spans.summary``) with ``counters``, ``slot_fill``,
    ``correct``, the run's ``metrics`` and the traced ``tokens_per_s``."""
    from harness import cell as cell_mod
    from harness.spans import lines, read_spans, summary

    held = []
    real = cell_mod._profiler

    def profiler(dev):
        held.append(_Window(real(dev)))
        return held[-1]

    cell_mod._profiler = profiler
    try:
        out = cell_mod.run_cell(cell, seed, seconds, True, device,
                                time.perf_counter(), log=log, port=port)
    finally:
        cell_mod._profiler = real
    window = held[-1]
    unit = "call" if cell.mix["loop"] == "prefill" else "step"
    s = summary(read_spans(window.prof), out["attempted"])
    for line in lines(s, unit):
        log(line)
    log(f"[links] {s['links']}; attributed {s['attributed_share']}, under "
        f"lm.* {s['lm_share']}; device {s['device_ms']:.4f} ms a {unit}, "
        f"self times {s['self_sum_ms']:.4f}; program ranges a {unit} "
        f"{s['program_ranges']:.1f}")
    mix = cell.mix
    per = (mix["shapes"][0][0] * mix["shapes"][0][1] if unit == "call"
           else mix["batch"])  # every prefill shape holds the same tokens
    s.update(counters=window.counters, slot_fill=slot_fill(window.counters),
             correct=out["correct"], metrics=out["metrics"], unit=unit,
             tokens_per_s=out["attempted"] * per / out["device"]["window_s"])
    log(f"[counters] {s['counters']}; slot fill {s['slot_fill']}")
    log(f"[rate] traced {s['tokens_per_s']:.1f} tokens/s over the "
        f"window's span")
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "cuda_cache"))
    import torch

    from harness.manifest import load_cell, load_manifest

    if not torch.cuda.is_available():
        print("no CUDA card: nothing to trace", file=sys.stderr)
        return 3
    cost = span_cost_ns()
    print("[span-cost] host ns a call, no profiler: " + ", ".join(
        f"{k} {v:.1f}" for k, v in cost.items()), flush=True)
    cell = load_cell(load_manifest(), args.workload)
    s = run(cell, args.seed, args.seconds, "cuda:0",
            log=lambda line: print(line, flush=True))
    s.update(workload=args.workload, seed=args.seed, span_cost_ns=cost,
             card=torch.cuda.get_device_name(0), torch=torch.__version__)
    text = json.dumps(s)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
