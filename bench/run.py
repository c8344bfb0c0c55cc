"""Run one cell of the port's benchmark once.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The cell, its configuration, traffic, limits and metrics are found by
name from ``BENCHMARK.json`` (see ``bench/harness/manifest.py``).  The
run makes its weights and inputs from ``--seed``, warms up, measures for
``--seconds`` (traced with ``--trace 1``), compares a sample of what it
served with the float32 reference and prints one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; the numbers
compared come last, under ``checks``, and again as the last lines of
standard error.  It exits non-zero, printing no result, without the
cards the cell asks for, without the port's package beside it, or when
its process holds JAX or the JAX package once the window has closed
(``harness.cell.run_cell`` raises, naming the modules).
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {BENCH}: nothing to measure",
              file=sys.stderr)
        return 2
    # the CUDA driver's JIT cache inside the checkout, at a fixed path
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build"
                                                 / "cuda_cache"))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    t_args = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    from harness.cell import run_cell
    from harness.manifest import load_cell, load_manifest

    cell = load_cell(load_manifest(), args.workload)
    t_cell = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"[setup] run.py: arguments {t_args - T0:.3f} s, import torch "
          f"{t_torch - t_args:.3f} s, the cell {t_cell - t_torch:.3f} s, "
          f"CUDA check {time.perf_counter() - t_cell:.3f} s", flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T0, log=lambda s: print(s, flush=True))
    # read after the run: nvidia-smi's time varies, and set-up ends at
    # the first timed call
    print(f"[card] {_card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    lines = out.pop("_stderr")
    print(json.dumps({k: v for k, v in out.items() if not k.startswith("_")}),
          flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
