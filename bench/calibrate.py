"""Read the comparison's numbers of a cell over many seeds in one
process, for the program and for the control (the float32 reference
computed in fp8 in the program's place), to set the cell's limits:

  python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
      [--control-seeds 1,2,3] [--seconds 4] [--out FILE.json]

Each seed is a whole run of the cell (``harness.cell.run_cell``: its
weights, set-up, a window of ``--seconds`` and the comparison), at the
cell's own sizes, on the first CUDA card.  Prints one JSON line a seed
and writes them all to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", default="fp8",
                    help="precisions of the reference put in the program's "
                         "place on the control seeds (fp8; bf16: a witness)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(BENCH))
    import torch

    from harness.cell import run_cell
    from harness.manifest import load_cell, load_manifest

    if not torch.cuda.is_available():
        print("calibrate.py reads the card's numbers: no CUDA card",
              file=sys.stderr)
        return 3
    cell = load_cell(load_manifest(), args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                       controls=tuple(args.controls.split(","))
                       if seed in controls else ())
        row = {"workload": args.workload, "seed": seed,
               "program": {k: c["value"] for k, c in out["checks"].items()},
               "control": out.get("_controls"),
               "rows": {k: {q: [round(float(x), 6) for x in t]
                            for q, t in r.items()}
                        for k, r in out["_rows"].items()},
               "metrics": {k: m["value"] for k, m in out["metrics"].items()},
               "memory_peak_bytes": out["device"]["memory_peak_bytes"],
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
