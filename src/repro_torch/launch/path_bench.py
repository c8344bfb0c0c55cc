"""Time the fixed-point main paths of one source tree on the card.

Runs the two main paths of ``chip_smoke.py`` once each, in its order and
with its configuration: Jacobi g = 2048, then Garnet value iteration
S = 10^6, A = 4, b = 5, each for 200 applied updates on the thread
backend with 4 workers, the device plane on, Anderson(m=5) every 4
arrivals and worker 0 a 100 ms straggler.  ``repro_torch`` is imported
from ``--src`` (default: the tree this file lives in); the problems, the
configuration and the run come from the ``chip_smoke.py`` of this file's
checkout, so only ``repro_torch`` differs between two trees.  Each path
reports its run wall, the seconds of its inline Anderson fires, fires,
accepts, device refreshes and the coordinator's busy share.

These are host walls: they spread between runs by tens of percent.  To
compare two trees, start one process per run and alternate them
(parent, change, change, parent, ...) on one card for several turns:

    python3 src/repro_torch/launch/path_bench.py [--src DIR/src] \\
        [--label NAME] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("path_bench: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    label = args.label or str(args.src)
    print(f"[paths] {label}: {card}", flush=True)
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()  # off the runs' clocks
    rows = []
    for name, make in (("jacobi", chip_smoke.jacobi_problem),
                       ("vi", chip_smoke.vi_problem)):
        res = chip_smoke.run_path(name, make(dev), chip_smoke.main_cfg())[0]
        rows.append(dict(path=name, run_wall_s=res.wall_time,
                         fire_window_s=res.fire_window_s,
                         fires=res.accel_fires, accepts=res.accel_accepts,
                         device_refreshes=res.device_refreshes,
                         coordinator_busy_frac=res.coordinator_busy_frac,
                         residual=res.residual_norm))
    result = dict(label=label, card=card, rows=rows)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
