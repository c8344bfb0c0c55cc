"""Time the Anderson combine's launch plans on the card, to choose
``mix_plan``'s constants.

At the Jacobi, VI and SCF windows of ``kernel_bench.ANDERSON_SHAPES``
(beta = 1, VI's with the L2 flushed before every call), every plan of the
kernel in ``csrc/anderson_mix.cu`` is launched through
``repro_torch.kernels.anderson_mix.anderson_mix(..., plan=...)``:
16-byte or 8-byte loads, and grids from two CTAs per SM up to one thread
per column pair (the plan's).  Each is checked against ``a @ G`` and
timed by its CUPTI device time (``kernel_bench.device_profile``), in
``--reps`` rounds whose order alternates, beside ``a @ G``; the plan
``mix_plan`` takes is marked:

    python3 src/repro_torch/launch/anderson_sweep.py [--reps 2] \\
        [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

#: CTAs per SM of the capped grids tried beside one thread per pair
CTAS_PER_SM = (2, 4, 8)


def plans(N: int, n_sms: int):
    """Every plan the sweep times for rows of ``N`` (aligned rows)."""
    from repro_torch.kernels.anderson_mix import MixPlan, mix_plan

    full = mix_plan(N, 0).grid
    grids = sorted({min(full, n_sms * c) for c in CTAS_PER_SM} | {full})
    for kernel in ("vector", "scalar"):
        for grid in grids:
            yield MixPlan(kernel, grid)


def sweep(torch, reps: int):
    from repro_torch.kernels import anderson_mix as mix
    from repro_torch.launch import kernel_bench as kb

    dev = torch.device("cuda", 0)
    f64 = dict(dtype=torch.float64, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = kb.l2_flush(torch, dev)
    rows = []
    for h, N, cold in kb.ANDERSON_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(5)
        X, G = (torch.randn(h, N, generator=gen, **f64) for _ in range(2))
        a = torch.randn(h, generator=gen, **f64)
        a = a / a.sum()
        between = flush if cold else None
        want = a @ G
        chosen = mix.mix_plan(N, 0)
        cases = [(p, (lambda p=p: mix.anderson_mix(X, G, a, beta=1.0,
                                                   plan=p)))
                 for p in plans(N, n_sms)]
        cases.append((None, lambda: a @ G))
        for rep in range(reps):
            for p, fn in (cases if rep % 2 == 0 else cases[::-1]):
                err = float((fn() - want).abs().max())
                ms = kb.device_profile(torch, fn, between=between)[0]
                rows.append(dict(
                    shape=[h, N], rep=rep, l2_flush=cold,
                    plan="a @ G" if p is None else p._asdict(),
                    chosen=p == chosen, device_ms=ms, max_abs_err=err))
        mine = sorted((r for r in rows if r["shape"] == [h, N]),
                      key=lambda r: r["device_ms"])
        print(f"[sweep] {[h, N]}{' (L2 flushed)' if cold else ''}: "
              f"mix_plan takes {chosen}", flush=True)
        for r in mine:
            p = r["plan"]
            name = p if isinstance(p, str) else (
                f"{p['kernel']:6s} grid {p['grid']:6d}")
            mark = "  (mix_plan)" if r["chosen"] else ""
            print(f"[sweep]   {name:18s} rep {r['rep']}: "
                  f"{1e3 * r['device_ms']:8.2f} us, err "
                  f"{r['max_abs_err']:.1e}{mark}", flush=True)
        del X, G, want
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("anderson_sweep: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[sweep] {card}", flush=True)
    result = dict(card=card, rows=sweep(torch, args.reps))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
