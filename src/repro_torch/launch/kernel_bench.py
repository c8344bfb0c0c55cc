"""Time the flash-attention and Bellman kernels of one source tree on the card.

To compare two versions of the kernels, run it once per source tree, in
turns (parent, change, change, parent), on one card.  It imports
``repro_torch`` from ``--src`` (default: the tree it lives in), builds
that tree's kernels there and times each kernel with CUDA events around
20 back-to-back calls after warm-up:

* ``flash_attention`` at the Gemma-2-2B serve shape, q (2, 8192, 8, 256),
  k/v (2, 8192, 4, 256), causal, softcap 50: a local layer (window 4096)
  and a global one (no window) in float32, the local one in bfloat16;
* ``bellman`` at (10^6, 4, 5) and ``bellman_block`` at (250000, 4, 5)
  gathering from a 10^6-state v (the value-iteration smoke shapes).

Each row carries its bound (the larger of bytes over the memory rate and
operations over the float32 rate outside the tensor cores, or the float64
rate; NVIDIA's H100 data sheet for the part ``nvidia-smi`` names) and the
largest deviation from the tree's plain version.  ``chip_smoke.py`` uses
the same timing and the same work counts (:func:`flash_work`,
:func:`bellman_work`).  Run it by path so that
``--src`` decides which ``repro_torch`` is imported:

    python3 src/repro_torch/launch/kernel_bench.py [--src DIR/src] \\
        [--label NAME] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

#: (bytes/s, float64 FLOP/s, float32 FLOP/s outside the tensor cores,
#: bfloat16 dense tensor FLOP/s) by part, from NVIDIA's H100 data sheet
PEAKS = {"PCIe": (2.0e12, 26e12, 51e12, 756e12),
         "NVL": (3.9e12, 30e12, 60e12, 835e12),
         "SXM": (3.35e12, 34e12, 67e12, 989e12)}


def peaks(name: str):
    """The data-sheet peaks of the card called ``name`` (SXM if unknown)."""
    for part, vals in PEAKS.items():
        if part in name:
            return vals
    return PEAKS["SXM"]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call: ``reps`` calls back to back between two CUDA
    events, after warm-up, so the host's launch cost hides behind the
    device's work (timing each call alone adds the wrapper's host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_pairs(Sq, Skv, causal, window, q_offset=0) -> int:
    """Unmasked (query, key) pairs of one head: what the work needs."""
    import numpy as np

    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(Sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(B, S, nq, nkv, hd, window, itemsize):
    """Bytes and operations of one causal self-attention over ``S`` tokens:
    q, k and v read and o written once; 4 operations per head dim for each
    visible (query, key) pair (the multiply-adds of both products)."""
    nbytes = (2 * B * S * nq * hd + 2 * B * S * nkv * hd) * itemsize
    return nbytes, 4 * B * nq * hd * attention_pairs(S, S, True, window)


def bellman_work(idx, block=False):
    """Bytes and operations of one ``bellman`` call over ``idx`` (rows, A,
    b): the index, probability and reward rows, the distinct ``v`` entries
    gathered and the output, each once; a multiply-add per successor, the
    discount, reward and max per action.  ``block`` counts
    ``bellman_block``, which also reads ``v_old`` and reduces the norm."""
    rows, A, b = idx.shape
    touched = int(idx.unique().numel())
    nbytes = idx.numel() * 4 + (idx.numel() + rows * A + touched
                                + rows * (2 if block else 1)) * 8
    flops = rows * A * (2 * b + 2) + rows * A + (3 * rows if block else 0)
    return nbytes, flops


def bound_ms(nbytes: float, flops: float, bw: float, peak: float):
    """The least time for the work: bytes over ``bw`` or operations over
    ``peak``, whichever is longer, and which one it is."""
    tb, tf = nbytes / bw * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bench(torch, card: str):
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", 0)
    bw, fp64, fp32, bf16 = peaks(card)
    rows = []

    def row(name, shape, err, fn, nbytes, flops, peak):
        b, by = bound_ms(nbytes, flops, bw, peak)
        ms = time_ms(torch, fn)
        rows.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                         bound_ms=b, bound_by=by, bound_share=b / ms))
        print(f"[bench] {name} {shape}: {ms:.4f} ms, bound {b:.4f} ms ({by},"
              f" {100 * b / ms:.1f}%), err {err:.2e}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, nq, nkv, hd = 2, 8192, 8, 4, 256
    qf = torch.randn(B, S, nq, hd, generator=gen, device=dev)
    kf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    vf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    for label, window, dt in (("local", 4096, torch.float32),
                              ("global", None, torch.float32),
                              ("local", 4096, torch.bfloat16)):
        q, k, v = qf.to(dt), kf.to(dt), vf.to(dt)
        kw = dict(causal=True, window=window, softcap=50.0)
        err = float((ops.flash_attention(q, k, v, **kw).float()
                     - ref.flash_attention(q, k, v, **kw).float()).abs().max())
        torch.cuda.empty_cache()
        row(f"flash_attention_{label}_{str(dt).split('.')[-1]}",
            [B, S, nq, nkv, hd, window], err,
            lambda: ops.flash_attention(q, k, v, **kw),
            *flash_work(B, S, nq, nkv, hd, window, q.element_size()),
            fp32 if dt == torch.float32 else bf16)
    del q, k, v, qf, kf, vf
    torch.cuda.empty_cache()

    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    S, A, b, gamma = 10 ** 6, 4, 5, 0.95
    idx = torch.randint(0, S, (S, A, b), generator=gen, device=dev,
                        dtype=torch.int32)
    probs = torch.rand(S, A, b, generator=gen, **f64)
    probs /= probs.sum(-1, keepdim=True)
    R = torch.rand(S, A, generator=gen, **f64)
    v = torch.randn(S, generator=gen, **f64)
    err = float((ops.bellman(idx, probs, R, v, gamma=gamma)
                 - ref.bellman(idx, probs, R, v, gamma=gamma)).abs().max())
    row("bellman", [S, A, b], err,
        lambda: ops.bellman(idx, probs, R, v, gamma=gamma),
        *bellman_work(idx), fp64)
    n = S // 4
    bi, bp, bR = idx[:n], probs[:n], R[:n]
    v_old = torch.randn(n, generator=gen, **f64)
    err = float((ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)[0]
                 - ref.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)[0]
                 ).abs().max())
    row("bellman_block", [n, A, b, S], err,
        lambda: ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma),
        *bellman_work(bi, block=True), fp64)
    return rows


def main() -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=here,
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[bench] {args.label or args.src}: {card}", flush=True)
    result = dict(label=args.label or str(args.src), card=card,
                  rows=bench(torch, card))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
