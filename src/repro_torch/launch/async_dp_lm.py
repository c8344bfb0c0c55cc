"""Beyond-paper: the coupling-density criterion on LM training.

Counterpart of ``benchmarks/async_dp_lm.py``: full-gradient workers
(evaluation-level staleness) against multi-step block-coordinate workers
(iterate-level corruption), each without and with coordinator Anderson,
on the virtual backend with worker 0 a 0.05 s straggler.  ``--config
tiny`` is the benchmark's one-layer transformer; ``--config card`` grows
it (2 layers, d_model 256, vocab 4096: n ≈ 2.9 M parameters) so that θ
reaches the ``anderson_mix`` kernel's size (n ≥ 2^18) on the card.

  PYTHONPATH=src python -m repro_torch.launch.async_dp_lm --fast \\
      [--config tiny|card] [--device cpu]

Each row prints the initial loss, the loss after the plain and the
accelerated runs, whether Anderson helped, and the runs' fires, accepts
and virtual walls.  The paper's prediction (Anderson survives for
``full_grad``, degrades for ``block_grad``) is printed, not checked.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core import AndersonConfig, FaultProfile, RunConfig, run_fixed_point
from ..training.async_dp import (BlockGradientWorkersProblem,
                                 GradientWorkersProblem)

__all__ = ["CONFIGS", "DESIGNS", "run", "main"]

#: the worker designs: name, problem class and its arguments
DESIGNS = (
    ("full_grad", GradientWorkersProblem, dict(lr=0.25)),
    ("block_grad", BlockGradientWorkersProblem,
     dict(lr=0.25, local_steps=4)),
)

#: ``reduced()`` overrides of gemma_2b: the benchmark's and the card's
CONFIGS = {
    "tiny": dict(n_layers=1, d_model=32, vocab_size=64, d_ff=64, n_heads=2,
                 n_kv_heads=1, head_dim=16),
    "card": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
                 head_dim=64, d_ff=1024, vocab_size=4096),
}


def make_config(name: str) -> ModelConfig:
    return get_config("gemma_2b").reduced(**CONFIGS[name])


def run(cfg: ModelConfig, fast: bool = False, device=None) -> List[Dict]:
    """One row per design: the losses before and after the plain and the
    accelerated run (each on a fresh problem from the same seed), the
    accelerated run's fires and accepts, walls, and both ``RunResult``s
    under ``results``."""
    rows = []
    budget = 120 if fast else 320
    faults = {0: FaultProfile(delay_mean=0.05)}
    base = dict(mode="async", tol=1e-9, max_updates=budget,
                compute_time=5e-3, faults=faults, record_every=10**9, seed=0)
    for name, cls, kw in DESIGNS:
        out = {}
        for label, extra in (("plain", {}),
                             ("anderson", dict(accel=AndersonConfig(m=5),
                                               fire_every=8))):
            prob = cls(cfg, batch=4, seq=16, device=device, **kw)
            if label == "plain":
                out["loss0"] = prob.loss(prob.initial())
            t0 = time.perf_counter()
            res = run_fixed_point(prob, RunConfig(**base, **extra))
            out[f"{label}_s"] = time.perf_counter() - t0
            out[label] = prob.loss(res.x)
            out[f"{label}_result"] = res
        rows.append(dict(
            name=f"async_dp/{name}", loss0=out["loss0"], plain=out["plain"],
            anderson=out["anderson"],
            anderson_helps=out["anderson"] < out["plain"],
            fires=out["anderson_result"].accel_fires,
            accepts=out["anderson_result"].accel_accepts,
            worker_updates=[out["plain_result"].worker_updates,
                            out["anderson_result"].worker_updates],
            virtual_wall_s=[out["plain_result"].wall_time,
                            out["anderson_result"].wall_time],
            host_s=[out["plain_s"], out["anderson_s"]],
            results=(out["plain_result"], out["anderson_result"])))
    return rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="tiny")
    ap.add_argument("--fast", action="store_true",
                    help="the benchmark's fast budget (120 updates)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = run(make_config(args.config), fast=args.fast, device=args.device)
    for r in rows:
        print(json.dumps({k: v for k, v in r.items() if k != "results"}))
    return rows


if __name__ == "__main__":
    main()
