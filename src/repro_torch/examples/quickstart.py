"""Quickstart: the paper's core result in 60 seconds.

Runs sync vs async Jacobi under a straggler, shows Anderson helping the
synchronous solve and hurting the asynchronous one (iterate-level
corruption), then shows async VI where Anderson KEEPS helping
(evaluation-level perturbation) — the coupling-density criterion.
The port of ``examples/quickstart.py``: the problems live on ``device``
(the card by default), the engine's virtual clock is the reference's.

Usage:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
from typing import Callable, Dict

from repro_torch.core import (
    AndersonConfig, FaultProfile, RunConfig, coupling_density,
    run_fixed_point,
)
from repro_torch.problems import GarnetMDP, JacobiProblem, ValueIterationProblem

CT, OH = 4.5e-3, 2.7e-3  # calibrated to the paper's Table 2


def run(grid: int = 50, vi_states: int = 200,
        device="cuda", log: Callable[[str], None] = print) -> Dict:
    """The example at a ``grid`` x ``grid`` Jacobi problem and a Garnet
    MDP of ``vi_states`` states; returns every run's ``RunResult``."""
    log("=== Jacobi (low coupling density) ===")
    jac = JacobiProblem(grid=grid, sweeps=10, device=device)
    log(f"coupling density: {coupling_density(jac):.2e}")
    straggler = {0: FaultProfile(delay_mean=0.1)}
    kw = dict(tol=1e-5, max_updates=500_000, compute_time=CT)
    s = run_fixed_point(jac, RunConfig(mode="sync", sync_overhead=OH,
                                       faults=straggler, **kw))
    a = run_fixed_point(jac, RunConfig(mode="async", faults=straggler, **kw))
    log(f"sync : {s.summary()}")
    log(f"async: {a.summary()}  -> straggler speedup "
        f"{s.wall_time/a.wall_time:.1f}x at {a.worker_updates/s.worker_updates:.1f}x work")
    aa_sync = run_fixed_point(jac, RunConfig(mode="sync", sync_overhead=OH,
                                             accel=AndersonConfig(m=20), **kw))
    log(f"sync +Anderson(20): rounds {s.rounds} -> {aa_sync.rounds} "
        f"({s.rounds/max(aa_sync.rounds,1):.0f}x)")
    # the paper's Fig-2 comparison is at no injected delay
    a0 = run_fixed_point(jac, RunConfig(mode="async", **kw))
    aa_async = run_fixed_point(jac, RunConfig(mode="async",
                                              accel=AndersonConfig(m=5),
                                              fire_every=8, **kw))
    ratio = aa_async.worker_updates / max(a0.worker_updates, 1)
    log(f"async+Anderson(5) at 0 delay: WU {a0.worker_updates} -> "
        f"{aa_async.worker_updates} ({ratio:.2f}x; at the paper's 100x100 "
        f"scale Anderson consistently HURTS — benchmarks/anderson_jacobi)\n")

    log("=== Value iteration (high coupling density) ===")
    vi = ValueIterationProblem(GarnetMDP(S=vi_states, A=4, b=5, gamma=0.95,
                                         seed=0, device=device))
    log(f"coupling density: {coupling_density(vi):.2f} "
        "(each update reads the full value vector)")
    kw = dict(tol=1e-6, max_updates=500_000, compute_time=CT)
    va = run_fixed_point(vi, RunConfig(mode="async", faults=straggler, **kw))
    vaa = run_fixed_point(vi, RunConfig(mode="async", faults=straggler,
                                        accel=AndersonConfig(m=5),
                                        fire_every=4, **kw))
    log(f"async plain    : WU={va.worker_updates}")
    log(f"async +Anderson: WU={vaa.worker_updates} "
        f"(Anderson SURVIVES: evaluation-level perturbation)")
    return dict(jacobi_sync=s, jacobi_async=a, jacobi_sync_anderson=aa_sync,
                jacobi_async_0=a0, jacobi_async_anderson=aa_async,
                vi_async=va, vi_async_anderson=vaa)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
