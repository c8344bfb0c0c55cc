"""Solver-service launcher: submit N solve requests, print a latency table.

  PYTHONPATH=src python -m repro_torch.launch.solver_serve \
      --executor process --workers 2 --requests 8 --tenants a,b \
      --max-active 2

Drives :class:`repro_torch.serve.SolverService` against the port's
fixed-point problems on the card (``--device``, default ``cuda``; pass
``--device cpu`` without one): every request is one full solve of a
Jacobi grid (``--problem jacobi``, default side 2048) or a Garnet value
iteration (``--problem vi``, default S = 10^6 states, A = 4, b = 5), the
sizes of ``chip_smoke.py``'s main paths; ``--grid`` and ``--states``
shrink them (``--device cpu --grid 24`` runs in seconds).  Same-payload
requests share one warm worker pool (zero respawns on the process
backend).  The table shows per-request queueing delay vs service time,
then aggregate throughput and the per-tenant served counts.
"""

import argparse
import time


def make_problems(args):
    """One problem per payload family (seed-varied), on ``args.device``."""
    from repro_torch.problems import (GarnetMDP, JacobiProblem,
                                      ValueIterationProblem)

    fams = range(max(1, args.families))
    if args.problem == "jacobi":
        return [JacobiProblem(grid=args.grid, sweeps=args.sweeps, seed=f,
                              device=args.device)
                for f in fams]
    return [ValueIterationProblem(GarnetMDP(
        S=args.states, A=4, b=5, gamma=0.95, seed=f, sample="fast",
        device=args.device)) for f in fams]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multiplex solve requests over a SolverService")
    ap.add_argument("--executor", default="virtual",
                    choices=["virtual", "thread", "process"])
    ap.add_argument("--device", default="cuda",
                    help="where the problems live: cuda (default) or cpu")
    ap.add_argument("--problem", default="jacobi", choices=["jacobi", "vi"])
    ap.add_argument("--workers", type=int, default=2,
                    help="n_workers per solve")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tenants", default="default",
                    help="comma-separated tenant names, round-robined")
    ap.add_argument("--weights", default="",
                    help="tenant=weight pairs, comma-separated")
    ap.add_argument("--max-active", type=int, default=2,
                    help="concurrently running solves")
    ap.add_argument("--families", type=int, default=1,
                    help="distinct problem payloads (seed-varied)")
    ap.add_argument("--grid", type=int, default=2048,
                    help="Jacobi grid side")
    ap.add_argument("--states", type=int, default=10 ** 6,
                    help="Garnet state count (--problem vi)")
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-updates", type=int, default=200)
    args = ap.parse_args(argv)

    from repro_torch.core.engine import RunConfig, shutdown_pools
    from repro_torch.serve import ServiceConfig, SolverService

    tenants = [t.strip() for t in args.tenants.split(",") if t.strip()]
    weights = {}
    for pair in args.weights.split(","):
        if pair.strip():
            t, w = pair.split("=")
            weights[t.strip()] = float(w)
    problems = make_problems(args)
    cfg = RunConfig(
        mode="async", executor=args.executor, n_workers=args.workers,
        tol=args.tol, max_updates=args.max_updates,
        compute_time=1e-3 if args.executor == "virtual" else None)

    t0 = time.perf_counter()
    with SolverService(ServiceConfig(max_active=args.max_active,
                                     weights=weights)) as svc:
        tickets = [
            svc.submit(problems[i % len(problems)], cfg,
                       tenant=tenants[i % len(tenants)])
            for i in range(args.requests)
        ]
        results = [t.result() for t in tickets]
        stats = svc.stats()
    wall = time.perf_counter() - t0

    print(f"{'req':>4} {'tenant':>8} {'wait_ms':>9} {'service_ms':>11} "
          f"{'total_ms':>9} {'converged':>9} {'wu':>7} {'residual':>10}")
    for i, (tk, r) in enumerate(zip(tickets, results)):
        print(f"{i:>4} {tk.tenant:>8} {tk.wait_s * 1e3:>9.1f} "
              f"{(tk.total_s - tk.wait_s) * 1e3:>11.1f} "
              f"{tk.total_s * 1e3:>9.1f} {str(r.converged):>9} "
              f"{r.worker_updates:>7} {r.residual_norm:>10.3e}")
    waits = sorted(tk.wait_s for tk in tickets)
    totals = sorted(tk.total_s for tk in tickets)
    p95 = totals[min(len(totals) - 1, int(0.95 * len(totals)))]
    print(f"\n{args.requests} {args.problem} requests in {wall:.2f}s "
          f"({args.requests / wall:.2f} req/s) on executor="
          f"{args.executor} device={args.device} "
          f"max_active={args.max_active}")
    print(f"latency total: median {totals[len(totals) // 2] * 1e3:.1f} ms, "
          f"p95 {p95 * 1e3:.1f} ms; "
          f"median queueing {waits[len(waits) // 2] * 1e3:.1f} ms")
    print("served by tenant:", stats["served"])
    if args.executor == "process":
        from repro_torch.core.engine import pool_stats

        for key, st in pool_stats().items():
            print(f"pool {key[0][:12]}… workers={st['n_workers']} "
                  f"runs_served={st['runs_served']} pids={st['pids']}")
        shutdown_pools()
    return 0


if __name__ == "__main__":
    main()
