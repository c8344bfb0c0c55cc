"""Multi-pod DiLoCo with a straggling pod and Anderson-accelerated outer
updates — the paper's coordinator pattern at the pod level.

The port of ``examples/diloco_async.py``: θ lives on ``device``.

Usage:  PYTHONPATH=src python -m repro_torch.examples.diloco_async [--device cpu]
"""

import argparse
from typing import Callable, Dict

from repro_torch.configs import get_config
from repro_torch.core import AndersonConfig, FaultProfile
from repro_torch.training.compression import Compressor
from repro_torch.training.diloco import DiLoCoConfig, DiLoCoTrainer


def example_config():
    return get_config("gemma_2b").reduced(
        n_layers=1, d_model=64, d_ff=128, vocab_size=256, n_heads=2,
        n_kv_heads=1, head_dim=16)


def run(inner_steps: int = 8, outer_steps: int = 8, batch: int = 8,
        seq: int = 32, device="cuda", params=None,
        inner_lr: float = 0.15, log: Callable[[str], None] = print) -> Dict:
    """The three runs (sync, async, async with Anderson and top-k
    compression), each from ``params`` (default: seeded); returns their
    results and starting losses, and checks that every run lowers the
    loss."""
    cfg = example_config()
    faults = {0: FaultProfile(delay_mean=3.0)}  # one straggling pod
    kw = dict(n_pods=4, inner_steps=inner_steps, inner_lr=inner_lr,
              outer_steps=outer_steps, faults=faults)

    runs, start = {}, {}
    for name, dcfg in {
        "sync": DiLoCoConfig(**kw),
        "async": DiLoCoConfig(mode="async", **kw),
        "async+anderson+topk": DiLoCoConfig(
            mode="async", accel=AndersonConfig(m=4),
            compressor=Compressor(top_k_frac=0.2), **kw),
    }.items():
        tr = DiLoCoTrainer(cfg, dcfg, batch=batch, seq=seq,
                           params=None if params is None else params.copy(),
                           device=device)
        start[name] = tr.eval_loss(tr.theta)
        res = tr.run()
        runs[name] = res
        log(f"{name:22s} final_loss={res.losses[-1]:.4f} "
            f"wall={res.wall_times[-1]:.1f}s "
            f"accel_acc/rej={res.accel_accepts}/{res.accel_rejects}")
        assert res.losses[-1] < start[name], f"{name}: the loss did not fall"
    sp = runs["sync"].wall_times[-1] / runs["async"].wall_times[-1]
    log(f"async pod-straggler speedup: {sp:.1f}x")
    return dict(runs=runs, start=start, speedup=sp)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
