"""Training launcher: the single-host driver on the card.

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (default ``cuda``; ``--device cpu`` runs the plain PyTorch
path, for tests).  The production-mesh check is the multi-rank dry run,
ROADMAP.md item 1.6a.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
      --reduced --steps 50 --ckpt /tmp/ckpt [--device cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train(cfg, TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        accum=args.accum, checkpoint_dir=args.ckpt), device=args.device)
    print(f"final loss {out['losses'][-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
