"""Serve a small model: batched prefill + token-by-token decode with the
ring-buffer KV cache, verifying decode equals teacher forcing.

The port of ``examples/serve_batched.py``: prefill through the flash
kernel on the card (its plain version on the CPU), decode steps in place
on the caches.

Usage:  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward_train, init_params, prefill


def example_config():
    return get_config("gemma2_2b").reduced(
        n_layers=4, d_model=128, d_ff=256, vocab_size=512, n_heads=4,
        n_kv_heads=2, head_dim=32, window=16)


def run(B: int = 4, S0: int = 24, steps: int = 24, device="cuda",
        params=None, log: Callable[[str], None] = print) -> Dict:
    """Greedy decode of ``steps`` tokens after a (B, S0) prompt; ``params``
    (default: seeded on ``device``) may be given, e.g. carried over from
    the reference.  Returns the tokens and the teacher-forcing match."""
    cfg = example_config()
    device = torch.device(device)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S0)),
                             device=device)

    logits, caches = prefill(cfg, params, {"tokens": prompt},
                             max_len=S0 + steps)
    toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
    generated = [toks]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    for t in range(steps - 1):
        logits, caches = decode_step(cfg, params, caches, toks, S0 + t)
        toks = torch.argmax(logits[:, 0], dim=-1)[:, None]
        generated.append(toks)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.time() - t0) / (steps - 1)
    gen = torch.cat(generated, dim=1)
    log(f"generated {tuple(gen.shape)} tokens, {dt*1e3:.1f} ms/step/batch")
    log(f"sample row: {gen[0].cpu().numpy()[:16]}")

    # verify: greedy decode == teacher-forced argmax over the same prefix
    full = torch.cat([prompt, gen], dim=1)
    with torch.no_grad():
        ref_logits, _ = forward_train(cfg, params, {"tokens": full})
    ref_next = torch.argmax(ref_logits[:, S0 - 1: S0 + steps - 1], dim=-1)
    match = float((ref_next == gen).float().mean())
    log(f"decode/teacher-forcing agreement: {match*100:.1f}%")
    assert match > 0.99
    return dict(tokens=gen.cpu(), match=match, ms_per_step=dt * 1e3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
