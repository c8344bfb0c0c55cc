"""LM-serving launcher: batched prefill + greedy decode on a (reduced) arch.

Counterpart of ``repro.launch.lm_serve``, with the same flags and the same
``--reduced`` shrink, float32 parameters drawn from a seeded
``torch.Generator`` (no published weights are in the repository) and a
prompt from ``numpy.random.default_rng(0)``.  It runs on the CUDA card,
where prefill attention goes through the hand-written flash kernel;
``--device cpu`` takes the plain PyTorch path (for tests):

  PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch gemma2_2b \\
      --reduced --batch 4 --prompt-len 24 --gen 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..configs import ModelConfig, get_config
from ..models import DecoderLM, decode_step, init_params, prefill

__all__ = ["ServeResult", "PREFILL", "DECODE", "make_config",
           "make_params", "make_prompt", "serve", "main"]

#: names of the profiler ranges around the two phases of :func:`serve`
PREFILL, DECODE = "lm_serve.prefill", "lm_serve.decode"


@dataclass
class ServeResult:
    tokens: torch.Tensor  # (B, gen) greedy tokens, the prefill's first
    prefill_logits: torch.Tensor  # (B, 1, vocab) at the last prompt position
    step_logits: List[torch.Tensor]  # (B, 1, vocab) of each decode step
    prefill_s: float
    decode_ms_per_step: float


def make_config(arch: str, reduced: bool = False) -> ModelConfig:
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(n_layers=4, d_model=128, d_ff=256, vocab_size=512,
                          n_heads=4, n_kv_heads=2, head_dim=32)
    return cfg


def make_params(cfg: ModelConfig, device, seed: int = 0) -> DecoderLM:
    """float32 parameters drawn on ``device`` from a generator seeded
    with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, dtype=torch.float32, device=device)


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, device,
                seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    prompt = rng.integers(1, cfg.vocab_size, (batch, prompt_len))
    return torch.as_tensor(prompt, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params: DecoderLM, prompt: torch.Tensor,
          gen: int, keep_logits: bool = False) -> ServeResult:
    """Prefill the prompt, then ``gen - 1`` greedy decode steps: ``gen``
    tokens in all.  Times are host clock around work that ends in a
    device synchronise; a profiler sees the two phases as the ranges
    ``PREFILL`` and ``DECODE``."""
    device = prompt.device
    B, S0 = prompt.shape
    _sync(device)
    with record_function(PREFILL):
        t0 = time.perf_counter()
        logits, caches = prefill(cfg, params, {"tokens": prompt},
                                 max_len=S0 + gen)
        toks = logits[:, -1].argmax(-1)[:, None]
        _sync(device)
        prefill_s = time.perf_counter() - t0
    out, steps = [toks], []
    with record_function(DECODE):
        t0 = time.perf_counter()
        for t in range(gen - 1):
            step, caches = decode_step(cfg, params, caches, toks, S0 + t)
            toks = step[:, 0].argmax(-1)[:, None]
            out.append(toks)
            if keep_logits:
                steps.append(step)
        _sync(device)
        per = (time.perf_counter() - t0) / max(gen - 1, 1) * 1e3
    return ServeResult(torch.cat(out, dim=1), logits, steps, prefill_s, per)


def main(argv: Optional[List[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path, for tests)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.arch, args.reduced)
    params = make_params(cfg, device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, device)
    res = serve(cfg, params, prompt, args.gen)
    print(f"prefill {args.batch} x {args.prompt_len} tokens: "
          f"{res.prefill_s:.3f} s")
    print(f"decoded {res.tokens.shape[1]} tokens x batch {args.batch}: "
          f"{res.decode_ms_per_step:.1f} ms/step")
    print("row0:", res.tokens[0].cpu().numpy())
    return res


if __name__ == "__main__":
    main()
