"""LM-serving launcher: batched prefill + greedy decode on a (reduced) arch.

Counterpart of ``repro.launch.lm_serve``, with the same flags and the same
``--reduced`` shrink, float32 parameters drawn from a seeded
``torch.Generator`` (no published weights are in the repository) and a
prompt from ``numpy.random.default_rng(0)``; an encoder-decoder (Whisper)
gets the reference's zero frame embeddings (B, 32, d) for its stub
frontend.  It runs on the CUDA card, where prefill attention (the
encoder's and the cross-attention too) goes through the hand-written
flash kernel; ``--device cpu`` takes the plain PyTorch path (for tests):

  PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch gemma2_2b \\
      --reduced --batch 4 --prompt-len 24 --gen 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..configs import ModelConfig, get_config
from ..models import DecoderLM, decode_step, init_params, prefill
from ..telemetry.serving import span
from .inputs import STUB_DIV

__all__ = ["ServeResult", "PREFILL", "DECODE", "SYNC", "make_config",
           "make_params", "make_prompt", "audio_inputs", "vision_grid",
           "vision_inputs", "serve", "main"]

#: names of the profiler ranges around the two phases of :func:`serve`
#: and around each of its waits on the device
#: (``telemetry.serving.SERVE_SPANS``)
PREFILL, DECODE, SYNC = "lm_serve.prefill", "lm_serve.decode", "lm_serve.sync"


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


def audio_inputs(cfg: ModelConfig, batch: int, frames: int, device,
                 dtype, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Whisper's stub-frontend input: seeded standard-normal frame
    embeddings ``audio_embeds`` (batch, frames, d) in ``dtype`` (the
    parameters'), drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"audio_embeds": torch.randn(batch, frames, cfg.d_model,
                                        generator=gen, device=device,
                                        dtype=dtype)}


def vision_grid(n: int) -> Tuple[int, int, int]:
    """A (t, h, w) patch grid of ``n`` patches, one frame: w the power of
    two at or above sqrt(n) (2048 patches: 1 x 32 x 64)."""
    w = 1 << max(math.ceil(math.log2(math.sqrt(n))), 0)
    if n % w:
        raise ValueError(f"{n} patches do not fill rows of {w}")
    return 1, n // w, w


def vision_inputs(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
                  device, dtype, seed: int = 0
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Qwen2-VL's stub-frontend inputs and M-RoPE position ids: seeded
    standard-normal ``vision_embeds`` for the first ``prompt_len //
    STUB_DIV`` positions in ``dtype``, on the
    :func:`vision_grid` (t = 0, h = i // w, w = i % w); the text after it
    at t = h = w running on from the grid's largest id + 1, as Qwen2-VL
    assigns them.  Returns ``({"vision_embeds", "positions" (B, 3, S)},
    decode_positions (B, 3, gen - 1))``: the decode steps' ids continue
    the text's, apart from the cache index."""
    nv = prompt_len // STUB_DIV
    t, h, w = vision_grid(nv)
    i = torch.arange(nv, device=device)
    vis = torch.stack([torch.zeros_like(i), i // w, i % w])  # (3, nv)
    start = max(t, h, w)
    text = start + torch.arange(prompt_len - nv + gen - 1, device=device)
    ids = torch.cat([vis, text[None].expand(3, -1)], dim=1).to(torch.int32)
    ids = ids[None].expand(batch, -1, -1).contiguous()
    gen_ = torch.Generator(device=device).manual_seed(seed)
    ve = torch.randn(batch, nv, cfg.d_model, generator=gen_, device=device,
                     dtype=dtype)
    return ({"vision_embeds": ve, "positions": ids[:, :, :prompt_len]},
            ids[:, :, prompt_len:])


def _sync(device: torch.device) -> None:
    with span(SYNC):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params: DecoderLM, prompt: torch.Tensor,
          gen: int, keep_logits: bool = False,
          inputs: Optional[Dict[str, torch.Tensor]] = None,
          decode_positions: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill the prompt, then ``gen - 1`` greedy decode steps: ``gen``
    tokens in all.  ``inputs`` are the prefill's other inputs
    (``audio_embeds``; ``vision_embeds`` and M-RoPE ``positions``, as
    :func:`audio_inputs` and :func:`vision_inputs` make them), and
    ``decode_positions`` (B, 3, >= gen - 1) the decode steps' M-RoPE ids.
    Times are host clock around work that ends in a device synchronise; a
    profiler sees the two phases as the ranges ``PREFILL`` and
    ``DECODE``, each synchronise as ``SYNC``, and the model's parts as
    the spans of ``telemetry.serving.SERVE_SPANS``."""
    device = prompt.device
    B, S0 = prompt.shape
    _sync(device)
    with span(PREFILL):
        t0 = time.perf_counter()
        logits, caches = prefill(cfg, params,
                                 {"tokens": prompt, **(inputs or {})},
                                 max_len=S0 + gen)
        toks = logits[:, -1].argmax(-1)[:, None]
        _sync(device)
        prefill_s = time.perf_counter() - t0
    out, steps = [toks], []
    with span(DECODE):
        t0 = time.perf_counter()
        for t in range(gen - 1):
            mrope = (None if decode_positions is None
                     else decode_positions[:, :, t:t + 1])
            step, caches = decode_step(cfg, params, caches, toks, S0 + t,
                                       mrope)
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
    inputs = None
    if cfg.kind == "encdec":  # the reference's stub frames
        inputs = {"audio_embeds": torch.zeros(args.batch, 32, cfg.d_model,
                                              device=device)}
    res = serve(cfg, params, prompt, args.gen, inputs=inputs)
    print(f"prefill {args.batch} x {args.prompt_len} tokens: "
          f"{res.prefill_s:.3f} s")
    print(f"decoded {res.tokens.shape[1]} tokens x batch {args.batch}: "
          f"{res.decode_ms_per_step:.1f} ms/step")
    print("row0:", res.tokens[0].cpu().numpy())
    return res


if __name__ == "__main__":
    main()
