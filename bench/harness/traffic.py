"""The one traffic generator: it reads a mix's parameters from its data
file and makes the run's calls from the seed.

Two loops, named by the mix's ``loop``:

* ``prefill``: a closed loop of one client, calls back to back.  Each
  call is one of the mix's ``shapes`` (batch, length); the calls come in
  cycles, each cycle every shape once in an order drawn from the seed,
  so every seed sends the same sizes in another order.  The prompts'
  tokens are drawn from the seed, for as many calls as calls of
  ``min_call_s`` seconds could fill the window.
* ``decode``: ``batch`` sequences of ``prompt_len`` tokens from the
  seed, prefilled in set-up with ``warmup_steps`` greedy steps, then
  greedy steps until the window closes; the caches hold as many
  positions as the step's floor (``counts.step_floor_s``) could use in
  the window, or ``max_steps`` where the mix caps them (a CPU test's
  tiny model, whose floor is microseconds).  ``check_rows`` sequences,
  drawn from the seed, are compared at every served position.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .weights import derive_seed

__all__ = ["load_mix", "call_shapes", "prompt_pool"]


def load_mix(path: Path) -> Dict:
    mix = json.loads(Path(path).read_text())
    if mix.get("loop") not in ("prefill", "decode"):
        raise ValueError(f"{path}: loop must be prefill or decode")
    if mix["loop"] == "prefill":
        tokens = {b * s for b, s in mix["shapes"]}
        if len(tokens) != 1:
            raise ValueError(f"{path}: every shape must hold the same "
                             f"number of tokens, got {sorted(tokens)}")
    return mix


def call_shapes(mix: Dict, seed: int, n: int) -> List[Tuple[int, int]]:
    """The first ``n`` calls' (batch, length): cycles of the shapes, each
    in an order drawn from ``seed``."""
    rng = np.random.default_rng(derive_seed(seed, "order"))
    shapes = [tuple(s) for s in mix["shapes"]]
    out: List[Tuple[int, int]] = []
    while len(out) < n:
        out += [shapes[i] for i in rng.permutation(len(shapes))]
    return out[:n]


def prompt_pool(n_calls: int, tokens: int, vocab: int, seed: int,
                device) -> torch.Tensor:
    """(n_calls, tokens) token ids in [1, vocab), drawn from ``seed`` on
    ``device``: call i's prompt is row i, viewed as its (batch,
    length)."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, "prompts"))
    return torch.randint(1, vocab, (n_calls, tokens), generator=gen,
                         device=device)
