"""Synthetic LM data pipeline: deterministic, shardable, checkpointable.

Zipf-distributed token streams with a planted bigram structure so that a
model can actually reduce loss (pure uniform noise has no learnable
signal).  Each (worker, step) batch is a pure function of the seed, so
async workers, elastic restarts, and exact resume are trivially supported:
the pipeline state IS the step counter.

A copy of ``repro.training.data`` (numpy only): the same seed gives the
same tokens, bit for bit, in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.3
    n_workers: int = 1


class SyntheticLM:
    """data[worker, step] -> batch dict, deterministically."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # planted bigram table: each token has a small set of likely successors
        self._succ = rng.integers(0, V, size=(V, 4))
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._p = p / p.sum()

    def batch(self, step: int, worker: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + worker)
        B, S, V = cfg.batch, cfg.seq, cfg.vocab_size
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self._p)
        follow = rng.random((B, S)) < 0.7  # bigram-follow probability
        draws = rng.choice(V, size=(B, S), p=self._p)
        pick = rng.choice(4, size=(B, S), p=[0.55, 0.2, 0.15, 0.1])
        for t in range(1, S):
            nxt = self._succ[toks[:, t - 1], pick[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, draws[:, t])
        return {"tokens": toks}

    def iterator(self, start_step: int = 0, worker: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, worker)
            step += 1
