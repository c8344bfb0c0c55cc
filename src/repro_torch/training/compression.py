"""Gradient/delta compression for the distributed exchanges.

Top-k sparsification with error feedback (memory) and symmetric int8
quantization — the standard toolkit for taming the collective term at
1000+-node scale.  Error feedback keeps the compression bias bounded so
convergence is preserved (tested on a quadratic in tests/test_training.py).

A copy of ``repro.training.compression`` (numpy only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass
class Compressor:
    """top_k_frac and/or int8 quantization with per-slot error feedback."""

    top_k_frac: Optional[float] = None  # keep this fraction of entries
    int8: bool = False
    error_feedback: bool = True
    _memory: Dict[str, np.ndarray] = field(default_factory=dict)

    def compressed_bytes(self, n: int) -> int:
        """Wire estimate for an n-element f32 exchange."""
        if self.top_k_frac is not None:
            k = max(int(n * self.top_k_frac), 1)
            per = (1 if self.int8 else 4) + 4  # value + index
            return k * per
        return n * (1 if self.int8 else 4)

    def roundtrip(self, x: np.ndarray, slot: str = "g") -> np.ndarray:
        """Compress + decompress (what the receiver reconstructs)."""
        mem = self._memory.get(slot)
        if self.error_feedback and mem is not None:
            x = x + mem
        out = x
        if self.top_k_frac is not None:
            k = max(int(x.size * self.top_k_frac), 1)
            idx = np.argpartition(np.abs(x), -k)[-k:]
            out = np.zeros_like(x)
            out[idx] = x[idx]
        if self.int8:
            scale = np.max(np.abs(out)) / 127.0
            if scale > 0:
                out = np.round(out / scale).astype(np.int8).astype(
                    np.float64) * scale
        if self.error_feedback:
            self._memory[slot] = x - out
        return out
