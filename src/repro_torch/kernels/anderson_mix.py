"""Launcher of the CUDA Anderson combine (``csrc/anderson_mix.cu``).

Counterpart of ``repro.kernels.anderson_mix``.  CUDA tensors only; see
:mod:`repro_torch.kernels.jacobi_stencil` for the launcher contract.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import F64, I64, PTR

__all__ = ["anderson_mix", "MAX_H"]

#: window depth the kernel holds in registers (``kMaxH``)
MAX_H = 16


def anderson_mix(X: torch.Tensor, G: torch.Tensor, alpha: torch.Tensor, *,
                 beta: float = 1.0) -> torch.Tensor:
    """``sum_j alpha_j ((1 - beta) X_j + beta G_j)`` on the card; ``alpha``
    stays on the device (the kernel reads it, the host never waits)."""
    fn = _build.function("rt_anderson_mix", [PTR] * 4 + [I64, I64, F64, PTR])
    _build.require(dict(X=X, G=G, alpha=alpha), torch.float64, X.device)
    h, N = X.shape
    if h > MAX_H:
        raise ValueError(f"window depth {h} exceeds the kernel's {MAX_H}")
    out = torch.empty(N, dtype=torch.float64, device=X.device)
    with torch.cuda.device(X.device):
        err = fn(X.data_ptr(), G.data_ptr(), alpha.data_ptr(),
                 out.data_ptr(), h, N, float(beta), _build.stream_of(X))
    _build.check(err, "anderson_mix")
    return out
