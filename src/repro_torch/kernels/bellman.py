"""Launchers of the CUDA Bellman kernels (``csrc/bellman.cu``).

Counterpart of ``repro.kernels.bellman``.  CUDA tensors only; see
:mod:`repro_torch.kernels.jacobi_stencil` for the launcher contract.  The
successor indices must lie in ``[0, len(v))``: the problems build them, so
they are not re-checked on the card (that would need a synchronisation).
"""

from __future__ import annotations

import torch

from . import _build
from ._build import F64, I64, PTR

__all__ = ["bellman", "bellman_block"]


def _check(idx, probs, rewards, v, extra=None):
    _build.require(dict(idx=idx), torch.int32, v.device)
    fl = dict(probs=probs, rewards=rewards, v=v)
    fl.update(extra or {})
    _build.require(fl, torch.float64, v.device)


def bellman(idx: torch.Tensor, probs: torch.Tensor, rewards: torch.Tensor,
            v: torch.Tensor, *, gamma: float) -> torch.Tensor:
    """The full Bellman operator over all ``S`` states on the card."""
    fn = _build.function("rt_bellman", [PTR] * 5 + [I64, I64, I64, F64, PTR])
    _check(idx, probs, rewards, v)
    S, A, B = idx.shape
    tv = torch.empty(S, dtype=torch.float64, device=v.device)
    with torch.cuda.device(v.device):
        err = fn(idx.data_ptr(), probs.data_ptr(), rewards.data_ptr(),
                 v.data_ptr(), tv.data_ptr(), S, A, B, float(gamma),
                 _build.stream_of(v))
    _build.check(err, "bellman")
    return tv


def bellman_block(idx: torch.Tensor, probs: torch.Tensor,
                  rewards: torch.Tensor, v: torch.Tensor,
                  v_old: torch.Tensor, *, gamma: float):
    """State-block backup plus ``max|tv - v_old|`` on the card."""
    fn = _build.function("rt_bellman_block",
                         [PTR] * 7 + [I64, PTR, I64, I64, I64, F64, PTR])
    _check(idx, probs, rewards, v, dict(v_old=v_old))
    rows, A, B = idx.shape
    tv = torch.empty(rows, dtype=torch.float64, device=v.device)
    # one partial norm per CTA; a CTA owns at least one state
    partials = torch.empty(rows, dtype=torch.float64, device=v.device)
    norm = torch.empty((), dtype=torch.float64, device=v.device)
    with torch.cuda.device(v.device):
        err = fn(idx.data_ptr(), probs.data_ptr(), rewards.data_ptr(),
                 v.data_ptr(), v_old.data_ptr(), tv.data_ptr(),
                 partials.data_ptr(), rows, norm.data_ptr(), rows, A, B,
                 float(gamma), _build.stream_of(v))
    _build.check(err, "bellman_block")
    return tv, norm
