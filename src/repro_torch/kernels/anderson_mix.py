"""Launcher of the CUDA Anderson combine (``csrc/anderson_mix.cu``).

Counterpart of ``repro.kernels.anderson_mix``.  CUDA tensors only; see
:mod:`repro_torch.kernels.jacobi_stencil` for the launcher contract.

:func:`mix_plan`, a pure function of the window's row length and the
alignment of its rows, sizes the launch: 16-byte loads where every row the
call reads starts on a 16-byte boundary (the ``"vector"`` kernel), 8-byte
loads otherwise (``"scalar"``: odd N, or a window view 8 bytes off); one
thread per column pair.  The launcher keeps each plan's C arguments, so a
call's host time is the checks, the output's allocation and the launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from ._build import F64, PTR

__all__ = ["anderson_mix", "MAX_H", "MixPlan", "mix_plan", "plan_of"]

#: window depth the kernel is instantiated for (``kMaxH``)
MAX_H = 16
#: threads of a CTA (``kThreads``)
THREADS = 256
#: the most CTAs one launch may have (a grid's x dimension); past it the
#: kernel's grid-stride loop walks the rest of the column pairs
MAX_GRID = 2 ** 31 - 1


class MixPlan(NamedTuple):
    """One launch: ``kernel`` is ``"vector"`` (16-byte loads) or
    ``"scalar"`` (8-byte loads).  Thread t of ``grid * THREADS`` combines
    column pairs ``(2q, 2q + 1)`` for ``q = t, t + grid * THREADS, ...``
    below ``N // 2``, and thread 0 the last column of an odd N."""

    kernel: str
    grid: int


def mix_plan(N: int, row_offset_elems: int) -> MixPlan:
    """The launch of one ``anderson_mix`` call on windows of rows of ``N``.

    ``row_offset_elems``: how many float64 elements row 0 starts past a
    16-byte boundary (only its parity counts; 1 if any window the call
    reads is off).
    """
    vector = row_offset_elems % 2 == 0 and N % 2 == 0
    grid = max(1, min(-(-(N // 2) // THREADS), MAX_GRID))
    return MixPlan("vector" if vector else "scalar", grid)


def _read(X: torch.Tensor, G: torch.Tensor, beta: float):
    """The windows a call reads: G at beta = 1, X at 0, both otherwise."""
    return (G,) if beta == 1.0 else (X,) if beta == 0.0 else (X, G)


def _offset(X: torch.Tensor, G: torch.Tensor, beta: float) -> int:
    return int(any(t.data_ptr() % 16 for t in _read(X, G, beta)))


def plan_of(X: torch.Tensor, G: torch.Tensor, beta: float) -> MixPlan:
    """The plan the launcher takes for this window and ``beta``."""
    return mix_plan(X.shape[1], _offset(X, G, beta))


class _Plan(ctypes.Structure):
    """``MixPlan`` in ``csrc/anderson_mix.cu``: the C entry's arguments."""

    _fields_ = [(name, ctypes.c_int64) for name in (
        "h", "N", "vector", "grid", "device")]


def _to_c(h: int, N: int, p: MixPlan, device: int) -> _Plan:
    return _Plan(h, N, int(p.kernel == "vector"), p.grid, device)


#: (h, N, row offset parity, device) -> the C plan and its address
_c_plans: Dict[Tuple[int, int, int, int], Tuple[_Plan, int]] = {}


def _c_plan(X: torch.Tensor, G: torch.Tensor, beta: float) -> int:
    """The address of the C arguments for this window (built once per
    shape, alignment and device)."""
    h, N = X.shape
    device = X.get_device()
    off = _offset(X, G, beta)
    key = (h, N, off, device)
    hit = _c_plans.get(key)
    if hit is None:
        c = _to_c(h, N, mix_plan(N, off), device)
        # the first plan stored wins, so a racing thread's copy is never
        # freed under a launch that uses its address
        hit = _c_plans.setdefault(key, (c, ctypes.addressof(c)))
    return hit[1]


def anderson_mix(X: torch.Tensor, G: torch.Tensor, alpha: torch.Tensor, *,
                 beta: float = 1.0,
                 plan: Optional[MixPlan] = None) -> torch.Tensor:
    """``sum_j alpha_j ((1 - beta) X_j + beta G_j)`` on the card; ``alpha``
    stays on the device (the kernel reads it, the host never waits).
    ``plan`` replaces :func:`mix_plan`'s (to time other plans); the C
    entry refuses one the window's alignment does not allow."""
    fn = _build.function("rt_anderson_mix", [PTR] * 4 + [F64, PTR, PTR])
    _build.require(dict(X=X, G=G, alpha=alpha), torch.float64, X.device)
    if X.shape[0] > MAX_H:
        raise ValueError(f"window depth {X.shape[0]} exceeds the kernel's "
                         f"{MAX_H}")
    out = X.new_empty(X.shape[1])
    if plan is None:
        c_plan = _c_plan(X, G, beta)
    else:
        c = _to_c(*X.shape, plan, X.get_device())
        c_plan = ctypes.addressof(c)
    err = fn(X.data_ptr(), G.data_ptr(), alpha.data_ptr(), out.data_ptr(),
             float(beta), c_plan, _build.stream_of(X))
    _build.check(err, "anderson_mix")
    return out
