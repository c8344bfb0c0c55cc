"""Public wrappers of the port's kernels, with launch counters.

Counterpart of ``repro.kernels.ops``: the same shape checks and
``ValueError``s.  The device of the tensors picks the route, and nothing
else does: CPU tensors take the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the hand-written
kernel or raise (there is no fallback).  Each CUDA launch adds one to its
wrapper's counter, which :func:`launch_counts` reads, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from . import anderson_mix as _mix
from . import bellman as _bellman
from . import flash_attention as _flash
from . import jacobi_stencil as _jacobi
from . import ref

__all__ = ["jacobi_sweep", "jacobi_halo_sweeps", "bellman", "bellman_block",
           "anderson_mix", "flash_attention", "launch_counts",
           "reset_launch_counts", "KERNELS"]

#: the wrappers that count launches, in the order of the kernel table
KERNELS = ("jacobi_halo_sweeps", "jacobi_sweep", "bellman_block", "bellman",
           "anderson_mix", "flash_attention")

_count_lock = threading.Lock()
_counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per wrapper since the last reset."""
    with _count_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _counts:
            _counts[k] = 0


def _counted(name: str) -> None:
    with _count_lock:
        _counts[name] += 1


def _on_cpu(*tensors) -> bool:
    """True for all-CPU inputs, False for all-CUDA; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"inputs must all be on the CPU or all on CUDA, got "
                     f"{sorted(kinds)}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0):
    """GQA attention, q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd), with the
    causal, sliding-window, softcap and ``q_offset`` options."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected (B, S, heads, head_dim) inputs")
    if k.shape != v.shape:
        raise ValueError(f"k/v mismatch: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    out = _flash.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)
    _counted("flash_attention")
    return out


def jacobi_sweep(x, b, g: int, order: str = "pallas"):
    """One global Dirichlet sweep; ``order`` picks the add order
    (``ref.JACOBI_ORDERS``: the Pallas kernel's or ``_full_sweep``'s)."""
    if x.shape != (g * g,) or b.shape != (g * g,):
        raise ValueError(f"expected flat ({g*g},) arrays")
    if order not in ref.JACOBI_ORDERS:
        raise ValueError(f"order must be one of {ref.JACOBI_ORDERS}, got "
                         f"{order!r}")
    if _on_cpu(x, b):
        return ref.jacobi_sweep(x, b, g, order)
    out = _jacobi.jacobi_sweep(x, b, g, order)
    _counted("jacobi_sweep")
    return out


def jacobi_halo_sweeps(xb, top, bot, b, *, sweeps: int):
    """Fused frozen-halo row-block sweeps + block-local residual norm."""
    if xb.ndim != 2 or b.shape != xb.shape:
        raise ValueError(f"expected matching (rows, g) blocks, got "
                         f"{tuple(xb.shape)} vs {tuple(b.shape)}")
    g = xb.shape[1]
    if top.shape != (g,) or bot.shape != (g,):
        raise ValueError(f"expected ({g},) halo rows")
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    if _on_cpu(xb, top, bot, b):
        return ref.jacobi_halo_sweeps(xb, top, bot, b, sweeps=sweeps)
    out = _jacobi.jacobi_halo_sweeps(xb, top, bot, b, sweeps=sweeps)
    _counted("jacobi_halo_sweeps")
    return out


def bellman_block(idx, probs, rewards, v, v_old, *, gamma: float):
    """Fused state-block Bellman backup + block-local residual norm."""
    rows, A, b = idx.shape
    if (probs.shape != (rows, A, b) or rewards.shape != (rows, A)
            or v.ndim != 1 or v_old.shape != (rows,)):
        raise ValueError("inconsistent MDP block shapes")
    if _on_cpu(idx, probs, rewards, v, v_old):
        return ref.bellman_block(idx, probs, rewards, v, v_old, gamma=gamma)
    out = _bellman.bellman_block(idx, probs, rewards, v, v_old, gamma=gamma)
    _counted("bellman_block")
    return out


def bellman(idx, probs, rewards, v, *, gamma: float):
    S, A, b = idx.shape
    if probs.shape != (S, A, b) or rewards.shape != (S, A) or v.shape != (S,):
        raise ValueError("inconsistent MDP shapes")
    if _on_cpu(idx, probs, rewards, v):
        return ref.bellman(idx, probs, rewards, v, gamma=gamma)
    out = _bellman.bellman(idx, probs, rewards, v, gamma=gamma)
    _counted("bellman")
    return out


def anderson_mix(X, G, alpha, *, beta: float = 1.0):
    if X.shape != G.shape or alpha.shape != (X.shape[0],):
        raise ValueError("inconsistent history shapes")
    if _on_cpu(X, G, alpha):
        return ref.anderson_mix(X, G, alpha, beta=beta)
    out = _mix.anderson_mix(X, G, alpha, beta=beta)
    _counted("anderson_mix")
    return out

