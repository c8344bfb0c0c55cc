"""Public wrappers of the port's kernels, with launch counters.

Counterpart of ``repro.kernels.ops``: the same shape checks and
``ValueError``s; ``selective_scan`` is the port's own (Mamba's scan, which
the reference leaves to ``jax.lax.associative_scan``), as is
``moe_expert_ffn`` (a MoE layer's picked experts, whose dropless decode the
reference leaves to einsums over all experts).  The device of the
tensors picks the route, and nothing else does: CPU tensors take the
plain PyTorch version in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the hand-written
kernel or raise (there is no fallback).  Each CUDA launch adds one to its
wrapper's counter, which :func:`launch_counts` reads, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from . import anderson_mix as _mix
from . import bellman as _bellman
from . import flash_attention as _flash
from . import jacobi_stencil as _jacobi
from . import moe_expert_ffn as _moe
from . import ref
from . import selective_scan as _scan

__all__ = ["jacobi_sweep", "jacobi_halo_sweeps", "bellman", "bellman_block",
           "anderson_mix", "flash_attention", "selective_scan",
           "moe_expert_ffn", "launch_counts", "reset_launch_counts",
           "add_launch_counts", "KERNELS"]

#: the wrappers that count launches, in the order of the kernel tables
#: (the Pallas kernels', then the port's own)
KERNELS = ("jacobi_halo_sweeps", "jacobi_sweep", "bellman_block", "bellman",
           "anderson_mix", "flash_attention", "selective_scan",
           "moe_expert_ffn")

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


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add launches counted elsewhere (a process-backend worker's, sent
    back at the end of its run) to this process's counters."""
    with _count_lock:
        for k, c in counts.items():
            _counts[k] += c


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
    causal, sliding-window, softcap and ``q_offset`` options.  On CUDA it
    refuses inputs that require grad while autograd records: the kernel
    has no backward."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: its CUDA kernel's output is "
            "invisible to autograd, so q, k and v must not require grad "
            "(run under torch.no_grad(); training attention goes through "
            "repro_torch.models.attention.train_attention)")
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


def selective_scan(dt, xc, Bm, Cm, A, h0=None, *, chunk=None):
    """Mamba's selective scan (``ref.selective_scan``): dt, xc (B, S,
    d_inner) and Bm, Cm (B, S, d_state) in the model's type, A (d_inner,
    d_state) float32, ``h0`` (B, d_inner, d_state) float32 or None.
    Returns ``(y, h_S)`` in float32.  ``chunk`` bounds the plain version's
    (B, chunk, d_inner, d_state) temporaries; the kernel walks time in
    order with no such temporary, so it does not read it.  On CUDA it
    refuses inputs that require grad while autograd records: the kernel
    has no backward."""
    if dt.ndim != 3 or xc.shape != dt.shape:
        raise ValueError(f"expected dt and xc of one (B, S, d_inner) shape, "
                         f"got {tuple(dt.shape)} and {tuple(xc.shape)}")
    B, S, di = dt.shape
    if A.ndim != 2 or A.shape[0] != di:
        raise ValueError(f"expected A of shape ({di}, d_state), got "
                         f"{tuple(A.shape)}")
    ds = A.shape[1]
    if Bm.shape != (B, S, ds) or Cm.shape != (B, S, ds):
        raise ValueError(f"expected Bm and Cm of shape {(B, S, ds)}, got "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    if h0 is not None and h0.shape != (B, di, ds):
        raise ValueError(f"expected h0 of shape {(B, di, ds)}, got "
                         f"{tuple(h0.shape)}")
    if S == 0:
        raise ValueError("empty sequence")
    tensors = (dt, xc, Bm, Cm, A) + (() if h0 is None else (h0,))
    if _on_cpu(*tensors):
        return ref.selective_scan(dt, xc, Bm, Cm, A, h0, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "selective_scan has no backward: its CUDA kernel's output is "
            "invisible to autograd, so its inputs must not require grad "
            "(run under torch.no_grad(); training takes "
            "repro_torch.kernels.ref.selective_scan)")
    out = _scan.selective_scan(dt, xc, Bm, Cm, A, h0)
    _counted("selective_scan")
    return out


def moe_expert_ffn(x, wi, wo, used, *, act: str,
                   picks: Optional[int] = None):
    """A MoE layer's experts on every token, each picked expert's weights
    read once where they lie (``ref.moe_expert_ffn``): x (T, d), wi (E, d,
    2, f) for a gated ``act`` (swiglu, geglu) or (E, d, f) (gelu, relu2),
    wo (E, f, d), ``used`` int32 of at least E entries (non-zero: the
    expert was picked), ``picks`` a bound on the picked experts (the
    assignments, T*k) that sizes the plain version's copy.  Returns (E, T,
    d) in x's type; the rows of the experts with ``used`` 0 are zero from
    the plain version and unwritten by the kernel, so a caller reads only
    the picked experts' rows.  On CUDA it refuses inputs that require grad
    while autograd records: the kernel has no backward."""
    if act not in ref.MOE_ACTS:
        raise ValueError(f"act must be one of {ref.MOE_ACTS}, got {act!r}")
    if x.ndim != 2:
        raise ValueError(f"expected x of shape (T, d), got {tuple(x.shape)}")
    T, d = x.shape
    E, f = wo.shape[0], wo.shape[1]
    gated = act in ("swiglu", "geglu")
    want = (E, d, 2, f) if gated else (E, d, f)
    if tuple(wi.shape) != want or tuple(wo.shape) != (E, f, d):
        raise ValueError(f"expected wi {want} and wo {(E, f, d)} for {act}, "
                         f"got {tuple(wi.shape)} and {tuple(wo.shape)}")
    if used.ndim != 1 or used.shape[0] < E:
        raise ValueError(f"expected a used mask of at least {E} entries, got "
                         f"{tuple(used.shape)}")
    if _on_cpu(x, wi, wo, used):
        return ref.moe_expert_ffn(x, wi, wo, used, act=act, picks=picks)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, wi, wo)):
        raise RuntimeError(
            "moe_expert_ffn has no backward: its CUDA kernel's output is "
            "invisible to autograd, so x, wi and wo must not require grad "
            "(run under torch.no_grad(); a gradient of a dropless MoE layer "
            "is taken on the CPU)")
    out = _moe.moe_expert_ffn(x, wi, wo, used, act)
    _counted("moe_expert_ffn")
    return out
