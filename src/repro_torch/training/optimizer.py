"""AdamW with configurable state dtype, on flat parameter buffers.

Counterpart of ``repro.training.optimizer``.  The reference is
pure-functional over pytrees; here θ, the gradient and the moments are
flat vectors in the reference's ``ravel_pytree`` order (a
:class:`~repro_torch.models.common.FlatParams`), updated in place under
``torch.no_grad``.  The update math runs in float32, chunk by chunk so the
temporaries stay small beside a multi-billion-element θ; the moments are
stored in ``state_dtype`` (``"float32"`` or ``"bfloat16"``).  The learning
rate schedule and the bias corrections are computed in float32, as the
reference computes them.

Weight decay follows the reference's rule, ``p.ndim >= 2`` on the
reference's leaves: a stacked leaf has the leading ``n_periods`` axis, so
the per-layer norm scales of the stacked periods are decayed, while
``final_norm`` and the norms of the unstacked ``rest`` layers are not.
The rank is read from the reference's leaf shape
(:attr:`FlatLeaf.shape`), not from the port's per-layer tensors.
``torch.optim.AdamW`` is not used: its decay rule differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .._device import host_float
from ..distributed import collectives as coll
from ..models.common import FlatParams

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "lr_schedule",
           "global_norm", "adamw_update"]

f32 = torch.float32

#: elements per update chunk (bounds the float32 temporaries to ~128 MB)
_CHUNK = 1 << 25


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    state_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    """``step`` (updates taken) and the flat moments ``m``, ``v`` in the
    reference's order, in ``state_dtype``."""

    step: int
    m: torch.Tensor
    v: torch.Tensor


def adamw_init(params: FlatParams, cfg: AdamWConfig) -> AdamWState:
    dt = getattr(torch, cfg.state_dtype)
    kw = dict(dtype=dt, device=params.device)
    return AdamWState(0, torch.zeros(params.n, **kw),
                      torch.zeros(params.n, **kw))


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=f32)


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_frac, in float32."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return float(cfg.lr * warm * frac)


def global_norm(grads: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a flat gradient, accumulated in float32."""
    return torch.linalg.vector_norm(grads, dtype=f32)


def _chunks(params: FlatParams, lo: int, hi: int):
    """(start, stop, decay) pieces of ``[lo, hi)`` of at most ``_CHUNK``
    elements, each inside one leaf."""
    for leaf in params.leaves:
        decay = len(leaf.shape) >= 2  # the reference's leaf rank
        a, b = max(leaf.start, lo), min(leaf.stop, hi)
        for s in range(a, b, _CHUNK):
            yield s, min(s + _CHUNK, b), decay


def _split_sq(grads: torch.Tensor, params: FlatParams,
              lo: int) -> torch.Tensor:
    """The sum of squares of ``grads`` (θ's ``[lo, lo + len)``) over the
    leaves that are a rank's slices (:attr:`FlatLeaf.whole` False)."""
    sq = grads.new_zeros((), dtype=f32)
    hi = lo + grads.numel()
    for leaf in params.leaves:
        a, b = max(leaf.start, lo), min(leaf.stop, hi)
        if not leaf.whole and a < b:
            sq = sq + global_norm(grads[a - lo:b - lo]).square()
    return sq


@torch.no_grad()
def adamw_update(grads: torch.Tensor, state: AdamWState, params: FlatParams,
                 cfg: AdamWConfig, *, lo: int = 0, group=None,
                 count_whole: bool = True
                 ) -> Tuple[FlatParams, AdamWState, Dict[str, float]]:
    """One AdamW step on ``params.theta`` and the moments, in place.
    ``grads`` is a flat gradient (float32, or ``state_dtype`` when it was
    accumulated there).  Returns ``(params, new_state, metrics)`` with
    ``grad_norm`` and ``lr``, as the reference does.

    A sharded step (ZeRO over the flat buffer) passes one rank's chunk:
    ``grads``, ``state.m`` and ``state.v`` then cover ``theta[lo:lo +
    len(grads)]`` only, and the gradient's global norm sums the squares
    of every chunk over the process group ``group``.  Where ranks along
    ``"model"`` hold slices of θ, ``group`` spans them too and a whole
    leaf (the same on each of them) counts on one of them only: the
    others pass ``count_whole=False``."""
    step = state.step + 1
    if count_whole:
        gnorm = global_norm(grads)
    else:
        gnorm = _split_sq(grads, params, lo).sqrt()
    if group is not None:
        gnorm = coll.all_reduce_sum(gnorm.square(), group).sqrt()
    scale = None
    if cfg.grad_clip is not None:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(1 - b1 ** _f32(step))
    bc2 = float(1 - b2 ** _f32(step))
    theta, m, v = params.theta, state.m, state.v
    for s, e, decay in _chunks(params, lo, lo + grads.numel()):
        g = grads[s - lo:e - lo].to(f32)
        if scale is not None:
            g = g * scale
        m32 = b1 * m[s - lo:e - lo].to(f32) + (1 - b1) * g
        v32 = b2 * v[s - lo:e - lo].to(f32) + (1 - b2) * g.square()
        delta = (m32 / bc1) / ((v32 / bc2).sqrt() + cfg.eps)
        p32 = theta[s:e]
        if cfg.weight_decay and decay:  # no decay on norms/bias
            delta = delta + cfg.weight_decay * p32
        p32.sub_(lr * delta)
        m[s - lo:e - lo] = m32
        v[s - lo:e - lo] = v32
    metrics = {"grad_norm": host_float(gnorm), "lr": lr}
    return params, AdamWState(step, m, v), metrics
