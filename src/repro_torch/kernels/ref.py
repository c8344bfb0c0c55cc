"""Plain PyTorch versions of the five CUDA kernels, plus numpy oracles.

Each torch function computes exactly what its kernel computes, with the
same argument order (``kernels/ref.py`` and the Pallas kernels of the JAX
package are the source).  :mod:`repro_torch.kernels.ops` takes them for
CPU tensors only; the CPU tests and ``chip_smoke.py`` hold the kernels
against them.  The arithmetic order is part of the contract:

* ``jacobi_halo_sweeps`` sums ``(b + (((up + down) + left) + right)) / 4``
  like ``_halo_kernel`` and the host path's ``_block_sweeps``;
* ``jacobi_sweep`` sums ``((((b + up) + down) + left) + right) * 0.25``
  like ``_jacobi_kernel`` (not ``ref_jacobi_sweep``'s order).

The ``oracle_*`` functions are numpy copies of the reference's
``ref_jacobi_halo_sweeps``/``ref_bellman_block``: the device plane's
``"ref"`` mode runs them, for differential tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["jacobi_sweep", "jacobi_halo_sweeps", "bellman", "bellman_block",
           "anderson_mix", "oracle_jacobi_halo_sweeps", "oracle_bellman_block"]


def jacobi_sweep(x: torch.Tensor, b: torch.Tensor, g: int) -> torch.Tensor:
    """One global five-point Dirichlet sweep of a flat ``(g*g,)`` grid."""
    p = F.pad(x.reshape(g, g), (1, 1, 1, 1))
    up, down = p[:-2, 1:-1], p[2:, 1:-1]
    left, right = p[1:-1, :-2], p[1:-1, 2:]
    return (((((b.reshape(g, g) + up) + down) + left) + right) * 0.25
            ).reshape(-1)


def jacobi_halo_sweeps(xb: torch.Tensor, top: torch.Tensor,
                       bot: torch.Tensor, b: torch.Tensor, *, sweeps: int):
    """``sweeps`` frozen-halo sweeps of a ``(rows, g)`` block; returns
    ``(new_block, sum((new - xb)**2))``."""
    blk = xb
    for _ in range(sweeps):
        p = F.pad(torch.cat([top[None], blk, bot[None]], dim=0), (1, 1))
        nb = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        blk = (b + nb) / 4.0
    d = blk - xb
    return blk, (d * d).sum()


def bellman(idx: torch.Tensor, probs: torch.Tensor, rewards: torch.Tensor,
            v: torch.Tensor, *, gamma: float) -> torch.Tensor:
    """``max_a [R(s,a) + gamma * sum_b P_b(s,a) * v[idx_b(s,a)]]``."""
    ev = (probs * v[idx.long()]).sum(-1)
    return (rewards + gamma * ev).amax(-1)


def bellman_block(idx: torch.Tensor, probs: torch.Tensor,
                  rewards: torch.Tensor, v: torch.Tensor,
                  v_old: torch.Tensor, *, gamma: float):
    """State-block backup plus its local inf-norm ``max|tv - v_old|``."""
    tv = bellman(idx, probs, rewards, v, gamma=gamma)
    return tv, (tv - v_old).abs().amax()


def anderson_mix(X: torch.Tensor, G: torch.Tensor, alpha: torch.Tensor, *,
                 beta: float = 1.0) -> torch.Tensor:
    """``sum_j alpha_j ((1 - beta) X_j + beta G_j)`` over an ``(h, N)``
    window."""
    combined = (1.0 - beta) * X + beta * G
    return alpha.to(combined.dtype) @ combined


def oracle_jacobi_halo_sweeps(xb, top, bot, b, *, sweeps: int):
    """Numpy oracle of :func:`jacobi_halo_sweeps`."""
    blk0 = np.asarray(xb, dtype=np.float64)
    top = np.asarray(top, dtype=np.float64)
    bot = np.asarray(bot, dtype=np.float64)
    bg = np.asarray(b, dtype=np.float64)
    blk = blk0
    for _ in range(sweeps):
        p = np.concatenate([top[None], blk, bot[None]], axis=0)
        p = np.pad(p, ((0, 0), (1, 1)))
        nb = p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        blk = (bg + nb) / 4.0
    return blk, float(np.sum((blk - blk0) ** 2))


def oracle_bellman_block(idx, probs, rewards, v, v_old, *, gamma: float):
    """Numpy oracle of :func:`bellman_block`."""
    ev = np.einsum("sab,sab->sa", np.asarray(probs), np.asarray(v)[idx])
    tv = np.max(np.asarray(rewards) + gamma * ev, axis=-1)
    return tv, float(np.max(np.abs(tv - np.asarray(v_old))))
