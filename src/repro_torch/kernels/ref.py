"""Plain PyTorch versions of the CUDA kernels, plus numpy oracles.

Each torch function computes exactly what its kernel computes, with the
same argument order (``kernels/ref.py`` and the Pallas kernels of the
JAX package are the source; for ``selective_scan``, which has no Pallas
kernel, the reference's ``models/mamba.py``).
:mod:`repro_torch.kernels.ops` takes them for CPU tensors only; the CPU
tests and ``chip_smoke.py`` hold the kernels against them.  The
arithmetic order is part of the contract:

* ``jacobi_halo_sweeps`` sums ``(b + (((up + down) + left) + right)) / 4``
  like ``_halo_kernel`` and the host path's ``_block_sweeps``;
* ``jacobi_sweep`` takes the add order as an argument: ``"pallas"`` (the
  default) sums ``((((b + up) + down) + left) + right) * 0.25`` like
  ``_jacobi_kernel``; ``"jnp"`` sums ``(b + (((up + down) + left) +
  right)) / 4`` like the reference problem's ``_full_sweep`` and
  ``ref_jacobi_sweep``.

``flash_attention`` is ``ref_attention`` (materialised float32 scores)
with its conventions: ``-2e38`` for masked scores, zeros for fully-masked
rows, kv head ``h // (nq / nkv)``.

``selective_scan`` is the reference's ``_ssm_apply`` and
``ssm_final_state`` in one: the (decay, increment) pairs combined as its
``_combine`` by a doubling scan along time within each chunk, the carried
state injected as ``b_cum + a_cum * h0``.

``moe_expert_ffn`` runs ``models/moe.py``'s ``_expert_ffn`` (batched
products in the inputs' type, the activation between them) on a copy of
the experts a ``used`` mask names, on every token.

The ``oracle_*`` functions are numpy copies of the reference's
``ref_jacobi_halo_sweeps``/``ref_bellman_block``: the device plane's
``"ref"`` mode runs them, for differential tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["JACOBI_ORDERS", "jacobi_sweep", "jacobi_halo_sweeps", "bellman",
           "bellman_block", "anderson_mix", "flash_attention",
           "selective_scan", "MOE_ACTS", "moe_expert_ffn",
           "oracle_jacobi_halo_sweeps",
           "oracle_bellman_block"]


#: add orders of :func:`jacobi_sweep`
JACOBI_ORDERS = ("pallas", "jnp")


def jacobi_sweep(x: torch.Tensor, b: torch.Tensor, g: int,
                 order: str = "pallas") -> torch.Tensor:
    """One global five-point Dirichlet sweep of a flat ``(g*g,)`` grid,
    summed in the Pallas kernel's or ``_full_sweep``'s order."""
    p = F.pad(x.reshape(g, g), (1, 1, 1, 1))
    up, down = p[:-2, 1:-1], p[2:, 1:-1]
    left, right = p[1:-1, :-2], p[1:-1, 2:]
    bg = b.reshape(g, g)
    if order == "jnp":
        return ((bg + (((up + down) + left) + right)) / 4.0).reshape(-1)
    return (((((bg + up) + down) + left) + right) * 0.25).reshape(-1)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, softcap=None,
                    q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention, q (B, Sq, nq, hd), k/v (B, Skv, nkv, hd),
    computed in float32 (float64 for float64 inputs) and returned in q's
    dtype.  Query row i sits at position ``i + q_offset``; key j at
    position j."""
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, nkv, g, hd).to(ct)
    s = torch.einsum("bsngh,btnh->bngst", qg * hd ** -0.5, k.to(ct))
    if softcap is not None:
        s.div_(softcap).tanh_().mul_(softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s.masked_fill_(~mask, -2.0e38)
    w = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bngst,btnh->bsngh", w, v.to(ct))
    # fully-masked rows: zero output (the kernel's convention)
    out.masked_fill_(~mask.any(-1)[None, :, None, None, None], 0.0)
    return out.reshape(B, Sq, nq, hd).to(q.dtype)


def _doubling_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a, b) under the
    reference's ``_combine((al, bl), (ar, br)) = (al * ar, ar * bl + br)``,
    by doubling: step d combines each position with the one d before it."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def selective_scan(dt: torch.Tensor, xc: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0=None, *,
                   chunk=None, acc=None):
    """Mamba's selective scan: ``h_t = exp(dt_t A) h_{t-1} + (dt_t xc_t)
    B_t``, ``y_t = C_t . h_t``, from ``h0`` (zero when None).  dt, xc (B,
    S, d_inner) and Bm, Cm (B, S, d_state) in the model's type, A (d_inner,
    d_state) float32; ``dt * xc`` is rounded to that type, everything
    after it is computed in ``acc`` (default float32, as the reference, or
    float64 for float64 inputs; float64 for an error yardstick).  Chunks
    of ``chunk`` steps when it divides S
    (the reference's rule: its unchunked form is the one chunk S), each a
    doubling scan over (B, chunk, d_inner, d_state) tensors.  Returns
    ``(y (B, S, d_inner), h_S (B, d_inner, d_state))`` in ``acc``."""
    B, S, _ = dt.shape
    L = chunk if chunk and S % chunk == 0 else S
    acc = acc or torch.promote_types(dt.dtype, torch.float32)
    A = A.to(acc)
    h = None if h0 is None else h0.to(acc)
    ys = []
    for s0 in range(0, S, L):
        dti, xci, Bi = (t[:, s0:s0 + L] for t in (dt, xc, Bm))
        a = torch.exp(dti.to(acc)[..., None] * A)
        b = (dti * xci).to(acc)[..., None] * Bi.to(acc)[..., None, :]
        a_cum, hs = _doubling_scan(a, b)
        del a, b
        if h is not None:  # inject the carried state
            hs = hs + a_cum * h[:, None]
        del a_cum
        ys.append(torch.einsum("bcin,bcn->bci", hs,
                               Cm[:, s0:s0 + L].to(acc)))
        h = hs[:, -1].clone()
        del hs
    return torch.cat(ys, dim=1), h


#: activations of :func:`moe_expert_ffn`: gated (``wi`` (E, d, 2, f)),
#: then not (``wi`` (E, d, f)); GELU is the tanh approximation
MOE_ACTS = ("swiglu", "geglu", "gelu", "relu2")


def moe_expert_ffn(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                   used: torch.Tensor, *, act: str,
                   picks: Optional[int] = None) -> torch.Tensor:
    """Every expert ``e`` of ``wi``/``wo`` with ``used[e] != 0`` through
    its FFN on all tokens ``x`` (T, d): ``models.moe._expert_ffn`` on a
    copy of the weights of ``min(E, picks)`` experts (all E when ``picks``
    is None) that hold every picked one, a size known before the data, as
    autograd and the meta device need.  Returns (E, T, d) in x's type; the
    other experts' rows are zero."""
    from ..models import moe  # the layer's own experts, not a second copy

    E = wi.shape[0]
    T, d = x.shape
    K = E if picks is None else min(E, picks)
    sel = torch.argsort(used[:E], descending=True, stable=True)[:K]
    h = moe._expert_ffn(act, {"wi": wi[sel], "wo": wo[sel]},
                        x.expand(K, T, d))
    out = x.new_zeros((E, T, d)).index_copy(0, sel, h)
    return torch.where(used[:E, None, None] != 0, out, out.new_zeros(()))


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
