"""Mixture-of-Experts with gather-based dispatch (no one-hot matmul FLOPs).

Counterpart of ``repro.models.moe`` on one device.  Top-k routing in
float32 with capacity dropping, GShard-style; token movement is gathers
and scatters of *indices* (a stable sort of the assignments by expert and
``searchsorted`` slots), never a ``(T, E, C)`` one-hot einsum.  Experts
are batched products (``torch.bmm``) over the ``(E, C, d)`` dispatch
buffer, as the reference's einsums are.  Shared (always-on) experts are
one wide MLP.  Padding experts (``moe.pad_to``) get a -1e30 router logit,
so they are never routed.

Capacity: every assignment whose position within its expert is below
``C`` is kept.  The gather table is written by one scatter whose indices
are all distinct (dropped assignments write past the table's end), so the
dispatch is deterministic on every device.  The reference writes every
dropped assignment to slot ``C - 1`` with duplicate indices, which can
replace the kept token there by the padding row (ROADMAP.md queue 3); the
port's result equals the reference's on every other token.

Decode (``dropless=True``) is the reference's ``C = T`` path, computed on
the experts the batch picked only: the other experts' rows are padding and
contribute exactly 0, so the function is the same while at most ``T * k``
experts' weights are read (all ``E`` in the reference).

The expert-parallel all-to-all is :mod:`repro_torch.models.moe_shard_map`
(taken under a mesh with a ``"model"`` axis); ``cfg.moe.a2a`` without a
mesh runs :func:`moe_ffn`, as in the reference.

Under a mesh whose ``"model"`` ranks each hold a slice of the experts
(``transformer.shard_params``: ``E / |model|`` experts and the router's
columns for them, the ``experts -> model`` rule), :func:`moe_ffn` runs
that slice: every rank computes its experts' router logits for all of
its tokens, the (T, E) float32 logits are gathered over ``"model"``
before top-k (so routing, the capacity decisions and the auxiliary
losses are the same on every rank), it runs its own experts' slots,
combines the assignments to them (the rest weigh 0) and the ranks'
partial sums are reduced (``collectives.reduce``).  The tokens enter
the router and the experts, and the routing weights the experts,
through ``collectives.replicated_param``, whose backward sums the ranks'
partial gradients; the gather's backward keeps the rank's columns of the
logits' gradient, which is the same on every rank.  Shared experts split
along their hidden width as a dense MLP does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import collectives as coll
from .common import ParamSpec, model_axis
from .layers import mlp, mlp_spec

__all__ = ["moe_spec", "Routing", "route", "capacity", "capacity_positions",
           "moe_ffn"]

f32 = torch.float32


def moe_spec(cfg: ModelConfig) -> Dict:
    moe = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, moe.padded_experts
    gated = cfg.ffn_act in ("swiglu", "geglu")
    s: Dict = {
        "router": ParamSpec((d, E), ("embed", "experts")),
        "wi": ParamSpec((E, d, 2, f) if gated else (E, d, f),
                        ("experts", "embed", None, "expert_ffn") if gated
                        else ("experts", "embed", "expert_ffn")),
        "wo": ParamSpec((E, f, d), ("experts", "expert_ffn", "embed")),
    }
    if moe.n_shared:
        s["shared"] = mlp_spec(cfg, d_ff=moe.n_shared * f)
    return s


def _expert_ffn(cfg: ModelConfig, params, xin: torch.Tensor) -> torch.Tensor:
    """xin: (E', C, d) -> (E', C, d) through each expert's (gated) MLP;
    ``params["wi"]``/``["wo"]`` hold the same E' experts in order."""
    wi, wo = params["wi"], params["wo"]
    if cfg.ffn_act in ("swiglu", "geglu"):
        E, d, _, f = wi.shape
        h = torch.bmm(xin, wi.reshape(E, d, 2 * f)).unflatten(-1, (2, f))
        gate, up = h[..., 0, :], h[..., 1, :]
        g = (F.silu(gate) if cfg.ffn_act == "swiglu"
             else F.gelu(gate, approximate="tanh"))
        h = g * up
    else:
        h = torch.bmm(xin, wi)
        h = (F.gelu(h, approximate="tanh") if cfg.ffn_act == "gelu"
             else F.relu(h).square())
    return torch.bmm(h, wo)


class Routing(NamedTuple):
    logits: torch.Tensor  # (T, E) float32, padding experts at -1e30
    probs: torch.Tensor  # (T, E) softmax of the logits
    top_p: torch.Tensor  # (T, k) the chosen probabilities, renormalised
    top_e: torch.Tensor  # (T, k) the chosen experts (int64), largest first


def route(cfg: ModelConfig, params, xt: torch.Tensor) -> Routing:
    """The router in float32 for the tokens ``xt`` (T, d).  A router that
    holds this rank's experts' columns (under a mesh) gives the rank's
    logits, gathered over ``"model"``; ``xt`` is then the same on every
    rank and has entered through ``collectives.replicated_param``."""
    moe = cfg.moe
    E = moe.padded_experts
    logits = xt.to(f32) @ params["router"].to(f32)
    if logits.shape[-1] < E:  # this rank's experts' columns
        ax = model_axis()
        logits = coll.gather(logits.t().contiguous(), ax.group).t()
    if E != moe.n_experts:  # mask the padding experts
        pad = torch.arange(E, device=xt.device) >= moe.n_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    return Routing(logits, probs, top_p, top_e)


def capacity(cfg: ModelConfig, T: int, dropless: bool = False) -> int:
    """Slots per expert for ``T`` tokens: ``T`` when dropless (every token
    on one expert fits), else ``T * k * capacity_factor / E``."""
    moe = cfg.moe
    if dropless:
        return T
    return max(int(T * moe.top_k * moe.capacity_factor / moe.padded_experts),
               1)


def _slots(flat_e: torch.Tensor):
    """The assignments stably sorted by expert: ``(order, sorted_e,
    pos_in_e)``, each one's position within its expert counted in token
    order."""
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_in_e = (torch.arange(flat_e.numel(), device=flat_e.device)
                - torch.searchsorted(sorted_e, sorted_e, side="left"))
    return order, sorted_e, pos_in_e


def capacity_positions(top_e: torch.Tensor) -> torch.Tensor:
    """(T, k): each assignment's position within its expert; those below
    the capacity are kept."""
    order, _, pos_in_e = _slots(top_e.reshape(-1))
    return torch.empty_like(pos_in_e).scatter_(0, order,
                                               pos_in_e).view(top_e.shape)


def _capacity_combine(cfg: ModelConfig, params, xt: torch.Tensor,
                      r: Routing, top_p: torch.Tensor,
                      e0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch into (E, C, d), the experts, and the weighted combine
    (weights ``top_p``); also the number of assignments dropped by
    capacity.  ``params`` may
    hold the experts ``[e0, e0 + E')`` only: then only their slots run
    and the other assignments weigh 0."""
    T, d = xt.shape
    E, k = cfg.moe.padded_experts, cfg.moe.top_k
    E_loc = params["wi"].shape[0]
    C = capacity(cfg, T)
    flat_e = r.top_e.reshape(-1)
    order, sorted_e, pos_in_e = _slots(flat_e)
    ok = pos_in_e < C
    # gather table (E, C) -> source token (T: the padding row).  Every
    # assignment writes its own index: a kept one its slot, a dropped one
    # a place past the table's end, so no index repeats.
    n = flat_e.numel()
    dst = torch.where(ok, sorted_e * C + pos_in_e,
                      E * C + torch.arange(n, device=xt.device))
    table = torch.full((E * C + n,), T, dtype=torch.long, device=xt.device)
    table = table.scatter_(0, dst, order // k)[e0 * C:(e0 + E_loc) * C]
    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    out_e = _expert_ffn(cfg, params, xpad[table.view(E_loc, C)])
    # combine: invert the slotting
    inv_pos = torch.empty_like(pos_in_e).scatter_(0, order, pos_in_e)
    e_loc = flat_e - e0
    valid = ((inv_pos < C) & (e_loc >= 0) & (e_loc < E_loc))[:, None]
    picked = out_e[e_loc.clamp(0, E_loc - 1), inv_pos.clamp(0, C - 1)]
    picked = torch.where(valid, picked, picked.new_zeros(()))
    combined = torch.einsum("tkd,tk->td", picked.view(T, k, d),
                            top_p.to(picked.dtype))
    return combined, (~ok).sum()


def _dropless_combine(cfg: ModelConfig, params, xt: torch.Tensor,
                      r: Routing, top_p: torch.Tensor,
                      e0: int = 0) -> torch.Tensor:
    """The reference's ``C = T`` combine on the experts the tokens picked:
    every token through each of ``min(E', T*k)`` experts that include all
    picked ones (the rest get no weight), then each assignment's row.
    ``params`` may hold the experts ``[e0, e0 + E')`` only, as
    :func:`_capacity_combine`'s."""
    T, d = xt.shape
    E_loc = params["wi"].shape[0]
    K = min(E_loc, r.top_e.numel())
    e_loc = r.top_e - e0
    mine = (e_loc >= 0) & (e_loc < E_loc)
    used = torch.zeros(E_loc + 1, dtype=torch.int32, device=xt.device)
    used.index_fill_(0, torch.where(mine, e_loc, E_loc).reshape(-1), 1)
    sel = torch.argsort(used[:E_loc], descending=True, stable=True)[:K]
    out = _expert_ffn(cfg, {"wi": params["wi"][sel], "wo": params["wo"][sel]},
                      xt.expand(K, T, d))  # (K, T, d)
    j = (e_loc[..., None] == sel).to(torch.int32).argmax(-1)  # (T, k)
    picked = out[j, torch.arange(T, device=xt.device)[:, None]]  # (T, k, d)
    picked = torch.where(mine[..., None], picked, picked.new_zeros(()))
    return torch.einsum("tkd,tk->td", picked, top_p.to(picked.dtype))


def moe_ffn(cfg: ModelConfig, params, x: torch.Tensor,
            dropless: bool = False,
            losses: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (out, aux).  ``aux`` holds ``moe_dropped`` (the
    assignments dropped by capacity, 0 when dropless) and, with
    ``losses``, the float32 load-balance and router-z losses.

    ``dropless=True`` (the decode path) sizes capacity so no assignment
    can be dropped (C = T): serving must not silently drop tokens."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    E = moe.padded_experts
    xt = x.reshape(T, d)
    # a rank's slice of the experts under a mesh (see the module
    # docstring): tokens and weights enter, the partial sums are reduced
    ax = model_axis()
    if ax is None or params["wi"].shape[0] == E:
        ax, xe, e0 = None, xt, 0
        r = route(cfg, params, xt)
        top_p = r.top_p
    else:
        xe = coll.replicated_param(xt, ax.group)
        r = route(cfg, params, xe)
        top_p = coll.replicated_param(r.top_p, ax.group)
        e0 = ax.index * params["wi"].shape[0]
    if dropless:
        combined = _dropless_combine(cfg, params, xe, r, top_p, e0)
        dropped = torch.zeros((), dtype=torch.long, device=x.device)
    else:
        combined, dropped = _capacity_combine(cfg, params, xe, r, top_p, e0)
    if ax is not None:
        combined = coll.reduce(combined, ax.group)
    if moe.n_shared:
        combined = combined + mlp(params["shared"], xt, cfg.ffn_act,
                                  d_ff=moe.n_shared * cfg.d_ff)
    aux = {"moe_dropped": dropped}
    if losses:  # Switch-style load balance + router z
        me = r.probs.mean(0)  # (E,)
        ce = torch.bincount(r.top_e.reshape(-1), minlength=E).to(f32) / T
        aux["moe_load_balance"] = (moe.n_experts * (me * ce).sum()
                                   * moe.aux_loss_coef)
        aux["moe_router_z"] = (torch.logsumexp(r.logits, dim=-1).square()
                               .mean() * moe.router_z_coef)
    return combined.reshape(B, S, d), aux
