"""Expert-parallel MoE: the token <-> expert exchange as an all-to-all.

Counterpart of ``repro.models.moe_shard_map``, which writes the exchange
with ``shard_map`` + ``lax.all_to_all``.  Here it is one rank of an SPMD
program over a :class:`~repro_torch.distributed.sharding.Mesh` with a
``"model"`` axis.  A rank is given its data rank's tokens ``x`` (the same
on every ``"model"`` rank of that data rank) and either the whole router
and expert weights or its own ``E/|model|`` experts and their router
columns (the ``experts -> model`` placement of
``transformer.shard_params``):

  1. it takes its ``1/|model|`` piece of the tokens (``T_loc`` rows);
  2. routes them with the full router (tiny; its columns all-gathered
     over ``"model"`` where the rank holds its own) in float32;
  3. packs per-destination send buffers ``(|model|, cap, d)``, the
     destination being ``expert // E_loc``, by a stable sort and
     ``searchsorted`` slots (no one-hot products);
  4. exchanges them with one all-to-all over ``"model"`` (with the local
     expert ids);
  5. runs its ``E_loc = E/|model|`` experts on an ``(E_loc, C2, d)``
     buffer slotted the same way;
  6. sends the results back with the reverse all-to-all, combines each
     token's ``k`` rows with its routing weights, and all-gathers the
     pieces over ``"model"``, so every rank leaves with the whole
     ``(B, S, d)``; shared experts run on the whole ``x`` (split along
     their hidden width where their weights are a rank's slices, as a
     dense MLP's).

Capacity is enforced per (source, destination) pair, ``cap =
ceil(T_loc * k * cf / |model|)``, and per local expert, ``C2 =
ceil(|model| * cap * cf / E_loc)``; with ample ``cf`` nothing is dropped
and the result is ``moe.moe_ffn(dropless=True)``'s.  Every assignment
writes its own slot: a dropped one a place past the buffer's end, so no
index repeats.  (The reference writes dropped assignments to slot
``cap - 1`` with duplicate indices, which can replace the kept token
there by the padding row: the fault ``models.moe`` also avoids.)

Gradients (``distributed.collectives``): the router and whole expert
weights enter as
:func:`~repro_torch.distributed.collectives.replicated_param` (their
gradient is summed over ``"model"``, so every rank holds the whole
gradient; a rank's own experts see all their tokens here, so their
gradient is whole without a sum), the token piece as ``split`` and the
result leaves as ``gather``. So a sharded step averages gradients over
the data ranks only. The auxiliary losses are each rank's, averaged over
every rank, as the reference's ``pmean``; their gradient is scaled by
``1/|model|`` so that this averaging over the data ranks gives the
gradient of that mean. ``moe_dropped`` counts the assignments of ``x``
dropped by either capacity (summed over ``"model"``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed import collectives as coll
from ..telemetry.serving import span
from .layers import mlp
from .moe import _expert_ffn, _slots, route

__all__ = ["moe_ffn_a2a"]

f32 = torch.float32


def _slot_table(keys: torch.Tensor, n_keys: int, per_key: int,
                fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable slotting of ``keys`` (values in ``[0, n_keys]``; ``n_keys``
    marks padding) into ``(n_keys, per_key)`` slots: returns ``(table,
    pos)``, the table holding each kept entry's index (``fill`` where
    empty) and ``pos`` each entry's position within its key, in entry
    order (kept where below ``per_key``)."""
    order, sorted_k, pos = _slots(keys)
    ok = (pos < per_key) & (sorted_k < n_keys)
    n = keys.numel()
    dst = torch.where(ok, sorted_k * per_key + pos,
                      n_keys * per_key + torch.arange(n, device=keys.device))
    table = torch.full((n_keys * per_key + n,), fill, dtype=torch.long,
                       device=keys.device)
    table = table.scatter_(0, dst, order)[:n_keys * per_key]
    return (table.view(n_keys, per_key),
            torch.empty_like(pos).scatter_(0, order, pos))


def moe_ffn_a2a(cfg: ModelConfig, params, x: torch.Tensor, mesh,
                data_axes: Tuple[str, ...] = ("data",),
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: this data rank's (B, S, d) -> (out (B, S, d), aux): the
    expert-parallel counterpart of :func:`~repro_torch.models.moe.moe_ffn`
    under ``mesh`` (a ``distributed.sharding.Mesh``); ``data_axes`` are
    the mesh axes the batch is split over."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k, cf = moe.padded_experts, moe.top_k, moe.capacity_factor
    n_model = mesh.shape["model"]
    if E % n_model:
        raise ValueError(f"{E} experts do not split over {n_model} model "
                         f"ranks")
    E_loc = E // n_model
    m = mesh.coord("model")
    group = mesh.group("model")

    # 1-2. this rank's tokens, routed over all E experts
    xt = coll.split(x.reshape(B * S, d), group)
    T_loc = xt.shape[0]
    router = params["router"]
    if router.shape[1] < E:  # this rank's columns: the whole router
        router = coll.gather(router.t().contiguous(), group).t()
    p = {"router": coll.replicated_param(router, group)}
    if params["wi"].shape[0] == E:
        p.update({name: coll.replicated_param(params[name], group)
                  [m * E_loc:(m + 1) * E_loc] for name in ("wi", "wo")})
    else:  # this rank's experts
        p.update(wi=params["wi"], wo=params["wo"])
    r = route(cfg, p, xt)

    # 3. per-destination send buffers (n_model, cap, d)
    cap = max(math.ceil(T_loc * k * cf / n_model), 1)
    flat_e = r.top_e.reshape(-1)
    dest = flat_e // E_loc
    table, inv = _slot_table(dest, n_model, cap, T_loc * k)
    xpad = torch.cat([xt, xt.new_zeros(1, d)])
    send_x = xpad[torch.where(table < T_loc * k, table // k, T_loc)]
    epad = torch.cat([flat_e % E_loc, flat_e.new_full((1,), E_loc)])
    send_e = epad[table.clamp(max=T_loc * k)]  # E_loc marks an empty slot

    # 4. the exchange over "model": slot (r, c) came from model rank r
    rx = coll.all_to_all(send_x, group).reshape(n_model * cap, d)
    re = coll.all_to_all(send_e, group).reshape(n_model * cap)

    # 5. the local experts on an (E_loc, C2, d) buffer
    C2 = max(math.ceil(n_model * cap * cf / max(E_loc, 1)), 1)
    n_rx = rx.shape[0]
    table2, inv2 = _slot_table(re, E_loc, C2, n_rx)
    rxpad = torch.cat([rx, rx.new_zeros(1, d)])
    with span("lm.moe.experts"):
        out_e = _expert_ffn(cfg.ffn_act, p, rxpad[table2])

    # 6. back to the receive slots, the reverse exchange and the combine
    v2 = (inv2 < C2) & (re < E_loc)
    ret = out_e[re.clamp(0, E_loc - 1), inv2.clamp(0, C2 - 1)]
    ret = torch.where(v2[:, None], ret, ret.new_zeros(()))
    back = coll.all_to_all(ret.view(n_model, cap, d), group)
    valid = (inv < cap)[:, None]
    picked = back[dest, inv.clamp(0, cap - 1)]
    picked = torch.where(valid, picked, picked.new_zeros(()))
    combined = torch.einsum("tkd,tk->td", picked.view(T_loc, k, d),
                            r.top_p.to(picked.dtype))
    out = coll.gather(combined, group).view(B, S, d)
    if moe.n_shared:
        out = out + mlp(params["shared"], x, cfg.ffn_act,
                        d_ff=moe.n_shared * cfg.d_ff)

    # auxiliary losses: each rank's, averaged over every rank
    me = r.probs.mean(0)
    ce = torch.bincount(flat_e, minlength=E).to(f32) / T_loc
    lb = moe.n_experts * (me * ce).sum() * moe.aux_loss_coef
    z = torch.logsumexp(r.logits, dim=-1).square().mean() * moe.router_z_coef
    every = mesh.group(tuple(a for a in data_axes if a in mesh.shape)
                       + ("model",))
    dropped = (inv >= cap).sum() + ((re < E_loc) & ~v2).sum()
    aux = {"moe_load_balance": coll.mean(lb, every, 1.0 / n_model),
           "moe_router_z": coll.mean(z, every, 1.0 / n_model),
           "moe_dropped": coll.all_reduce_sum(dropped, group)}
    return out, aux
