"""Dry run: every (arch x shape) cell's step traced on the meta device
for one rank of a mesh (one card by default, or the 16x16 and 2x16x16
production meshes), its bytes on the card, its collectives and its three
roofline terms.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell for a 256- or 512-device mesh and reads XLA's memory
and cost analyses; here each cell's step runs eagerly on the meta device
(shapes and dtypes, no storage: nothing is allocated and the card is
never touched) under :mod:`repro_torch.launch.opstats`.  On a mesh the
step is rank 0's (``sharding.traced_rank``): its tensor-parallel slices
of the parameters (``transformer.shard_params``), its piece of the
batch, and collectives that take and return meta tensors and report
what they would move, so the collective term comes from the collectives
the step issues.  Resident bytes per rank are given twice:

* ``rule_bytes``: the reference's count, ``bytes_per_device`` of the
  parameter specs (float32) and the caches' bytes under the cell's rules
  (its ``_local_bytes_of_spec_tree`` and ``_local_cache_bytes``);
* ``resident_bytes``: the port's own layout on the rank (no activations,
  so a run's measured peak lies above it):

  train    its slice of θ and the gradient buffer (float32, the port
           trains in float32; autograd fills the whole slice before the
           reduce-scatter), its ZeRO chunks of AdamW's m and v
           (``cfg.opt_state_dtype``), plus the accumulation buffer where
           that dtype is not float32
  prefill  its slice of the parameters (``cfg.param_dtype``) and the
           caches it emits
  decode   its parameters and the caches it reads

  The slice is the rules' ``"model"`` placement and θ stays whole along
  the data axes; the caches are the rank's pieces under the cell's
  rules (``transformer.cache_shardings``: the reference's cache rule,
  the batch split as the step builders split it), so where the batch
  divides the data axes the two counts' caches agree.  ``fits``
  compares the total with the card's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k
      [--mesh {one_card,16x16,2x16x16} | --multi-pod]
  python -m repro_torch.launch.dryrun --all [--variant chunk512] [--out DIR]

``--multi-pod`` is ``--mesh 2x16x16``.  The train step is the port's
``make_train_step`` with ``grad_accum_for(cfg, shape, dp)`` microbatches
(``dp`` the data ranks).  Identical repeats are
traced a few times and scaled, the eager counterpart of the reference's
loop trip counts: a step of more than 3 microbatches is traced with 3
and the second's counts (from its start to the third's, its share of
the accumulation included) are added for each of the rest; a stack of
more than 2 periods is traced at 1 and 2 periods; the sLSTM's loop over
time (``xlstm._slstm_scan``) is traced at 3 and 4 steps (its product
FLOPs exact, its other counts but a few zero-fills).  ``--unscaled``
traces every microbatch, period and time step instead (slow: it shows
what the scaling saves).
``--jobs N`` traces ``--all``'s cells in N processes (CPU only).  Variants that
change only sharding rules take effect on a mesh (on one card the record
says they do nothing): the rule count follows them, and so does the
port's layout where they move the ``"model"`` placements or the batch
(``fsdp_all``: data parallel over every axis); ``moe_a2a`` traces the
expert-parallel all-to-all on a mesh; ``chunk512`` and ``chunk2048``
change ``attn_chunk`` and so the traced train step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.base import ModelConfig
from ..distributed.sharding import (MeshShape, Rules, bytes_per_device,
                                    resolve_axes, shards_of, traced_rank)
from ..models import transformer as tf
from ..models import xlstm
from ..models.common import use_mesh
from ..training.optimizer import AdamWConfig, adamw_init
from . import inputs as inp
from . import opstats
from .mesh import HBM_PER_DEVICE, make_production_mesh
from .roofline import roofline_from_stats
from .steps import data_axes, dp_size, make_train_step, shard_range, tp_size

META = torch.device("meta")

__all__ = ["ONE_CARD", "MESHES", "apply_variant", "rule_bytes",
           "resident_bytes", "trace_step", "dry_run", "run_cell",
           "cell_list", "main"]

#: the one-card mesh, the default
ONE_CARD = MeshShape(("data", "model"), (1, 1))

#: the meshes a cell can be planned on (``--mesh``)
MESHES = {"one_card": ONE_CARD, "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}

#: the variants that only edit the sharding rules (or, ``grad_rs`` and
#: ``tp_only``, the reference's gradient and optimizer-state sharding):
#: nothing changes on one card
RULE_EDITS = {
    "seq_shard_prefill": {"act_seq": "data"}, "no_fsdp": {"embed": None},
    "fsdp_pod": {"embed": ("pod", "data")},
    "kv_seq_data": {"cache_seq": ("data", "model")},
    "expert_fsdp": {"expert_ffn": "data"},
    "moe_cap_shard": {"expert_capacity": "data"},
    "opt1": {"expert_capacity": "data"},
    "opt_all": {"expert_capacity": "data"},
    "grad_rs": {}, "tp_only": {"embed": None},
}


def apply_variant(cfg: ModelConfig, rules: Rules, variant: str,
                  mesh: MeshShape = ONE_CARD
                  ) -> Tuple[ModelConfig, Rules, Optional[int], str]:
    """The reference's named variants: ``(cfg, rules, accum_override,
    note)``; ``note`` says what a variant does not do on one card (empty
    on a mesh of more than one)."""
    if variant == "baseline":
        return cfg, rules, None, ""
    rules = dict(rules)
    if variant == "chunk512":
        return dataclasses.replace(cfg, attn_chunk=512), rules, None, ""
    if variant == "chunk2048":
        return dataclasses.replace(cfg, attn_chunk=2048), rules, None, ""
    one_rank = ("changes sharding only: no effect on one card"
                if mesh.size == 1 else "")
    if variant == "moe_a2a":
        if cfg.moe is None:
            return cfg, rules, None, "no MoE layer: no effect"
        moe = dataclasses.replace(cfg.moe, a2a=True)
        return (dataclasses.replace(cfg, moe=moe), rules, None,
                "all-to-all dispatch needs a mesh of ranks; the one-card "
                "trace runs moe_ffn" if mesh.size == 1 else "")
    if variant in RULE_EDITS:
        rules.update(RULE_EDITS[variant])
        return cfg, rules, None, one_rank
    if variant.startswith("accum"):
        return cfg, rules, int(variant[len("accum"):]), ""
    if variant.startswith("fsdp_all"):
        rules.update(embed=("data", "model"), ffn=None, ffn_act=None,
                     heads=None, kv_heads=None, inner=None,
                     batch=("pod", "data", "model"))
        n = variant[len("fsdp_all"):]
        return cfg, rules, (int(n) if n else None), one_rank
    raise ValueError(f"unknown variant {variant!r}")


def _cache_bytes(cfg, batch: int, max_len: int, dtype, rules, mesh) -> int:
    """Per-device bytes of the decode caches (the reference's
    ``_local_cache_bytes``)."""
    caches = inp.cache_abstract(cfg, batch, max_len, dtype)
    axes = dict(inp.tree_leaves_with_path(inp.cache_axes(cfg, caches)))
    total = 0
    for path, leaf in inp.tree_leaves_with_path(caches):
        spec = resolve_axes(tuple(axes[path]), tuple(leaf.shape), rules, mesh)
        total += leaf.numel() * leaf.element_size() // shards_of(spec, mesh)
    return total


def rule_bytes(cfg: ModelConfig, batch: int, max_len: int, rules: Rules,
               mesh: MeshShape) -> Dict[str, int]:
    """The reference's per-device count: ``params``, the float32 bytes of
    the parameter specs under ``rules`` (``_local_bytes_of_spec_tree``),
    and ``caches``, the bfloat16 decode caches' (``_local_cache_bytes``)."""
    return {"params": bytes_per_device(tf.model_spec(cfg), rules, mesh),
            "caches": _cache_bytes(cfg, batch, max_len, torch.bfloat16,
                                   rules, mesh)}


def _local_batch(batch: int, dp: int) -> int:
    """A data rank's batch: its piece where ``dp`` divides the batch,
    else all of it (the rules' divisibility policy)."""
    return batch // dp if batch % dp == 0 else batch


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(map(_nbytes, tree))


def resident_bytes(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                   rules: Rules, mesh: MeshShape = ONE_CARD,
                   accum: int = 1) -> Dict[str, int]:
    """Bytes that stay on rank 0 of ``mesh`` through the step in the
    port's layout, by part, and their ``total`` (see the module
    docstring; no activations); ``batch`` is the global batch."""
    rank = traced_rank(mesh)
    axes = data_axes(mesh, rules)
    dp, tp = dp_size(mesh, axes), tp_size(mesh, axes)
    params = tf.abstract_params(cfg, dtype=torch.float32,
                                mesh=rank if tp > 1 else None, rules=rules)
    n = sum(p.numel() for p in params.parameters())
    out: Dict[str, int] = {}
    rank = rank if mesh.size > 1 else None
    if kind == "train":
        state = getattr(torch, cfg.opt_state_dtype).itemsize
        lo, hi = shard_range(n, dp, 0)
        out.update(params=4 * n, grads=4 * n, adamw=2 * state * (hi - lo))
        if state != 4 and accum > 1:
            out["accum_buffer"] = state * n
    else:
        dt = getattr(torch, cfg.param_dtype)
        out.update(params=dt.itemsize * n, caches=_nbytes(tf.abstract_caches(
            cfg, batch, max_len, dt, enc_len=max_len // inp.STUB_DIV,
            mesh=rank, rules=rules)))
    out["total"] = sum(out.values())
    return out


#: the sLSTM loop lengths the scaled block is traced at
_SLSTM_PROBES = (3, 4)


def _fwd_bwd(fn, grad: bool, out_shape, dtype, device):
    """Counts of ``fn()``'s forward and, when ``grad``, of its backward
    from a cotangent of ``out_shape``."""
    g = torch.empty(out_shape, dtype=dtype, device=device)
    with torch.set_grad_enabled(grad), opstats.counting() as st:
        y = fn()
        fwd = opstats.snapshot(st)
        if grad:
            torch.autograd.backward(y, g)
    return fwd, opstats.add_repeats(st, fwd, opstats.OpStats(), 1)


def _slstm_counts(wr, bias, xp, grad: bool):
    """Counts of the real sLSTM loop over time (``xlstm._slstm_scan``),
    forward and, when ``grad``, backward from a cotangent of its h, at
    each probe length: {S: (forward, backward)}.  As in a train step,
    the bias already holds a gradient, which the backward adds to."""
    wr32 = torch.empty_like(wr, dtype=torch.float32).requires_grad_(grad)
    b = torch.empty_like(bias).requires_grad_(grad)
    if grad:
        b.grad = torch.empty_like(b)
    B, _, _, di = xp.shape
    out = {}
    for S in _SLSTM_PROBES:
        xs = torch.empty((B, S, 4, di), dtype=xp.dtype, device=xp.device,
                         requires_grad=grad)
        st = xlstm._zero_slstm(B, di, xp.device)
        out[S] = _fwd_bwd(lambda: _REAL_SCAN(wr32, b, xs, st)[0], grad,
                          (B, S, di), torch.float32, xp.device)
    return out


def _at_length(counts, part: int, S: int) -> opstats.OpStats:
    a, b = (counts[n][part] for n in _SLSTM_PROBES)
    return opstats.add_repeats(a, a, b, S - _SLSTM_PROBES[0])


_REAL_SCAN = xlstm._slstm_scan


def _scan_key(wr, batch: int, dtype, grad: bool):
    return batch, wr.shape[0] * wr.shape[1], tuple(wr.shape), dtype, grad


@contextlib.contextmanager
def _scaled_slstm(live, params, batch: int, dtype, grad: bool):
    """For the trace: the sLSTM's loop over time, identical at every
    step, traced at 3 and 4 steps (before the step runs, on the loop's
    shapes in ``params``' sLSTM layers: the rank's heads, or every head
    where they do not split; so that a checkpoint's recomputation sees
    the same ops) and its counts scaled to the sequence (forward, and
    backward through an autograd function that returns shapes only); the
    block's projections and collectives run as they are.  ``live()`` is
    the trace's OpStats; ``batch``, ``dtype`` and ``grad`` are the loop
    input's.  The eager counterpart of the reference's scan trip
    count."""
    cache = {}
    for layer in params.layers:
        if layer.kind[0] == "slstm":
            wr = layer["mixer"]["wr"]
            key = _scan_key(wr, batch, dtype, grad)
            if key not in cache:
                di = key[1]
                cache[key] = _slstm_counts(
                    wr, torch.empty((4, di), dtype=dtype, device=META),
                    torch.empty((batch, 1, 4, di), dtype=dtype,
                                device=META), grad)

    class Loop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, key, xp, wr32, bias, *state):
            # a saved input, so that a checkpoint's recomputation runs the
            # loop again, as it runs the real loop's saved steps
            ctx.save_for_backward(xp, wr32, bias)
            ctx.key, ctx.S = key, xp.shape[1]
            ctx.n_state = len(state)
            opstats.add_into(live(), _at_length(cache[key], 0, ctx.S))
            B, S, _, di = xp.shape
            with _uncounted():
                return (torch.empty(B, S, di, dtype=torch.float32,
                                    device=META),
                        *(torch.empty(B, di, dtype=torch.float32,
                                      device=META) for _ in range(4)))

        @staticmethod
        def backward(ctx, *grads):
            opstats.add_into(live(), _at_length(cache[ctx.key], 1, ctx.S))
            xp, wr32, bias = ctx.saved_tensors
            with _uncounted():
                gs = tuple(torch.empty_like(t) for t in (xp, wr32, bias))
            return (None,) + gs + (None,) * ctx.n_state

    def scan(wr32, bias, xp, st):
        if xp.device != META or xp.shape[1] <= max(_SLSTM_PROBES):
            return _REAL_SCAN(wr32, bias, xp, st)
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xp, wr32, bias))
        key = _scan_key(wr32, xp.shape[0], xp.dtype, grad)
        h, *state = Loop.apply(key, xp, wr32, bias, *st)
        return h, xlstm.SLSTMState(*state)

    xlstm._slstm_scan = scan
    try:
        yield
    finally:
        xlstm._slstm_scan = _REAL_SCAN


def _uncounted():
    """No dispatch mode (so no count) inside the block."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def _batch(cfg: ModelConfig, kind: str, batch: int, seq: int,
           dtype) -> Dict[str, torch.Tensor]:
    """Abstract inputs of a (batch, seq) step, float inputs in ``dtype``."""
    specs, _ = inp.batch_specs(cfg, inp.ShapeSpec("cell", seq, batch, kind))
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in specs.items()}


def _counted(fn, slstm: Optional[tuple]) -> opstats.OpStats:
    """``fn(st)`` under :func:`~repro_torch.launch.opstats.counting`, whose
    OpStats ``st`` it is given, with the sLSTM loop scaled unless
    ``slstm`` is None (else :func:`_scaled_slstm`'s params, batch, dtype
    and grad)."""
    scaled = (_scaled_slstm(lambda: st, *slstm) if slstm is not None
              else contextlib.nullcontext())
    with scaled, opstats.counting() as st:
        fn(st)
    return st


def trace_step(cfg: ModelConfig, kind: str, batch: int, seq: int,
               accum: int = 1, max_len: Optional[int] = None,
               scale: bool = True, mesh: Optional[MeshShape] = None,
               rules: Optional[Rules] = None,
               global_batch: Optional[int] = None) -> opstats.OpStats:
    """The step of one cell on the meta device under
    :func:`~repro_torch.launch.opstats.counting`: a train step of
    ``accum`` microbatches, a prefill into caches of ``max_len`` (default
    ``seq``) positions, or one decode step at position ``seq - 1``
    against caches of ``max_len`` positions; ``batch`` is the rank's.
    With ``mesh`` (a mesh shape of more than one device) the step is its
    rank 0's (``sharding.traced_rank``), on its slices of the parameters
    under ``rules`` (default the baseline's), its collectives counted, its
    caches placed for ``global_batch`` (default ``batch`` times the data
    ranks: the batch split over them).  A
    stack of more than 2 periods is traced at 1 and at 2 periods, and the
    second's counts are added for each of the rest (the periods are
    identical: the counterpart of the reference's scan over them).  With
    ``scale`` False every period, microbatch and sLSTM time step is
    traced."""
    P = len(cfg.period)
    if scale and cfg.n_periods > 2:
        def at(n):
            return _trace_step(dataclasses.replace(
                cfg, n_layers=n * P + len(cfg.remainder)), kind, batch, seq,
                accum, max_len, scale, mesh, rules, global_batch)

        one = at(1)
        return opstats.add_repeats(one, one, at(2), cfg.n_periods - 1)
    return _trace_step(cfg, kind, batch, seq, accum, max_len, scale, mesh,
                       rules, global_batch)


def _trace_step(cfg: ModelConfig, kind: str, batch: int, seq: int,
                accum: int, max_len: Optional[int], scale: bool,
                mesh: Optional[MeshShape], rules: Optional[Rules],
                global_batch: Optional[int]) -> opstats.OpStats:
    max_len = max_len or seq
    rank = traced_rank(mesh) if mesh is not None and mesh.size > 1 else None
    axes = data_axes(rank, rules) if rank is not None else ()
    tp = tp_size(rank, axes) if rank is not None else 1
    # every trace counts the making of the host tables, as a fresh
    # process's first step does
    tf.clear_host_tables()
    if kind == "train":
        params = tf.abstract_params(cfg, dtype=torch.float32,
                                    mesh=rank if tp > 1 else None,
                                    rules=rules)
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        flat = tf.make_trainable(params)
        lo, hi = shard_range(flat.n, dp_size(rank, axes) if axes else 1, 0)
        state = adamw_init(flat, opt_cfg)
        state = state._replace(m=state.m[lo:hi], v=state.v[lo:hi])
        n_micro = min(accum, 3) if scale else accum
        b = _batch(cfg, kind, batch // accum * n_micro, seq, torch.float32)
        marks = []

        def step(st):
            fn = make_train_step(cfg, opt_cfg, n_micro, mesh=rank,
                                 on_microbatch=(lambda i: marks.append(
                                     opstats.snapshot(st))),
                                 batch_axes=axes)
            fn(params, state, b)

        st = _counted(step, (params, batch // accum, torch.float32, True)
                      if scale else None)
        if accum > n_micro:
            # microbatch 1 runs whole between the second and third marks,
            # with its share of the accumulation (microbatch 0 also fills
            # the caches of host tables, such as RoPE's frequencies)
            return opstats.add_repeats(st, marks[1], marks[2],
                                       accum - n_micro)
        return st
    params = tf.abstract_params(cfg, mesh=rank if tp > 1 else None,
                                rules=rules)
    dt = getattr(torch, cfg.param_dtype)
    b = _batch(cfg, kind, batch, seq, dt)
    slstm = (params, batch, dt, False) if scale else None
    if global_batch is None:  # the step builders' split over the data axes
        global_batch = batch * (dp_size(rank, axes) if axes else 1)
    with torch.no_grad(), use_mesh(rank, rules, global_batch):
        if kind == "prefill":  # caches in bfloat16, as build_prefill's
            return _counted(lambda st: tf.prefill(
                cfg, params, b, max_len, cache_dtype=torch.bfloat16), slstm)
        caches = tf.abstract_caches(cfg, global_batch if rank is not None
                                    else batch, max_len, dt,
                                    enc_len=max_len // inp.STUB_DIV,
                                    mesh=rank, rules=rules)
        return _counted(lambda st: tf.decode_step(
            cfg, params, caches, b["tokens"], seq - 1,
            b.get("mrope_positions")), slstm)


def dry_run(cfg: ModelConfig, shape: inp.ShapeSpec, *,
            accum: Optional[int] = None, max_len: Optional[int] = None,
            rules: Optional[Rules] = None, scale: bool = True,
            mesh: MeshShape = ONE_CARD) -> dict:
    """One cell on rank 0 of ``mesh``: trace, resident bytes (the
    port's layout and the reference's rule count), collectives and
    roofline."""
    rules = rules if rules is not None else inp.rules_for(cfg, shape)
    kind = shape.kind
    axes = data_axes(mesh, rules)
    dp, tp = dp_size(mesh, axes), tp_size(mesh, axes)
    if kind == "train" and accum is None:
        accum = inp.grad_accum_for(cfg, shape, dp)
    accum = accum or 1
    max_len = max_len or shape.seq
    batch = _local_batch(shape.batch, dp)
    t0 = time.perf_counter()
    st = trace_step(cfg, kind, batch, shape.seq, accum, max_len, scale,
                    mesh, rules, shape.batch)
    trace_s = time.perf_counter() - t0
    res = resident_bytes(cfg, kind, shape.batch, max_len, rules, mesh,
                         accum=accum)
    rep = roofline_from_stats(st, cfg, shape, kind, accum, mesh.size,
                              res["params"], res.get("caches", 0),
                              token_ranks=dp)
    return dict(
        status="OK", n_devices=mesh.size, dp=dp, tp=tp,
        accum=accum if kind == "train" else None,
        seq=shape.seq, batch=shape.batch, rank_batch=batch, max_len=max_len,
        trace_s=trace_s, resident_bytes=res,
        rule_bytes=rule_bytes(cfg, shape.batch, max_len, rules, mesh),
        fits_hbm=bool(res["total"] <= HBM_PER_DEVICE),
        dot_flops=st.dot_flops, dot_flops_by_dtype=st.dot_flops_by_dtype,
        leaf_flops=st.leaf_flops, leaves=st.leaves,
        traffic_bytes=st.traffic_bytes, collectives=rep.collectives,
        wire_bytes_per_dev=rep.wire_bytes_per_dev,
        mem_bytes_per_dev=rep.mem_bytes_per_dev,
        compute_s=rep.compute_s, memory_s=rep.memory_s,
        collective_s=rep.collective_s, bottleneck=rep.bottleneck,
        model_flops=rep.model_flops_total,
        useful_fraction=rep.useful_fraction)


def _describe(label: str, rec: dict) -> str:
    res = rec["resident_bytes"]
    parts = " ".join(f"{k}={v / 2**30:.2f}" for k, v in res.items()
                     if k != "total")
    rules = " ".join(f"{k}={v / 2**30:.3f}" for k, v in
                     rec["rule_bytes"].items())
    coll = " ".join(f"{op}:n={d['count']:g},wire={d['wire_bytes']:.3e}"
                    for op, d in sorted(rec["collectives"].items()))
    return (f"[{label}] OK resident={res['total'] / 2**30:.2f}GiB ({parts}) "
            f"rule_count=({rules}) collectives=({coll or 'none'}) "
            f"fits={rec['fits_hbm']} bottleneck={rec['bottleneck']} "
            f"terms=(c={rec['compute_s']:.4f}s m={rec['memory_s']:.4f}s "
            f"coll={rec['collective_s']:.4f}s) useful="
            f"{rec['useful_fraction']:.2f} dot_flops={rec['dot_flops']:.3e} "
            f"model_flops={rec['model_flops']:.3e} "
            f"traced in {rec['trace_s']:.1f}s")


def run_cell(arch: str, shape_name: str, variant: str = "baseline",
             multi_pod: bool = False, verbose: bool = True,
             scale: bool = True, mesh: str = "one_card") -> dict:
    """One (arch x shape) cell of the reference's list on rank 0 of
    ``MESHES[mesh]`` (``multi_pod``: the 2x16x16 mesh)."""
    m = MESHES["2x16x16" if multi_pod else mesh]
    shape = inp.SHAPES[shape_name]
    cfg0 = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": str(m),
           "variant": variant}
    ok, why = inp.cell_is_runnable(cfg0, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
    else:
        cfg = inp.adjusted_config(cfg0, shape)
        cfg, rules, accum, note = apply_variant(
            cfg, inp.rules_for(cfg, shape), variant, m)
        rec.update(dry_run(cfg, shape, accum=accum, rules=rules,
                           scale=scale, mesh=m))
        rec.update(variant_note=note, attn_chunk=cfg.attn_chunk,
                   ssm_chunk=cfg.ssm_chunk)
    if verbose:
        _report(rec, None)
    return rec


def cell_list() -> Iterator[Tuple[str, str]]:
    for arch in ARCH_IDS:
        for shape_name in inp.SHAPES:
            yield arch, shape_name


def _cell_or_failure(item) -> dict:
    """:func:`run_cell` (silent), or the failure as a record."""
    arch, shape_name, variant, scale, mesh = item
    try:
        return run_cell(arch, shape_name, variant, verbose=False,
                        scale=scale, mesh=mesh)
    except Exception as e:  # noqa: BLE001 - recorded, counted, exit 1
        return {"arch": arch, "shape": shape_name, "mesh": str(MESHES[mesh]),
                "variant": variant, "status": "FAIL",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()}


def _report(rec: dict, out: Optional[str]) -> int:
    """Print a cell's line (and write its record into ``out``); 1 for a
    failure."""
    label = " x ".join((rec["arch"], rec["shape"], rec["mesh"],
                        rec["variant"]))
    if rec["status"] == "OK":
        note = rec.get("variant_note")
        print(_describe(label, rec) + (f" ({note})" if note else ""),
              flush=True)
    elif rec["status"] == "SKIP":
        print(f"[{label}] SKIP {rec['reason']}", flush=True)
    else:
        print(rec["traceback"], end="", flush=True)
        print(f"[{label}] FAIL {rec['error']}", flush=True)
    if out:
        name = "__".join((rec["arch"], rec["shape"], rec["mesh"],
                          rec["variant"])) + ".json"
        with open(os.path.join(out, name), "w") as f:
            json.dump(rec, f, indent=1)
    return int(rec["status"] == "FAIL")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(inp.SHAPES))
    ap.add_argument("--mesh", default="one_card", choices=list(MESHES),
                    help="plan each cell on rank 0 of this mesh")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the same as --mesh 2x16x16")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--unscaled", action="store_true",
                    help="trace every microbatch, period and sLSTM step "
                    "(slow)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the cells in this many processes")
    ap.add_argument("--out", default=None,
                    help="write one JSON record a cell into this directory")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    cells = (list(cell_list()) if args.all
             else [(args.arch, args.shape)])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    fails, t0 = 0, time.perf_counter()
    work = [(arch, shape_name, args.variant, not args.unscaled, mesh)
            for arch, shape_name in cells]
    if args.jobs > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.imap(_cell_or_failure, work)
            for rec in recs:
                fails += _report(rec, args.out)
    else:
        for item in work:
            fails += _report(_cell_or_failure(item), args.out)
    print(f"[dryrun] {len(work)} cells, {fails} failed, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
