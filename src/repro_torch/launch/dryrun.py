"""One-card dry run: every (arch x shape) cell's step traced on the meta
device, its bytes on the card and its three roofline terms.

Counterpart of ``repro.launch.dryrun``, at one card.  The reference
lowers and compiles each cell for a 256- or 512-device mesh and reads
XLA's memory and cost analyses; here each cell's step runs eagerly on
the meta device (shapes and dtypes, no storage: nothing is allocated and
the card is never touched) under :mod:`repro_torch.launch.opstats`, and
its resident bytes come from ``bytes_per_device`` on a (1, 1) mesh:

  train    parameters, gradient (float32, the port trains in float32) and
           AdamW's m and v (``cfg.opt_state_dtype``), plus the
           accumulation buffer where that dtype is not float32
  prefill  parameters (``cfg.param_dtype``) and the caches it emits
  decode   parameters and the caches it reads

Activations and temporaries are not in the estimate, so the measured
peak of a run lies above it.  ``fits`` compares it with the card's 80 GB.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2_2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--variant chunk512] [--out DIR]

The train step is the port's ``make_train_step`` with
``grad_accum_for(cfg, shape, 1)`` microbatches.  Identical repeats are
traced a few times and scaled, the eager counterpart of the reference's
loop trip counts: a step of more than 3 microbatches is traced with 3
and the second's counts (from its start to the third's, its share of
the accumulation included) are added for each of the rest; a stack of
more than 2 periods is traced at 1 and 2 periods; the sLSTM's loop over
time is traced at 3 and 4 steps (its product FLOPs exact, its other
counts but a few zero-fills).  ``--unscaled`` traces every microbatch,
period and time step instead (slow: it shows what the scaling saves).
``--jobs N`` traces ``--all``'s cells in N processes (CPU only).  Variants that
change only sharding rules are accepted and do nothing on one rank (the
record says so); ``chunk512`` and ``chunk2048`` change ``attn_chunk``
and so the traced train step.  Multi-device meshes and per-rank
partitioning wait for ROADMAP.md item 1.6: ``--multi-pod`` raises.
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
                                    resolve_axes, shards_of)
from ..models import transformer as tf
from ..models import xlstm
from ..training.optimizer import AdamWConfig, adamw_init
from . import inputs as inp
from . import opstats
from .mesh import HBM_PER_DEVICE
from .roofline import roofline_from_stats
from .steps import make_train_step

META = torch.device("meta")

__all__ = ["ONE_CARD", "apply_variant", "resident_bytes", "trace_step",
           "dry_run", "run_cell", "cell_list", "main"]

#: the one-card mesh every cell is planned on
ONE_CARD = MeshShape(("data", "model"), (1, 1))

#: the variants that only edit the sharding rules (or, ``grad_rs`` and
#: ``tp_only``, the reference's gradient and optimizer-state sharding):
#: nothing changes on one rank
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


def apply_variant(cfg: ModelConfig, rules: Rules, variant: str
                  ) -> Tuple[ModelConfig, Rules, Optional[int], str]:
    """The reference's named variants: ``(cfg, rules, accum_override,
    note)``; ``note`` says what a variant does on one rank."""
    if variant == "baseline":
        return cfg, rules, None, ""
    rules = dict(rules)
    if variant == "chunk512":
        return dataclasses.replace(cfg, attn_chunk=512), rules, None, ""
    if variant == "chunk2048":
        return dataclasses.replace(cfg, attn_chunk=2048), rules, None, ""
    one_rank = "changes sharding only: no effect on one rank"
    if variant == "moe_a2a":
        if cfg.moe is None:
            return cfg, rules, None, "no MoE layer: no effect"
        moe = dataclasses.replace(cfg.moe, a2a=True)
        return (dataclasses.replace(cfg, moe=moe), rules, None,
                "all-to-all dispatch needs a mesh (ROADMAP.md item 1.6): "
                "one rank runs moe_ffn")
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


def resident_bytes(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                   rules: Rules, mesh: MeshShape = ONE_CARD,
                   accum: int = 1) -> Dict[str, int]:
    """Bytes that stay on each card through the step, by part, and their
    ``total`` (see the module docstring; no activations)."""
    n = bytes_per_device(tf.model_spec(cfg), rules, mesh) // 4  # fp32 specs
    out: Dict[str, int] = {}
    if kind == "train":
        state = getattr(torch, cfg.opt_state_dtype).itemsize
        out.update(params=4 * n, grads=4 * n, adamw=2 * state * n)
        if state != 4 and accum > 1:
            out["accum_buffer"] = state * n
    else:
        dt = getattr(torch, cfg.param_dtype)
        out.update(params=dt.itemsize * n,
                   caches=_cache_bytes(cfg, batch, max_len, dt, rules, mesh))
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


def _slstm_counts(cfg, params, x, grad: bool):
    """Counts of the real sLSTM block without its output product (``h @
    wo``, which the traced block runs itself), forward and, when
    ``grad``, backward, at each probe length: {S: (forward, backward)}.
    As in a train step, the weights already hold a gradient, which the
    backward adds to."""
    w = {}
    for k in ("wx", "wr", "bias", "wo"):
        w[k] = torch.empty_like(params[k]).requires_grad_(grad)
        if grad:
            w[k].grad = torch.empty_like(w[k])
    B, _, d = x.shape
    di = w["wo"].shape[0]
    out = {}
    for S in _SLSTM_PROBES:
        def new(*shape):
            return torch.empty(shape, dtype=x.dtype, device=x.device,
                               requires_grad=grad)

        xs, hs = new(B, S, d), new(B, S, di)
        block = _fwd_bwd(lambda: _REAL_SLSTM(cfg, w, xs)[0], grad,
                         (B, S, d), x.dtype, x.device)
        product = _fwd_bwd(lambda: hs @ w["wo"], grad, (B, S, d), x.dtype,
                           x.device)
        out[S] = tuple(opstats.add_repeats(a, b, opstats.OpStats(), 1)
                       for a, b in zip(block, product))
    return out


def _at_length(counts, part: int, S: int) -> opstats.OpStats:
    a, b = (counts[n][part] for n in _SLSTM_PROBES)
    return opstats.add_repeats(a, a, b, S - _SLSTM_PROBES[0])


_REAL_SLSTM = xlstm.slstm_block_with_state


@contextlib.contextmanager
def _scaled_slstm(live, cfg: ModelConfig, batch: int, dtype, grad: bool):
    """For the trace: the sLSTM block's loop over time, identical at every
    step, traced at 3 and 4 steps (before the step runs, so that a
    checkpoint's recomputation sees the same ops) and its counts scaled to
    the sequence (forward, and backward through an autograd function that
    returns shapes only); the block's output product runs as is.
    ``live()`` is the trace's OpStats; ``batch``, ``dtype`` and ``grad``
    are the block input's.  The eager counterpart of the reference's scan
    trip count."""
    cache = {}
    if any(m == "slstm" for m, _ in tf.layer_kinds(cfg)):
        spec = tf.sublayer_spec(cfg, ("slstm", "none"))["mixer"]
        params = {k: torch.empty(v.shape, dtype=dtype, device=META)
                  for k, v in spec.items()}
        x = torch.empty(batch, 1, cfg.d_model, dtype=dtype, device=META)
        cache[(batch, cfg.d_model, dtype, grad)] = _slstm_counts(
            cfg, params, x, grad)

    class Loop(torch.autograd.Function):
        @staticmethod
        def forward(ctx, key, S, di, x, *weights):
            # a saved input, so that a checkpoint's recomputation runs the
            # loop again, as it runs the real block's saved steps
            ctx.save_for_backward(x)
            ctx.key, ctx.S = key, S
            ctx.n_weights = len(weights)
            opstats.add_into(live(), _at_length(cache[key], 0, S))
            B = x.shape[0]
            with _uncounted():
                return (torch.empty(B, S, di, dtype=x.dtype, device=META),
                        *(torch.empty(B, di, dtype=torch.float32,
                                      device=META) for _ in range(4)))

        @staticmethod
        def backward(ctx, *grads):
            # the weights' gradients were added to their .grad in the
            # calibrated counts; only x's flows on
            opstats.add_into(live(), _at_length(cache[ctx.key], 1, ctx.S))
            x, = ctx.saved_tensors
            with _uncounted():
                gx = torch.empty_like(x)
            return (None, None, None, gx) + (None,) * ctx.n_weights

    def block(cfg, params, x):
        S = x.shape[1]
        if x.device != META or S <= max(_SLSTM_PROBES):
            return _REAL_SLSTM(cfg, params, x)
        names = ("wx", "wr", "bias")
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(params[k].requires_grad for k in names))
        key = (x.shape[0], x.shape[2], x.dtype, grad)
        h, *state = Loop.apply(key, S, params["wo"].shape[0], x,
                               *(params[k] for k in names))
        return h @ params["wo"], xlstm.SLSTMState(*state)

    xlstm.slstm_block_with_state = block
    try:
        yield
    finally:
        xlstm.slstm_block_with_state = _REAL_SLSTM


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
    ``slstm`` is None (else :func:`_scaled_slstm`'s cfg, batch, dtype and
    grad)."""
    scaled = (_scaled_slstm(lambda: st, *slstm) if slstm is not None
              else contextlib.nullcontext())
    with scaled, opstats.counting() as st:
        fn(st)
    return st


def trace_step(cfg: ModelConfig, kind: str, batch: int, seq: int,
               accum: int = 1, max_len: Optional[int] = None,
               scale: bool = True) -> opstats.OpStats:
    """The step of one cell on the meta device under
    :func:`~repro_torch.launch.opstats.counting`: a train step of
    ``accum`` microbatches, a prefill into caches of ``max_len`` (default
    ``seq``) positions, or one decode step at position ``seq - 1``
    against caches of ``max_len`` positions.  A stack of more than 2
    periods is traced at 1 and at 2 periods, and the second's counts are
    added for each of the rest (the periods are identical: the counterpart
    of the reference's scan over them).  With ``scale`` False every
    period, microbatch and sLSTM time step is traced."""
    P = len(cfg.period)
    if scale and cfg.n_periods > 2:
        def at(n):
            return _trace_step(dataclasses.replace(
                cfg, n_layers=n * P + len(cfg.remainder)), kind, batch, seq,
                accum, max_len, scale)

        one = at(1)
        return opstats.add_repeats(one, one, at(2), cfg.n_periods - 1)
    return _trace_step(cfg, kind, batch, seq, accum, max_len, scale)


def _trace_step(cfg: ModelConfig, kind: str, batch: int, seq: int,
                accum: int, max_len: Optional[int], scale: bool
                ) -> opstats.OpStats:
    max_len = max_len or seq
    # every trace counts the making of the host tables, as a fresh
    # process's first step does
    tf.clear_host_tables()
    if kind == "train":
        params = tf.abstract_params(cfg, dtype=torch.float32)
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        state = adamw_init(tf.make_trainable(params), opt_cfg)
        n_micro = min(accum, 3) if scale else accum
        b = _batch(cfg, kind, batch // accum * n_micro, seq, torch.float32)
        marks = []

        def step(st):
            fn = make_train_step(cfg, opt_cfg, n_micro, on_microbatch=(
                lambda i: marks.append(opstats.snapshot(st))))
            fn(params, state, b)

        st = _counted(step, (cfg, batch // accum, torch.float32, True)
                      if scale else None)
        if accum > n_micro:
            # microbatch 1 runs whole between the second and third marks,
            # with its share of the accumulation (microbatch 0 also fills
            # the caches of host tables, such as RoPE's frequencies)
            return opstats.add_repeats(st, marks[1], marks[2],
                                       accum - n_micro)
        return st
    params = tf.abstract_params(cfg)
    dt = getattr(torch, cfg.param_dtype)
    b = _batch(cfg, kind, batch, seq, dt)
    slstm = (cfg, batch, dt, False) if scale else None
    with torch.no_grad():
        if kind == "prefill":
            return _counted(lambda st: tf.prefill(cfg, params, b, max_len),
                            slstm)
        caches = tf.abstract_caches(cfg, batch, max_len, dt,
                                    enc_len=max_len // inp.STUB_DIV)
        return _counted(lambda st: tf.decode_step(
            cfg, params, caches, b["tokens"], seq - 1,
            b.get("mrope_positions")), slstm)


def dry_run(cfg: ModelConfig, shape: inp.ShapeSpec, *,
            accum: Optional[int] = None, max_len: Optional[int] = None,
            rules: Optional[Rules] = None, scale: bool = True) -> dict:
    """One cell at one card: trace, resident bytes and roofline."""
    rules = rules if rules is not None else inp.rules_for(cfg, shape)
    kind = shape.kind
    if kind == "train" and accum is None:
        accum = inp.grad_accum_for(cfg, shape, 1)
    accum = accum or 1
    max_len = max_len or shape.seq
    t0 = time.perf_counter()
    st = trace_step(cfg, kind, shape.batch, shape.seq, accum, max_len,
                    scale)
    trace_s = time.perf_counter() - t0
    res = resident_bytes(cfg, kind, shape.batch, max_len, rules,
                         accum=accum)
    param_b = res["params"]
    rep = roofline_from_stats(st, cfg, shape, kind, accum, 1, param_b,
                              res.get("caches", 0))
    return dict(
        status="OK", n_devices=1, accum=accum if kind == "train" else None,
        seq=shape.seq, batch=shape.batch, max_len=max_len,
        trace_s=trace_s, resident_bytes=res,
        fits_hbm=bool(res["total"] <= HBM_PER_DEVICE),
        dot_flops=st.dot_flops, dot_flops_by_dtype=st.dot_flops_by_dtype,
        leaf_flops=st.leaf_flops, leaves=st.leaves,
        traffic_bytes=st.traffic_bytes,
        mem_bytes_per_dev=rep.mem_bytes_per_dev,
        compute_s=rep.compute_s, memory_s=rep.memory_s,
        collective_s=rep.collective_s, bottleneck=rep.bottleneck,
        model_flops=rep.model_flops_total,
        useful_fraction=rep.useful_fraction)


def _describe(label: str, rec: dict) -> str:
    res = rec["resident_bytes"]
    parts = " ".join(f"{k}={v / 2**30:.2f}" for k, v in res.items()
                     if k != "total")
    return (f"[{label}] OK resident={res['total'] / 2**30:.2f}GiB ({parts}) "
            f"fits={rec['fits_hbm']} bottleneck={rec['bottleneck']} "
            f"terms=(c={rec['compute_s']:.4f}s m={rec['memory_s']:.4f}s "
            f"coll={rec['collective_s']:.4f}s) useful="
            f"{rec['useful_fraction']:.2f} dot_flops={rec['dot_flops']:.3e} "
            f"model_flops={rec['model_flops']:.3e} "
            f"traced in {rec['trace_s']:.1f}s")


def run_cell(arch: str, shape_name: str, variant: str = "baseline",
             multi_pod: bool = False, verbose: bool = True,
             scale: bool = True) -> dict:
    """One (arch x shape) cell of the reference's list at one card."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh needs sharded steps across cards: ROADMAP.md "
            "item 1.6")
    shape = inp.SHAPES[shape_name]
    cfg0 = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": str(ONE_CARD),
           "variant": variant}
    ok, why = inp.cell_is_runnable(cfg0, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
    else:
        cfg = inp.adjusted_config(cfg0, shape)
        cfg, rules, accum, note = apply_variant(
            cfg, inp.rules_for(cfg, shape), variant)
        rec.update(dry_run(cfg, shape, accum=accum, rules=rules,
                           scale=scale))
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
    arch, shape_name, variant, scale = item
    try:
        return run_cell(arch, shape_name, variant, verbose=False,
                        scale=scale)
    except Exception as e:  # noqa: BLE001 - recorded, counted, exit 1
        return {"arch": arch, "shape": shape_name, "mesh": str(ONE_CARD),
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: raises (ROADMAP.md item 1.6)")
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
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the (2, 16, 16) mesh needs sharded steps across "
            "cards, ROADMAP.md item 1.6")
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    cells = (list(cell_list()) if args.all
             else [(args.arch, args.shape)])
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    fails, t0 = 0, time.perf_counter()
    work = [(arch, shape_name, args.variant, not args.unscaled)
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
