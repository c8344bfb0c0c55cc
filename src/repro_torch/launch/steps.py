"""Step builders: the train step (gradient accumulation and AdamW on a
flat θ, on one rank or sharded over a mesh of ranks), prefill and decode,
with their placements.

Counterpart of ``repro.launch.steps``.  The reference returns functions
for ``jax.jit`` with ``NamedSharding`` trees; here a step runs eagerly on
one rank of an SPMD program and the placements are
:class:`~repro_torch.distributed.sharding.Sharding` trees saying which
piece of each global tensor the rank holds.  The port's layout:

* the batch is split over the data axes (``("pod", "data")``, the
  ``batch`` rule; whole where it does not divide); ``"model"`` ranks hold
  the same batch;
* along ``"model"`` each rank holds its tensor-parallel slice of the
  parameters (:func:`tp_shardings`: the rules' ``"model"`` placements,
  ``transformer.shard_params`` cuts them) and the layers split heads,
  FFN columns, the vocabulary, the experts (and their router columns)
  and the Mamba and xLSTM ``inner`` channels over the ranks (the MoE
  layers' all-to-all where ``moe.a2a`` asks for it);
* along the data axes θ is whole: the rank's slice lives in the model's
  flat buffer (:func:`~repro_torch.models.transformer.make_trainable`);
  its gradient is reduce-scattered over the data ranks, AdamW updates
  each data rank's chunk of it with its chunk of the moments (ZeRO over
  the flat buffer: the FSDP rule ``embed -> data`` in the form a flat
  buffer allows), and it is all-gathered.  So m and v are placed as the
  rank's flat vector split over the data axes (:func:`opt_shardings`);
* prefill and decode caches are split over the data axes along the
  batch and otherwise as the reference's cache rule places them
  (``transformer.cache_shardings``: KV caches along the sequence over
  the rules' cache axes, recurrent states along ``inner``); logits are
  split over the data axes and, where the vocabulary is, over
  ``"model"`` (the reference's ``("batch", None, "vocab")``).

Every collective goes through :mod:`~repro_torch.distributed.collectives`,
where the dry run counts it.  A step over a
:class:`~repro_torch.distributed.sharding.MeshShape` without ranks traces
its rank 0 (``sharding.traced_rank``).

:func:`param_shardings` gives the reference's rule-resolved placements of
the parameter tree (what :func:`~repro_torch.training.checkpoint.restore`
takes, and what the dry run's rule count reads).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import host_float
from ..configs.base import ModelConfig
from ..distributed import collectives as coll
from ..distributed.sharding import (
    Mesh,
    MeshShape,
    Rules,
    Sharding,
    local_tree,
    model_rules,
    spec_tree_to_shardings,
    traced_rank,
)
from ..models import transformer as tf
from ..models.common import leaves, use_mesh
from ..training.optimizer import AdamWConfig, AdamWState, adamw_update
from . import inputs as inp

__all__ = ["make_train_step", "param_shardings", "tp_shardings",
           "opt_shardings", "abstract_opt_state",
           "shard_range", "data_axes", "dp_size", "tp_size", "build_train",
           "build_prefill", "build_decode", "build_cell"]


def data_axes(mesh, rules: Optional[Rules] = None) -> Tuple[str, ...]:
    """The mesh axes the batch is split over: the ``batch`` rule's
    (default ``("pod", "data")``) that the mesh has, in mesh order."""
    rule = ("pod", "data") if rules is None else rules.get("batch") or ()
    rule = rule if isinstance(rule, tuple) else (rule,)
    return tuple(a for a in mesh.axes if a in rule)


def dp_size(mesh, axes=None) -> int:
    """The number of data ranks: the product of the data axes' sizes."""
    axes = data_axes(mesh) if axes is None else axes
    return int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))


def tp_size(mesh, axes=None) -> int:
    """The ``"model"`` ranks that split the layers' work: the axis's
    size, unless it has none or the batch is split along it."""
    axes = data_axes(mesh) if axes is None else axes
    return 1 if "model" in axes else mesh.shape.get("model", 1)


def _flat_sharding(mesh, axes=None) -> Sharding:
    """A flat vector split over the data axes."""
    axes = data_axes(mesh) if axes is None else axes
    return Sharding(mesh, (axes if len(axes) > 1 else
                           (axes[0] if axes else None),))


def _rank_of(mesh) -> Mesh:
    """A mesh of ranks as it is; a bare mesh shape's traced rank 0."""
    if isinstance(mesh, Mesh):
        return mesh
    if not isinstance(mesh, MeshShape):
        raise TypeError(f"mesh must be a distributed.sharding.Mesh (or a "
                        f"MeshShape to trace), not a {type(mesh).__name__}")
    return traced_rank(mesh)


def shard_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of piece ``index`` of ``n`` elements cut into
    ``parts`` (``torch.chunk``'s sizes, as :func:`local_slice`)."""
    c = -(-n // parts)
    lo = min(index * c, n)
    return lo, min(lo + c, n)


# --------------------------------------------------------------------- #
# Train
# --------------------------------------------------------------------- #
def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int,
                    mesh=None,
                    on_microbatch: Optional[Callable[[int], None]] = None,
                    batch_axes: Optional[Tuple[str, ...]] = None):
    """Gradient-accumulated train step; grads accumulate in state_dtype.

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` is a :class:`~repro_torch.models.transformer.DecoderLM`
    (made trainable on first use), ``batch["tokens"]`` a ``(B, S)``
    integer tensor on its device with ``B`` divisible by ``accum`` (every
    input of the batch, an encoder-decoder's ``audio_embeds`` or a
    vision-language model's ``vision_embeds`` and ``positions`` too, is
    split into the microbatches along its first dimension);
    metrics hold ``loss``, ``grad_norm`` and ``lr`` as floats.
    ``on_microbatch(i)``, when given, is called as microbatch ``i`` starts
    (the dry run counts one microbatch's work between two calls).

    With ``mesh`` (a :class:`~repro_torch.distributed.sharding.Mesh`) the
    step is this rank's part of the sharded step (see the module's
    docstring): ``params`` hold the rank's tensor-parallel slices
    (``transformer.shard_params``; whole ones run every product whole),
    ``batch`` is the rank's piece of the global batch (split over
    ``batch_axes``, default :func:`data_axes`), ``opt_state`` holds the
    moments of the rank's chunk of its flat θ (``local_tree(adamw_init(
    ...), opt_shardings(...))``), the layers run under ``use_mesh(mesh)``,
    and the metrics are the global ones.  A bare
    :class:`~repro_torch.distributed.sharding.MeshShape` is traced: the
    step is its rank 0's on the meta device (``traced_rank``).  Without a
    mesh it is the one-rank step: one data rank whose chunk is the whole
    of θ.  After either, ``flat.grad[lo:hi]`` (``shard_range(flat.n, dp,
    data rank)``) holds that chunk's mean gradient over the data ranks, in
    float32.
    """
    if mesh is not None:
        mesh = _rank_of(mesh)
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    acc_dt = getattr(torch, opt_cfg.state_dtype)
    dp_axes = (() if mesh is None else
               batch_axes if batch_axes is not None else data_axes(mesh))
    dp = dp_size(mesh, dp_axes) if mesh is not None else 1
    group = mesh.group(dp_axes) if dp_axes else None
    index = mesh.coord(dp_axes) if dp_axes else 0
    # the gradient norm's squares: over every rank where "model" ranks
    # hold slices of θ, whose whole leaves count on model rank 0 only
    tp = mesh is not None and tp_size(mesh, dp_axes) > 1
    norm_group = mesh.group(dp_axes + ("model",)) if tp else group
    count_whole = not tp or mesh.coord("model") == 0

    def loss_and_grad(params, micro) -> torch.Tensor:
        loss, _ = tf.lm_loss(cfg, params, micro)
        loss.backward()
        return loss.detach()

    def accumulate(params: tf.DecoderLM, flat, batch):
        """(mean loss, mean gradient) over the microbatches."""
        flat.grad.zero_()
        if accum == 1:
            if on_microbatch is not None:
                on_microbatch(0)
            return loss_and_grad(params, batch), flat.grad
        n = batch["tokens"].shape[0]
        if n % accum:
            raise ValueError(f"batch {n} is not divisible by accum {accum}")
        # every input splits into accum microbatches along its batch
        # dimension (the reference's tree-mapped reshape)
        micros = {k: x.reshape(accum, n // accum, *x.shape[1:])
                  for k, x in batch.items()}
        # float32 sums accumulate in place in the gradient buffer
        # (0 + g1 + g2 ..., the reference's order); another dtype gets
        # its own buffer, each microbatch's gradient cast into it.
        gsum = flat.grad if acc_dt == torch.float32 else torch.zeros(
            flat.n, dtype=acc_dt, device=flat.device)
        lsum = torch.zeros((), dtype=torch.float32, device=flat.device)
        for i in range(accum):
            if on_microbatch is not None:
                on_microbatch(i)
            if gsum is not flat.grad:
                flat.grad.zero_()
            lsum = lsum + loss_and_grad(
                params, {k: x[i] for k, x in micros.items()})
            if gsum is not flat.grad:
                gsum.add_(flat.grad.to(acc_dt))
        inv = 1.0 / accum
        return lsum * inv, gsum.mul_(inv)

    def train_step(params: tf.DecoderLM, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        flat = tf.make_trainable(params)
        with use_mesh(mesh):
            loss, grads = accumulate(params, flat, batch)
        lo, hi = shard_range(flat.n, dp, index)
        c = -(-flat.n // dp)
        if opt_state.m.shape != (hi - lo,):
            raise ValueError(f"opt_state holds {tuple(opt_state.m.shape)} "
                             f"moments, this rank's chunk {hi - lo}")
        if dp > 1:  # the mean over the data ranks, in float32
            padded = torch.zeros(dp * c, dtype=torch.float32,
                                 device=grads.device)
            padded[:flat.n] = grads
            grads = coll.reduce_scatter_sum(padded, group)[:hi - lo].div_(dp)
            flat.grad[lo:hi] = grads
            loss = coll.all_reduce_sum(loss, group) / dp
        elif grads is not flat.grad:
            flat.grad.copy_(grads)
        _, new_opt, metrics = adamw_update(grads, opt_state, flat, opt_cfg,
                                           lo=lo, group=norm_group,
                                           count_whole=count_whole)
        if dp > 1:
            mine = torch.zeros(c, dtype=flat.theta.dtype,
                               device=flat.device)
            mine[:hi - lo] = flat.theta[lo:hi]
            whole = coll.all_gather(mine, group)
            with torch.no_grad():
                flat.theta.copy_(whole[:flat.n])
        metrics = dict(metrics, loss=host_float(loss))
        return params, new_opt, metrics

    return train_step


def param_shardings(cfg: ModelConfig, mesh, rules: Rules):
    """The parameter tree's placements under ``rules`` (the reference's)."""
    return spec_tree_to_shardings(tf.model_spec(cfg), rules, mesh)


def tp_shardings(cfg: ModelConfig, mesh, rules: Rules):
    """The parameter tree's placements in the port's tensor-parallel
    layout: the ``"model"`` part of ``rules`` on :func:`model_spec`'s
    leaves (whole along the data axes).  What
    ``transformer.shard_params`` and ``convert.lm_params_from_arrays``
    cut."""
    return spec_tree_to_shardings(tf.model_spec(cfg), model_rules(rules),
                                  mesh)


def opt_shardings(mesh, axes=None) -> AdamWState:
    """The optimizer state's placements in the port's layout: the step
    count whole, the rank's flat moments split over the data axes (the
    reference's follow the parameter tree's; ``opt_rules`` has no
    counterpart)."""
    flat = _flat_sharding(mesh, axes)
    return AdamWState(step=Sharding(mesh, ()), m=flat, v=flat)


def abstract_opt_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                       params: Optional[tf.DecoderLM] = None) -> AdamWState:
    """The optimizer state on the meta device: flat moments of θ's length
    (of ``params``', a rank's slices, where given) in ``state_dtype``."""
    n = (sum(int(np.prod(s.shape)) for _, s in leaves(tf.model_spec(cfg)))
         if params is None else sum(p.numel() for p in params.parameters()))
    dt = getattr(torch, opt_cfg.state_dtype)
    mk = lambda: torch.empty(n, dtype=dt, device="meta")  # noqa: E731
    return AdamWState(0, mk(), mk())


def _batch_split(tree, mesh, batch: int, axes):
    """Each tensor leaf (nested lists, tuples, NamedTuples) split over the
    data axes ``axes`` along dim 0 when that is ``batch`` long and they
    divide it, else whole."""
    if isinstance(tree, (list, tuple)):
        out = [_batch_split(t, mesh, batch, axes) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    spec = [None] * tree.ndim
    if (tree.ndim and tree.shape[0] == batch
            and batch % dp_size(mesh, axes) == 0):
        spec[0] = _flat_sharding(mesh, axes).spec[0]
    return Sharding(mesh, tuple(spec))


def _inputs(cfg: ModelConfig, shape, mesh, axes):
    """(placements, this rank's abstract inputs): every input split over
    the data axes along the batch where they divide it, else whole."""
    specs, _ = inp.batch_specs(cfg, shape)
    shard = {k: _batch_split(v, mesh, shape.batch, axes)
             for k, v in specs.items()}
    return shard, local_tree(specs, shard)


def build_train(cfg: ModelConfig, shape, mesh, rules: Rules,
                opt_cfg: Optional[AdamWConfig] = None,
                accum_override: Optional[int] = None):
    """``(step, in_shardings, out_shardings, abstract_args, meta)`` of a
    train cell on ``mesh`` (a mesh of ranks, or a mesh shape whose rank
    0 is traced): in = (θ, opt_state, batch), out = (θ, opt_state,
    metrics); θ placed by :func:`tp_shardings`, the moments as the
    rank's flat vector split over the data axes, the batch split over
    them.  ``abstract_args`` are this rank's inputs on the meta device
    (its slices of θ, its moments' chunk, its batch piece); ``meta``
    holds ``accum``, ``dp`` and ``tp`` (:func:`tp_size`)."""
    mesh = _rank_of(mesh)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    axes = data_axes(mesh, rules)
    dp = dp_size(mesh, axes)
    accum = accum_override or inp.grad_accum_for(cfg, shape, dp)
    fn = make_train_step(cfg, opt_cfg, accum, mesh, batch_axes=axes)
    p_shard = tp_shardings(cfg, mesh, rules)
    o_shard = opt_shardings(mesh, axes)
    b_shard, batch = _inputs(cfg, shape, mesh, axes)
    whole = Sharding(mesh, ())
    in_shardings = (p_shard, o_shard, b_shard)
    out_shardings = (p_shard, o_shard,
                     {"grad_norm": whole, "lr": whole, "loss": whole})
    params = tf.abstract_params(cfg, mesh=mesh, rules=rules)
    opt = local_tree(abstract_opt_state(cfg, opt_cfg, params), o_shard)
    return fn, in_shardings, out_shardings, (params, opt, batch), {
        "accum": accum, "dp": dp, "tp": tp_size(mesh, axes)}


def _serve_outputs(cfg: ModelConfig, mesh, axes, rules: Rules, batch: int,
                   caches):
    """Placements of a serving step's logits and (whole) caches (see the
    module docstring)."""
    tp = tp_size(mesh, axes)
    vocab = tp > 1 and cfg.vocab_size % tp == 0
    logits = torch.empty((batch, 1, cfg.vocab_size), device="meta")
    ls = _batch_split(logits, mesh, batch, axes)
    ls = Sharding(mesh, ls.spec[:2] + ("model" if vocab else None,))
    return ls, tf.cache_shardings(cfg, caches, mesh, rules)


def build_prefill(cfg: ModelConfig, shape, mesh, rules: Rules):
    """``(fn, in, out, abstract_args, {})``: ``fn(params, batch) ->
    (logits, caches)`` on this rank's slices of the parameters
    (:func:`tp_shardings`) and piece of the batch, under the mesh; the
    logits and caches placed as the module docstring says.
    ``abstract_args`` are the rank's inputs on the meta device."""
    mesh = _rank_of(mesh)
    axes = data_axes(mesh, rules)
    max_len = shape.seq
    B = shape.batch

    def fn(params, batch):
        with use_mesh(mesh, rules, B), torch.no_grad():
            return tf.prefill(cfg, params, batch, max_len=max_len,
                              cache_dtype=torch.bfloat16)

    b_shard, batch = _inputs(cfg, shape, mesh, axes)
    caches = tf.abstract_caches(
        cfg, B, max_len, torch.bfloat16,
        enc_len=batch["audio_embeds"].shape[1]
        if "audio_embeds" in batch else 1)
    in_shardings = (tp_shardings(cfg, mesh, rules), b_shard)
    out_shardings = _serve_outputs(cfg, mesh, axes, rules, B, caches)
    return fn, in_shardings, out_shardings, (
        tf.abstract_params(cfg, mesh=mesh, rules=rules), batch), {}


def build_decode(cfg: ModelConfig, shape, mesh, rules: Rules):
    """``(fn, in, out, abstract_args, {})``: ``fn(params, caches, tokens,
    pos, mrope_positions=None) -> (logits, caches)`` on this rank's slices
    of the parameters, piece of the batch and caches
    (``transformer.cache_shardings``)."""
    mesh = _rank_of(mesh)
    axes = data_axes(mesh, rules)
    B = shape.batch

    def fn(params, caches, tokens, pos, mrope_positions=None):
        with use_mesh(mesh, rules, B):
            return tf.decode_step(cfg, params, caches, tokens, pos,
                                  mrope_positions=mrope_positions)

    b_shard, batch = _inputs(cfg, shape, mesh, axes)
    logit_shard, c_shard = _serve_outputs(
        cfg, mesh, axes, rules, B, tf.abstract_caches(cfg, B, shape.seq,
                                                      torch.bfloat16))
    caches = tf.abstract_caches(cfg, B, shape.seq, torch.bfloat16,
                                mesh=mesh, rules=rules)
    in_shardings = [tp_shardings(cfg, mesh, rules), c_shard,
                    b_shard["tokens"], Sharding(mesh, ())]
    args = [tf.abstract_params(cfg, mesh=mesh, rules=rules), caches,
            batch["tokens"], 0]
    if "mrope_positions" in batch:
        in_shardings.append(b_shard["mrope_positions"])
        args.append(batch["mrope_positions"])
    return fn, tuple(in_shardings), (logit_shard, c_shard), tuple(args), {}


def build_cell(cfg: ModelConfig, shape, mesh, rules: Rules,
               accum_override: Optional[int] = None):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules,
                           accum_override=accum_override)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules)
    return build_decode(cfg, shape, mesh, rules)
