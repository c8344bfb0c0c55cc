"""Step builders: the train step (gradient accumulation and AdamW on a
flat θ, on one rank or sharded over a mesh of ranks), prefill and decode,
with their placements.

Counterpart of ``repro.launch.steps``.  The reference returns functions
for ``jax.jit`` with ``NamedSharding`` trees; here a step runs eagerly on
one rank of an SPMD program and the placements are
:class:`~repro_torch.distributed.sharding.Sharding` trees saying which
piece of each global tensor the rank holds.  The port's layout:

* the batch is split over the data axes (``("pod", "data")``, the
  ``batch`` rule); ``"model"`` ranks hold the same batch (the MoE layers'
  all-to-all splits their work over them; tensor-parallel attention and
  FFN products along ``"model"`` are ROADMAP.md item 1.6b);
* θ is whole on every rank (the model's flat buffer,
  :func:`~repro_torch.models.transformer.make_trainable`); its gradient is
  reduce-scattered over the data ranks, AdamW updates each data rank's
  chunk of θ with its chunk of the moments (ZeRO over the flat buffer:
  the FSDP rule ``embed -> data`` in the form a flat buffer allows), and
  θ is all-gathered.  So θ, m and v are placed as one flat vector split
  over the data axes (:func:`opt_shardings`);
* prefill and decode caches and logits are split over the data axes
  along the batch.

:func:`param_shardings` gives the reference's rule-resolved placements of
the parameter tree (what :func:`~repro_torch.training.checkpoint.restore`
takes, and what the dry run counts).
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
    Rules,
    Sharding,
    sharding_for,
    spec_tree_to_shardings,
)
from ..models import transformer as tf
from ..models.common import leaves, use_mesh
from ..training.optimizer import AdamWConfig, AdamWState, adamw_update
from . import inputs as inp

__all__ = ["make_train_step", "param_shardings", "opt_shardings",
           "batch_shardings", "abstract_opt_state", "shard_range",
           "build_train", "build_prefill", "build_decode", "build_cell"]


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _dp(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in _dp_axes(mesh)],
                       dtype=np.int64))


def _flat_sharding(mesh) -> Sharding:
    """A flat vector split over the data axes."""
    axes = _dp_axes(mesh)
    return Sharding(mesh, (axes if len(axes) > 1 else
                           (axes[0] if axes else None),))


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
                    on_microbatch: Optional[Callable[[int], None]] = None):
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
    docstring): ``batch`` is the rank's piece of the global batch,
    ``opt_state`` holds the moments of the rank's chunk of θ
    (``local_tree(adamw_init(...), opt_shardings(...))``), the layers
    run under ``use_mesh(mesh)``, and the metrics are the global ones.
    Without one it is the one-rank step: one data rank whose chunk is the
    whole of θ.  After either, ``flat.grad[lo:hi]`` (``shard_range(flat.n,
    dp, data rank)``) holds that chunk's mean gradient over the data
    ranks, in float32.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"a sharded train step runs on a mesh of ranks "
            f"(distributed.sharding.make_mesh), not a "
            f"{type(mesh).__name__}; a step traced over a mesh shape "
            f"alone is the multi-rank dry run, ROADMAP.md item 1.6a")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    acc_dt = getattr(torch, opt_cfg.state_dtype)
    dp_axes = _dp_axes(mesh) if mesh is not None else ()
    dp = _dp(mesh) if mesh is not None else 1
    group = mesh.group(dp_axes) if dp_axes else None
    index = mesh.coord(dp_axes) if dp_axes else 0

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
            import torch.distributed as dist

            padded = torch.zeros(dp * c, dtype=torch.float32,
                                 device=grads.device)
            padded[:flat.n] = grads
            chunk = torch.empty(c, dtype=torch.float32, device=grads.device)
            dist.reduce_scatter_tensor(chunk, padded, group=group)
            grads = chunk[:hi - lo].div_(dp)
            flat.grad[lo:hi] = grads
            loss = coll.all_reduce_sum(loss, group) / dp
        elif grads is not flat.grad:
            flat.grad.copy_(grads)
        _, new_opt, metrics = adamw_update(grads, opt_state, flat, opt_cfg,
                                           lo=lo, group=group)
        if dp > 1:
            mine = torch.zeros(c, dtype=flat.theta.dtype,
                               device=flat.device)
            mine[:hi - lo] = flat.theta[lo:hi]
            whole = torch.empty(dp * c, dtype=mine.dtype, device=mine.device)
            dist.all_gather_into_tensor(whole, mine, group=group)
            with torch.no_grad():
                flat.theta.copy_(whole[:flat.n])
        metrics = dict(metrics, loss=host_float(loss))
        return params, new_opt, metrics

    return train_step


def param_shardings(cfg: ModelConfig, mesh, rules: Rules):
    """The parameter tree's placements under ``rules`` (the reference's)."""
    return spec_tree_to_shardings(tf.model_spec(cfg), rules, mesh)


def opt_shardings(mesh) -> AdamWState:
    """The optimizer state's placements in the port's layout: the step
    count whole, the flat moments split over the data axes (the
    reference's follow the parameter tree's; ``opt_rules`` has no
    counterpart)."""
    flat = _flat_sharding(mesh)
    return AdamWState(step=Sharding(mesh, ()), m=flat, v=flat)


def abstract_opt_state(cfg: ModelConfig, opt_cfg: AdamWConfig) -> AdamWState:
    """The whole optimizer state on the meta device: flat moments of θ's
    length in ``state_dtype``."""
    n = sum(int(np.prod(s.shape)) for _, s in leaves(tf.model_spec(cfg)))
    dt = getattr(torch, opt_cfg.state_dtype)
    mk = lambda: torch.empty(n, dtype=dt, device="meta")  # noqa: E731
    return AdamWState(0, mk(), mk())


def batch_shardings(cfg: ModelConfig, shape, mesh, rules: Rules):
    """(placements, abstract batch) of a cell's inputs."""
    specs, axes = inp.batch_specs(cfg, shape)
    return {k: sharding_for(specs[k].shape, axes[k], rules, mesh)
            for k in specs}, specs


def _batch_split(tree, mesh, batch: int):
    """Each tensor leaf (nested lists, tuples, NamedTuples) split over the
    data axes along dim 0 when that is ``batch`` long, else whole."""
    if isinstance(tree, (list, tuple)):
        out = [_batch_split(t, mesh, batch) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(
            out)
    rest = (None,) * (tree.ndim - 1)
    if tree.ndim and tree.shape[0] == batch:
        return Sharding(mesh, _flat_sharding(mesh).spec + rest)
    return Sharding(mesh, (None,) + rest if tree.ndim else ())


def _whole(cfg: ModelConfig, mesh):
    return spec_tree_to_shardings(tf.model_spec(cfg), {}, mesh)


def build_train(cfg: ModelConfig, shape, mesh, rules: Rules,
                opt_cfg: Optional[AdamWConfig] = None,
                accum_override: Optional[int] = None):
    """``(step, in_shardings, out_shardings, abstract_args, meta)`` of a
    train cell on ``mesh``: in = (θ, opt_state, batch), out = (θ,
    opt_state, metrics), θ placed as the flat vector the step updates
    chunk-wise; ``meta`` holds ``accum`` and ``dp``."""
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
    dp = _dp(mesh)
    accum = accum_override or inp.grad_accum_for(cfg, shape, dp)
    fn = make_train_step(cfg, opt_cfg, accum, mesh)
    p_shard = _flat_sharding(mesh)
    o_shard = opt_shardings(mesh)
    b_shard, b_specs = batch_shardings(cfg, shape, mesh, rules)
    whole = Sharding(mesh, ())
    in_shardings = (p_shard, o_shard, b_shard)
    out_shardings = (p_shard, o_shard,
                     {"grad_norm": whole, "lr": whole, "loss": whole})
    args = (tf.abstract_params(cfg), abstract_opt_state(cfg, opt_cfg),
            b_specs)
    return fn, in_shardings, out_shardings, args, {"accum": accum, "dp": dp}


def build_prefill(cfg: ModelConfig, shape, mesh, rules: Rules):
    """``(fn, in, out, abstract_args, {})``: ``fn(params, batch) ->
    (logits, caches)`` on this rank's piece of the batch, under the mesh;
    parameters whole, the batch, logits and caches split over the data
    axes (``rules["batch"]``)."""
    max_len = shape.seq

    def fn(params, batch):
        with use_mesh(mesh), torch.no_grad():
            return tf.prefill(cfg, params, batch, max_len=max_len,
                              cache_dtype=torch.bfloat16)

    b_shard, b_specs = batch_shardings(cfg, shape, mesh, {"batch":
                                                          rules["batch"]})
    B = shape.batch
    caches = tf.abstract_caches(
        cfg, B, max_len, torch.bfloat16,
        enc_len=b_specs["audio_embeds"].shape[1]
        if "audio_embeds" in b_specs else 1)
    logits = torch.empty((B, 1, cfg.vocab_size), device="meta")
    in_shardings = (_whole(cfg, mesh), b_shard)
    out_shardings = (_batch_split(logits, mesh, B),
                     _batch_split(caches, mesh, B))
    return fn, in_shardings, out_shardings, (tf.abstract_params(cfg),
                                             b_specs), {}


def build_decode(cfg: ModelConfig, shape, mesh, rules: Rules):
    """``(fn, in, out, abstract_args, {})``: ``fn(params, caches, tokens,
    pos, mrope_positions=None) -> (logits, caches)`` on this rank's piece
    of the batch and its caches."""

    def fn(params, caches, tokens, pos, mrope_positions=None):
        with use_mesh(mesh):
            return tf.decode_step(cfg, params, caches, tokens, pos,
                                  mrope_positions=mrope_positions)

    B = shape.batch
    caches = tf.abstract_caches(cfg, B, shape.seq, torch.bfloat16)
    c_shard = _batch_split(caches, mesh, B)
    b_shard, b_specs = batch_shardings(cfg, shape, mesh, {"batch":
                                                          rules["batch"]})
    in_shardings = [_whole(cfg, mesh), c_shard, b_shard["tokens"],
                    Sharding(mesh, ())]
    args = [tf.abstract_params(cfg), caches, b_specs["tokens"], 0]
    if "mrope_positions" in b_specs:
        in_shardings.append(b_shard["mrope_positions"])
        args.append(b_specs["mrope_positions"])
    logits = torch.empty((B, 1, cfg.vocab_size), device="meta")
    out_shardings = (_batch_split(logits, mesh, B), c_shard)
    return fn, tuple(in_shardings), out_shardings, tuple(args), {}


def build_cell(cfg: ModelConfig, shape, mesh, rules: Rules,
               accum_override: Optional[int] = None):
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules,
                           accum_override=accum_override)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules)
    return build_decode(cfg, shape, mesh, rules)
