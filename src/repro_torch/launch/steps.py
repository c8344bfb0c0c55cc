"""The train step: gradient accumulation and AdamW on a flat θ.

Counterpart of ``repro.launch.steps.make_train_step``.  The reference
returns a function for ``jax.jit`` over (params, opt_state, batch); here
the step runs eagerly and updates the model's flat buffers in place
(:func:`~repro_torch.models.transformer.make_trainable`), returning the
same triple.  The mesh builders (``param_shardings``, ``build_train``,
``build_prefill``, ``build_decode``, ``build_cell``) wait for ROADMAP.md
items 1.6 and 1.7g: a step asked for a mesh raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tf
from ..training.optimizer import AdamWConfig, AdamWState, adamw_update

__all__ = ["make_train_step"]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, accum: int,
                    mesh=None):
    """Gradient-accumulated train step; grads accumulate in state_dtype.

    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``params`` is a :class:`~repro_torch.models.transformer.DecoderLM`
    (made trainable on first use), ``batch["tokens"]`` a ``(B, S)``
    integer tensor on its device with ``B`` divisible by ``accum``;
    metrics hold ``loss``, ``grad_norm`` and ``lr`` as floats.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharded train steps are not ported yet: ROADMAP.md items 1.6 "
            "(sharding) and 1.7g (mesh launch tools)")
    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")
    acc_dt = getattr(torch, opt_cfg.state_dtype)

    def loss_and_grad(params, micro) -> torch.Tensor:
        loss, _ = tf.lm_loss(cfg, params, micro)
        loss.backward()
        return loss.detach()

    def train_step(params: tf.DecoderLM, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        flat = tf.make_trainable(params)
        flat.grad.zero_()
        if accum == 1:
            loss = loss_and_grad(params, batch)
            grads = flat.grad
        else:
            tokens = batch["tokens"]
            if tokens.shape[0] % accum:
                raise ValueError(f"batch {tokens.shape[0]} is not divisible "
                                 f"by accum {accum}")
            micros = tokens.reshape(accum, tokens.shape[0] // accum,
                                    *tokens.shape[1:])
            # float32 sums accumulate in place in the gradient buffer
            # (0 + g1 + g2 ..., the reference's order); another dtype gets
            # its own buffer, each microbatch's gradient cast into it.
            gsum = flat.grad if acc_dt == torch.float32 else torch.zeros(
                flat.n, dtype=acc_dt, device=flat.device)
            lsum = torch.zeros((), dtype=torch.float32, device=flat.device)
            for micro in micros:
                if gsum is not flat.grad:
                    flat.grad.zero_()
                lsum = lsum + loss_and_grad(params, {"tokens": micro})
                if gsum is not flat.grad:
                    gsum.add_(flat.grad.to(acc_dt))
            inv = 1.0 / accum
            loss = lsum * inv
            grads = gsum.mul_(inv)
        _, new_opt, metrics = adamw_update(grads, opt_state, flat, opt_cfg)
        metrics = dict(metrics, loss=float(loss))
        return params, new_opt, metrics

    return train_step
