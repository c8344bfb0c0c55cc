"""Carry state from the JAX package's objects into the port's.

Each function takes plain numpy arrays (what ``np.asarray`` of a reference
object's fields gives), so this module imports nothing of the reference
package.  The tests build port objects from reference objects this way,
so both sides compute on identical data.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .configs.base import ModelConfig
from .core.anderson import AndersonConfig, AndersonState
from .models.common import leaves, tree_map
from .models.transformer import DecoderLM, make_trainable, model_spec
from .training.optimizer import AdamWState
from .problems.jacobi import JacobiProblem
from .problems.value_iteration import GarnetMDP

__all__ = ["jacobi_from_arrays", "garnet_from_arrays",
           "anderson_from_snapshot", "lm_params_from_arrays",
           "lm_params_from_theta", "adamw_state_from_arrays"]


def jacobi_from_arrays(b, grid: int, sweeps: int, backend: str = "jnp",
                       device=None) -> JacobiProblem:
    """A port :class:`JacobiProblem` whose right-hand side is exactly ``b``
    (flat ``(grid*grid,)``, e.g. a reference problem's ``_b``) and whose
    full map sums in ``backend``'s order (the reference's argument)."""
    b = np.array(b, dtype=np.float64).reshape(-1)
    if b.shape != (grid * grid,):
        raise ValueError(f"expected b of shape ({grid * grid},), got "
                         f"{b.shape}")
    prob = JacobiProblem(grid=grid, sweeps=sweeps, seed=0, backend=backend,
                         device=device)
    prob._b = b
    prob._b_t = prob._b_t.new_tensor(b)
    return prob


def garnet_from_arrays(idx, probs, R, gamma: float, device=None) -> GarnetMDP:
    """A port :class:`GarnetMDP` holding exactly these arrays
    (``idx`` ``(S, A, b)`` int32, ``probs`` ``(S, A, b)``, ``R``
    ``(S, A)``)."""
    idx = np.asarray(idx)
    S, A, b = idx.shape
    probs = np.asarray(probs, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    if probs.shape != (S, A, b) or R.shape != (S, A):
        raise ValueError("inconsistent MDP array shapes")
    return GarnetMDP.from_arrays(idx.astype(np.int32), probs, R, gamma,
                                 device=device)


def anderson_from_snapshot(snap: dict, config: AndersonConfig,
                           device=None) -> AndersonState:
    """A port :class:`AndersonState` restored from the dict of the
    reference ``AndersonState.snapshot()`` (counters and window)."""
    state = AndersonState(config, device=device)
    state.restore(snap)
    return state


def lm_params_from_arrays(cfg: ModelConfig, tree: dict, device=None,
                          trainable: bool = False) -> DecoderLM:
    """The port's :class:`~repro_torch.models.transformer.DecoderLM` holding
    exactly the arrays of a reference parameter tree (``init_params``'s
    output as nested dicts of numpy arrays).

    Both packages keep the reference's einsum layouts (``wq (d, nq, hd)``,
    ``wi (d, 2, f)``, Mamba's ``in_proj (d, 2, d_inner)`` and ``A_log
    (d_inner, d_state)``, ...), so this is a renaming, never a transpose: the
    stacked ``stack`` leaves ``(n_periods, ...)`` are split per layer, in
    order, followed by the ``rest`` layers (an encoder-decoder's carry
    their ``norm_x`` and ``cross``), and an encoder-decoder's
    ``encoder/stack`` leaves ``(n_enc_layers, ...)`` per encoder layer
    beside ``encoder/final_norm``.  Shapes are checked against
    the port's own :func:`~repro_torch.models.transformer.model_spec`.
    The tensors land on ``device`` (None: the card).  With ``trainable``
    the parameters are bound into their flat buffer
    (:func:`~repro_torch.models.transformer.make_trainable`).
    """
    spec = model_spec(cfg)
    device = resolve_device(device)

    def check(spec_node, node, path):
        if isinstance(spec_node, dict):
            if not isinstance(node, dict) or set(node) != set(spec_node):
                raise ValueError(f"{path or 'tree'}: expected keys "
                                 f"{sorted(spec_node)}")
            for k in spec_node:
                check(spec_node[k], node[k], f"{path}/{k}")
        elif tuple(np.shape(node)) != tuple(spec_node.shape):
            raise ValueError(f"{path}: expected shape {spec_node.shape}, got "
                             f"{np.shape(node)}")

    check(spec, tree, "")
    to_t = lambda a: torch.as_tensor(np.array(a), device=device)  # noqa: E731
    layers = [tree_map(lambda a, p=p: to_t(np.asarray(a)[p]),
                       tree["stack"][str(i)])
              for p in range(cfg.n_periods) for i in range(len(cfg.period))]
    layers += [tree_map(to_t, tree["rest"][str(i)])
               for i in range(len(cfg.remainder))]
    encoder = None
    if "encoder" in tree:
        enc = tree["encoder"]
        encoder = ([tree_map(lambda a, p=p: to_t(np.asarray(a)[p]),
                             enc["stack"]["0"])
                    for p in range(cfg.n_enc_layers)],
                   tree_map(to_t, enc["final_norm"]))
    model = DecoderLM(cfg, tree_map(to_t, tree["embed"]), layers,
                      tree_map(to_t, tree["final_norm"]), encoder)
    if trainable:
        make_trainable(model)
    return model


def lm_params_from_theta(cfg: ModelConfig, theta, device=None) -> DecoderLM:
    """A trainable :class:`DecoderLM` holding a reference flat vector
    (``jax.flatten_util.ravel_pytree`` of a parameter tree; float64 is
    rounded to float32 as the reference's ``unravel`` does)."""
    theta = np.asarray(theta)
    zeros = tree_map(lambda s: np.zeros(s.shape, np.float32),
                     model_spec(cfg))
    model = lm_params_from_arrays(cfg, zeros, device=device, trainable=True)
    model.flat.unravel(theta)
    return model


def adamw_state_from_arrays(params: DecoderLM, step, m: dict,
                            v: dict) -> AdamWState:
    """The port's flat :class:`~repro_torch.training.optimizer.AdamWState`
    from the reference's ``(step, m, v)``: the moment trees (numpy, any
    float dtype, bfloat16 too) ravelled in the reference's order, in
    their own dtype (float32 or bfloat16), on the model's device."""
    flat = make_trainable(params)

    def dtype_of(tree):
        name = str(np.asarray(next(leaves(tree))[1]).dtype)
        return getattr(torch, name)

    return AdamWState(int(np.asarray(step)),
                      flat.ravel_tree(m, dtype_of(m)),
                      flat.ravel_tree(v, dtype_of(v)))
