"""Asynchronous data-parallel LM training as a fixed-point problem.

Counterpart of ``repro.training.async_dp``: the paper's coordinator/worker
machinery applied to neural-network training, testing its central
*coupling-density* prediction on a new domain.

Training is the fixed-point iteration  theta <- G(theta) = theta - lr *
grad(L)(theta), and the two worker designs map exactly onto the paper's two
staleness mechanisms:

  * :class:`GradientWorkersProblem` — each worker evaluates the FULL
    gradient on its own data shard from a (stale) snapshot and returns its
    owned parameter block of ``theta - lr * g``.  Every returned component
    reflects the whole stale iterate -> *evaluation-level perturbation*
    (high coupling).  Prediction: Anderson acceleration survives asynchrony.

  * :class:`BlockGradientWorkersProblem` — each worker differentiates the
    loss ONLY w.r.t. its own parameter block (block-coordinate descent with
    frozen stale off-block parameters).  Returned values encode block-local
    information -> *iterate-level corruption* (low effective coupling).
    Prediction: Anderson degrades or fails under asynchrony.

θ lives on the problem's device (the card unless ``device=`` says
otherwise) as the model's flat float32 buffer, in the reference's
``ravel_pytree`` order, so ``contiguous_blocks`` gives each worker the
same parameters as in the reference.  ``full_map`` and ``block_update``
cross the coordinator's float64 host boundary through
:func:`~repro_torch._device.to_device`/:func:`~repro_torch._device.to_host`.
One lock serializes the evaluations, which share the model's buffers.
The launcher is :mod:`repro_torch.launch.async_dp_lm`.
"""

from __future__ import annotations

import copy
import threading
from typing import Union

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from ..configs.base import ModelConfig
from ..convert import lm_params_from_theta
from ..core.fixedpoint import FixedPointProblem, as_block_slice
from ..models.transformer import DecoderLM, init_params, lm_loss, make_trainable
from .data import DataConfig, SyntheticLM

__all__ = ["GradientWorkersProblem", "BlockGradientWorkersProblem",
           "start_model"]

#: the data step of the held-out batch (the reference's)
_HELD_OUT = 10_000_000

Start = Union[None, DecoderLM, np.ndarray]


def start_model(cfg: ModelConfig, params: Start, seed: int,
                device: torch.device) -> DecoderLM:
    """A trainable model of its own on ``device``: a copy of ``params``
    (a :class:`DecoderLM`), θ from a reference flat vector (``ndarray``),
    or weights drawn from a generator seeded with ``seed`` (None)."""
    if isinstance(params, DecoderLM):
        model = copy.deepcopy(params).to(device)
    elif params is not None:
        return lm_params_from_theta(cfg, params, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = init_params(cfg, gen, dtype=torch.float32, device=device)
    make_trainable(model)
    return model


class _LMBase(FixedPointProblem):
    def __init__(self, cfg: ModelConfig, lr: float = 0.2, batch: int = 8,
                 seq: int = 32, seed: int = 0, data_seed: int = 1, *,
                 params: Start = None, device=None):
        self.cfg = cfg
        self.lr = lr
        self.device = resolve_device(device)
        self.model = start_model(cfg, params, seed, self.device)
        self.flat = self.model.flat
        self._theta0 = to_host(self.flat.theta).astype(np.float64)
        self.n = self.flat.n
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, batch=batch, seq=seq, seed=data_seed))
        self._held_out = self._tokens(self.data.batch(_HELD_OUT))
        self._step = 0  # data cursor: advances per evaluation (fresh shards)
        self._lock = threading.Lock()

    def _tokens(self, b) -> torch.Tensor:
        return torch.as_tensor(b["tokens"], device=self.device)

    def _next_tokens(self, worker_salt: int = 0) -> torch.Tensor:
        b = self.data.batch(self._step, worker=worker_salt)
        self._step += 1
        return self._tokens(b)

    def _grad(self, theta, tokens: torch.Tensor) -> torch.Tensor:
        """The flat float32 gradient at ``float32(theta)`` (a view of the
        model's gradient buffer, valid until the next evaluation)."""
        self.flat.unravel(theta)
        self.flat.grad.zero_()
        loss, _ = lm_loss(self.cfg, self.model, {"tokens": tokens})
        loss.backward()
        return self.flat.grad

    def initial(self) -> np.ndarray:
        return self._theta0.copy()

    def loss(self, x: np.ndarray) -> float:
        with self._lock, torch.no_grad():
            self.flat.unravel(x)
            loss, _ = lm_loss(self.cfg, self.model,
                              {"tokens": self._held_out})
            return float(loss)

    def full_map(self, x: np.ndarray) -> np.ndarray:
        with self._lock:
            g = self._grad(x, self._next_tokens())
            with torch.no_grad():
                return to_host(self.flat.theta - self.lr * g).astype(
                    np.float64)

    def residual_norm(self, x: np.ndarray) -> float:
        # deterministic held-out gradient norm (scaled by lr)
        with self._lock:
            g = self._grad(x, self._held_out)
            return float(self.lr * torch.linalg.vector_norm(g))


class GradientWorkersProblem(_LMBase):
    """Full-gradient workers: evaluation-level perturbation (high coupling)."""

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        return self.full_map(x)[indices]

    def dependency_counts(self) -> None:
        return None  # every component's update reads the full iterate


class BlockGradientWorkersProblem(_LMBase):
    """Multi-step block-coordinate workers: iterate-level corruption.

    The training analogue of the paper's Jacobi multi-sweep local solves:
    each worker takes ``local_steps`` SGD steps that update ONLY its own
    parameter block, with the off-block (stale) parameters frozen.  The
    returned block has moved far on the basis of stale boundary values —
    exactly the paper's iterate-level corruption mechanism.  The float64
    working copy stays on the device between the steps.
    """

    def __init__(self, *args, local_steps: int = 5, **kw):
        super().__init__(*args, **kw)
        self.local_steps = local_steps

    def block_update(self, x: np.ndarray, indices: np.ndarray) -> np.ndarray:
        sl = as_block_slice(indices)
        idx = sl if sl is not None else torch.as_tensor(
            np.asarray(indices), device=self.device)
        salt = int(indices[0]) % 97
        with self._lock:
            cur = to_device(x, self.device).clone()
            for _ in range(self.local_steps):
                g = self._grad(cur, self._next_tokens(salt))
                with torch.no_grad():
                    cur[idx] -= self.lr * g[idx].double()
            return to_host(cur[idx])
