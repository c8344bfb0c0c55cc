"""DiLoCo-style multi-pod training with Anderson-accelerated outer loop.

Counterpart of ``repro.training.diloco``: each pod runs ``inner_steps`` of
local SGD from the shared iterate; the coordinator treats the averaged pod
delta as a *pseudo-gradient* and the outer update as a fixed-point map

    theta <- G(theta) = theta + outer_lr * mean_k( local_k(theta) - theta ).

Because each pod's delta is a full map evaluation on (possibly stale)
parameters, staleness enters at evaluation level — the regime where the
paper predicts Anderson acceleration survives.  The outer iterate sequence
goes through the same safeguarded Anderson machinery
(:class:`~repro_torch.core.anderson.AndersonState`, its window on the
trainer's device, the combine through ``anderson_mix`` on the card), and
the async mode applies pod deltas in arrival order with bounded staleness.

The outer iterate is a float64 host vector, as in the reference; the
pods' inner steps run on the device in float32, on the model's flat
buffer (the reference's ``ravel_pytree`` order).  The exchanged deltas
optionally go through :class:`~repro_torch.training.compression.Compressor`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device, to_host
from ..configs.base import ModelConfig
from ..core.anderson import AndersonConfig, AndersonState
from ..core.async_engine import FaultProfile
from ..models.transformer import lm_loss
from .async_dp import Start, start_model
from .compression import Compressor
from .data import DataConfig, SyntheticLM

__all__ = ["DiLoCoConfig", "DiLoCoResult", "DiLoCoTrainer"]


@dataclass
class DiLoCoConfig:
    n_pods: int = 4
    inner_steps: int = 10
    inner_lr: float = 0.1
    outer_lr: float = 1.0
    outer_steps: int = 20
    accel: Optional[AndersonConfig] = None
    mode: str = "sync"  # "sync" | "async" (arrival-order pod deltas)
    compute_time: float = 1.0  # virtual seconds per inner phase
    faults: Optional[Dict[int, FaultProfile]] = None
    compressor: Optional[Compressor] = None
    seed: int = 0


@dataclass
class DiLoCoResult:
    losses: List[float] = field(default_factory=list)
    wall_times: List[float] = field(default_factory=list)
    outer_updates: int = 0
    accel_accepts: int = 0
    accel_rejects: int = 0
    final_theta: Optional[np.ndarray] = None


class DiLoCoTrainer:
    """``params`` (a :class:`DecoderLM` to copy or a reference flat θ)
    sets the starting weights, else they are drawn from ``dcfg.seed``;
    ``device`` is the card unless it says otherwise."""

    def __init__(self, cfg: ModelConfig, dcfg: DiLoCoConfig,
                 batch: int = 8, seq: int = 32, *, params: Start = None,
                 device=None):
        self.cfg, self.dcfg = cfg, dcfg
        self.device = resolve_device(device)
        self.model = start_model(cfg, params, dcfg.seed, self.device)
        self.flat = self.model.flat
        self.theta = to_host(self.flat.theta).astype(np.float64)
        self.data = [SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                            batch=batch, seq=seq,
                                            seed=100 + k))
                     for k in range(dcfg.n_pods)]
        self._eval_data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, batch=batch, seq=seq, seed=999))
        self._eval_tokens = [self._tokens(self._eval_data.batch(i))
                             for i in (0, 1)]
        self._cursor = [0] * dcfg.n_pods

    def _tokens(self, b) -> torch.Tensor:
        return torch.as_tensor(b["tokens"], device=self.device)

    def _grad_here(self, tokens: torch.Tensor) -> torch.Tensor:
        """The flat gradient at the model's current θ."""
        self.flat.grad.zero_()
        loss, _ = lm_loss(self.cfg, self.model, {"tokens": tokens})
        loss.backward()
        return self.flat.grad

    # ------------------------------------------------------------------ #
    def eval_loss(self, theta: np.ndarray) -> float:
        with torch.no_grad():
            self.flat.unravel(theta)
            loss, _ = lm_loss(self.cfg, self.model,
                              {"tokens": self._eval_tokens[0]})
            return float(loss)

    def _local_phase(self, theta: np.ndarray, pod: int) -> np.ndarray:
        """inner_steps of SGD on the pod's data shard; returns the delta."""
        self.flat.unravel(theta)
        lr = self.dcfg.inner_lr
        for _ in range(self.dcfg.inner_steps):
            toks = self._tokens(self.data[pod].batch(self._cursor[pod]))
            self._cursor[pod] += 1
            g = self._grad_here(toks)
            with torch.no_grad():
                self.flat.theta.sub_(lr * g)
        return to_host(self.flat.theta).astype(np.float64) - theta

    def _outer_map(self, theta: np.ndarray, deltas: List[np.ndarray]
                   ) -> np.ndarray:
        d = np.mean(deltas, axis=0)
        if self.dcfg.compressor is not None:
            d = self.dcfg.compressor.roundtrip(d, slot="outer")
        return theta + self.dcfg.outer_lr * d

    def _residual_norm(self, theta: np.ndarray) -> float:
        self.flat.unravel(theta)
        g = self._grad_here(self._eval_tokens[1])
        return float(torch.linalg.vector_norm(g))

    # ------------------------------------------------------------------ #
    def run(self) -> DiLoCoResult:
        dcfg = self.dcfg
        res = DiLoCoResult()
        accel = (AndersonState(dcfg.accel, device=self.device)
                 if dcfg.accel else None)
        rng = np.random.default_rng(dcfg.seed)
        t = 0.0

        if dcfg.mode == "sync":
            for outer in range(dcfg.outer_steps):
                deltas = [self._local_phase(self.theta, k)
                          for k in range(dcfg.n_pods)]
                phase_t = max(
                    dcfg.compute_time
                    + (dcfg.faults or {}).get(k, FaultProfile()).sample_delay(rng)
                    for k in range(dcfg.n_pods))
                t += phase_t
                g = self._outer_map(self.theta, deltas)
                self.theta = self._accel_step(accel, self.theta, g, res)
                res.losses.append(self.eval_loss(self.theta))
                res.wall_times.append(t)
                res.outer_updates += 1
        else:  # async: deltas applied in arrival order
            heap: List[Tuple[float, int, int, np.ndarray]] = []
            seq = 0
            for k in range(dcfg.n_pods):
                d = self._local_phase(self.theta, k)
                dt = dcfg.compute_time + (dcfg.faults or {}).get(
                    k, FaultProfile()).sample_delay(rng)
                heapq.heappush(heap, (dt, seq, k, d))
                seq += 1
            applied = 0
            while applied < dcfg.outer_steps * dcfg.n_pods:
                t, _, k, d = heapq.heappop(heap)
                g = self._outer_map(self.theta, [d])
                self.theta = self._accel_step(accel, self.theta, g, res)
                applied += 1
                if applied % dcfg.n_pods == 0:
                    res.losses.append(self.eval_loss(self.theta))
                    res.wall_times.append(t)
                    res.outer_updates += 1
                d2 = self._local_phase(self.theta, k)
                dt = dcfg.compute_time + (dcfg.faults or {}).get(
                    k, FaultProfile()).sample_delay(rng)
                heapq.heappush(heap, (t + dt, seq, k, d2))
                seq += 1
        res.final_theta = self.theta
        return res

    def _accel_step(self, accel: Optional[AndersonState], theta, g, res
                    ) -> np.ndarray:
        if accel is None:
            return g
        accel.push(theta, g)
        cand = accel.propose()
        if cand is None:
            res.accel_rejects += 1
            return g
        if accel.config.safeguard:
            if self._residual_norm(cand) < self._residual_norm(theta):
                res.accel_accepts += 1
                accel.record_accept()
                return cand
            res.accel_rejects += 1
            accel.record_reject()
            return g
        res.accel_accepts += 1
        return cand
