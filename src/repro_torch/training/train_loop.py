"""Synchronous training driver with fault-tolerance hooks.

Counterpart of ``repro.training.train_loop``: the train step
(:func:`repro_torch.launch.steps.make_train_step`), checkpoint/restart via
:class:`~repro_torch.training.checkpoint.CheckpointManager` in the
reference's format (resume is exact: data cursor == step), and a crash
hook for restart tests.  It runs on the card unless ``device`` says
otherwise; ``params`` may carry starting weights (e.g. a reference tree
through :func:`repro_torch.convert.lm_params_from_arrays`), else they are
drawn from a generator seeded with ``TrainConfig.seed``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..launch.steps import make_train_step
from ..models.transformer import DecoderLM, init_params, make_trainable
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticLM
from .optimizer import AdamWConfig, AdamWState, adamw_init

__all__ = ["TrainConfig", "SimulatedCrash", "train", "state_tree"]


@dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    accum: int = 1
    lr: float = 3e-3
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    log_every: int = 10
    seed: int = 0
    crash_at_step: Optional[int] = None  # fault-injection for restart tests


class SimulatedCrash(RuntimeError):
    pass


def state_tree(params: DecoderLM, opt_state: AdamWState):
    """``(params, opt_state)`` as the reference's checkpoint tree: the
    parameter dict and ``AdamWState(step, m, v)`` with the moments as
    dicts, every leaf a view of the flat buffers."""
    flat = make_trainable(params)
    return (flat.tree(), AdamWState(np.int32(opt_state.step),
                                    flat.tree(opt_state.m),
                                    flat.tree(opt_state.v)))


def train(cfg: ModelConfig, tcfg: TrainConfig,
          log: Optional[Callable[[str], None]] = print, *,
          params: Optional[DecoderLM] = None, device=None) -> Dict:
    device = resolve_device(device) if params is None else (
        next(params.parameters()).device)
    opt_cfg = AdamWConfig(lr=tcfg.lr, warmup_steps=10,
                          total_steps=tcfg.steps,
                          state_dtype=cfg.opt_state_dtype)
    step_fn = make_train_step(cfg, opt_cfg, tcfg.accum)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=tcfg.batch, seq=tcfg.seq,
                                  seed=tcfg.seed + 7))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        params = init_params(cfg, gen, dtype=torch.float32, device=device)
    flat = make_trainable(params)
    opt_state = adamw_init(flat, opt_cfg)
    start = 0
    mgr = None
    if tcfg.checkpoint_dir:
        mgr = CheckpointManager(tcfg.checkpoint_dir, keep=3, async_save=False)
        try:
            template = state_tree(params, opt_state)
            (p_tree, o_tree), start, _ = mgr.restore_latest(template)
            flat.unravel(flat.ravel_tree(p_tree))
            opt_state = AdamWState(int(o_tree.step),
                                   flat.ravel_tree(o_tree.m, opt_state.m.dtype),
                                   flat.ravel_tree(o_tree.v, opt_state.v.dtype))
            if log:
                log(f"[train] resumed from step {start}")
        except FileNotFoundError:
            pass

    losses: List[float] = []
    t0 = time.time()
    for step in range(start, tcfg.steps):
        if tcfg.crash_at_step is not None and step == tcfg.crash_at_step:
            raise SimulatedCrash(f"injected fault at step {step}")
        batch = {"tokens": torch.as_tensor(data.batch(step)["tokens"],
                                           device=device)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(metrics["loss"])
        if mgr and (step + 1) % tcfg.checkpoint_every == 0:
            mgr.save(step + 1, state_tree(params, opt_state))
        if log and (step + 1) % tcfg.log_every == 0:
            log(f"[train] step {step+1} loss {losses[-1]:.4f} "
                f"gnorm {metrics['grad_norm']:.3f} "
                f"({(time.time()-t0)/(step-start+1):.2f}s/step)")
    if mgr:
        mgr.save(tcfg.steps, state_tree(params, opt_state))
        mgr.wait()
    return {"params": params, "opt_state": opt_state, "losses": losses}
