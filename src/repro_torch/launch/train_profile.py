"""Where an LM training step's time goes on the card.

Builds the train step of ``chip_smoke.py``'s ``[train]`` phase, whose
shape is :data:`BATCH` x :data:`SEQ` tokens in :data:`ACCUM` microbatches
(:func:`repro_torch.launch.steps.make_train_step`, Gemma-2-2B float32
weights from a seeded generator, ``SyntheticLM`` batches), takes a
warm-up step and a timed untraced one, then traces one step and,
separately, one ``adamw_update`` on the gradient it left, under
``torch.profiler``:

  PYTHONPATH=src python -m repro_torch.launch.train_profile

For each trace it prints the host wall time, the device time summed over
the kernels and copies, the busy share and the device time by group and
by kernel (:func:`repro_torch.launch.lm_profile.breakdown`); the step
minus the optimizer is the forward, recompute and backward passes.
``--reduced --device cpu`` runs the reduced config at :data:`BATCH` x
:data:`REDUCED_SEQ` tokens without device times, for tests.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .._device import resolve_device
from ..models import make_trainable
from ..telemetry.serving import SERVE_SPANS
from ..training.data import DataConfig, SyntheticLM
from ..training.optimizer import AdamWConfig, adamw_init, adamw_update
from . import lm_serve
from .lm_profile import breakdown
from .steps import make_train_step

__all__ = ["ARCH", "BATCH", "SEQ", "ACCUM", "main"]

#: the ``[train]`` cell: Gemma-2-2B, batch x seq tokens a step, microbatches
ARCH, BATCH, SEQ, ACCUM = "gemma2_2b", 2, 2048, 2
#: tokens a sequence with ``--reduced``
REDUCED_SEQ = 16


def _wall_ms(device, fn) -> float:
    """Host milliseconds of one call of ``fn``, the device's work included."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _traced(device, fn):
    """Host wall ms and the device events of one traced call of ``fn``."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        wall_ms = _wall_ms(device, fn)
    # (the profiler may mirror the model's spans on the device: not
    # kernels)
    return wall_ms, [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and e.name not in SERVE_SPANS]


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (no device times; tests)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    seq = REDUCED_SEQ if args.reduced else SEQ
    cfg = lm_serve.make_config(ARCH, args.reduced)
    params = lm_serve.make_params(cfg, device)
    flat = make_trainable(params)
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=1)
    state = adamw_init(flat, opt_cfg)
    step = make_train_step(cfg, opt_cfg, ACCUM)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=BATCH, seq=seq, seed=7))
    batches = [{"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                          device=device)} for i in range(3)]

    def run_step(i):
        nonlocal params, state
        params, state, _ = step(params, state, batches[i])

    run_step(0)  # warm-up: cuBLAS handles and plans, the allocator
    untraced_ms = _wall_ms(device, lambda: run_step(1))
    print(f"[train] {cfg.name} {BATCH} x {seq} tokens, accum {ACCUM}: "
          f"{untraced_ms / 1e3:.3f} s/step (untraced)")
    out = dict(arch=cfg.name, batch=BATCH, seq=seq, accum=ACCUM,
               step_s=untraced_ms / 1e3)
    out["step"] = breakdown("step", *_traced(device, lambda: run_step(2)))
    out["adamw"] = breakdown("adamw", *_traced(
        device, lambda: adamw_update(flat.grad, state, flat, opt_cfg)))
    return out


if __name__ == "__main__":
    main()
