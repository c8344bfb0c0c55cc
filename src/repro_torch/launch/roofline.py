"""Roofline terms of a step on one H100, and the model FLOPs.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch x shape)
cell, in seconds, per device:

  compute    = the step's product FLOPs / the peak of their dtype
               (bfloat16: the tensor-core rate; float32: the rate outside
               the tensor cores, since the port's float32 products run
               with TF32 off)
  memory     = the analytic HBM traffic model / HBM3's rate
  collective = wire bytes / NVLink's rate

The FLOPs come from :mod:`repro_torch.launch.opstats` (the counterpart of
the reference's ``hloparse``).  The reference also parses the collectives
of a compiled SPMD program (``collective_stats``); the port's dry run
traces one rank until ROADMAP.md item 1.6a, so that parser has no
counterpart yet and the collective term is 0.

MODEL_FLOPS uses the 6ND convention (+ logits matmul term), with MoE
parameters scaled by top_k / n_experts (active fraction).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from ..configs.base import ModelConfig
from ..models.common import leaves
from ..models.transformer import model_spec
from .inputs import STUB_DIV, WHISPER_DEC_LEN
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

__all__ = ["PEAK_BY_DTYPE", "active_params", "model_flops",
           "RooflineReport", "analytic_memory_bytes", "compute_seconds",
           "roofline_from_stats"]

#: the card's product rate by the products' dtype (``str(torch.dtype)``):
#: the LM steps' products are bfloat16 or float32
PEAK_BY_DTYPE = {
    "torch.bfloat16": PEAK_FLOPS_BF16,
    "torch.float32": PEAK_FLOPS_F32,
}


# --------------------------------------------------------------------- #
# MODEL_FLOPS (6ND convention)
# --------------------------------------------------------------------- #
def active_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total_params, active_params_excl_embeddings)."""
    total = 0
    active = 0
    moe = cfg.moe
    for path, s in leaves(model_spec(cfg)):
        n = int(np.prod(s.shape))
        total += n
        if "vocab" in (s.axes or ()):  # embedding / unembedding
            continue
        if moe is not None and "experts" in (s.axes or ()):
            if not any("router" in k for k in path):
                e_idx = s.axes.index("experts")
                # padded experts carry no activation
                n_eff = n * moe.n_experts // s.shape[e_idx]
                total += n_eff - n  # correct total for padding
                active += int(n_eff * moe.top_k / moe.n_experts)
                continue
        active += n
    return total, active


def _tokens(cfg: ModelConfig, shape) -> int:
    return shape.batch * (shape.seq if cfg.kind != "encdec"
                          else shape.seq // STUB_DIV + WHISPER_DEC_LEN)


def model_flops(cfg: ModelConfig, shape, kind: str) -> float:
    """6*N_active*D (+ logits term) for train; 2*... for inference."""
    _, active = active_params(cfg)
    if kind == "train":
        tokens = _tokens(cfg, shape)
        mult = 6.0
    elif kind == "prefill":
        tokens = _tokens(cfg, shape)
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.batch
        mult = 2.0
    logits_flops = mult * tokens * cfg.d_model * cfg.vocab_size
    return mult * active * tokens + logits_flops


@dataclass
class RooflineReport:
    flops_per_dev: float
    mem_bytes_per_dev: float
    wire_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_fraction: float  # MODEL_FLOPS / (counted product FLOPs * n_dev)
    traffic_bytes: float = 0.0  # eager operand + output bytes (opstats)
    collectives: Dict[str, Dict[str, float]] = field(default_factory=dict)


def analytic_memory_bytes(cfg: ModelConfig, shape, kind: str, accum: int,
                          n_dev: int, param_bytes_local: float,
                          cache_bytes_local: float = 0.0) -> float:
    """Per-device HBM traffic model (the reference's).

    train:   weights read twice per microbatch (fwd+bwd under FSDP) + one
             optimizer read-modify-write pass (m, v, p read + write), plus
             activation traffic ~C_act bytes per token per layer per d_model
             (C_act ~ 28: fwd writes/reads, remat recompute, bwd reads).
    prefill: weights once + activations (C_act ~ 10).
    decode:  weights + full KV/state cache read per emitted token.
    """
    if kind == "decode":
        return param_bytes_local + cache_bytes_local * 1.5  # read + partial write
    act_bytes = 2.0  # bf16
    tokens_local = _tokens(cfg, shape) / n_dev
    # d_ff activations dominate d_model ones; fold into C_act multiplier
    c_act = 28.0 if kind == "train" else 10.0
    act_traffic = tokens_local * cfg.d_model * act_bytes * cfg.n_layers * c_act
    if kind == "train":
        w = param_bytes_local * (2.0 * accum + 6.0)
    else:
        w = param_bytes_local
    return w + act_traffic


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Product FLOPs by dtype over the card's peak for each dtype."""
    return sum(f / PEAK_BY_DTYPE[dt] for dt, f in flops_by_dtype.items())


def roofline_from_stats(
    st, cfg: ModelConfig, shape, kind: str, accum: int, n_dev: int,
    param_bytes_local: float, cache_bytes_local: float,
) -> RooflineReport:
    """The three terms from an :class:`~.opstats.OpStats` (its products'
    FLOPs by dtype; its collectives, empty for one rank)."""
    mflops = model_flops(cfg, shape, kind)
    mem_bytes = analytic_memory_bytes(cfg, shape, kind, accum, n_dev,
                                      param_bytes_local, cache_bytes_local)
    compute_s = compute_seconds(st.dot_flops_by_dtype)
    memory_s = mem_bytes / HBM_BW
    collective_s = st.total_wire / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = mflops / max(st.dot_flops * n_dev, 1.0)
    return RooflineReport(
        flops_per_dev=st.dot_flops,
        mem_bytes_per_dev=mem_bytes,
        wire_bytes_per_dev=st.total_wire,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops_total=mflops,
        useful_fraction=useful,
        traffic_bytes=st.traffic_bytes,
        collectives={
            op: {
                "count": st.coll_counts[op],
                "operand_bytes": st.coll_operand_bytes[op],
                "wire_bytes": st.coll_wire_bytes[op],
            }
            for op in st.coll_counts
        },
    )
