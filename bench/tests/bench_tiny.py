"""Tiny configurations of the benchmark's two families, for CPU tests:
the configuration files' keys with small widths, and the port's config
cut to the same widths."""

import dataclasses
import json
import time

import torch

from harness.check import load_limits
from harness.manifest import BENCH, Cell, load_manifest, metric_entries
from harness.port import Port
from harness.spec import spec_from_dict


def tiny(family: str, capacity_factor: float = 1.25):
    """(spec, the port's config) of a tiny Jamba or Qwen1.5-MoE."""
    from repro_torch.configs import get_config

    if family == "jamba":
        c = json.loads((BENCH / "configs" /
                        "jamba-1.5-large-d5.json").read_text())
        c.update(hidden_size=64, intermediate_size=96, num_attention_heads=4,
                 num_key_value_heads=2, vocab_size=512, mamba_d_state=8,
                 mamba_dt_rank=4, num_experts=4)
        c["assumed"].update(moe_pad_experts_to=4,
                            moe_capacity_factor=capacity_factor)
        base = get_config("jamba_1p5_large_398b")
        cfg = dataclasses.replace(
            base, n_layers=5, d_model=64, d_ff=96, n_heads=4, n_kv_heads=2,
            head_dim=16, vocab_size=512,
            moe=dataclasses.replace(base.moe, n_experts=4, pad_to=4,
                                    capacity_factor=capacity_factor),
            mamba=dataclasses.replace(base.mamba, d_state=8, dt_rank=4))
    else:
        c = json.loads((BENCH / "configs" /
                        "qwen1.5-moe-a2.7b.json").read_text())
        c.update(hidden_size=64, moe_intermediate_size=32,
                 shared_expert_intermediate_size=64, num_attention_heads=4,
                 num_key_value_heads=4, vocab_size=512, num_experts=6,
                 num_hidden_layers=2)
        c["assumed"].update(moe_pad_experts_to=4,
                            moe_capacity_factor=capacity_factor)
        base = get_config("qwen2_moe_a2p7b")
        cfg = dataclasses.replace(
            base, n_layers=2, d_model=64, d_ff=32, n_heads=4, n_kv_heads=4,
            head_dim=16, vocab_size=512,
            moe=dataclasses.replace(base.moe, n_experts=6, n_shared=2,
                                    pad_to=4,
                                    capacity_factor=capacity_factor))
    return spec_from_dict(c), cfg


PREFILL_MIX = {"loop": "prefill",
               "shapes": [[8, 16], [4, 32], [2, 64], [1, 128]],
               "min_call_s": 0.01}
DECODE_MIX = {"loop": "decode", "batch": 6, "prompt_len": 32,
              "warmup_steps": 2, "check_rows": 3, "max_steps": 12}


def tiny_cell(name: str, family: str, mix):
    """The benchmark cell ``name`` (its metrics and its limits) on a tiny
    configuration and mix, and its port."""
    spec, cfg = tiny(family)
    m = metric_entries(load_manifest(), name)
    cell = Cell(name, 1, spec, mix,
                load_limits(BENCH / "limits" / f"{name}.json"),
                m["end_to_end"], m["per_layer"])
    return cell, Port(spec, cfg)


def run_tiny(cell, port, seed=2**31 + 7, seconds=0.3, trace=False,
             controls=()):
    from harness.cell import run_cell

    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    log=lambda s: None, port=port, controls=controls)


__all__ = ["tiny", "tiny_cell", "run_tiny", "PREFILL_MIX",
           "DECODE_MIX", "torch"]
