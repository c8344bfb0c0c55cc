"""The system under test: the only module of the benchmark that imports
the port (``repro_torch``).

It builds the port's config for a benchmark configuration and checks
that every width, the layer pattern and the MoE settings are the
file's; it hands the benchmark's weights to the port's model without a
copy; and it calls the port's serving entry points: ``lm_serve.serve``
for a prefill call and ``models.prefill`` then ``models.decode_step``
as ``serve`` runs them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from .spec import ModelSpec

__all__ = ["Port"]


class Port:
    """The port's entry points for one configuration."""

    def __init__(self, spec: ModelSpec, cfg=None):
        """``cfg``: the port's config to hold to ``spec`` (default the
        port's config of ``spec.port["arch"]`` at ``spec``'s depth)."""
        from repro_torch.configs import get_config
        from repro_torch.models.transformer import layer_kinds

        if cfg is None:
            cfg = dataclasses.replace(get_config(spec.port["arch"]),
                                      n_layers=spec.n_layers)
        m = cfg.moe
        have = dict(
            d=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            hd=cfg.hd, vocab=cfg.vocab_size, eps=cfg.norm_eps,
            rope_theta=cfg.rope_theta, tie=cfg.tie_embeddings,
            kinds=tuple(layer_kinds(cfg)), dtype=cfg.param_dtype,
            ffn_act=cfg.ffn_act, pos_embed=cfg.pos_embed)
        want = dict(
            d=spec.d, n_heads=spec.n_heads, n_kv=spec.n_kv, hd=spec.hd,
            vocab=spec.vocab, eps=spec.eps, rope_theta=spec.rope_theta,
            tie=spec.tie, kinds=spec.kinds, dtype="bfloat16",
            ffn_act="swiglu", pos_embed="rope")
        if spec.moe is not None:
            s = spec.moe
            have.update(n_experts=m.n_experts, padded=m.padded_experts,
                        top_k=m.top_k, expert_ff=cfg.d_ff,
                        shared_ff=m.n_shared * cfg.d_ff,
                        capacity_factor=m.capacity_factor)
            want.update(n_experts=s.n_experts, padded=s.padded,
                        top_k=s.top_k, expert_ff=s.d_ff,
                        shared_ff=s.shared_ff,
                        capacity_factor=s.capacity_factor)
        if any(f == "mlp" for _, f in spec.kinds):
            have["d_ff"], want["d_ff"] = cfg.d_ff, spec.d_ff
        if spec.mamba is not None:
            mc, s = cfg.mamba, spec.mamba
            have.update(d_state=mc.d_state, d_conv=mc.d_conv,
                        d_inner=mc.expand * cfg.d_model,
                        dt_rank=mc.dt_rank or max(cfg.d_model // 16, 1))
            want.update(d_state=s.d_state, d_conv=s.d_conv,
                        d_inner=s.d_inner, dt_rank=s.dt_rank)
        bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
        if bad:
            raise ValueError(f"{spec.name}: the port's config differs from "
                             f"the benchmark's (port, benchmark): {bad}")
        self.spec, self.cfg = spec, cfg

    def build_model(self, weights: Dict[Tuple, torch.Tensor]):
        """The port's model whose parameters are the tensors ``weights``
        (shared, not copied); raises unless its parameter names and
        shapes are exactly the benchmark's."""
        from repro_torch.models.common import ParamTree
        from repro_torch.models.transformer import DecoderLM, abstract_params

        meta = abstract_params(self.cfg)
        seen = set()

        def tree(module, prefix):
            out = {}
            for k in module.keys():
                v = module[k]
                path = prefix + (k,)
                if isinstance(v, ParamTree):
                    out[k] = tree(v, path)
                    continue
                w = weights.get(path)
                if w is None or tuple(w.shape) != tuple(v.shape):
                    raise ValueError(
                        f"{'/'.join(map(str, path))}: the port holds "
                        f"{tuple(v.shape)}, the benchmark "
                        f"{None if w is None else tuple(w.shape)}")
                seen.add(path)
                out[k] = w
            return out

        layers = [tree(layer, ("layers", i))
                  for i, layer in enumerate(meta.layers)]
        model = DecoderLM(self.cfg, tree(meta.embed, ("embed",)), layers,
                          tree(meta.final_norm, ("final_norm",)))
        extra = set(weights) - seen
        if extra:
            raise ValueError(f"the port has no parameters "
                             f"{sorted('/'.join(map(str, p)) for p in extra)}")
        return model

    def serve_call(self, model, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prefill call through ``lm_serve.serve`` generating one
        token a sequence: (the tokens (B,), the last position's logits
        (B, vocab))."""
        from repro_torch.launch import lm_serve

        res = lm_serve.serve(self.cfg, model, tokens, 1)
        return res.tokens[:, 0], res.prefill_logits[:, -1]

    def prefill(self, model, tokens: torch.Tensor, max_len: int):
        """``models.prefill``: (the last position's logits (B, vocab),
        the caches)."""
        from repro_torch.models import prefill

        logits, caches = prefill(self.cfg, model, {"tokens": tokens},
                                 max_len=max_len)
        return logits[:, -1], caches

    def decode_step(self, model, caches: List, tokens: torch.Tensor,
                    pos: int):
        """``models.decode_step`` of tokens (B, 1) at ``pos``: (logits
        (B, vocab), caches)."""
        from repro_torch.models import decode_step

        logits, caches = decode_step(self.cfg, model, caches, tokens, pos)
        return logits[:, 0], caches

    @staticmethod
    def load_library() -> None:
        """Load the port's kernel library (building it on first use in a
        checkout), apart from the first call that launches a kernel."""
        from repro_torch.kernels import _build

        _build.load_library()

    @staticmethod
    def reset_launch_counts() -> None:
        from repro_torch.kernels import ops

        ops.reset_launch_counts()

    @staticmethod
    def launch_counts() -> Dict[str, int]:
        from repro_torch.kernels import ops

        return ops.launch_counts()
