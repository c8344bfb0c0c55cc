"""Qwen2-MoE's layer pattern (``model_type`` ``qwen2_moe``): attention
in every layer; MoE where ``(i + 1) % decoder_sparse_step == 0``, a
dense MLP elsewhere; experts of ``moe_intermediate_size`` plus shared
experts of ``shared_expert_intermediate_size``."""

from harness.spec import MoESpec, pad


def layout(c):
    L, step = c["num_hidden_layers"], c["decoder_sparse_step"]
    kinds = tuple(("attn", "moe" if (i + 1) % step == 0 else "mlp")
                  for i in range(L))
    a = c["assumed"]
    return dict(
        d_ff=c["intermediate_size"] if any(f == "mlp" for _, f in kinds)
        else 0,
        kinds=kinds, rope_theta=float(c["rope_theta"]),
        moe=MoESpec(c["num_experts"], pad(c["num_experts"],
                                          a["moe_pad_experts_to"]),
                    c["num_experts_per_tok"], c["moe_intermediate_size"],
                    c["shared_expert_intermediate_size"],
                    float(a["moe_capacity_factor"])),
        mamba=None)
