"""Jamba's layer pattern (``model_type`` ``jamba``): attention where
``i % attn_layer_period == attn_layer_offset``, Mamba elsewhere; MoE
where ``i % expert_layer_period == expert_layer_offset``, a dense MLP
elsewhere; ``d_inner = mamba_expand * hidden_size``."""

from harness.spec import MambaSpec, MoESpec, pad


def layout(c):
    L = c["num_hidden_layers"]
    kinds = tuple(
        ("attn" if i % c["attn_layer_period"] == c["attn_layer_offset"]
         else "mamba",
         "moe" if i % c["expert_layer_period"] == c["expert_layer_offset"]
         else "mlp")
        for i in range(L))
    a = c["assumed"]
    return dict(
        d_ff=c["intermediate_size"], kinds=kinds,
        rope_theta=float(a["rope_theta"]),
        moe=MoESpec(c["num_experts"], pad(c["num_experts"],
                                          a["moe_pad_experts_to"]),
                    c["num_experts_per_tok"], c["intermediate_size"], 0,
                    float(a["moe_capacity_factor"])),
        mamba=MambaSpec(c["mamba_d_state"], c["mamba_d_conv"],
                        c["mamba_expand"] * c["hidden_size"],
                        c["mamba_dt_rank"]))
