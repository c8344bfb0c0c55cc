"""Architecture configuration schema + registry (copy of
``repro.configs.base`` without its JAX import).

Each ported architecture has one module in :mod:`repro_torch.configs`
exporting ``CONFIG``; ``get_config(name)`` resolves by id.  The port
carries every id of :data:`ARCH_IDS` (:data:`PORTED`): the four dense
decoder configs, the two MoE configs, xLSTM, Whisper (encoder-decoder),
Qwen2-VL (vision-language) and the Jamba hybrid (Mamba, attention and
MoE).  Layer stacks are expressed as a repeating *period* of (mixer,
ffn) sublayer pairs plus an optional remainder, so heterogeneous
patterns (Jamba 1:7 attn:mamba with MoE every 2nd layer, Gemma
local:global alternation) scan efficiently.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

# mixer kinds: "attn" (global), "local" (sliding window), "mamba",
#              "mlstm", "slstm"
# ffn kinds:   "mlp", "moe", "none"
Sublayer = Tuple[str, str]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts, Qwen-MoE style
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3
    # Experts padded up to a multiple of this for clean EP sharding; the
    # router masks the padding (see DESIGN.md §8.3).
    pad_to: int = 1
    # Explicit shard_map all-to-all dispatch (models/moe_shard_map.py);
    # GSPMD's gather-based fallback replicates expert compute over the data
    # axis or blows up collectives (EXPERIMENTS.md §Perf).
    a2a: bool = False

    @property
    def padded_experts(self) -> int:
        r = self.n_experts % self.pad_to
        return self.n_experts + (self.pad_to - r if r else 0)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- layer pattern ------------------------------------------------- #
    period: Tuple[Sublayer, ...] = (("attn", "mlp"),)
    # --- attention ----------------------------------------------------- #
    pos_embed: str = "rope"  # rope | sinusoidal (whisper)
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding window for "local" mixers
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    mrope_sections: Optional[Tuple[int, int, int]] = None  # Qwen2-VL M-RoPE
    qk_norm: bool = False
    # --- ffn ------------------------------------------------------------ #
    ffn_act: str = "swiglu"  # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # --- embeddings / output -------------------------------------------- #
    tie_embeddings: bool = True
    scale_embed: bool = False  # Gemma-style sqrt(d_model) input scaling
    # --- enc-dec (whisper) ----------------------------------------------- #
    kind: str = "decoder"  # decoder | encdec
    n_enc_layers: int = 0
    cross_every: int = 1
    # --- vlm stub --------------------------------------------------------- #
    vision_stub: bool = False
    audio_stub: bool = False
    # --- long-context chunking (memory-bounded exact computation) -------- #
    # When set and S > chunk, attention runs in query chunks and SSM/mLSTM
    # scans run chunk-recurrently (exact; bounds temps for 32k+ prefill).
    attn_chunk: Optional[int] = None
    ssm_chunk: Optional[int] = None
    # --- numerics --------------------------------------------------------- #
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    # Adam m/v dtype; the 398B arch needs bf16 states to fit HBM (DESIGN §8).
    opt_state_dtype: str = "float32"
    # --- notes ------------------------------------------------------------- #
    source: str = ""
    sub_quadratic: bool = False  # eligible for long_500k decode

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def remainder(self) -> Tuple[Sublayer, ...]:
        return self.period[: self.n_layers % len(self.period)]

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=max(len(self.period), overrides.pop("n_layers", len(self.period))),
            d_model=overrides.pop("d_model", 64),
            n_heads=overrides.pop("n_heads", 4),
            n_kv_heads=overrides.pop(
                "n_kv_heads", min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1
            ),
            head_dim=overrides.pop("head_dim", 16),
            d_ff=overrides.pop("d_ff", 128 if self.d_ff else 0),
            vocab_size=overrides.pop("vocab_size", 256),
            n_enc_layers=overrides.pop(
                "n_enc_layers", min(self.n_enc_layers, 2)
            ),
            window=overrides.pop("window", 8 if self.window else None),
            param_dtype="float32",
        )
        if self.moe is not None:
            # ample capacity: keeps reduced-config decode/train consistent
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2), pad_to=1, capacity_factor=8.0,
            )
        if self.mrope_sections is not None:
            hd = changes.get("head_dim", 16)
            half = hd // 2
            r = 3 * half // 8
            changes["mrope_sections"] = (half - 2 * r, r, r)
        if self.mamba is not None:
            changes["mamba"] = dataclasses.replace(self.mamba, d_state=8, expand=2)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


ARCH_IDS = [
    "jamba_1p5_large_398b",
    "qwen2_vl_72b",
    "qwen2_moe_a2p7b",
    "olmoe_1b_7b",
    "whisper_large_v3",
    "minitron_8b",
    "gemma3_4b",
    "gemma2_2b",
    "gemma_2b",
    "xlstm_125m",
]


#: the configs the port carries: the dense decoders, the MoE decoders,
#: xLSTM, the encoder-decoder, the vision-language backbone and the
#: Mamba hybrid
PORTED = ("gemma2_2b", "gemma_2b", "gemma3_4b", "minitron_8b",
          "qwen2_moe_a2p7b", "olmoe_1b_7b", "xlstm_125m", "whisper_large_v3",
          "qwen2_vl_72b", "jamba_1p5_large_398b")


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "p")
    if name not in PORTED:
        raise ValueError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
