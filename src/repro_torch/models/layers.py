"""Shared layers: norms, MLPs (gated and 2-matrix), embeddings, RoPE,
M-RoPE and sinusoidal positions.

Counterpart of ``repro.models.layers``.  Pure functions of explicit
params (a dict or :class:`~repro_torch.models.common.ParamTree` with the
reference's keys and einsum layouts: ``wi (d, 2, f)`` for gated MLPs,
``embedding (vocab, d)``), so a parameter tree carried over from the JAX
package needs no transposes.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamSpec

__all__ = ["rmsnorm_spec", "rmsnorm", "mlp_spec", "mlp", "embed_spec",
           "embed", "logits", "rope_freqs", "apply_rope", "apply_mrope",
           "sinusoidal_positions"]

f32 = torch.float32


# --------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------- #
def rmsnorm_spec(d: int) -> Dict:
    return {"scale": ParamSpec((d,), ("embed",), init="zeros")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma-style ``x / rms(x) * (1 + scale)``, computed in float32."""
    dt = x.dtype
    x = x.to(f32)
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].to(f32))).to(dt)


# --------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------- #
def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.ffn_act in ("swiglu", "geglu"):
        return {
            "wi": ParamSpec((d, 2, f), ("embed", None, "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
    return {  # 2-matrix MLP (gelu / relu2)
        "wi": ParamSpec((d, f), ("embed", "ffn")),
        "wo": ParamSpec((f, d), ("ffn", "embed")),
    }


def mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """Gated (SwiGLU/GeGLU) or 2-matrix (GELU/ReLU²) MLP.  GELU is the
    tanh approximation, ``jax.nn.gelu``'s default."""
    wi = params["wi"]
    if act in ("swiglu", "geglu"):
        d, _, f = wi.shape
        h = (x @ wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
        gate, up = h[..., 0, :], h[..., 1, :]
        g = F.silu(gate) if act == "swiglu" else F.gelu(gate,
                                                        approximate="tanh")
        h = g * up
    else:
        h = x @ wi
        if act == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif act == "relu2":
            h = F.relu(h).square()
        else:
            raise ValueError(act)
    return h @ params["wo"]


# --------------------------------------------------------------------- #
# Embeddings / logits
# --------------------------------------------------------------------- #
def embed_spec(cfg: ModelConfig) -> Dict:
    s: Dict = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                                      ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    return s


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embedding"][tokens]
    if cfg.scale_embed:
        # sqrt(d) rounded to x's dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = x @ params["embedding"].T
    else:
        out = x @ params["unembed"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = c * torch.tanh(out / c)
    return out


# --------------------------------------------------------------------- #
# Positions
# --------------------------------------------------------------------- #
def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` rounded to float32, made once per device (a copy
    from the host per call would make the host wait for the stream)."""
    return torch.as_tensor(rope_freqs(hd, theta), dtype=f32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, heads, hd); positions: (..., S) integers.  Frequencies
    in float64 rounded to float32, angles and rotation in float32."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)  # (hd/2,)
    ang = positions[..., None].to(f32) * freqs  # (..., S, hd/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x: (B, S, heads, hd); positions: (B, 3, S),
    the temporal, height and width position ids.  The hd/2 frequency slots
    are split into ``sections`` (summing to hd/2), and each section rotates
    with its own position stream: section 0 with t, 1 with h, 2 with w.
    Angles and rotation in float32, as :func:`apply_rope`."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = _rope_freqs_on(hd, float(theta), x.device)  # (hd/2,)
    sec_id = _section_ids(tuple(sections), x.device)  # (hd/2,)
    pos = positions.to(f32).index_select(1, sec_id)  # (B, hd/2, S)
    ang = pos.transpose(1, 2) * freqs  # (B, S, hd/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: Tuple[int, int, int],
                 device: torch.device) -> torch.Tensor:
    """The position stream (0, 1, 2) of each frequency slot, made once per
    device."""
    return torch.as_tensor(np.repeat(np.arange(3), sections),
                           device=device)


def sinusoidal_positions(S: int, d: int, offset: int = 0) -> np.ndarray:
    """Whisper's (S, d) sinusoidal table in float64: sin on the even
    columns, cos on the odd ones."""
    pos = np.arange(offset, offset + S, dtype=np.float64)[:, None]
    dim = np.arange(0, d, 2, dtype=np.float64)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    out = np.zeros((S, d))
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
