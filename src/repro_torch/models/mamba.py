"""Mamba (selective SSM) block: a full-sequence scan for training and
prefill, an O(1)-state recurrence for decode.  [arXiv:2312.00752]

Counterpart of ``repro.models.mamba``, with the same parameter tree, the
same order of operations and the same dtype points.  Sequence form:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ;   y_t = C_t . h_t + D x_t

with input-dependent (selective) dt, B, C.  ``dt * xc`` is rounded to the
model's type before the float32 products, ``A = -exp(A_log)`` is float32,
``y + D xc`` is float32 and is cast to the model's type before the
``silu(z)`` gate; the causal depthwise conv is the reference's sum of
shifted products plus ``conv_b``, in its order.

The reference scans with ``jax.lax.associative_scan``.  Here the scan is
``ops.selective_scan``: on the card the hand-written kernel
(``csrc/selective_scan.cu``, one launch a layer giving y and the final
state together), on the CPU the plain doubling scan
(``kernels.ref.selective_scan``, chunk-recurrent when ``cfg.ssm_chunk``
divides S, the reference's rule).  When autograd records a graph through
the scan's inputs (training), the plain version runs on either device.
The reference computes a prefill's output and its final state in two
passes (``_ssm_apply`` and ``_prefill_mamba_state``); the port shares
``in_proj``, the conv and the scan between them
(:func:`mamba_block_with_state`).  Decode is plain PyTorch, the
reference's one recurrence step.

Tensor parallelism along ``"model"`` (the ``inner -> model`` rule):
where a rank's ``conv_b`` holds fewer channels than ``d_inner`` (its
slices, cut by ``transformer.shard_params``), ``in_proj`` is
column-parallel over the inner channels, both halves (the normed input
enters through ``collectives.replicated_param``); the conv, ``dt_bias``,
``A_log``, ``D`` and the scan act on the rank's channels (the
``selective_scan`` kernel at ``(B, S, d_inner / model)``); ``x_proj``
contracts over the split channels, so its ``(..., dt_rank + 2 d_state)``
output is a partial sum that ``collectives.reduce`` completes before
``dt_proj`` (column-parallel) and the scan read it (entering again
through ``replicated_param``: each rank's gradient of it covers its own
channels); ``out_proj`` is row-parallel, followed by ``reduce``.  A
:class:`MambaState` then holds the rank's channels; decode takes the
same steps on one token.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .common import ModelAxis, ParamSpec, enter, leave, model_axis

__all__ = ["MambaState", "mamba_spec", "mamba_block",
           "mamba_block_with_state", "ssm_final_state", "init_mamba_state",
           "mamba_decode"]

f32 = torch.float32


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) trailing inner inputs
    ssm: torch.Tensor  # (B, d_inner, d_state) float32


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    mc = cfg.mamba
    d_inner = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, mc.d_state, mc.d_conv, dt_rank


def mamba_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_inner, d_state, d_conv, dt_rank = _dims(cfg)
    return {
        "in_proj": ParamSpec((d, 2, d_inner), ("embed", None, "inner")),
        "conv_w": ParamSpec((d_conv, d_inner), (None, "inner")),
        "conv_b": ParamSpec((d_inner,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * d_state), ("inner", None)),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "inner")),
        "dt_bias": ParamSpec((d_inner,), ("inner",), init="ones"),
        "A_log": ParamSpec((d_inner, d_state), ("inner", None), init="ones"),
        "D": ParamSpec((d_inner,), ("inner",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("inner", "embed")),
    }


def _split(cfg: ModelConfig, params) -> Optional[ModelAxis]:
    """The ``"model"`` axis when this block's channels are split over
    it."""
    ax = model_axis()
    if ax is None or params["conv_b"].shape[0] == _dims(cfg)[0]:
        return None
    return ax




def _in_proj(params, x: torch.Tensor):
    """The inner stream and the gate, each (..., d_inner) (the rank's
    channels under a split)."""
    w = params["in_proj"]
    d, _, d_inner = w.shape
    h = (x @ w.reshape(d, 2 * d_inner)).unflatten(-1, (2, d_inner))
    return h[..., 0, :], h[..., 1, :]


def _conv(params, xi: torch.Tensor, d_conv: int):
    """The causal depthwise conv and its silu: (xc, the zero-padded
    input (B, d_conv - 1 + S, d_inner))."""
    B, S, d_inner = xi.shape
    xpad = torch.cat([xi.new_zeros(B, d_conv - 1, d_inner), xi], dim=1)
    w = params["conv_w"]
    xc = xpad[:, :S] * w[0]
    for i in range(1, d_conv):
        xc = xc + xpad[:, i:i + S] * w[i]
    return F.silu(xc + params["conv_b"]), xpad


def _ssm_inputs(cfg: ModelConfig, params, xc: torch.Tensor,
                ax: Optional[ModelAxis] = None):
    """Selective parameters from the (conv'd, activated) inner stream:
    dt (softplus, in the model's type), A (float32), B and C (views of
    the ``x_proj`` output, summed over the ranks' channels under a
    split)."""
    _, d_state, _, dt_rank = _dims(cfg)
    proj = xc @ params["x_proj"]
    if ax is not None:
        proj = enter(leave(proj, ax), ax)
    dt_r, Bm, Cm = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"]
                    + params["dt_bias"].to(proj.dtype))
    A = -torch.exp(params["A_log"].to(f32))  # (d_inner, d_state)
    return dt, A, Bm, Cm


def _scan(cfg: ModelConfig, dt, A, Bm, Cm, xc):
    """(y (B, S, d_inner), h_S (B, d_inner, d_state)), both float32:
    ``ops.selective_scan``, or the plain version when autograd records a
    graph through its inputs."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, A, Bm, Cm, xc)):
        return ref.selective_scan(dt, xc, Bm, Cm, A, chunk=cfg.ssm_chunk)
    return ops.selective_scan(dt, xc, Bm, Cm, A, chunk=cfg.ssm_chunk)


def _ssm_apply(cfg: ModelConfig, dt, A, Bm, Cm, xc) -> torch.Tensor:
    """The selective scan's y over the sequence (the reference's
    ``_ssm_apply``)."""
    return _scan(cfg, dt, A, Bm, Cm, xc)[0]


def ssm_final_state(cfg: ModelConfig, dt, A, Bm, xc) -> torch.Tensor:
    """The final hidden state h_S (for the prefill -> decode handoff)."""
    # the state does not read C: B stands in for it
    return _scan(cfg, dt, A, Bm, Bm, xc)[1]


def mamba_block_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, MambaState]:
    """Training / prefill, x (B, S, d): the block's output and its final
    (conv, ssm) state, from one scan."""
    S = x.shape[1]
    _, _, d_conv, _ = _dims(cfg)
    ax = _split(cfg, params)
    xi, z = _in_proj(params, enter(x, ax))
    xc, xpad = _conv(params, xi, d_conv)
    dt, A, Bm, Cm = _ssm_inputs(cfg, params, xc, ax)
    y, h = _scan(cfg, dt, A, Bm, Cm, xc)
    y = y + params["D"].to(f32) * xc.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    # the trailing d_conv - 1 raw inner inputs (copied: not a view that
    # keeps the whole padded stream alive in the cache)
    return leave(y @ params["out_proj"], ax), MambaState(
        conv=xpad[:, S:].clone(), ssm=h)


def mamba_block(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill: the full-sequence block, x (B, S, d)."""
    return mamba_block_with_state(cfg, params, x)[0]


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> MambaState:
    """Zero states of the whole ``d_inner`` channels
    (``transformer.init_caches`` cuts a rank's out of their shapes)."""
    d_inner, d_state, d_conv, _ = _dims(cfg)
    return MambaState(
        conv=torch.zeros(batch, d_conv - 1, d_inner, dtype=dtype,
                         device=device),
        ssm=torch.zeros(batch, d_inner, d_state, dtype=f32, device=device),
    )


def mamba_decode(cfg: ModelConfig, params, x: torch.Tensor,
                 state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """One-token recurrent step, x (B, 1, d)."""
    ax = _split(cfg, params)
    xi, z = _in_proj(params, enter(x[:, 0], ax))  # (B, d_inner)
    window = torch.cat([state.conv, xi[:, None]], dim=1)  # (B, d_conv, di)
    xc = F.silu(torch.einsum("bci,ci->bi", window, params["conv_w"])
                + params["conv_b"])
    dt, A, Bm, Cm = _ssm_inputs(cfg, params, xc, ax)
    a = torch.exp(dt.to(f32)[..., None] * A[None])  # (B, d_inner, d_state)
    b = (dt * xc).to(f32)[..., None] * Bm.to(f32)[:, None, :]
    new_ssm = a * state.ssm + b
    y = torch.einsum("bin,bn->bi", new_ssm, Cm.to(f32))
    y = y + params["D"].to(f32) * xc.to(f32)
    y = y.to(x.dtype) * F.silu(z)
    out = leave(y @ params["out_proj"], ax)[:, None, :]
    return out, MambaState(conv=window[:, 1:], ssm=new_ssm)
