"""xLSTM blocks: mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory, sequential exponential gating).  [arXiv:2405.04517]

Counterpart of ``repro.models.xlstm``, with the same parameter trees, the
same order of operations and the same dtype points: q/k/v are projected in
the parameter dtype and cast to float32 for the gates, the decay matrix
and the states; the block's output is cast back to the input's dtype.

The mLSTM parallel form follows the paper's stabilised formulation:
cumulative log forget gates build a decay matrix D; y = ((QK^T/sqrt(d)) ⊙
D̃) V with a max stabiliser and |n| normalisation.  With ``cfg.ssm_chunk``
dividing S it runs chunk-recurrently, carrying an exact (C, n, m) state
between chunks.  Decode keeps (C, n, m) per head and is O(1) a token.

The sLSTM is sequential (recurrent gate connections): its prefill is a
Python loop over time, the counterpart of the reference's ``lax.scan``;
decode is one step.  The states are NamedTuples of float32 tensors on the
model's device.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import ParamSpec

__all__ = ["MLSTMState", "SLSTMState", "mlstm_spec", "mlstm_block",
           "mlstm_final_state", "mlstm_block_with_state", "init_mlstm_state",
           "mlstm_decode", "slstm_spec", "init_slstm_state", "slstm_block",
           "slstm_block_with_state", "slstm_decode"]

f32 = torch.float32


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    d_inner = 2 * cfg.d_model
    hd = d_inner // cfg.n_heads
    return d_inner, hd


def _scale(hd: int, device) -> torch.Tensor:
    return torch.tensor(hd ** -0.5, dtype=f32, device=device)


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, nh, hd, hd) matrix memory
    n: torch.Tensor  # (B, nh, hd) normalizer
    m: torch.Tensor  # (B, nh) stabilizer


def mlstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_inner, hd = _dims(cfg)
    nh = cfg.n_heads
    return {
        "wqkv": ParamSpec((d, 3, nh, hd), ("embed", None, "heads", "head_dim")),
        "wif": ParamSpec((d, 2, nh), ("embed", None, "heads")),  # i/f gates
        "wz": ParamSpec((d, d_inner), ("embed", "inner")),  # output gate path
        "wo": ParamSpec((d_inner, d), ("inner", "embed")),
    }


def _qkvif(cfg: ModelConfig, params, x: torch.Tensor):
    """q, k, v (B, S, nh, hd) in x's dtype; i/f gate pre-activations
    (B, S, nh) in float32."""
    wqkv, wif = params["wqkv"], params["wif"]
    d, _, nh, hd = wqkv.shape
    qkv = (x @ wqkv.reshape(d, 3 * nh * hd)).unflatten(-1, (3, nh, hd))
    q, k, v = qkv.unbind(2)
    gif = (x @ wif.reshape(d, 2 * nh)).unflatten(-1, (2, nh)).to(f32)
    ig, fg = gif.unbind(2)
    return q, k, v, ig, fg


def _mlstm_out(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The output gate and down projection of the inner y (B, S, d_inner)."""
    z = F.silu(x @ params["wz"])
    return (y * z) @ params["wo"]


def _mlstm_parallel(qkvif, dtype) -> torch.Tensor:
    """The stabilised parallel form: inner y (B, S, d_inner) in ``dtype``."""
    q, k, v, ig, fg = qkvif
    B, S, nh, hd = q.shape
    logf = F.logsigmoid(fg)  # (B, S, nh)
    Fs = torch.cumsum(logf, dim=1).transpose(1, 2)  # (B, nh, S)
    # D_log[b,n,s,t] = F_s - F_t + i_t   (t <= s)
    Dlog = (Fs[..., :, None] - Fs[..., None, :]
            + ig.transpose(1, 2)[..., None, :])
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    Dlog = torch.where(causal, Dlog, -torch.inf)
    mstab = Dlog.amax(-1, keepdim=True).clamp_min(-1e30)  # (B, nh, S, 1)
    Dmat = torch.exp(Dlog - mstab)  # (B, nh, S, S)
    del Dlog
    scale = _scale(hd, q.device)
    scores = (q.to(f32) * scale).transpose(1, 2) @ k.to(f32).permute(0, 2, 3, 1)
    W = scores * Dmat
    del scores, Dmat
    norm = W.sum(-1, keepdim=True).abs()
    norm = torch.maximum(norm, torch.exp(-mstab))  # max(|n q|, e^{-m})
    y = (W / norm) @ v.to(f32).transpose(1, 2)  # (B, nh, S, hd)
    return y.transpose(1, 2).reshape(B, S, nh * hd).to(dtype)


def _mlstm_chunks(cfg: ModelConfig, params, x: torch.Tensor, chunk: int,
                  qkvif=None) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunk-recurrent mLSTM: (inner y (B, S, d_inner), final state)."""
    B, S, _ = x.shape
    d_inner, hd = _dims(cfg)
    q, k, v, ig, fg = qkvif if qkvif is not None else _qkvif(cfg, params, x)
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    scale = _scale(hd, x.device)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    C0, n0, m0 = init_mlstm_state(cfg, B, x.device)
    ys = []
    for start in range(0, S, chunk):
        sl = slice(start, start + chunk)
        qi, ki, vi = q[:, sl], k[:, sl], v[:, sl]  # (B, chunk, nh, hd)
        logf = F.logsigmoid(fg[:, sl])  # (B, chunk, nh)
        Fc = torch.cumsum(logf, dim=1).transpose(1, 2)  # (B, nh, chunk)
        igT = ig[:, sl].transpose(1, 2)  # (B, nh, chunk)
        # intra-chunk log weights (B, nh, t, j)
        Dlog = Fc[..., :, None] - Fc[..., None, :] + igT[..., None, :]
        Dlog = torch.where(causal, Dlog, -torch.inf)
        intra_max = Dlog.amax(-1)  # (B, nh, chunk)
        inter_log = Fc + m0[..., None]  # carried-state weight
        m_t = torch.maximum(intra_max, inter_log).clamp_min(-1e30)
        w_intra = torch.exp(Dlog - m_t[..., None])
        w_inter = torch.exp(inter_log - m_t)  # (B, nh, chunk)
        scores = torch.einsum("btnh,bjnh->bntj", qi * scale, ki)
        Wm = scores * w_intra
        num = torch.einsum("bntj,bjnh->btnh", Wm, vi)
        num = num + torch.einsum("btnh,bnhk->btnk",
                                 w_inter.transpose(1, 2)[..., None] * qi, C0)
        den = Wm.sum(-1) + w_inter * torch.einsum("btnh,bnh->bnt", qi, n0)
        den = torch.maximum(den.abs(), torch.exp(-m_t)).transpose(1, 2)
        ys.append(num / den[..., None])  # (B, chunk, nh, hd)
        # end-of-chunk state
        FL = Fc[..., -1]  # (B, nh)
        logw_end = FL[..., None] - Fc + igT  # (B, nh, chunk)
        m_end = torch.maximum(FL + m0, logw_end.amax(-1))
        w_end = torch.exp(logw_end - m_end[..., None])
        carry_w = torch.exp(FL + m0 - m_end)  # (B, nh)
        kw = (ki * scale) * w_end.transpose(1, 2)[..., None]
        C0 = carry_w[..., None, None] * C0 + torch.einsum(
            "bjnh,bjnk->bnhk", kw, vi)
        n0 = carry_w[..., None] * n0 + kw.sum(1)
        m0 = m_end
    y = torch.cat(ys, dim=1).reshape(B, S, d_inner).to(x.dtype)
    return y, MLSTMState(C0, n0, m0)


def _chunked(cfg: ModelConfig, S: int) -> bool:
    chunk = cfg.ssm_chunk
    return chunk is not None and S > chunk and S % chunk == 0


def mlstm_block(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Parallel form for train/prefill; chunk-recurrent when
    ``cfg.ssm_chunk`` divides S (bounding the (B, nh, S, S) temporaries to
    (B, nh, chunk, chunk))."""
    if _chunked(cfg, x.shape[1]):
        y, _ = _mlstm_chunks(cfg, params, x, cfg.ssm_chunk)
    else:
        y = _mlstm_parallel(_qkvif(cfg, params, x), x.dtype)
    return _mlstm_out(params, x, y)


def _final_state(qkvif) -> MLSTMState:
    q, k, v, ig, fg = qkvif
    hd = q.shape[-1]
    logf = F.logsigmoid(fg)
    Fc = torch.cumsum(logf, dim=1)
    FS = Fc[:, -1:]  # (B, 1, nh)
    logw = (FS - Fc + ig).transpose(1, 2)  # (B, nh, S)
    m = logw.amax(-1)
    w = torch.exp(logw - m[..., None])
    ks = k.to(f32) * _scale(hd, k.device)
    kw = ks * w.transpose(1, 2)[..., None]  # (B, S, nh, hd)
    C = torch.einsum("bsnh,bsnk->bnhk", kw, v.to(f32))
    return MLSTMState(C=C, n=kw.sum(1), m=m)


def mlstm_final_state(cfg: ModelConfig, params, x: torch.Tensor
                      ) -> MLSTMState:
    """Final (C, n, m) for the prefill -> decode handoff (chunked when
    set)."""
    if _chunked(cfg, x.shape[1]):
        return _mlstm_chunks(cfg, params, x, cfg.ssm_chunk)[1]
    return _final_state(_qkvif(cfg, params, x))


def mlstm_block_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, MLSTMState]:
    """:func:`mlstm_block` and :func:`mlstm_final_state` of the same x,
    sharing the projections (the reference computes them twice, with the
    same result)."""
    qkvif = _qkvif(cfg, params, x)
    if _chunked(cfg, x.shape[1]):
        y, state = _mlstm_chunks(cfg, params, x, cfg.ssm_chunk, qkvif)
    else:
        y = _mlstm_parallel(qkvif, x.dtype)
        state = _final_state(qkvif)
    return _mlstm_out(params, x, y), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    _, hd = _dims(cfg)
    nh = cfg.n_heads
    return MLSTMState(
        C=torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, nh, hd), dtype=f32, device=device),
        m=torch.full((batch, nh), -1e30, dtype=f32, device=device),
    )


def mlstm_decode(cfg: ModelConfig, params, x: torch.Tensor,
                 state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """O(1) recurrent step.  x: (B, 1, d)."""
    B = x.shape[0]
    d_inner, hd = _dims(cfg)
    q, k, v, ig, fg = _qkvif(cfg, params, x)
    q, k, v = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
    ig, logf = ig[:, 0], F.logsigmoid(fg[:, 0])  # (B, nh)
    m_new = torch.maximum(logf + state.m, ig)
    fe = torch.exp(logf + state.m - m_new)[..., None]
    ie = torch.exp(ig - m_new)[..., None]
    scale = _scale(hd, x.device)
    ks = ie * k * scale  # (B, nh, hd)
    C_new = fe[..., None] * state.C + ks[..., :, None] * v[..., None, :]
    n_new = fe * state.n + ks
    num = torch.einsum("bnhk,bnh->bnk", C_new, q)
    den = torch.maximum((n_new * q).sum(-1).abs()[..., None],
                        torch.exp(-m_new)[..., None])
    y = (num / den).reshape(B, 1, d_inner).to(x.dtype)
    return _mlstm_out(params, x, y), MLSTMState(C_new, n_new, m_new)


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, d_inner)
    n: torch.Tensor  # (B, d_inner)
    h: torch.Tensor  # (B, d_inner) recurrent input
    m: torch.Tensor  # (B, d_inner) stabilizer


def slstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    d_inner, hd = _dims(cfg)
    nh = cfg.n_heads
    return {
        # 4 gates (i, f, z, o) from input ...
        "wx": ParamSpec((d, 4, d_inner), ("embed", None, "inner")),
        # ... plus head-block-diagonal recurrence from h_{t-1}
        "wr": ParamSpec((nh, hd, 4, hd), ("heads", "head_dim", None, None)),
        "bias": ParamSpec((4, d_inner), (None, "inner"), init="zeros"),
        "wo": ParamSpec((d_inner, d), ("inner", "embed")),
    }


def _slstm_step(wr32: torch.Tensor, bias: torch.Tensor, xt: torch.Tensor,
                st: SLSTMState) -> SLSTMState:
    """xt: (B, 4, d_inner) precomputed input projections; wr32 the
    recurrence in float32 (the state's dtype, to which the reference's
    mixed-type einsum promotes)."""
    nh, hd = wr32.shape[0], wr32.shape[1]
    B = xt.shape[0]
    hprev = st.h.reshape(B, nh, hd).transpose(0, 1)  # (nh, B, hd)
    rec = torch.bmm(hprev, wr32.reshape(nh, hd, 4 * hd))  # (nh, B, 4*hd)
    rec = rec.view(nh, B, 4, hd).permute(1, 2, 0, 3).reshape(B, 4, nh * hd)
    pre = (xt + rec + bias[None]).to(f32)
    ig, fg, zg, og = pre.unbind(1)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + st.m, ig)
    i_e = torch.exp(ig - m_new)
    f_e = torch.exp(logf + st.m - m_new)
    c_new = f_e * st.c + i_e * torch.tanh(zg)
    n_new = f_e * st.n + i_e
    h_new = torch.sigmoid(og) * c_new / n_new.clamp_min(1e-6)
    return SLSTMState(c_new, n_new, h_new, m_new)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    d_inner, _ = _dims(cfg)
    z = torch.zeros((batch, d_inner), dtype=f32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d_inner), -1e30,
                                          dtype=f32, device=device))


def _in_proj(params, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dgi->bsgi", x, wx)``: (B, S, 4, d_inner)."""
    wx = params["wx"]
    d, _, di = wx.shape
    return (x @ wx.reshape(d, 4 * di)).unflatten(-1, (4, di))


def slstm_block_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, SLSTMState]:
    """The sequential scan over time (sLSTM is not parallelisable): the
    block's output and its final state."""
    B, S, _ = x.shape
    xp = _in_proj(params, x)  # (B, S, 4, d_inner)
    wr32, bias = params["wr"].to(f32), params["bias"]
    st = init_slstm_state(cfg, B, x.device)
    hs: List[torch.Tensor] = []
    for t in range(S):
        st = _slstm_step(wr32, bias, xp[:, t], st)
        hs.append(st.h)
    h = torch.stack(hs, dim=1).to(x.dtype)  # (B, S, d_inner)
    return h @ params["wo"], st


def slstm_block(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    return slstm_block_with_state(cfg, params, x)[0]


def slstm_decode(cfg: ModelConfig, params, x: torch.Tensor,
                 state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    xt = _in_proj(params, x[:, :1])[:, 0]  # (B, 4, d_inner)
    st2 = _slstm_step(params["wr"].to(f32), params["bias"], xt, state)
    out = st2.h.to(x.dtype) @ params["wo"]
    return out[:, None, :], st2
