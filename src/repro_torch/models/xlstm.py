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

Tensor parallelism along ``"model"`` (the ``heads`` and ``inner -> model``
rules), where a rank's ``wo`` holds fewer rows than ``d_inner`` (its
slices, cut by ``transformer.shard_params``); the input enters through
``collectives.replicated_param`` and ``wo`` is row-parallel, followed by
``collectives.reduce``:

* mLSTM, heads split: q, k, v and the i/f gates are column-parallel over
  the rank's heads, the parallel and chunked forms run on them, and
  ``wz`` gives the matching ``inner`` columns (``d_inner = nh * hd``,
  head-major).  Heads whole (4 heads on 8 ranks) but ``inner`` split:
  q, k, v are whole on each rank (``wqkv`` and ``wif`` enter through
  ``replicated_param``: each rank's gradient of them is its columns'
  share) and the rank keeps its ``inner`` columns of y for the z gate
  and ``wo``.
* sLSTM, heads split: ``wx`` and ``bias`` column-parallel, ``wr``'s
  block-diagonal recurrence on the rank's heads, no collective inside
  the time loop.  Heads whole: the input projections (and ``bias``) are
  gathered once before the loop, the recurrence runs whole and h is
  sliced for ``wo``.

A state holds what the reference's cache rule gives a rank (``("batch",
"inner", ...)``: the first dimension after the batch that the
``"model"`` size divides is split): the local heads, or for whole heads
an mLSTM's ``C`` and ``n`` along the key dimension (its decode then sums
the partial ``C q`` and ``n q`` over ``"model"``) and an sLSTM's
channels (its decode gathers ``h`` for the recurrence).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed import collectives as coll
from .common import ModelAxis, ParamSpec, enter, leave, model_axis

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


def _split(cfg: ModelConfig, params) -> Optional[ModelAxis]:
    """The ``"model"`` axis when this block's ``inner`` channels are split
    over it (its ``wo`` holds fewer rows than ``d_inner``)."""
    ax = model_axis()
    if ax is None or params["wo"].shape[0] == _dims(cfg)[0]:
        return None
    return ax




def _columns(y: torch.Tensor, ax: ModelAxis, n: int) -> torch.Tensor:
    """This rank's ``n`` columns of the whole ``inner`` y."""
    return y[..., ax.index * n:(ax.index + 1) * n]


def _cut_state(state, ax: Optional[ModelAxis]):
    """The rank's piece of a whole state: each tensor cut along its first
    dimension after the batch that the ``"model"`` size divides (the
    reference's ``("batch", "inner", ...)`` cache rule), else whole."""
    if ax is None:
        return state
    out = []
    for t in state:
        dims = [d for d in range(1, t.ndim) if t.shape[d] % ax.size == 0]
        if dims:
            t = t.narrow(dims[0], ax.index * (t.shape[dims[0]] // ax.size),
                         t.shape[dims[0]] // ax.size).contiguous()
        out.append(t)
    return type(state)(*out)


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


def _qkvif(cfg: ModelConfig, params, x: torch.Tensor,
           ax: Optional[ModelAxis] = None):
    """q, k, v (B, S, nh, hd) in x's dtype; i/f gate pre-activations
    (B, S, nh) in float32 (the rank's heads under a split; whole heads
    under an ``inner`` split read the whole weights, whose gradient is
    summed over ``"model"``)."""
    wqkv, wif = params["wqkv"], params["wif"]
    if ax is not None and wqkv.shape[2] == cfg.n_heads:
        wqkv, wif = enter(wqkv, ax), enter(wif, ax)
    d, _, nh, hd = wqkv.shape
    qkv = (x @ wqkv.reshape(d, 3 * nh * hd)).unflatten(-1, (3, nh, hd))
    q, k, v = qkv.unbind(2)
    gif = (x @ wif.reshape(d, 2 * nh)).unflatten(-1, (2, nh)).to(f32)
    ig, fg = gif.unbind(2)
    return q, k, v, ig, fg


def _mlstm_out(params, x: torch.Tensor, y: torch.Tensor,
               ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """The output gate and down projection of the inner y (B, S, d_inner;
    under a split the rank's columns of it, or the whole y, which it
    slices)."""
    wz = params["wz"]
    if ax is not None and y.shape[-1] != wz.shape[1]:
        y = _columns(y, ax, wz.shape[1])
    z = F.silu(x @ wz)
    return leave((y * z) @ params["wo"], ax)


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
    """Chunk-recurrent mLSTM: (inner y (B, S, nh * hd), final state) of
    the heads ``qkvif`` holds."""
    B, S, _ = x.shape
    q, k, v, ig, fg = qkvif if qkvif is not None else _qkvif(cfg, params, x)
    nh, hd = q.shape[2], q.shape[3]
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    scale = _scale(hd, x.device)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    C0, n0, m0 = _zero_mlstm(B, nh, hd, x.device)
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
    y = torch.cat(ys, dim=1).reshape(B, S, nh * hd).to(x.dtype)
    return y, MLSTMState(C0, n0, m0)


def _chunked(cfg: ModelConfig, S: int) -> bool:
    chunk = cfg.ssm_chunk
    return chunk is not None and S > chunk and S % chunk == 0


def _mlstm(cfg: ModelConfig, params, x: torch.Tensor, state: bool):
    """(output, final state or None) of the block, split over the
    ``"model"`` ranks under a split (see the module docstring)."""
    ax = _split(cfg, params)
    x = enter(x, ax)
    qkvif = _qkvif(cfg, params, x, ax)
    st = None
    if _chunked(cfg, x.shape[1]):
        y, st = _mlstm_chunks(cfg, params, x, cfg.ssm_chunk, qkvif)
    else:
        y = _mlstm_parallel(qkvif, x.dtype)
        if state:
            st = _final_state(qkvif)
    if state and qkvif[0].shape[2] == cfg.n_heads:
        st = _cut_state(st, ax)
    return _mlstm_out(params, x, y, ax), st


def mlstm_block(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Parallel form for train/prefill; chunk-recurrent when
    ``cfg.ssm_chunk`` divides S (bounding the (B, nh, S, S) temporaries to
    (B, nh, chunk, chunk))."""
    return _mlstm(cfg, params, x, False)[0]


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
    if _split(cfg, params) is not None:
        return _mlstm(cfg, params, x, True)[1]
    if _chunked(cfg, x.shape[1]):
        return _mlstm_chunks(cfg, params, x, cfg.ssm_chunk)[1]
    return _final_state(_qkvif(cfg, params, x))


def mlstm_block_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, MLSTMState]:
    """:func:`mlstm_block` and :func:`mlstm_final_state` of the same x,
    sharing the projections (the reference computes them twice, with the
    same result)."""
    return _mlstm(cfg, params, x, True)


def _zero_mlstm(batch: int, nh: int, hd: int, device) -> MLSTMState:
    return MLSTMState(
        C=torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, nh, hd), dtype=f32, device=device),
        m=torch.full((batch, nh), -1e30, dtype=f32, device=device),
    )


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    _, hd = _dims(cfg)
    return _zero_mlstm(batch, cfg.n_heads, hd, device)


def mlstm_decode(cfg: ModelConfig, params, x: torch.Tensor,
                 state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    """O(1) recurrent step.  x: (B, 1, d).  Under a split with whole
    heads whose state holds a slice of the key dimension (``C`` and
    ``n``), the partial ``C q`` and ``n q`` are summed over ``"model"``;
    a whole ``m`` is the same on every rank."""
    B = x.shape[0]
    ax = _split(cfg, params)
    x = enter(x, ax)
    q, k, v, ig, fg = _qkvif(cfg, params, x, ax)
    q, k, v = q[:, 0].to(f32), k[:, 0].to(f32), v[:, 0].to(f32)
    nh, hd = q.shape[1], q.shape[2]
    ig, logf = ig[:, 0], F.logsigmoid(fg[:, 0])  # (B, nh)
    m_new = torch.maximum(logf + state.m, ig)
    fe = torch.exp(logf + state.m - m_new)[..., None]
    ie = torch.exp(ig - m_new)[..., None]
    scale = _scale(hd, x.device)
    ks = ie * k * scale  # (B, nh, hd)
    qk = q
    part = state.C.shape[2] < hd  # this rank's slice of the key dimension
    if part:
        lo = ax.index * state.C.shape[2]
        ks, qk = (t[..., lo:lo + state.C.shape[2]] for t in (ks, q))
    C_new = fe[..., None] * state.C + ks[..., :, None] * v[..., None, :]
    n_new = fe * state.n + ks
    num = torch.einsum("bnhk,bnh->bnk", C_new, qk)
    dot = (n_new * qk).sum(-1)
    if part:
        num, dot = coll.all_reduce_sum(
            torch.cat([num, dot[..., None]], -1), ax.group).split([hd, 1],
                                                                  -1)
        dot = dot[..., 0]
    den = torch.maximum(dot.abs()[..., None], torch.exp(-m_new)[..., None])
    y = (num / den).reshape(B, 1, nh * hd).to(x.dtype)
    return _mlstm_out(params, x, y, ax), MLSTMState(C_new, n_new, m_new)


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


def _recurrence(wr32: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The head-block-diagonal recurrent input (B, 4, nh * hd) from h
    (B, nh * hd)."""
    nh, hd = wr32.shape[0], wr32.shape[1]
    B = h.shape[0]
    hprev = h.reshape(B, nh, hd).transpose(0, 1)  # (nh, B, hd)
    rec = torch.bmm(hprev, wr32.reshape(nh, hd, 4 * hd))  # (nh, B, 4*hd)
    return rec.view(nh, B, 4, hd).permute(1, 2, 0, 3).reshape(B, 4, nh * hd)


def _slstm_step(wr32: torch.Tensor, bias: torch.Tensor, xt: torch.Tensor,
                st: SLSTMState) -> SLSTMState:
    """xt: (B, 4, d_inner) precomputed input projections; wr32 the
    recurrence in float32 (the state's dtype, to which the reference's
    mixed-type einsum promotes)."""
    return _gates(xt, _recurrence(wr32, st.h), bias, st)


def _gates(xt: torch.Tensor, rec: torch.Tensor, bias: torch.Tensor,
           st: SLSTMState) -> SLSTMState:
    """The step from the input projections, the recurrent input and the
    bias of the state's channels."""
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


def _zero_slstm(batch: int, d_inner: int, device) -> SLSTMState:
    z = torch.zeros((batch, d_inner), dtype=f32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d_inner), -1e30,
                                          dtype=f32, device=device))


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    return _zero_slstm(batch, _dims(cfg)[0], device)


def _in_proj(params, x: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dgi->bsgi", x, wx)``: (B, S, 4, d_inner)."""
    wx = params["wx"]
    d, _, di = wx.shape
    return (x @ wx.reshape(d, 4 * di)).unflatten(-1, (4, di))


def _slstm_scan(wr32: torch.Tensor, bias: torch.Tensor, xp: torch.Tensor,
                st: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """The loop over time from ``st``: h at every step (B, S, d_inner),
    float32, and the final state (the dry run traces this loop at two
    lengths and scales it)."""
    hs: List[torch.Tensor] = []
    for t in range(xp.shape[1]):
        st = _slstm_step(wr32, bias, xp[:, t], st)
        hs.append(st.h)
    return torch.stack(hs, dim=1), st


def _gather_inner(t: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The ranks' ``inner`` columns (the last dimension) put together,
    once; each rank's gradient of the whole is its columns' share, so it
    is summed before this rank's piece is taken."""
    return enter(coll.gather(t.movedim(-1, 0), ax.group), ax).movedim(0, -1)


def slstm_block_with_state(cfg: ModelConfig, params, x: torch.Tensor
                           ) -> Tuple[torch.Tensor, SLSTMState]:
    """The sequential scan over time (sLSTM is not parallelisable): the
    block's output and its final state."""
    B = x.shape[0]
    ax = _split(cfg, params)
    x = enter(x, ax)
    xp = _in_proj(params, x)  # (B, S, 4, d_inner)
    wr32, bias = params["wr"].to(f32), params["bias"]
    whole = ax is not None and wr32.shape[0] == cfg.n_heads
    if whole:  # heads whole: gather once, run the recurrence whole
        xp, bias = _gather_inner(xp, ax), _gather_inner(bias, ax)
        wr32 = enter(wr32, ax)
    h, st = _slstm_scan(wr32, bias, xp,
                        _zero_slstm(B, xp.shape[-1], x.device))
    if whole:
        n = params["wo"].shape[0]
        h, st = _columns(h, ax, n), _cut_state(st, ax)
    return leave(h.to(x.dtype) @ params["wo"], ax), st


def slstm_block(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    return slstm_block_with_state(cfg, params, x)[0]


def slstm_decode(cfg: ModelConfig, params, x: torch.Tensor,
                 state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    """One step.  Under a split with whole heads the state holds the
    rank's channels: h is gathered for the recurrence, whose input for
    those channels is kept."""
    ax = _split(cfg, params)
    x = enter(x, ax)
    xt = _in_proj(params, x[:, :1])[:, 0]  # (B, 4, d_inner)
    wr32 = params["wr"].to(f32)
    if ax is not None and wr32.shape[0] == cfg.n_heads:
        rec = _columns(_recurrence(wr32, coll.all_gather(state.h, ax.group,
                                                         -1)),
                       ax, state.h.shape[-1])
        st2 = _gates(xt, rec, params["bias"], state)
    else:
        st2 = _slstm_step(wr32, params["bias"], xt, state)
    out = leave(st2.h.to(x.dtype) @ params["wo"], ax)
    return out[:, None, :], st2
