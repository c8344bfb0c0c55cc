"""The plain reference: the configured model's forward pass in float32
PyTorch, written from the configuration alone.

It imports nothing of the program.  It reads the weights that the
benchmark made (``weights.make_weights``) by name, casting one layer, one
expert, or the head at a time to float32, so that it fits on the card
beside the served bfloat16 weights.  Products run with TF32 off.  What
the program derives from the weights and the tokens (its caches, the
routing, the capacity drops, the Mamba states) the reference works out
again from its own float32 activations.

The equations are the JAX package's (``repro/models``), which the port
follows; where they depart from the published model the configuration
file lists it under ``assumed``:

* RMSNorm ``x / sqrt(mean(x^2) + eps) * (1 + scale)``;
* attention: q, k, v projections, RoPE (rotate-half) at the absolute
  position, causal softmax over the keys at or before each query with
  scale ``hd^-0.5`` and grouped KV heads, the output projection;
* Mamba: ``in_proj`` into the inner stream and the gate, the causal
  depthwise conv plus bias and SiLU, ``x_proj`` into dt's rank, B and C,
  ``dt = softplus(dt_r W + dt_bias)``, ``A = -exp(A_log)``, the
  recurrence ``h_t = exp(dt_t A) h_(t-1) + dt_t x_t B_t``, ``y_t = C_t h_t
  + D x_t``, gated by ``silu(z)``, ``out_proj``; it is run step by step
  in time, in float32;
* SwiGLU MLPs; MoE: float32 router, padding experts masked, softmax,
  top-k renormalised, each expert's assignments kept up to its capacity
  ``int(T k cf / E_padded)`` in token order where the program's call
  drops (prefill), all kept where it is dropless (decode), the kept
  ones weighted by their probability, plus the shared experts as one
  MLP;
* the final norm and the head at the positions asked for.

``precision="fp8"`` is the control: the reference computed in float8
e4m3, the precision below the configurations' bfloat16, wherever the
program keeps bfloat16: every product's two inputs (a scale a row of
the activations, a scale a column of the weights), the residual stream
after each sublayer, the norms' outputs, attention's q, k, v and
weights, Mamba's streams (the inner stream and gate, the conv's output,
dt, dt x, B and C) and the logits, each rounded to fp8 with a scale a
row; accumulation, softmax, the router's logits and the scan's state
stay float32, as the program keeps them.  ``precision="bf16"`` rounds
at the same points to bfloat16: the program's own precision, a witness
that what separates the program from the float32 reference is its
precision and not its code.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .spec import ModelSpec

__all__ = ["Reference", "LayerState", "no_tf32", "state_rows"]

f32 = torch.float32
#: elements of a score block or a scan chunk's temporaries (256 MB)
_BLOCK = 1 << 26


@contextlib.contextmanager
def no_tf32():
    """Float32 products at full precision inside (TF32 off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


class LayerState(NamedTuple):
    """A layer's state after a segment: attention's K and V (B, P, nkv,
    hd), or Mamba's last ``d_conv - 1`` raw inner inputs and its ssm
    state (B, d_inner, d_state); all float32."""

    a: torch.Tensor
    b: torch.Tensor


def _bf16(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.to(torch.bfloat16).to(f32)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(f32) * s


class Reference:
    def __init__(self, spec: ModelSpec, weights: Dict[Tuple, torch.Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.spec, self.w, self.precision = spec, weights, precision

    # -- pieces --------------------------------------------------------- #
    def _f(self, *path) -> torch.Tensor:
        return self.w[path].to(f32)

    def _q(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """``t`` rounded to the reference's precision (a scale a slice
        along ``dim`` for fp8); unchanged in float32."""
        if self.precision == "float32":
            return t
        return (_fp8 if self.precision == "fp8" else _bf16)(t, dim)

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) @ w (k, n), float32 accumulation of the rounded
        inputs."""
        return self._q(x, -1) @ self._q(w, 0)

    def _norm(self, x: torch.Tensor, *path) -> torch.Tensor:
        var = x.square().mean(-1, keepdim=True)
        return self._q(x * torch.rsqrt(var + self.spec.eps)
                       * (1.0 + self._f(*path)))

    def _swiglu(self, x: torch.Tensor, wi: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
        d, _, f = wi.shape
        h = self._mm(x, wi.reshape(d, 2 * f)).unflatten(-1, (2, f))
        return self._q(self._mm(F.silu(h[..., 0, :]) * h[..., 1, :], wo))

    def _rope(self, t: torch.Tensor, pos0: int) -> torch.Tensor:
        """Rotate-half RoPE of t (B, L, heads, hd) at positions pos0..;
        angles in float64."""
        L, hd = t.shape[1], t.shape[-1]
        freqs = 1.0 / self.spec.rope_theta ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=t.device)
            / hd)
        pos = torch.arange(pos0, pos0 + L, dtype=torch.float64,
                           device=t.device)
        ang = pos[:, None] * freqs
        cos = ang.cos().to(f32)[None, :, None, :]
        sin = ang.sin().to(f32)[None, :, None, :]
        x1, x2 = t[..., :hd // 2], t[..., hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    # -- mixers ---------------------------------------------------------- #
    def _attn(self, i: int, x: torch.Tensor, st: Optional[LayerState],
              pos0: int) -> Tuple[torch.Tensor, LayerState]:
        s = self.spec
        B, L, d = x.shape
        nq, nkv, hd = s.n_heads, s.n_kv, s.hd
        g = nq // nkv
        p = ("layers", i, "mixer")
        q = self._mm(x, self._f(*p, "wq").reshape(d, nq * hd))
        k = self._mm(x, self._f(*p, "wk").reshape(d, nkv * hd))
        v = self._mm(x, self._f(*p, "wv").reshape(d, nkv * hd))
        q = self._q(self._rope(q.view(B, L, nq, hd), pos0))
        k = self._q(self._rope(k.view(B, L, nkv, hd), pos0))
        v = self._q(v.view(B, L, nkv, hd))
        if st is not None:
            k, v = torch.cat([st.a, k], 1), torch.cat([st.b, v], 1)
        Lk = k.shape[1]
        out = torch.empty(B, L, nq, hd, dtype=f32, device=x.device)
        qpos = torch.arange(pos0, pos0 + L, device=x.device)
        kpos = torch.arange(Lk, device=x.device)
        cq = max(1, min(L, _BLOCK // max(B * g * Lk, 1)))
        scale = hd ** -0.5
        for j in range(nkv):
            kj = k[:, :, j].transpose(1, 2)  # (B, hd, Lk)
            vj = v[:, :, j]  # (B, Lk, hd)
            for s0 in range(0, L, cq):
                s1 = min(L, s0 + cq)
                end = pos0 + s1  # keys past the chunk's last query: masked
                qc = q[:, s0:s1, j * g:(j + 1) * g].transpose(1, 2)
                sc = (qc @ kj[:, None, :, :end]) * scale  # (B, g, c, end)
                mask = kpos[None, :end] <= qpos[s0:s1, None]
                sc = sc.masked_fill(~mask, float("-inf"))
                w = self._q(torch.softmax(sc, dim=-1))
                out[:, s0:s1, j * g:(j + 1) * g] = (
                    w @ vj[:, None, :end]).transpose(1, 2)
        o = self._mm(out.reshape(B, L, nq * hd),
                     self._f(*p, "wo").reshape(nq * hd, d))
        return self._q(o), LayerState(k, v)

    def _mamba(self, i: int, x: torch.Tensor,
               st: Optional[LayerState]) -> Tuple[torch.Tensor, LayerState]:
        m = self.spec.mamba
        B, L, d = x.shape
        di, n, dc, r = m.d_inner, m.d_state, m.d_conv, m.dt_rank
        p = ("layers", i, "mixer")
        h = self._mm(x, self._f(*p, "in_proj").reshape(d, 2 * di))
        xi, z = self._q(h[..., :di]), self._q(h[..., di:])
        prev = (st.a if st is not None
                else x.new_zeros(B, dc - 1, di))
        xpad = torch.cat([prev, xi], 1)  # (B, dc - 1 + L, di)
        w = self._f(*p, "conv_w")
        xc = xpad[:, :L] * w[0]
        for j in range(1, dc):
            xc = xc + xpad[:, j:j + L] * w[j]
        xc = self._q(F.silu(xc + self._f(*p, "conv_b")))
        proj = self._mm(xc, self._f(*p, "x_proj"))
        proj = self._q(proj)
        dt_r, Bm, Cm = proj.split([r, n, n], dim=-1)
        dt = self._q(F.softplus(self._mm(dt_r, self._f(*p, "dt_proj"))
                                + self._f(*p, "dt_bias")))
        A = -torch.exp(self._f(*p, "A_log"))  # (di, n)
        hstate = (st.b.clone() if st is not None
                  else x.new_zeros(B, di, n))
        y = torch.empty(B, L, di, dtype=f32, device=x.device)
        c = max(1, min(L, _BLOCK // (B * di * n)))
        u = self._q(dt * xc)
        for t0 in range(0, L, c):
            t1 = min(L, t0 + c)
            a = torch.exp(dt[:, t0:t1, :, None] * A)  # (B, c, di, n)
            b = u[:, t0:t1, :, None] * Bm[:, t0:t1, None, :]
            hs = torch.empty_like(a)
            for t in range(t1 - t0):
                torch.addcmul(b[:, t], a[:, t], hstate, out=hs[:, t])
                hstate = hs[:, t]
            y[:, t0:t1] = torch.einsum("bcin,bcn->bci", hs, Cm[:, t0:t1])
            hstate = hstate.clone()
            del a, b, hs
        y = (y + self._f(*p, "D") * xc) * F.silu(z)
        out = self._q(self._mm(y, self._f(*p, "out_proj")))
        return out, LayerState(xpad[:, L:].clone() if dc > 1
                               else xpad[:, :0], hstate)

    # -- FFNs ------------------------------------------------------------ #
    def _moe(self, i: int, x: torch.Tensor, capacity: bool) -> torch.Tensor:
        m = self.spec.moe
        B, L, d = x.shape
        T, k = B * L, m.top_k
        p = ("layers", i, "ffn")
        xt = x.reshape(T, d)
        logits = xt @ self._f(*p, "router")
        if m.padded != m.n_experts:
            logits[:, m.n_experts:] = -1e30
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.topk(probs, k, dim=-1)
        top_p = (top_p / top_p.sum(-1, keepdim=True)).reshape(-1)
        flat = top_e.reshape(-1)  # assignment a = token * k + rank
        keep = torch.ones_like(flat, dtype=torch.bool)
        if capacity:
            C = max(int(T * k * m.capacity_factor / m.padded), 1)
            keep[:] = False
            for e in range(m.n_experts):
                keep[(flat == e).nonzero()[:C, 0]] = True
        out = torch.zeros(T, d, dtype=f32, device=x.device)
        wi, wo = self.w[p + ("wi",)], self.w[p + ("wo",)]
        for e in range(m.n_experts):
            sel = ((flat == e) & keep).nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            tok = sel // k
            ye = self._swiglu(xt[tok], wi[e].to(f32), wo[e].to(f32))
            out.index_add_(0, tok, ye * top_p[sel, None])
        if m.shared_ff:
            out += self._swiglu(xt, self._f(*p, "shared", "wi"),
                                self._f(*p, "shared", "wo"))
        return self._q(out).view(B, L, d)

    # -- the model ------------------------------------------------------- #
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                state: Optional[List[LayerState]] = None, pos0: int = 0,
                capacity: bool = True,
                want: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[LayerState]]:
        """Run the segment ``tokens`` (B, L) at positions ``pos0..``
        after ``state`` (the layers' states after positions ``0..pos0-1``;
        None: the segment starts the sequence).  ``capacity``: MoE layers
        drop past capacity over this segment's B * L tokens (a prefill
        call), or keep every assignment (decode).  Returns the float32
        logits at the segment's positions ``want`` (default the last),
        (B, len(want), vocab), and the layers' states after it."""
        s = self.spec
        B, L = tokens.shape
        if want is None:
            want = torch.tensor([L - 1], device=tokens.device)
        with no_tf32():
            x = self._q(self.w[("embed", "embedding")][tokens].to(f32))
            new: List[LayerState] = []
            for i, (mixer, ffn) in enumerate(s.kinds):
                prev = None if state is None else state[i]
                h = self._norm(x, "layers", i, "norm1", "scale")
                if mixer == "attn":
                    o, st = self._attn(i, h, prev, pos0)
                else:
                    o, st = self._mamba(i, h, prev)
                x = self._q(x + o)
                new.append(st)
                h = self._norm(x, "layers", i, "norm2", "scale")
                if ffn == "mlp":
                    x = x + self._swiglu(h, self._f("layers", i, "ffn", "wi"),
                                         self._f("layers", i, "ffn", "wo"))
                else:
                    x = x + self._moe(i, h, capacity)
                x = self._q(x)
                del h, o
            x = self._norm(x[:, want], "final_norm", "scale")
            head = (self._f("embed", "embedding").t() if s.tie
                    else self._f("embed", "unembed"))
            logits = self._q(self._mm(x, head))
        return logits, new


def state_rows(state: List[LayerState], rows: torch.Tensor
               ) -> List[LayerState]:
    """The states of the batch rows ``rows``."""
    return [LayerState(st.a[rows], st.b[rows]) for st in state]

