"""Anderson acceleration / DIIS with the paper's residual-decrease safeguard.

Implements the coordinator-level accelerator of paper §3.2/§3.4: keep a window
of the last ``m+1`` iterates ``x_j``, their map values ``g_j = G(x_j)`` and
residuals ``f_j`` (default ``g_j - x_j``), and solve the paper's Eq. (2)

    min_alpha || sum_j alpha_j f_j ||_2   s.t.  sum_j alpha_j = 1,

via the classic DIIS/KKT system with relative Tikhonov regularization.  The
extrapolated iterate is

    x_acc = sum_j alpha_j * ((1 - beta) * x_j + beta * g_j)

so ``beta=1`` is undamped Anderson(m) and ``beta=0`` is classic
iterate-space DIIS mixing.  The safeguard (paper Eq. 5) is applied by the
*caller* (the coordinator), because it requires an extra residual
evaluation: accept ``x_acc`` only if ``res(x_acc) < res(x)``.

Window on the device
--------------------
The ``2(m+1) x n`` sliding buffers are float64 tensors on the state's
device (the problem's, passed by the coordinator).  Fed to a kernel on the
card, a host window would cross PCIe on every fire (400 MB at h=6,
n=4.2M), so ``push`` copies the two host vectors in and forms ``f = g - x``
on the device, the Gram ``B = F Fᵀ`` is one ``torch.matmul`` there, only
the ``(h+1)²`` KKT solve runs on the host, and the combine goes through
:func:`repro_torch.kernels.ops.anderson_mix` at ``n >= mix_kernel_n``.
``propose`` returns host numpy (the coordinator contract).  The live rows
are always one contiguous oldest-first block (compacted on wrap), so the
window views the kernel reads are contiguous.

``gram="incremental"`` keeps ``B`` on the host, updated by one rank-1
row/column (a GEMV on the device) per ``push``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .._device import resolve_device, to_device, to_host
from ..kernels import ops

__all__ = ["AndersonConfig", "AndersonState", "diis_solve"]

#: auto-dispatch threshold for the CUDA combine (not measured on the card:
#: the reference's TPU value, kept until a card measurement replaces it)
_MIX_KERNEL_AUTO_N = 1 << 18


@dataclass
class AndersonConfig:
    """Configuration of the coordinator-level accelerator.

    Attributes:
      m: window size; the history keeps the last ``m + 1`` (x, g, f) triples.
      beta: mixing parameter in [0, 1]; 1.0 = undamped AA-II / Anderson form.
      reg: relative Tikhonov regularization of the DIIS normal matrix; guards
        against the near-rank-deficient histories produced by asynchronous
        composite iterates (paper §3.4).
      safeguard: enforce paper Eq. 5 (performed by the caller).
      restart_on_reject: drop the history window when the safeguard rejects
        an extrapolation (fresh subspace after iterate corruption).
      max_coeff: conditioning guard — reject proposals with ||alpha||_1
        above this (used in addition to, not instead of, Eq. 5).
      gram: ``"exact"`` rebuilds ``B = F Fᵀ`` from the contiguous window per
        fire; ``"incremental"`` maintains ``B`` with one rank-1 row/column
        update per push (O(h·n) fires, last-ulp differences).
      mix_kernel_n: state size at or above which the combine runs through
        :func:`repro_torch.kernels.ops.anderson_mix`.  ``None`` (default)
        means auto: ``n >= 2**18`` when the window is on CUDA, never on the
        CPU.  Set an explicit int to force the wrapper (tests use this).
    """

    m: int = 5
    beta: float = 1.0
    reg: float = 1e-10
    safeguard: bool = True
    restart_on_reject: bool = False
    max_coeff: float = 1e8
    gram: str = "exact"
    mix_kernel_n: Optional[int] = None

    def __post_init__(self) -> None:
        if self.gram not in ("exact", "incremental"):
            raise ValueError(
                f"gram must be 'exact' or 'incremental', got {self.gram!r}")


def _solve_kkt(B: np.ndarray, reg: float) -> np.ndarray:
    """Solve the DIIS KKT system given the Gram matrix ``B = F Fᵀ``."""
    h = B.shape[0]
    scale = max(np.trace(B) / h, 1e-300)
    # KKT system [[B + reg*I, 1], [1^T, 0]] [alpha; lam] = [0; 1]
    A = np.zeros((h + 1, h + 1))
    A[:h, :h] = B + (reg * scale) * np.eye(h)
    A[:h, h] = 1.0
    A[h, :h] = 1.0
    rhs = np.zeros(h + 1)
    rhs[h] = 1.0
    try:
        sol = np.linalg.solve(A, rhs)
    except np.linalg.LinAlgError:
        sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    return sol[:h]


def diis_solve(F, reg: float) -> np.ndarray:
    """Solve Eq. (2): min ||alpha @ F|| s.t. sum(alpha) = 1.

    Args:
      F: (h, n) residual history (tensor or array), oldest first.
      reg: relative Tikhonov regularization.

    Returns:
      alpha: (h,) simplex-constrained coefficients (host numpy).
    """
    return _solve_kkt(_gram(torch.as_tensor(F, dtype=torch.float64)), reg)


def _gram(F: torch.Tensor) -> np.ndarray:
    """``F Fᵀ`` as host numpy.  On the CPU it is numpy's product of the
    zero-copy ``.numpy()`` views, the reference's float operations in the
    reference's order (a torch matmul differs in the last place, and the
    async accelerated Jacobi trajectory amplifies that); on CUDA it is one
    device matmul."""
    if F.device.type == "cpu":
        Fn = F.numpy()
        return Fn @ Fn.T
    return to_host(F @ F.T)


def _gram_row(W: torch.Tensor, f: torch.Tensor) -> np.ndarray:
    """``W f`` (one incremental Gram row) as host numpy; numpy's GEMV on
    the CPU, as :func:`_gram`."""
    if W.device.type == "cpu":
        return W.numpy() @ f.numpy()
    return to_host(W @ f)


@dataclass
class AndersonState:
    """Mutable coordinator-side accelerator state (history window).

    ``device`` holds the window (None: the default device, the card).
    ``xs``/``gs``/``fs`` return host copies of the live rows, for
    introspection and tests; the hot path never materializes them.
    """

    config: AndersonConfig
    device: Optional[torch.device] = None
    n_accept: int = 0
    n_reject: int = 0
    n_fire: int = 0
    last_alpha: Optional[np.ndarray] = None
    # --- sliding-window storage (lazily allocated on first push) -------- #
    _X: Optional[torch.Tensor] = field(default=None, repr=False)
    _G: Optional[torch.Tensor] = field(default=None, repr=False)
    _F: Optional[torch.Tensor] = field(default=None, repr=False)
    _B: Optional[np.ndarray] = field(default=None, repr=False)
    _scr1: Optional[torch.Tensor] = field(default=None, repr=False)
    _scr2: Optional[torch.Tensor] = field(default=None, repr=False)
    _start: int = 0
    _len: int = 0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # ----------------------------------------------------------------- #
    # Window storage
    # ----------------------------------------------------------------- #
    @property
    def depth(self) -> int:
        return self._len

    @property
    def xs(self) -> List[np.ndarray]:
        """Oldest-first iterate history (host copies)."""
        return list(to_host(self._window(self._X))) if self._len else []

    @property
    def gs(self) -> List[np.ndarray]:
        return list(to_host(self._window(self._G))) if self._len else []

    @property
    def fs(self) -> List[np.ndarray]:
        return list(to_host(self._window(self._F))) if self._len else []

    def _window(self, buf: torch.Tensor) -> torch.Tensor:
        """Contiguous oldest-first (h, n) view of the live window."""
        return buf[self._start:self._start + self._len]

    def _alloc(self, n: int) -> None:
        cap = 2 * (self.config.m + 1)
        kw = dict(dtype=torch.float64, device=self.device)
        self._X = torch.empty((cap, n), **kw)
        self._G = torch.empty((cap, n), **kw)
        self._F = torch.empty((cap, n), **kw)
        self._scr1 = torch.empty((self.config.m + 1, n), **kw)
        self._scr2 = torch.empty((self.config.m + 1, n), **kw)
        if self.config.gram == "incremental":
            self._B = np.zeros((self.config.m + 1, self.config.m + 1))
        self._start = self._len = 0

    def push(
        self, x: np.ndarray, g: np.ndarray, f: Optional[np.ndarray] = None
    ) -> None:
        """Record an (iterate, map value, residual) triple; keeps last m+1.

        ``f`` defaults to ``g - x``, computed on the device straight into
        its row.  Cost: two (three with ``f``) host-to-device row copies
        plus, in ``gram="incremental"`` mode, one (h, n) GEMV.
        """
        x = np.asarray(x, dtype=np.float64)
        g = np.asarray(g, dtype=np.float64)
        if x.ndim != 1 or g.shape != x.shape:
            raise ValueError(f"expected matching 1-D x/g, got {x.shape} "
                             f"and {g.shape}")
        if self._X is None or self._X.shape[1] != x.shape[0]:
            self._alloc(x.shape[0])
        m1 = self.config.m + 1
        if self._len == m1:  # evict the oldest triple
            self._start += 1
            self._len -= 1
            if self._B is not None:  # shift the window-ordered Gram up-left
                self._B[:-1, :-1] = self._B[1:, 1:].copy()
        if self._start + self._len == self._X.shape[0]:  # wrap: compact
            h = self._len
            for buf in (self._X, self._G, self._F):
                # rows never overlap: start == cap - h >= m + 2 > h
                buf[:h] = buf[self._start:self._start + h]
            self._start = 0
        row = self._start + self._len
        self._X[row].copy_(to_device(x, self.device))
        self._G[row].copy_(to_device(g, self.device))
        if f is None:
            torch.sub(self._G[row], self._X[row], out=self._F[row])
        else:
            self._F[row].copy_(to_device(f, self.device))
        self._len += 1
        if self._B is not None:  # rank-1 row/column update with the new f
            h = self._len
            r = _gram_row(self._window(self._F), self._F[row])
            self._B[h - 1, :h] = r
            self._B[:h, h - 1] = r

    def reset(self) -> None:
        self._start = self._len = 0
        self.last_alpha = None

    # ----------------------------------------------------------------- #
    # Checkpointable state
    # ----------------------------------------------------------------- #
    def snapshot(self) -> dict:
        """Counters plus the live window (host numpy, oldest first).
        Scratch buffers and the wrap position are not state."""
        out = {
            "n_accept": int(self.n_accept),
            "n_reject": int(self.n_reject),
            "n_fire": int(self.n_fire),
            "last_alpha": (None if self.last_alpha is None
                           else np.asarray(self.last_alpha,
                                           dtype=np.float64).copy()),
        }
        if self._len:
            out["X"] = to_host(self._window(self._X)).copy()
            out["G"] = to_host(self._window(self._G)).copy()
            out["F"] = to_host(self._window(self._F)).copy()
        return out

    def restore(self, snap: dict) -> None:
        """Inverse of :meth:`snapshot`: the window lands compacted at the
        front of fresh device buffers; the incremental Gram is rebuilt by
        replaying the per-row rank-1 updates.

        A Gram row came out of one GEMV over the window the row was pushed
        into, with the new row last, and a GEMV's row results depend on
        their position in it (the BLAS kernels block rows).  So each row is
        replayed at its push-time position, behind zero rows that stand in
        for the rows evicted since: the same bytes as the live run's (the
        reference replays every row from position 0, which differs in the
        last place once the window has evicted).  The push-time window
        sizes follow from ``n_fire`` (one push per fire); with
        ``restart_on_reject`` resets they may not, and a full window then
        replays as if no reset had happened.
        """
        self.n_accept = int(snap["n_accept"])
        self.n_reject = int(snap["n_reject"])
        self.n_fire = int(snap["n_fire"])
        la = snap.get("last_alpha")
        self.last_alpha = None if la is None else np.asarray(la, np.float64)
        X = snap.get("X")
        if X is None:
            self._start = self._len = 0
            return
        X = np.asarray(X, np.float64)
        h, n = X.shape
        self._alloc(n)
        self._X[:h] = to_device(X, self.device)
        self._G[:h] = to_device(snap["G"], self.device)
        self._F[:h] = to_device(snap["F"], self.device)
        self._start, self._len = 0, h
        if self._B is not None:
            m1 = self.config.m + 1
            pushes = self.n_fire if h == m1 else h
            pad = self._scr1  # (m + 1, n) scratch
            for k in range(h):
                H = max(min(pushes - h + 1 + k, m1), k + 1)
                pad[:H - k - 1].zero_()
                pad[H - k - 1:H].copy_(self._F[:k + 1])
                r = _gram_row(pad[:H], self._F[k])[H - k - 1:]
                self._B[k, :k + 1] = r
                self._B[:k + 1, k] = r

    # ----------------------------------------------------------------- #
    # Extrapolation
    # ----------------------------------------------------------------- #
    def propose(self) -> Optional[np.ndarray]:
        """Extrapolate from the current window (host numpy); None if
        degenerate."""
        self.n_fire += 1
        if self._len == 0:
            return None
        beta = self.config.beta
        X = self._window(self._X)
        G = self._window(self._G)
        if self._len == 1:
            return to_host((1.0 - beta) * X[0] + beta * G[0])
        h = self._len
        if self._B is not None:
            B = self._B[:h, :h]
        else:
            B = _gram(self._window(self._F))
        alpha = _solve_kkt(B, self.config.reg)
        if not np.all(np.isfinite(alpha)) or np.abs(alpha).sum() > self.config.max_coeff:
            return None
        self.last_alpha = alpha
        x_acc = to_host(self._combine(X, G, alpha, beta))
        if not np.all(np.isfinite(x_acc)):
            return None
        return x_acc

    def _mix_threshold(self) -> float:
        if self.config.mix_kernel_n is not None:
            return self.config.mix_kernel_n
        return _MIX_KERNEL_AUTO_N if self.device.type == "cuda" else math.inf

    def _combine(self, X: torch.Tensor, G: torch.Tensor, alpha: np.ndarray,
                 beta: float) -> torch.Tensor:
        """x_acc = alpha @ ((1 - beta) * X + beta * G) on the device.

        Above the size threshold the fused kernel wrapper; otherwise one
        GEMV on the window views (with beta = 0/1 fast paths) — no (h, n)
        temporaries beyond the preallocated scratch rows.  On the CPU that
        GEMV is numpy's on the zero-copy ``.numpy()`` views, the
        reference's float operations (a torch GEMV differs in the last
        place, as :func:`_gram` says).
        """
        if X.shape[1] >= self._mix_threshold():
            return ops.anderson_mix(X, G, to_device(alpha, self.device),
                                    beta=float(beta))
        if self.device.type == "cpu":
            return torch.from_numpy(self._combine_numpy(
                X.numpy(), G.numpy(), alpha, beta))
        a = to_device(alpha, self.device)
        if beta == 1.0:
            return a @ G
        if beta == 0.0:
            return a @ X
        h = X.shape[0]
        s1 = self._scr1[:h]
        s2 = self._scr2[:h]
        torch.mul(X, 1.0 - beta, out=s1)
        torch.mul(G, beta, out=s2)
        torch.add(s1, s2, out=s1)
        return a @ s1

    def _combine_numpy(self, X: np.ndarray, G: np.ndarray, alpha: np.ndarray,
                       beta: float) -> np.ndarray:
        """The reference's ``_combine`` below its threshold, on views of the
        CPU window and scratch rows."""
        if beta == 1.0:
            return alpha @ G
        if beta == 0.0:
            return alpha @ X
        h = X.shape[0]
        s1 = self._scr1[:h].numpy()
        s2 = self._scr2[:h].numpy()
        np.multiply(X, 1.0 - beta, out=s1)
        np.multiply(G, beta, out=s2)
        np.add(s1, s2, out=s1)
        return alpha @ s1

    # ----------------------------------------------------------------- #
    def record_accept(self) -> None:
        self.n_accept += 1

    def record_reject(self) -> None:
        self.n_reject += 1
        if self.config.restart_on_reject:
            self.reset()
