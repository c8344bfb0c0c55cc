"""The port's kernel wrappers against the JAX package's Pallas kernels.

Every case makes its inputs with numpy from a seed and hands the same
arrays to ``repro.kernels.ops`` (Pallas, interpret mode), to
``repro.kernels.ref`` and to ``repro_torch.kernels.ops`` on CPU tensors,
where the wrapper takes its plain PyTorch version.  Tolerances and why:

* Jacobi halo sweeps: values exact — adds and an exact division by 4 in the
  same order on both sides; the norm 1e-12 relative, because the two sum
  the squares in different orders.
* ``jacobi_sweep``: exact in both add orders — the default against the
  Pallas interpret output (same ``((((b+up)+down)+left)+right)*0.25``
  order), ``order="jnp"`` against the reference problem's ``_full_sweep``
  and ``ref_jacobi_sweep`` (same ``(b+(((up+down)+left)+right))/4``);
  1e-14 between the two orders.
* Bellman: 1e-13 — the expectation over successors is a reduction whose
  order differs between XLA's einsum and torch's sum (and the CUDA kernel
  may contract ``R + gamma * ev`` to an FMA).
* ``anderson_mix``: 1e-12 — a dot product over the window, ordered
  differently by XLA and torch.

The hand-written CUDA kernels are held against their plain versions in
``tests/test_torch_cuda.py``, on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.problems  # noqa: E402,F401  (enables jax x64)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a), device=CPU)


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------- #
# fused frozen-halo jacobi block sweeps
# --------------------------------------------------------------------- #
class TestJacobiHaloKernel:
    @pytest.mark.parametrize("rows,g,sweeps", [
        (4, 8, 1),     # minimal
        (5, 33, 3),    # odd grid size, odd block
        (7, 16, 4),    # rows not a divisor of g
        (1, 64, 2),    # single-row block
        (16, 128, 10), # paper-scale sweeps
        (3, 40, 10),   # fewer rows than sweeps
        (25, 100, 10), # the paper's 100 x 100 grid, one of four blocks
        (6, 24, 37),   # more sweeps than one CUDA pass runs (16)
    ])
    def test_matches_pallas(self, rows, g, sweeps):
        r = np.random.default_rng(rows * 1000 + g)
        blk, bg = r.standard_normal((rows, g)), r.standard_normal((rows, g))
        top, bot = r.standard_normal(g), r.standard_normal(g)
        out, norm = ops.jacobi_halo_sweeps(_t(blk), _t(top), _t(bot), _t(bg),
                                           sweeps=sweeps)
        jout, jnorm = jops.jacobi_halo_sweeps(
            jnp.asarray(blk), jnp.asarray(top), jnp.asarray(bot),
            jnp.asarray(bg), sweeps=sweeps, interpret=True)
        want, wnorm = jref.ref_jacobi_halo_sweeps(blk, top, bot, bg,
                                                  sweeps=sweeps)
        np.testing.assert_array_equal(_np(out), np.asarray(jout))
        np.testing.assert_array_equal(_np(out), want)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-12)
        np.testing.assert_allclose(float(norm), wnorm, rtol=1e-12)

    @pytest.mark.parametrize("edge", ["top", "bot", "both"])
    def test_dirichlet_boundary_rows(self, edge):
        r = np.random.default_rng(3)
        rows, g, sweeps = 6, 17, 3
        blk, bg = r.standard_normal((rows, g)), r.standard_normal((rows, g))
        z = np.zeros(g)
        top = z if edge in ("top", "both") else r.standard_normal(g)
        bot = z if edge in ("bot", "both") else r.standard_normal(g)
        out, norm = ops.jacobi_halo_sweeps(_t(blk), _t(top), _t(bot), _t(bg),
                                           sweeps=sweeps)
        want, wnorm = jref.ref_jacobi_halo_sweeps(blk, top, bot, bg,
                                                  sweeps=sweeps)
        np.testing.assert_array_equal(_np(out), want)
        np.testing.assert_allclose(float(norm), wnorm, rtol=1e-12)

    def test_numpy_oracle_is_the_reference(self):
        r = np.random.default_rng(4)
        blk, bg = r.standard_normal((5, 9)), r.standard_normal((5, 9))
        top, bot = r.standard_normal(9), r.standard_normal(9)
        got, gnorm = ref.oracle_jacobi_halo_sweeps(blk, top, bot, bg, sweeps=4)
        want, wnorm = jref.ref_jacobi_halo_sweeps(blk, top, bot, bg, sweeps=4)
        np.testing.assert_array_equal(got, want)
        assert gnorm == wnorm

    def test_rejects_bad_shapes(self):
        blk = torch.zeros((4, 8), dtype=torch.float64)
        z8 = torch.zeros(8, dtype=torch.float64)
        with pytest.raises(ValueError):
            ops.jacobi_halo_sweeps(blk, torch.zeros(7, dtype=torch.float64),
                                   z8, blk, sweeps=1)
        with pytest.raises(ValueError):
            ops.jacobi_halo_sweeps(blk, z8, z8,
                                   torch.zeros((3, 8), dtype=torch.float64),
                                   sweeps=1)
        with pytest.raises(ValueError):
            ops.jacobi_halo_sweeps(blk, z8, z8, blk, sweeps=0)


# --------------------------------------------------------------------- #
# global jacobi sweep
# --------------------------------------------------------------------- #
class TestJacobiStencil:
    @pytest.mark.parametrize("g", [8, 16, 32, 100])
    @pytest.mark.parametrize("block_rows", [2, 8])
    def test_matches_pallas(self, g, block_rows):
        r = np.random.default_rng(g + block_rows)
        x, b = r.standard_normal(g * g), r.standard_normal(g * g)
        out = _np(ops.jacobi_sweep(_t(x), _t(b), g))
        jout = np.asarray(jops.jacobi_sweep(jnp.asarray(x), jnp.asarray(b), g,
                                            block_rows=block_rows,
                                            interpret=True))
        np.testing.assert_array_equal(out, jout)
        want = np.asarray(jref.ref_jacobi_sweep(jnp.asarray(x),
                                                jnp.asarray(b), g))
        np.testing.assert_allclose(out, want, rtol=1e-14, atol=1e-14)

    @pytest.mark.parametrize("g", [1, 8, 17, 32, 100])
    def test_jnp_order_matches_full_sweep(self, g):
        """``order="jnp"`` equals the reference problem's default full map,
        ``repro.problems.jacobi._full_sweep``, byte for byte."""
        from repro.problems.jacobi import _full_sweep

        r = np.random.default_rng(100 + g)
        x, b = r.standard_normal(g * g), r.standard_normal(g * g)
        out = _np(ops.jacobi_sweep(_t(x), _t(b), g, order="jnp"))
        want = np.asarray(_full_sweep(jnp.asarray(x), jnp.asarray(b), g))
        assert out.tobytes() == want.tobytes()
        np.testing.assert_array_equal(
            out, np.asarray(jref.ref_jacobi_sweep(jnp.asarray(x),
                                                  jnp.asarray(b), g)))

    def test_rejects_unknown_order(self):
        x = torch.zeros(16, dtype=torch.float64)
        with pytest.raises(ValueError, match="order"):
            ops.jacobi_sweep(x, x, 4, order="xla")

    def test_fixed_point_of_solution(self):
        """At A x = b the sweep is a no-op (the boundary is respected)."""
        from repro_torch.problems import JacobiProblem

        p = JacobiProblem(grid=16, device="cpu")
        xs = p.exact_solution()
        out = ops.jacobi_sweep(_t(xs), _t(p._b), 16)
        np.testing.assert_allclose(_np(out), xs, atol=1e-10)

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            ops.jacobi_sweep(torch.zeros(15, dtype=torch.float64),
                             torch.zeros(16, dtype=torch.float64), 4)


# --------------------------------------------------------------------- #
# full bellman operator
# --------------------------------------------------------------------- #
def _mdp(S, A, b, D, seed):
    r = np.random.default_rng(seed)
    idx = r.integers(0, D, size=(S, A, b)).astype(np.int32)
    probs = r.dirichlet(np.ones(b), (S, A))
    rewards = r.uniform(size=(S, A))
    return idx, probs, rewards, r.standard_normal(D), r.standard_normal(S)


class TestBellmanKernel:
    @pytest.mark.parametrize("S,A,b,gamma", [
        (32, 2, 3, 0.9), (96, 4, 5, 0.95), (200, 10, 3, 0.99),
        (200, 4, 5, 0.9),
    ])
    def test_matches_pallas(self, S, A, b, gamma):
        idx, probs, R, v, _ = _mdp(S, A, b, S, S + A + b)
        out = _np(ops.bellman(_t(idx), _t(probs), _t(R), _t(v), gamma=gamma))
        jout = np.asarray(jops.bellman(
            jnp.asarray(idx), jnp.asarray(probs), jnp.asarray(R),
            jnp.asarray(v), gamma=gamma, block_s=32, interpret=True))
        want = np.asarray(jref.ref_bellman(
            jnp.asarray(idx), jnp.asarray(probs), jnp.asarray(R),
            jnp.asarray(v), gamma=gamma))
        np.testing.assert_allclose(out, jout, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(out, want, rtol=1e-13, atol=1e-13)

    def test_contraction_through_wrapper(self):
        idx, probs, R, u, _ = _mdp(64, 3, 4, 64, 3)
        w = np.random.default_rng(4).standard_normal(64)
        tu = _np(ops.bellman(_t(idx), _t(probs), _t(R), _t(u), gamma=0.9))
        tw = _np(ops.bellman(_t(idx), _t(probs), _t(R), _t(w), gamma=0.9))
        assert np.max(np.abs(tu - tw)) <= 0.9 * np.max(np.abs(u - w)) + 1e-12

    def test_rejects_bad_shapes(self):
        idx = torch.zeros((4, 2, 3), dtype=torch.int32)
        f = dict(dtype=torch.float64)
        with pytest.raises(ValueError):
            ops.bellman(idx, torch.zeros((4, 2, 3), **f),
                        torch.zeros((4, 2), **f), torch.zeros(5, **f),
                        gamma=0.9)


# --------------------------------------------------------------------- #
# fused bellman state-block backup
# --------------------------------------------------------------------- #
class TestBellmanBlockKernel:
    @pytest.mark.parametrize("rows,A,b,D", [
        (8, 4, 3, 64),
        (13, 5, 2, 100),  # odd block size
        (1, 2, 4, 16),    # single state
        (50, 8, 5, 50),   # D == rows (dense closure)
    ])
    def test_matches_pallas(self, rows, A, b, D):
        idx, probs, R, v, v_old = _mdp(rows, A, b, D, rows)
        tv, norm = ops.bellman_block(_t(idx), _t(probs), _t(R), _t(v),
                                     _t(v_old), gamma=0.95)
        jtv, jnorm = jops.bellman_block(
            jnp.asarray(idx), jnp.asarray(probs), jnp.asarray(R),
            jnp.asarray(v), jnp.asarray(v_old), gamma=0.95, interpret=True)
        want, wnorm = jref.ref_bellman_block(idx, probs, R, v, v_old,
                                             gamma=0.95)
        np.testing.assert_allclose(_np(tv), np.asarray(jtv), rtol=1e-13,
                                   atol=1e-13)
        np.testing.assert_allclose(_np(tv), want, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-13)
        np.testing.assert_allclose(float(norm), wnorm, rtol=1e-13)

    def test_remapped_dependency_closure(self):
        """Gathering from a closure slice of v (remapped idx) gives the
        same backup as gathering from the full vector, bit for bit."""
        idx, probs, R, v, v_old = _mdp(6, 3, 4, 200, 7)
        closure = np.unique(idx)
        remap = np.searchsorted(closure, idx).astype(np.int32)
        full, _ = ops.bellman_block(_t(idx), _t(probs), _t(R), _t(v),
                                    _t(v_old), gamma=0.9)
        sliced, _ = ops.bellman_block(_t(remap), _t(probs), _t(R),
                                      _t(v[closure]), _t(v_old), gamma=0.9)
        np.testing.assert_array_equal(_np(full), _np(sliced))

    def test_numpy_oracle_is_the_reference(self):
        idx, probs, R, v, v_old = _mdp(9, 3, 4, 30, 8)
        got = ref.oracle_bellman_block(idx, probs, R, v, v_old, gamma=0.9)
        want = jref.ref_bellman_block(idx, probs, R, v, v_old, gamma=0.9)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]

    def test_rejects_bad_shapes(self):
        idx = torch.zeros((4, 2, 3), dtype=torch.int32)
        f = dict(dtype=torch.float64)
        with pytest.raises(ValueError):
            ops.bellman_block(idx, torch.zeros((4, 2, 2), **f),
                              torch.zeros((4, 2), **f), torch.zeros(10, **f),
                              torch.zeros(4, **f), gamma=0.9)
        with pytest.raises(ValueError):
            ops.bellman_block(idx, torch.zeros((4, 2, 3), **f),
                              torch.zeros((4, 2), **f), torch.zeros(10, **f),
                              torch.zeros(5, **f), gamma=0.9)


# --------------------------------------------------------------------- #
# anderson mix
# --------------------------------------------------------------------- #
class TestAndersonMixKernel:
    @pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("h,N,block_n", [
        (2, 512, 512),
        (6, 1000, 256),   # N % block_n != 0
        (8, 513, 128),    # prime-ish N
        (4, 4096, 1024),
    ])
    def test_matches_pallas(self, beta, h, N, block_n):
        r = np.random.default_rng(h * N)
        X, G = r.standard_normal((h, N)), r.standard_normal((h, N))
        a = r.standard_normal(h)
        a = a / a.sum()
        out = _np(ops.anderson_mix(_t(X), _t(G), _t(a), beta=beta))
        jout = np.asarray(jops.anderson_mix(
            jnp.asarray(X), jnp.asarray(G), jnp.asarray(a), beta=beta,
            block_n=block_n, interpret=True))
        want = np.asarray(jref.ref_anderson_mix(
            jnp.asarray(X), jnp.asarray(G), jnp.asarray(a), beta=beta))
        np.testing.assert_allclose(out, jout, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)

    def test_simplex_identity(self):
        """alpha = e_j, beta = 0 reproduces X_j exactly."""
        r = np.random.default_rng(5)
        X, G = r.standard_normal((4, 256)), r.standard_normal((4, 256))
        a = np.zeros(4)
        a[2] = 1.0
        out = ops.anderson_mix(_t(X), _t(G), _t(a), beta=0.0)
        np.testing.assert_array_equal(_np(out), X[2])

    def test_rejects_bad_shapes(self):
        f = dict(dtype=torch.float64)
        with pytest.raises(ValueError):
            ops.anderson_mix(torch.zeros((3, 8), **f), torch.zeros((3, 8), **f),
                             torch.zeros(4, **f))
