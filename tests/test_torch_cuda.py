"""The port on the card: each CUDA kernel against its plain version, and
the problems and the Anderson window on CUDA against the same objects on
the CPU.

Every test here needs a CUDA device and ``nvcc`` (the kernels build on
first use) and skips without one; the file imports nothing of JAX, so it
runs on the machine with the card:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the Jacobi kernels are exact (adds and an exact scaling, in
the plain version's order, for both add orders of ``jacobi_sweep``);
Bellman 1e-13 (the CUDA kernel may contract ``R + gamma * ev`` to an
FMA); ``anderson_mix`` 1e-12 (FMAs over the window); norms 1e-12 relative (per-CTA partial sums); ``flash_attention``
2e-5 in float32 and 2e-2 in bfloat16 (an online softmax against the plain
version's one-shot softmax, as ``tests/test_kernels.py`` holds the Pallas
kernel); the LM serving path on the card against the same weights on the
CPU 1e-4 relative in the logits (float32 matmuls in other orders through
a stack of layers) with identical greedy tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.anderson import AndersonConfig, AndersonState  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.problems import (  # noqa: E402
    GarnetMDP,
    JacobiProblem,
    ValueIterationProblem,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _mdp(S, A, b, D, seed):
    r = np.random.default_rng(seed)
    idx = r.integers(0, D, size=(S, A, b)).astype(np.int32)
    probs = r.dirichlet(np.ones(b), (S, A))
    rewards = r.uniform(size=(S, A))
    return idx, probs, rewards, r.standard_normal(D), r.standard_normal(S)


class TestKernelsMatchPlain:
    @pytest.mark.parametrize("rows,g", [(1, 8), (37, 45), (512, 256)])
    def test_jacobi_halo_sweeps(self, dev, rows, g):
        r = np.random.default_rng(rows)
        args = [torch.as_tensor(a, device=dev) for a in (
            r.standard_normal((rows, g)), r.standard_normal(g),
            r.standard_normal(g), r.standard_normal((rows, g)))]
        for sweeps in (1, 2, 5):
            out, norm = ops.jacobi_halo_sweeps(*args, sweeps=sweeps)
            want, wnorm = ref.jacobi_halo_sweeps(*args, sweeps=sweeps)
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            torch.testing.assert_close(norm, wnorm, rtol=1e-12, atol=0)

    @pytest.mark.parametrize("g", [1, 31, 64, 100])
    def test_jacobi_sweep(self, dev, g):
        r = np.random.default_rng(g)
        x, b = (torch.as_tensor(r.standard_normal(g * g), device=dev)
                for _ in range(2))
        torch.testing.assert_close(ops.jacobi_sweep(x, b, g),
                                   ref.jacobi_sweep(x, b, g), rtol=0, atol=0)

    @pytest.mark.parametrize("order", ["pallas", "jnp"])
    @pytest.mark.parametrize("g", [1, 33, 100])
    def test_jacobi_sweep_orders(self, dev, order, g):
        """Both add orders run through the kernel and are exact."""
        r = np.random.default_rng(g + 7)
        x, b = (torch.as_tensor(r.standard_normal(g * g), device=dev)
                for _ in range(2))
        ops.reset_launch_counts()
        got = ops.jacobi_sweep(x, b, g, order)
        assert ops.launch_counts()["jacobi_sweep"] == 1
        assert torch.equal(got, ref.jacobi_sweep(x, b, g, order))

    @pytest.mark.parametrize("S,A,b,D", [
        (300, 4, 5, 300),        # a ragged last tile of states
        (140_000, 4, 5, 1000),   # 2188 CTAs, one partial each, combined
        (50, 19, 7, 80),         # a row of 133 successors
        (301, 3, 1, 301),        # A not a power of two, b = 1
        (77, 20, 7, 90),         # 140 successors (the old staging's limit
        (64, 5, 40, 64),         # was 133), and b > 8: the generic loop
        (1000, 300, 2, 1000),    # A above the CTA's 256 threads
    ])
    def test_bellman_and_block(self, dev, S, A, b, D):
        idx, probs, R, v, v_old = (torch.as_tensor(a, device=dev)
                                   for a in _mdp(S, A, b, D, 2))
        if D == S:  # the full operator gathers from a v of its own length
            torch.testing.assert_close(
                ops.bellman(idx, probs, R, v, gamma=0.95),
                ref.bellman(idx, probs, R, v, gamma=0.95),
                rtol=1e-13, atol=1e-13)
        tv, norm = ops.bellman_block(idx, probs, R, v, v_old, gamma=0.95)
        wtv, wnorm = ref.bellman_block(idx, probs, R, v, v_old, gamma=0.95)
        torch.testing.assert_close(tv, wtv, rtol=1e-13, atol=1e-13)
        torch.testing.assert_close(norm, wnorm, rtol=1e-13, atol=1e-13)

    def test_bellman_nan_propagates(self, dev):
        """A NaN in v reaches every state that gathers it, through the max
        over actions and the block norm, as in the plain version."""
        idx, probs, R, v, v_old = (torch.as_tensor(a, device=dev)
                                   for a in _mdp(500, 3, 4, 500, 5))
        v[17] = float("nan")
        got = ops.bellman(idx, probs, R, v, gamma=0.9)
        want = ref.bellman(idx, probs, R, v, gamma=0.9)
        assert torch.equal(got.isnan(), want.isnan()) and bool(
            want.isnan().any())
        torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13,
                                   equal_nan=True)
        _, norm = ops.bellman_block(idx, probs, R, v, v_old, gamma=0.9)
        assert bool(norm.isnan())

    @pytest.mark.parametrize("rows", [1, 255, 70_001])
    def test_bellman_block_norm(self, dev, rows):
        """The block norm of one CTA, of four with a ragged last tile, and
        of 1094 partials (one per CTA) in the one-CTA combine pass,
        against the plain max."""
        idx, probs, R, v, v_old = (torch.as_tensor(a, device=dev)
                                   for a in _mdp(rows, 4, 5, 5000, rows))
        tv, norm = ops.bellman_block(idx, probs, R, v, v_old, gamma=0.95)
        wtv, wnorm = ref.bellman_block(idx, probs, R, v, v_old, gamma=0.95)
        torch.testing.assert_close(tv, wtv, rtol=1e-13, atol=1e-13)
        assert float(norm) == pytest.approx(float(wnorm), rel=1e-13)

    @pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("h,N", [(1, 7), (6, 1001), (16, 4096)])
    def test_anderson_mix(self, dev, beta, h, N):
        r = np.random.default_rng(h * N)
        X, G = (torch.as_tensor(r.standard_normal((h, N)), device=dev)
                for _ in range(2))
        a = torch.as_tensor(r.standard_normal(h), device=dev)
        torch.testing.assert_close(ops.anderson_mix(X, G, a, beta=beta),
                                   ref.anderson_mix(X, G, a, beta=beta),
                                   rtol=1e-12, atol=1e-12)

    def test_launches_are_counted(self, dev):
        ops.reset_launch_counts()
        x = torch.zeros(16, dtype=torch.float64, device=dev)
        ops.jacobi_sweep(x, x, 4)
        ops.jacobi_sweep(x, x, 4)
        assert ops.launch_counts()["jacobi_sweep"] == 2

    def test_wrong_dtype_raises(self, dev):
        x = torch.zeros(16, dtype=torch.float32, device=dev)
        with pytest.raises(ValueError, match="dtype"):
            ops.jacobi_sweep(x, x, 4)


class TestProblemsOnTheCard:
    def test_jacobi_matches_cpu(self, dev):
        gpu = JacobiProblem(grid=64, sweeps=4, seed=1, device=dev)
        cpu = JacobiProblem(grid=64, sweeps=4, seed=1, device="cpu")
        x = np.random.default_rng(0).standard_normal(gpu.n)
        for blk in gpu.default_blocks(4):  # whole-rows blocks: 16 rows each
            np.testing.assert_array_equal(gpu.block_update(x, blk),
                                          cpu.block_update(x, blk))
            plan = gpu.device_block_plan(blk, "kernel")
            plan.refresh(x[blk])
            vals, norm = plan.step(*[np.copy(x[s]) for s in plan.needs])
            np.testing.assert_array_equal(vals, cpu.block_update(x, blk))
        np.testing.assert_array_equal(gpu.full_map(x), cpu.full_map(x))
        assert gpu.residual_norm(x) == pytest.approx(cpu.residual_norm(x),
                                                     rel=1e-13)

    def test_value_iteration_matches_cpu(self, dev):
        kw = dict(S=500, A=4, b=5, gamma=0.95, seed=3)
        gpu = ValueIterationProblem(GarnetMDP(device=dev, **kw))
        cpu = ValueIterationProblem(GarnetMDP(device="cpu", **kw))
        x = np.random.default_rng(1).standard_normal(500)
        np.testing.assert_allclose(gpu.full_map(x), cpu.full_map(x),
                                   rtol=1e-13, atol=1e-13)
        for blk in gpu.default_blocks(4):
            plan = gpu.device_block_plan(blk, "kernel")
            plan.refresh(x[blk])
            vals, _ = plan.step(*[np.copy(x[s]) for s in plan.needs])
            np.testing.assert_allclose(vals, cpu.block_update(x, blk),
                                       rtol=1e-13, atol=1e-13)

    @pytest.mark.parametrize("beta", [0.5, 1.0])
    def test_anderson_window_matches_cpu(self, dev, beta):
        r = np.random.default_rng(9)
        n = 3000
        cfg = AndersonConfig(m=4, beta=beta, mix_kernel_n=1)
        gpu = AndersonState(cfg, device=dev)
        cpu = AndersonState(cfg, device="cpu")
        for _ in range(12):  # wraps the ring buffer
            x = r.standard_normal(n)
            g = x + 0.1 * r.standard_normal(n)
            gpu.push(x, g)
            cpu.push(x, g)
            np.testing.assert_allclose(gpu.propose(), cpu.propose(),
                                       rtol=1e-10, atol=1e-12)


#: B, Sq, Skv, nq, nkv, hd, causal, window, softcap, q_offset
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, True, None, None, 0),    # TestFlashAttention's
    (2, 256, 256, 8, 2, 64, True, None, None, 0),    # sweep
    (2, 128, 128, 4, 1, 128, True, None, None, 0),
    (1, 256, 256, 4, 2, 64, True, 64, None, 0),
    (1, 128, 128, 2, 2, 64, True, None, 30.0, 0),
    (2, 128, 128, 4, 4, 64, False, None, None, 0),
    (1, 256, 256, 8, 2, 64, True, 32, 50.0, 0),
    (2, 64, 256, 4, 4, 64, True, None, None, 192),   # q_offset
    (2, 77, 50, 4, 2, 32, True, 20, 50.0, -27),      # ragged, masked rows
    (1, 100, 300, 2, 1, 16, False, 40, None, 150),   # window, no causal
    (1, 200, 200, 8, 4, 256, True, 96, 50.0, 0),     # gemma2's head dim
]


class TestFlashAttentionKernel:
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Sq,Skv,nq,nkv,hd,causal,window,softcap,off",
                             FLASH_CASES)
    def test_matches_plain(self, dev, dtype, tol, B, Sq, Skv, nq, nkv, hd,
                           causal, window, softcap, off):
        r = np.random.default_rng(Sq * hd + Skv)
        q = torch.as_tensor(r.standard_normal((B, Sq, nq, hd)),
                            dtype=dtype, device=dev)
        k, v = (torch.as_tensor(r.standard_normal((B, Skv, nkv, hd)),
                                dtype=dtype, device=dev) for _ in range(2))
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, **kw)
        assert got.dtype == dtype and got.shape == (B, Sq, nq, hd)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("window,softcap", [(None, None), (70, 50.0)])
    @pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
    def test_ragged_tiles_every_head_dim(self, dev, dtype, tol, window,
                                         softcap, hd):
        """Sq and Skv that are not multiples of the 64-row q tile or the
        256-key tile, Sq != Skv with q_offset, every head dim."""
        r = np.random.default_rng(hd)
        B, Sq, Skv, nq, nkv, off = 2, 131, 299, 4, 2, 168
        q = torch.as_tensor(r.standard_normal((B, Sq, nq, hd)), dtype=dtype,
                            device=dev)
        k, v = (torch.as_tensor(r.standard_normal((B, Skv, nkv, hd)),
                                dtype=dtype, device=dev) for _ in range(2))
        for causal in (True, False):
            kw = dict(causal=causal, window=window, softcap=softcap,
                      q_offset=off)
            torch.testing.assert_close(
                ops.flash_attention(q, k, v, **kw).float(),
                ref.flash_attention(q, k, v, **kw).float(), rtol=tol,
                atol=tol)

    def test_misaligned_views_are_copied(self, dev):
        """A q whose rows do not start on 16 bytes is copied, not refused."""
        r = np.random.default_rng(6)
        base = torch.as_tensor(r.standard_normal(2 * 40 * 2 * 32 + 1),
                               dtype=torch.float32, device=dev)
        q = base[1:].view(2, 40, 2, 32)
        assert q.data_ptr() % 16
        torch.testing.assert_close(ops.flash_attention(q, q, q),
                                   ref.flash_attention(q, q, q),
                                   rtol=2e-5, atol=2e-5)

    def test_strided_views_read_in_place(self, dev):
        """k and v as head slices of one fused (B, S, 2*nkv, hd) tensor."""
        r = np.random.default_rng(4)
        q = torch.as_tensor(r.standard_normal((2, 96, 4, 32)),
                            dtype=torch.float32, device=dev)
        kv = torch.as_tensor(r.standard_normal((2, 96, 4, 32)),
                             dtype=torch.float32, device=dev)
        k, v = kv[:, :, :2], kv[:, :, 2:]
        assert not k.is_contiguous()
        torch.testing.assert_close(ops.flash_attention(q, k, v, window=16),
                                   ref.flash_attention(q, k, v, window=16),
                                   rtol=2e-5, atol=2e-5)

    def test_fully_masked_rows_are_zero(self, dev):
        q = torch.ones(1, 64, 2, 32, device=dev)
        out = ops.flash_attention(q, q, q, causal=True, q_offset=-64)
        assert bool((out == 0).all())

    def test_launches_are_counted(self, dev):
        ops.reset_launch_counts()
        q = torch.zeros(1, 8, 2, 16, device=dev)
        ops.flash_attention(q, q, q)
        ops.flash_attention(q, q, q)
        assert ops.launch_counts()["flash_attention"] == 2

    @pytest.mark.parametrize("shape,dtype,match", [
        ((1, 8, 2, 48), torch.float32, "head dim"),
        ((1, 8, 2, 16), torch.float64, "dtype"),
    ])
    def test_rejects_what_the_kernel_does_not_take(self, dev, shape, dtype,
                                                   match):
        q = torch.zeros(shape, dtype=dtype, device=dev)
        with pytest.raises(ValueError, match=match):
            ops.flash_attention(q, q, q)


class TestLmOnTheCard:
    @pytest.mark.parametrize("arch", ["gemma2_2b", "gemma3_4b"])
    def test_serve_matches_cpu(self, dev, arch):
        """Reduced config, prompt past the window: prefill through the
        kernel and greedy decode on the card against the CPU run."""
        cfg = lm_serve.make_config(arch, reduced=True)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=1)
        prompt = lm_serve.make_prompt(cfg, 2, 40, cpu)
        want = lm_serve.serve(cfg, params, prompt, gen=6, keep_logits=True)
        ops.reset_launch_counts()
        got = lm_serve.serve(cfg, params.to(dev), prompt.to(dev), gen=6,
                             keep_logits=True)
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        assert torch.equal(got.tokens.cpu(), want.tokens)
        for a, b in zip([got.prefill_logits] + got.step_logits,
                        [want.prefill_logits] + want.step_logits):
            rel = float((a.cpu() - b).abs().max() / b.abs().max())
            assert rel <= 1e-4
