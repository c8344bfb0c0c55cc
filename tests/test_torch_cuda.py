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
FMA); ``anderson_mix`` 1e-12 (FMAs over the window); norms 1e-12
relative (per-CTA partial sums); ``flash_attention`` 2e-5 in float32 and
2e-2 in bfloat16 (an online softmax against the plain version's one-shot
softmax, as ``tests/test_kernels.py`` holds the Pallas kernel);
``selective_scan`` 1e-5 relative (time in order against the plain
version's doubling scan); ``moe_expert_ffn`` 1e-5 relative in float32
and, in bfloat16, 1e-2 of the float32 answer with an RMS error no larger
than the plain bfloat16 version's (the kernel rounds h and out once
each); the LM serving path on the card against the
same weights on the CPU 1e-4 relative in the logits (float32 matmuls in
other orders through a stack of layers) with identical greedy tokens; a
train step on the card against the CPU 1e-4 relative in the loss and
every gradient leaf, and each parameter within 2 lr after AdamW (Adam's
first step moves an element by ±lr whatever the size of its gradient).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.anderson import AndersonConfig, AndersonState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import anderson_mix as mix  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import aligned  # noqa: E402
from repro_torch.kernels.anderson_mix import MixPlan  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models.attention import train_attention  # noqa: E402
from repro_torch.problems import (  # noqa: E402
    GarnetMDP,
    JacobiProblem,
    PPPChain,
    SCFProblem,
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
    @pytest.mark.parametrize("rows,g", [
        (1, 8),        # one row, g under the 108-column tile of 10 sweeps
        (3, 40),       # fewer rows than sweeps
        (37, 45),      # odd g: the 8-byte copy path
        (512, 256),    # the 64 x 128 region's rows not a multiple of a tile
        (100, 250),    # g not a multiple of the tile's columns
        (2048, 2048),  # the one-worker block: the whole smoke grid
    ])
    def test_jacobi_halo_sweeps(self, dev, rows, g):
        r = np.random.default_rng(rows)
        args = [torch.as_tensor(a, device=dev) for a in (
            r.standard_normal((rows, g)), r.standard_normal(g),
            r.standard_normal(g), r.standard_normal((rows, g)))]
        # 16 sweeps is one pass's most; 17 takes two passes, 37 three
        for sweeps in (1, 2, 5, 10, 16, 17, 37):
            out, norm = ops.jacobi_halo_sweeps(*args, sweeps=sweeps)
            want, wnorm = ref.jacobi_halo_sweeps(*args, sweeps=sweeps)
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            torch.testing.assert_close(norm, wnorm, rtol=1e-12, atol=0)

    def test_jacobi_halo_many_tiles(self, dev):
        """More output tiles (one partial norm each) than the 1024 partial
        slots of the kernel this one replaced, all summed by one CTA."""
        from repro_torch.kernels.jacobi_stencil import halo_plan

        rows, g, sweeps = 4096, 2048, 10
        assert halo_plan(rows, g, sweeps) == (1, 1786)
        r = np.random.default_rng(7)
        args = [torch.as_tensor(a, device=dev) for a in (
            r.standard_normal((rows, g)), r.standard_normal(g),
            r.standard_normal(g), r.standard_normal((rows, g)))]
        out, norm = ops.jacobi_halo_sweeps(*args, sweeps=sweeps)
        want, wnorm = ref.jacobi_halo_sweeps(*args, sweeps=sweeps)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        torch.testing.assert_close(norm, wnorm, rtol=1e-12, atol=0)

    def test_jacobi_halo_misaligned_views(self, dev):
        """A block of even width that starts 8 bytes past a 16-byte
        boundary takes the 8-byte copies and stays exact."""
        r = np.random.default_rng(11)
        rows, g = 25, 34
        flat = torch.as_tensor(r.standard_normal(1 + rows * g), device=dev)
        xb = flat[1:].view(rows, g)
        assert xb.data_ptr() % 16 == 8
        top, bot = (torch.as_tensor(r.standard_normal(g), device=dev)
                    for _ in range(2))
        b = torch.as_tensor(r.standard_normal((rows, g)), device=dev)
        for sweeps in (1, 10, 17):
            out, norm = ops.jacobi_halo_sweeps(xb, top, bot, b, sweeps=sweeps)
            want, wnorm = ref.jacobi_halo_sweeps(xb, top, bot, b,
                                                 sweeps=sweeps)
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            torch.testing.assert_close(norm, wnorm, rtol=1e-12, atol=0)

    @pytest.mark.parametrize("rows,g,sweeps", [(512, 2048, 10),
                                               (25, 100, 10), (45, 131, 17)])
    def test_jacobi_halo_deterministic(self, dev, rows, g, sweeps):
        """Two calls give the same bytes, the norm included (partials in
        a fixed order, no atomics)."""
        r = np.random.default_rng(rows + g)
        args = [torch.as_tensor(a, device=dev) for a in (
            r.standard_normal((rows, g)), r.standard_normal(g),
            r.standard_normal(g), r.standard_normal((rows, g)))]
        out1, norm1 = ops.jacobi_halo_sweeps(*args, sweeps=sweeps)
        out2, norm2 = ops.jacobi_halo_sweeps(*args, sweeps=sweeps)
        assert torch.equal(out1, out2)
        assert norm1.cpu().numpy().tobytes() == norm2.cpu().numpy().tobytes()

    @pytest.mark.parametrize("sweeps,launches", [(1, 2), (10, 2), (16, 2),
                                                 (17, 3), (37, 4)])
    def test_jacobi_halo_launches_per_call(self, dev, sweeps, launches):
        """One launch per pass of up to 16 sweeps plus the norm's combine,
        as CUPTI records them."""
        from repro_torch.kernels.jacobi_stencil import halo_plan
        from repro_torch.launch.kernel_bench import device_profile

        rows, g = 512, 2048
        assert halo_plan(rows, g, sweeps)[0] + 1 == launches
        xb, b = (torch.randn(rows, g, dtype=torch.float64, device=dev)
                 for _ in range(2))
        halo = torch.zeros(g, dtype=torch.float64, device=dev)
        _, per_call = device_profile(torch, lambda: ops.jacobi_halo_sweeps(
            xb, halo, halo, b, sweeps=sweeps), reps=5, warmup=1)
        assert per_call == launches

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

    @staticmethod
    def _mix_case(dev, h, N, seed, storage=None):
        """X, G (views into ``storage``'s rows when given) and alpha."""
        r = np.random.default_rng(seed)
        X, G = (torch.as_tensor(r.standard_normal((h, N)), device=dev)
                for _ in range(2))
        if storage is not None:
            X, G = (storage(t) for t in (X, G))
        return X, G, torch.as_tensor(r.standard_normal(h), device=dev)

    @pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("h,N", [
        (6, 2048 * 2048), (6, 10 ** 6), (9, 1024 * 1024),  # main paths
        (1, 100_000), (9, 100_002), (16, 100_000),         # depths
        (9, 2), (16, 62),                                  # under a CTA
    ])
    def test_anderson_mix_vector_loads(self, dev, beta, h, N):
        """Aligned windows of even N take 16-byte loads."""
        from repro_torch.kernels.anderson_mix import plan_of

        X, G, a = self._mix_case(dev, h, N, h + N)
        assert plan_of(X, G, beta).kernel == "vector"
        torch.testing.assert_close(ops.anderson_mix(X, G, a, beta=beta),
                                   ref.anderson_mix(X, G, a, beta=beta),
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("beta", [0.0, 0.5, 1.0])
    @pytest.mark.parametrize("start,length,N", [(1, 6, 100_001),
                                                (3, 9, 4097), (0, 16, 1)])
    def test_anderson_mix_odd_ring_view(self, dev, beta, start, length, N):
        """A window ``buf[start:start + length]`` of a ring buffer with odd
        N: its rows alternate between aligned and 8 bytes off, so the
        kernel takes 8-byte loads."""
        from repro_torch.kernels.anderson_mix import plan_of

        r = np.random.default_rng(N)
        bufs = [torch.as_tensor(r.standard_normal((start + length, N)),
                                device=dev) for _ in range(2)]
        X, G = (b[start:start + length] for b in bufs)
        a = torch.as_tensor(r.standard_normal(length), device=dev)
        assert plan_of(X, G, beta).kernel == "scalar"
        torch.testing.assert_close(ops.anderson_mix(X, G, a, beta=beta),
                                   ref.anderson_mix(X, G, a, beta=beta),
                                   rtol=1e-12, atol=1e-12)

    @pytest.mark.parametrize("beta", [0.0, 1.0])
    @pytest.mark.parametrize("h,N", [(1, 4096), (6, 10 ** 6), (9, 2 ** 20),
                                     (16, 30_002)])
    def test_anderson_mix_kernels_agree_bitwise(self, dev, beta, h, N):
        """8-byte loads (a window one element off a 16-byte boundary)
        and 16-byte loads (its aligned clone) give the same bits at beta =
        0 and 1, as does every grid and load policy of the plan."""
        from repro_torch.kernels.anderson_mix import plan_of

        def off_by_one(t):
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
            view = flat[1:].view(t.shape)
            view.copy_(t)
            return view

        X, G, a = self._mix_case(dev, h, N, 7 * h + N, storage=off_by_one)
        Xc, Gc = X.clone(), G.clone()
        assert plan_of(X, G, beta).kernel == "scalar"
        assert plan_of(Xc, Gc, beta).kernel == "vector"
        want = ops.anderson_mix(Xc, Gc, a, beta=beta)
        assert torch.equal(ops.anderson_mix(X, G, a, beta=beta), want)
        for p in (MixPlan("vector", 1), MixPlan("vector", 3),
                  MixPlan("scalar", 2)):
            assert torch.equal(mix.anderson_mix(Xc, Gc, a, beta=beta,
                                                plan=p), want), p

    def test_anderson_mix_refuses_vector_loads_off_alignment(self, dev):
        X, G, a = self._mix_case(dev, 6, 1000, 3)
        Go = torch.empty(G.numel() + 1, dtype=G.dtype, device=dev)[1:]
        Go = Go.view(G.shape).copy_(G)
        with pytest.raises(RuntimeError, match="failed to launch"):
            mix.anderson_mix(X, Go, a, beta=1.0,
                             plan=MixPlan("vector", 4))

    def test_stream_of_is_the_current_stream(self, dev):
        """The launchers' raw stream handle is PyTorch's current stream,
        also under a side stream, and the combine runs on it."""
        from repro_torch.kernels import _build

        x = torch.zeros(4, device=dev)
        assert _build.stream_of(x) == torch.cuda.current_stream(
            dev).cuda_stream
        side = torch.cuda.Stream(dev)
        X, G, a = self._mix_case(dev, 6, 1 << 20, 11)
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(side):
            assert _build.stream_of(x) == side.cuda_stream
            assert _build.stream_of(x) != torch.cuda.default_stream(
                dev).cuda_stream
            got = ops.anderson_mix(X, G, a, beta=1.0)
        side.synchronize()
        torch.testing.assert_close(got, ref.anderson_mix(X, G, a, beta=1.0),
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

    def test_scf_matches_cpu(self, dev):
        """n = 256: cuSOLVER's eigh against LAPACK's, through the density
        (free of eigenvector signs while the HOMO-LUMO gap is far above
        rounding)."""
        gpu = SCFProblem(PPPChain(256, 2.0, device=dev))
        cpu = SCFProblem(PPPChain(256, 2.0, device="cpu"))
        x = cpu.initial()
        np.testing.assert_allclose(gpu.initial(), x, rtol=0, atol=1e-12)
        assert cpu.chain.homo_lumo_gap(x) > 1e-3
        for _ in range(3):
            g = cpu.full_map(x)
            np.testing.assert_allclose(gpu.full_map(x), g, rtol=0, atol=1e-10)
            np.testing.assert_allclose(gpu.residual(x), cpu.residual(x),
                                       rtol=0, atol=1e-10)
            x = cpu.project(0.5 * (x + g))
        assert gpu.energy(x) == pytest.approx(cpu.energy(x), rel=1e-12)

    def test_one_process_worker_equals_one_thread_worker(self, dev):
        """Jacobi with the device plane on: the worker process's halo
        kernel launches are merged into the parent's counts, and its run
        equals the thread run byte for byte."""
        from repro_torch.core import (FaultProfile, RunConfig,
                                      run_fixed_point, shutdown_pools)

        prob = JacobiProblem(grid=128, sweeps=5, seed=2, device=dev)
        kw = dict(mode="async", n_workers=1, device_plane="on",
                  max_updates=20, tol=1e-12, accel=AndersonConfig(m=3),
                  fire_every=4, faults=FaultProfile())
        try:
            rt = run_fixed_point(prob, RunConfig(executor="thread", **kw))
            ops.reset_launch_counts()
            rp = run_fixed_point(prob, RunConfig(executor="process", **kw))
            launches = ops.launch_counts()
        finally:
            shutdown_pools()
        assert rp.worker_updates == rt.worker_updates == 20
        assert rp.device_dispatches > 0
        assert launches["jacobi_halo_sweeps"] >= 20
        assert rp.x.tobytes() == rt.x.tobytes()

    def test_one_ray_actor_equals_one_thread_worker(self, dev):
        """Jacobi on the Ray backend under ``tests/torch_ray_standin.py``
        (in a child interpreter; the actor a process of its own that asks for
        the card): its ``jacobi_halo_sweeps`` launches are merged into the
        parent's counts, and its run equals the thread run byte for byte."""
        from test_torch_ray import _ok, _run_children

        got = _ok(_run_children({"card": ("process", {
            "one": ("job_one_actor_card", {})})})["card"]["one"])
        rr, rt = got["ray"], got["thread"]
        assert rr["worker_updates"] == rt["worker_updates"] == 20
        assert got["launches"]["jacobi_halo_sweeps"] >= 20
        assert rr["x"].tobytes() == rt["x"].tobytes()

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


def _scripted_cfg(tmp, **kw):
    """A scripted virtual Jacobi run with Anderson through ``anderson_mix``
    (``mix_kernel_n=1``) and checkpoints every 150 updates."""
    from repro_torch.chaos import get_scenario
    from repro_torch.core import FaultProfile, RunConfig

    base = dict(mode="async", tol=1e-300, max_updates=600, seed=7,
                compute_time=1e-3, fire_every=4,
                faults=FaultProfile(delay_mean=2e-3, delay_std=1e-3),
                accel=AndersonConfig(m=5, mix_kernel_n=1),
                scenario=get_scenario("rolling_restart", 4).scaled(0.05),
                checkpoint_every=150, checkpoint_dir=str(tmp))
    base.update(kw)
    return RunConfig(**base)


class TestChaosAndRecoverOnTheCard:
    """Tolerances: the card's Anderson Gram is a cuBLAS product and the
    CPU's numpy's, so they differ in the last place at every fire, and
    accelerated async Jacobi (the paper's iterate-corruption case)
    amplifies that over the run's 150 fires (5.0e-7 measured on the H100):
    a card run and a CPU run take the same decisions with iterates within
    1e-5 relative.  A resume on the card continues the card run byte for
    byte (the same device, the same deterministic kernels and shapes)."""

    def test_scripted_virtual_run_matches_cpu(self, dev, tmp_path):
        from repro_torch.core import run_fixed_point

        runs = [run_fixed_point(JacobiProblem(grid=32, sweeps=5, seed=0,
                                              device=d),
                                _scripted_cfg(tmp_path / str(d)))
                for d in (dev, "cpu")]
        gpu, cpu = runs
        for f in ("worker_updates", "wall_time", "accel_fires",
                  "accel_accepts", "preemptions", "joins",
                  "reassigned_blocks", "preempt_discards"):
            assert getattr(gpu, f) == getattr(cpu, f), f
        assert gpu.preemptions == 4
        np.testing.assert_allclose(gpu.x, cpu.x, rtol=0,
                                   atol=1e-5 * np.abs(cpu.x).max())

    def test_resume_on_the_card_is_bit_identical(self, dev, tmp_path):
        import dataclasses

        from repro_torch.core import run_fixed_point
        from repro_torch.recover import SolveCheckpoint, list_checkpoints

        prob = JacobiProblem(grid=32, sweeps=5, seed=0, device=dev)
        cfg = _scripted_cfg(tmp_path)
        last = max(ev.t for ev in cfg.scenario.events)
        ops.reset_launch_counts()
        full = run_fixed_point(prob, cfg)
        ck = next(c for c in map(SolveCheckpoint.load,
                                 list_checkpoints(str(tmp_path)))
                  if c.t > last and c.wu < 600)
        res = run_fixed_point(prob, dataclasses.replace(
            cfg, scenario=None, resume_from=ck))
        assert ops.launch_counts()["anderson_mix"] > 0
        assert res.worker_updates == full.worker_updates
        assert res.accel_fires == full.accel_fires
        assert res.x.tobytes() == full.x.tobytes()

    def test_thread_scenario_and_crash_resume(self, dev, tmp_path):
        """The thread chaos loop on the card: workers preempted and
        rejoined, halo kernels launched on the host path; then a scripted
        crash and an at-most-once resume (one worker: exact fire count)."""
        from repro_torch.chaos import FaultScenario, get_scenario
        from repro_torch.core import (CoordinatorCrash, FaultProfile,
                                      RunConfig, run_fixed_point)
        from repro_torch.recover import latest_checkpoint, resume_fixed_point

        prob = JacobiProblem(grid=256, sweeps=5, seed=0, device=dev)
        ops.reset_launch_counts()
        r = run_fixed_point(prob, RunConfig(
            mode="async", executor="thread", n_workers=4, max_updates=400,
            tol=1e-300, accel=AndersonConfig(m=5), fire_every=4,
            faults=FaultProfile(delay_mean=2e-3),
            scenario=get_scenario("spot_wave", 4, t0=0.05, downtime=0.15,
                                  stagger=0.01, slow=0.005)))
        assert r.preemptions == 2 and r.joins == 2
        assert r.device_dispatches == 0
        assert ops.launch_counts()["jacobi_halo_sweeps"] >= 400
        cfg = RunConfig(mode="async", executor="thread", n_workers=1,
                        max_updates=2000, tol=1e-300,
                        accel=AndersonConfig(m=5), fire_every=4,
                        faults=FaultProfile(delay_mean=1e-3),
                        checkpoint_every=25, checkpoint_dir=str(tmp_path),
                        scenario=FaultScenario().coordinator_crash(0.5))
        with pytest.raises(CoordinatorCrash):
            run_fixed_point(prob, cfg)
        ck = latest_checkpoint(str(tmp_path))
        assert ck is not None and ck.wu < 2000
        res = resume_fixed_point(prob, cfg, ck)
        assert res.worker_updates == 2000 and res.accel_fires == 500
        assert res.resumed_from == ck.tag


class TestTelemetryAndServeOnTheCard:
    def test_telemetry_device_plane_jacobi(self, dev):
        """A telemetry-on device-plane Jacobi run on the card: eval spans
        of the offloaded fires, one lane per worker, the kernels' fused
        block-local norms kept per worker; with one worker the norm is the
        CPU oracle's to 1e-12 relative."""
        from repro_torch.core import RunConfig, run_fixed_point
        from repro_torch.core.engine import coordinator
        from repro_torch.telemetry.export import trace_lanes

        seen = []
        result0 = coordinator.Coordinator.result

        def spy(self, *a, **k):
            seen.append(dict(self.device_local_norms))
            return result0(self, *a, **k)

        prob = JacobiProblem(grid=256, sweeps=5, seed=0, device=dev)
        coordinator.Coordinator.result = spy
        try:
            ops.reset_launch_counts()
            r = run_fixed_point(prob, RunConfig(
                mode="async", executor="thread", n_workers=4,
                max_updates=200, tol=1e-300, device_plane="on",
                accel=AndersonConfig(m=5), fire_every=4, telemetry=True))
            launches = ops.launch_counts()
            ones = [run_fixed_point(JacobiProblem(
                grid=256, sweeps=5, seed=0, device=d), RunConfig(
                    mode="async", executor="thread", n_workers=1,
                    max_updates=20, tol=1e-300, device_plane=plane))
                for d, plane in ((dev, "on"), ("cpu", "ref"))]
        finally:
            coordinator.Coordinator.result = result0
        assert r.device_dispatches > 0
        assert launches["jacobi_halo_sweeps"] >= r.device_dispatches
        assert set(seen[0]) == {0, 1, 2, 3}
        assert {"w0", "w1", "w2", "w3"} <= set(trace_lanes(r.telemetry))
        fires = r.telemetry_summary["fires"]
        assert sum(fires.values()) == r.accel_fires > 0
        assert fires.get("accept", 0) == r.accel_accepts
        np.testing.assert_allclose(ones[0].x, ones[1].x, rtol=1e-12, atol=0)
        (gw,), (cw,) = seen[1].items(), seen[2].items()
        assert gw[0] == cw[0] == 0
        assert gw[1] == pytest.approx(cw[1], rel=1e-12)

    def test_telemetry_eval_spans_on_the_card(self, dev):
        from repro_torch.core import RunConfig, run_fixed_point

        r = run_fixed_point(
            JacobiProblem(grid=256, sweeps=5, seed=0, device=dev),
            RunConfig(mode="async", executor="thread", n_workers=4,
                      max_updates=200, tol=1e-300,
                      accel=AndersonConfig(m=5), fire_every=4,
                      accel_eval="worker", telemetry=True))
        evals = [e for e in r.telemetry.events if e["k"] == "eval"]
        assert evals and all(e["t1"] >= e["t0"] for e in evals)
        assert r.offloaded_evals > 0

    def test_two_request_service_on_the_card(self, dev):
        """Two requests of two families through one SolverService at
        ``max_active=2`` on ``cuda:0`` run concurrently and each equals
        its solo run's result on the card."""
        from repro_torch.core import FaultProfile, RunConfig, run_fixed_point
        from repro_torch.serve import ServiceConfig, SolverService

        jac = JacobiProblem(grid=256, sweeps=5, seed=0, device=dev)
        vi = ValueIterationProblem(GarnetMDP(S=20000, A=4, b=5, gamma=0.95,
                                             seed=0, device=dev))
        cfg = RunConfig(mode="async", executor="virtual", n_workers=4,
                        max_updates=200, tol=1e-300, compute_time=1e-3,
                        accel=AndersonConfig(m=5, mix_kernel_n=1),
                        fire_every=4, faults=FaultProfile(delay_mean=2e-3))
        ops.reset_launch_counts()
        with SolverService(ServiceConfig(max_active=2,
                                         telemetry=True)) as svc:
            tickets = [svc.submit(p, cfg, tenant=t)
                       for p, t in ((jac, "a"), (vi, "b"))]
            results = [t.result(timeout=300.0) for t in tickets]
            stats = svc.stats()
        launches = ops.launch_counts()
        assert stats["served"] == {"a": 1, "b": 1} and stats["failed"] == 0
        for k in ("jacobi_halo_sweeps", "jacobi_sweep", "bellman",
                  "anderson_mix"):
            assert launches[k] > 0, k
        for p, r in zip((jac, vi), results):
            solo = run_fixed_point(p, cfg)
            assert r.x.tobytes() == solo.x.tobytes()
            assert r.residual_norm < p.residual_norm(p.initial())


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
    (1, 224, 1500, 20, 20, 64, False, None, None, 0),  # Whisper's cross
    (1, 1500, 1500, 20, 20, 64, False, None, None, 0),  # Whisper's encoder
    (1, 320, 320, 64, 8, 128, True, None, None, 0),  # Qwen2-VL's 8:1 GQA
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

    def test_bf16_views_with_8_byte_strides_are_copied(self, dev):
        """bfloat16 heads 72 bytes apart (8-byte, not 16-byte, strides):
        TMA cannot read them in place, so the wrapper copies them, and the
        answer is the contiguous input's, bit for bit."""
        r = np.random.default_rng(7)
        base = torch.as_tensor(r.standard_normal((2, 70, 4, 36)),
                               dtype=torch.bfloat16, device=dev)
        q, k, v = base[..., :32], base[:, :, :2, 4:], base[:, :, 2:, 4:]
        for t in (q, k, v):
            assert t.stride(2) * 2 % 16 == 8
            assert not aligned(t.data_ptr(), t.shape, t.stride(), 2)
        kw = dict(causal=True, window=40, softcap=50.0)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
        assert torch.equal(got, want)
        torch.testing.assert_close(got.float(),
                                   ref.flash_attention(q, k, v, **kw).float(),
                                   rtol=2e-2, atol=2e-2)

    @pytest.mark.parametrize("window", [512, None])
    def test_bf16_no_further_from_float32_than_the_reference_math(
            self, dev, window):
        """Gemma-2-2B's heads at S = 2048: the max and the RMS of
        |kernel - plain| are no larger than those of the JAX package's own
        bfloat16 attention math (``train_attention``: scores and weights
        rounded to bfloat16, softcap 50) against the same plain version."""
        cfg = get_config("gemma2_2b")
        r = np.random.default_rng(11)
        B, S = 1, 2048
        q = torch.as_tensor(r.standard_normal((B, S, cfg.n_heads, cfg.hd)),
                            dtype=torch.bfloat16, device=dev)
        k, v = (torch.as_tensor(
            r.standard_normal((B, S, cfg.n_kv_heads, cfg.hd)),
            dtype=torch.bfloat16, device=dev) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        want = ref.flash_attention(q, k, v, **kw).float()
        dk = ops.flash_attention(q, k, v, **kw).float() - want
        dr = train_attention(cfg, q, k, v, causal=True,
                             window=window).float() - want
        assert float(dk.abs().max()) <= float(dr.abs().max())
        assert float(dk.pow(2).mean()) <= float(dr.pow(2).mean())

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


class TestEncDecAndVlmOnTheCard:
    """Reduced Whisper and Qwen2-VL served on the card against the plain
    CPU run of the same weights (float32): logits within 1e-4 relative
    with identical greedy tokens; and the flash launches a prefill at the
    smoke's depths (Whisper's 32 + 32 layers, Qwen2-VL's cut to 8) on
    reduced widths: one per layer and role."""

    @staticmethod
    def _inputs(cfg, B, S, gen, device):
        if cfg.kind == "encdec":
            return lm_serve.audio_inputs(cfg, B, 48, device,
                                         torch.float32), None
        return lm_serve.vision_inputs(cfg, B, S, gen, device, torch.float32)

    @pytest.mark.parametrize("arch", ["whisper_large_v3", "qwen2_vl_72b"])
    def test_serve_matches_cpu(self, dev, arch):
        cfg = lm_serve.make_config(arch, reduced=True)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=1)
        prompt = lm_serve.make_prompt(cfg, 2, 64, cpu)
        inputs, dec = self._inputs(cfg, 2, 64, 6, cpu)  # a 4 x 4 grid
        want = lm_serve.serve(cfg, params, prompt, gen=6, keep_logits=True,
                              inputs=inputs, decode_positions=dec)
        ops.reset_launch_counts()
        got = lm_serve.serve(
            cfg, params.to(dev), prompt.to(dev), gen=6, keep_logits=True,
            inputs={k: t.to(dev) for k, t in inputs.items()},
            decode_positions=None if dec is None else dec.to(dev))
        launches = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers
                                   if cfg.kind == "encdec" else 0)
        assert ops.launch_counts()["flash_attention"] == launches
        assert torch.equal(got.tokens.cpu(), want.tokens)
        for a, b in zip([got.prefill_logits] + got.step_logits,
                        [want.prefill_logits] + want.step_logits):
            rel = float((a.cpu() - b).abs().max() / b.abs().max())
            assert rel <= 1e-4

    @pytest.mark.parametrize("arch,depth,want", [
        ("whisper_large_v3", 32, {"encoder": 32, "self": 32, "cross": 32}),
        ("qwen2_vl_72b", 8, {"self": 8}),
    ])
    def test_flash_launches_per_prefill(self, dev, arch, depth, want):
        import dataclasses

        from repro_torch.launch.lm_profile import flash_roles, role_summary
        from repro_torch.models import init_params

        cfg = dataclasses.replace(lm_serve.make_config(arch, reduced=True),
                                  n_layers=depth)
        if cfg.kind == "encdec":
            cfg = dataclasses.replace(cfg, n_enc_layers=depth)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        prompt = lm_serve.make_prompt(cfg, 2, 64, dev)
        inputs, _ = self._inputs(cfg, 2, 64, 1, dev)
        ops.reset_launch_counts()
        with flash_roles() as calls:
            lm_serve.serve(cfg, params, prompt, 1,
                           inputs={k: t.to(params.embed["embedding"].dtype)
                                   if t.is_floating_point() else t
                                   for k, t in inputs.items()})
        roles = role_summary(calls)
        assert {r: v["launches"] for r, v in roles.items()} == want
        assert ops.launch_counts()["flash_attention"] == sum(want.values())


class TestMoeAndXlstmOnTheCard:
    """``moe_ffn`` and the MoE and xLSTM serving paths on the card against
    the plain CPU run of the same weights (float32): the layer within
    1e-5 relative with the same routing and the same drops; served logits
    within 1e-4 with identical greedy tokens."""

    @staticmethod
    def _moe_cfg(capacity_factor):
        import dataclasses

        cfg = get_config("qwen2_moe_a2p7b").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6, pad_to=8, capacity_factor=capacity_factor))

    @pytest.mark.parametrize("capacity_factor,dropless", [
        (8.0, False), (0.5, False), (1.25, True)])
    def test_moe_ffn_matches_cpu(self, dev, capacity_factor, dropless):
        from repro_torch.models import moe
        from repro_torch.models.common import materialize

        cfg = self._moe_cfg(capacity_factor)
        p = materialize(moe.moe_spec(cfg), torch.Generator().manual_seed(0),
                        dtype=torch.float32)
        pd = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(dev)) for k, v in p.items()}
        x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1))
        want, waux = moe.moe_ffn(cfg, p, x, dropless=dropless)
        got, gaux = moe.moe_ffn(cfg, pd, x.to(dev), dropless=dropless)
        xt = x.reshape(-1, cfg.d_model)
        assert torch.equal(moe.route(cfg, pd, xt.to(dev)).top_e.cpu(),
                           moe.route(cfg, p, xt).top_e)
        assert int(gaux["moe_dropped"]) == int(waux["moe_dropped"])
        assert (int(waux["moe_dropped"]) > 0) == (capacity_factor == 0.5)
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        assert rel <= 1e-5
        for k in ("moe_load_balance", "moe_router_z"):
            assert abs(float(gaux[k]) - float(waux[k])) <= 1e-6 * max(
                abs(float(waux[k])), 1.0)

    @pytest.mark.parametrize("arch,flash", [("qwen2_moe_a2p7b", True),
                                            ("olmoe_1b_7b", True),
                                            ("xlstm_125m", False)])
    def test_serve_matches_cpu(self, dev, arch, flash):
        cfg = lm_serve.make_config(arch, reduced=True)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=1)
        prompt = lm_serve.make_prompt(cfg, 2, 40, cpu)
        want = lm_serve.serve(cfg, params, prompt, gen=6, keep_logits=True)
        ops.reset_launch_counts()
        got = lm_serve.serve(cfg, params.to(dev), prompt.to(dev), gen=6,
                             keep_logits=True)
        assert ops.launch_counts()["flash_attention"] == (
            cfg.n_layers if flash else 0)
        assert torch.equal(got.tokens.cpu(), want.tokens)
        for a, b in zip([got.prefill_logits] + got.step_logits,
                        [want.prefill_logits] + want.step_logits):
            rel = float((a.cpu() - b).abs().max() / b.abs().max())
            assert rel <= 1e-4


class TestTrainingOnTheCard:
    def test_flash_refuses_inputs_that_require_grad(self, dev):
        q = torch.randn(1, 16, 2, 16, device=dev, requires_grad=True)
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(q, q, q)
        assert ops.launch_counts()["flash_attention"] == 0
        with torch.no_grad():
            ops.flash_attention(q, q, q)
        assert ops.launch_counts()["flash_attention"] == 1

    @pytest.mark.parametrize("accum", [1, 2])
    def test_train_step_matches_cpu(self, dev, accum):
        """Depth 2 (a local and a global layer), a window shorter than the
        sequence: the card against the CPU on the same weights, with no
        flash launch under grad."""
        import copy

        from repro_torch.configs import get_config
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import init_params, make_trainable
        from repro_torch.training.optimizer import AdamWConfig, adamw_init

        cfg = get_config("gemma2_2b").reduced(n_layers=2, window=16)
        cpu = torch.device("cpu")
        base = init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=cpu)
        models = {"cpu": copy.deepcopy(base), "card": base.to(dev)}
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
        step = make_train_step(cfg, opt_cfg, accum)
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 48)).astype(np.int32))
        out = {}
        ops.reset_launch_counts()
        for key, d in (("cpu", cpu), ("card", dev)):
            state = adamw_init(make_trainable(models[key]), opt_cfg)
            out[key] = step(models[key], state, {"tokens": toks.to(d)})[2]
        assert ops.launch_counts()["flash_attention"] == 0
        fc, fg = models["cpu"].flat, models["card"].flat
        assert abs(out["card"]["loss"] - out["cpu"]["loss"]) <= (
            1e-4 * abs(out["cpu"]["loss"]))
        for lf in fc.leaves:
            want = fc.grad[lf.start:lf.stop]
            got = fg.grad[lf.start:lf.stop].cpu()
            assert float((got - want).abs().max()
                         / want.abs().max()) <= 1e-4, lf.path
        # Adam moves an element by about lr whatever its gradient's size:
        # only an element whose gradient is within 100x of the card's
        # difference from the CPU's may move up to 2 lr the other way, and
        # those are few; the rest stay within lr / 10.
        lr = out["cpu"]["lr"]
        near = fc.grad.abs() <= 100 * (fg.grad.cpu() - fc.grad).abs()
        diff = (fg.theta.cpu() - fc.theta).abs()
        far = diff > lr / 10
        assert not (far & ~near).any()
        assert int(far.sum()) <= 1e-4 * fc.n
        assert float(diff.max()) <= 2 * lr

    def test_async_dp_on_the_card_matches_cpu(self, dev):
        """The tiny async-dp problem's full map and a DiLoCo outer step
        with Anderson, the window's combine through anderson_mix."""
        from repro_torch.launch import async_dp_lm
        from repro_torch.training.async_dp import GradientWorkersProblem
        from repro_torch.training.diloco import DiLoCoConfig, DiLoCoTrainer

        cfg = async_dp_lm.make_config("tiny")
        cpu = GradientWorkersProblem(cfg, batch=4, seq=16, lr=0.25,
                                     device="cpu")
        card = GradientWorkersProblem(cfg, batch=4, seq=16, lr=0.25,
                                      params=cpu.initial(), device=dev)
        x0 = cpu.initial()
        got, want = card.full_map(x0), cpu.full_map(x0)
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
        dcfg = DiLoCoConfig(n_pods=2, inner_steps=2, outer_steps=3,
                            inner_lr=0.001, accel=AndersonConfig(
                                m=3, mix_kernel_n=1))
        runs = {}
        ops.reset_launch_counts()
        for key, d in (("cpu", "cpu"), ("card", dev)):
            runs[key] = DiLoCoTrainer(cfg, dcfg, batch=4, seq=16,
                                      params=x0, device=d).run()
        assert ops.launch_counts()["anderson_mix"] > 0
        assert runs["card"].accel_accepts == runs["cpu"].accel_accepts
        a, b = np.array(runs["card"].losses), np.array(runs["cpu"].losses)
        assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(b))


class TestSelectiveScanKernel:
    """``selective_scan`` (``csrc/selective_scan.cu``) against its plain
    version on the card on the same inputs: ``max|kernel - plain| /
    max|plain|`` at most 1e-5 for y and the final state (the kernel walks
    time in order, the plain version doubles; both round ``dt * xc`` to
    the input type once), over both state sizes, both input types, with
    and without ``h0``, at lengths that are no multiple of the kernel's
    16- and 32-step tiles, just under and over a tile and its
    three-tile ring (float32 16 and 48 steps, bfloat16 32 and 96), at one
    length of 4100, at channel counts that are no multiple of a CTA's 256
    or of a 16-byte chunk (the plain-load path), with batch 3, and with B
    and C read in place from a projection's columns (the model's
    views)."""

    @staticmethod
    def _inputs(dev, B, S, di, ds, dtype, seed=0, views=False):
        import math

        g = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(generator=g, device=dev)
        dt = torch.exp(torch.empty(B, S, di, device=dev).uniform_(
            math.log(1e-3), math.log(1e-1), generator=g)).to(dtype)
        xc = torch.randn(B, S, di, **kw).to(dtype)
        if views:  # columns of one (B, S, 5 + 2 ds) projection
            proj = torch.randn(B, S, 5 + 2 * ds, **kw).to(dtype)
            Bm, Cm = proj[..., 5:5 + ds], proj[..., 5 + ds:]
        else:
            Bm, Cm = (torch.randn(B, S, ds, **kw).to(dtype) for _ in range(2))
        A = -torch.exp(torch.empty(di, ds, device=dev).uniform_(
            -1.0, 1.5, generator=g))
        return dt, xc, Bm, Cm, A

    @staticmethod
    def _rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    @pytest.mark.parametrize("ds", [8, 16])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("with_h0", [False, True])
    @pytest.mark.parametrize("B,S,di", [(1, 1, 32), (2, 33, 130),
                                        (2, 100, 256), (1, 515, 384),
                                        (1, 15, 72), (2, 17, 200),
                                        (1, 31, 64), (2, 47, 130),
                                        (1, 49, 96), (2, 95, 200),
                                        (1, 97, 64), (3, 70, 192),
                                        (1, 4100, 72)])
    @pytest.mark.parametrize("views", [False, True])
    def test_matches_plain(self, dev, ds, dtype, with_h0, B, S, di, views):
        dt, xc, Bm, Cm, A = self._inputs(dev, B, S, di, ds, dtype,
                                         views=views)
        h0 = (torch.randn(B, di, ds, device=dev) if with_h0 else None)
        y, h = ops.selective_scan(dt, xc, Bm, Cm, A, h0)
        wy, wh = ref.selective_scan(dt, xc, Bm, Cm, A, h0, chunk=None)
        assert y.dtype == h.dtype == torch.float32
        assert y.shape == (B, S, di) and h.shape == (B, di, ds)
        assert self._rel(y, wy) <= 1e-5
        assert self._rel(h, wh) <= 1e-5

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_reads_b_and_c_in_place(self, dev, dtype):
        dt, xc, Bm, Cm, A = self._inputs(dev, 2, 70, 160, 16, dtype,
                                         views=True)
        assert not Bm.is_contiguous()
        y, h = ops.selective_scan(dt, xc, Bm, Cm, A)
        wy, wh = ref.selective_scan(dt, xc, Bm.contiguous(),
                                    Cm.contiguous(), A)
        assert self._rel(y, wy) <= 1e-5 and self._rel(h, wh) <= 1e-5

    def test_launches_are_counted_and_grad_refused(self, dev):
        dt, xc, Bm, Cm, A = self._inputs(dev, 1, 8, 32, 8, torch.float32)
        ops.reset_launch_counts()
        ops.selective_scan(dt, xc, Bm, Cm, A)
        assert ops.launch_counts()["selective_scan"] == 1
        A.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.selective_scan(dt, xc, Bm, Cm, A)
        with torch.no_grad():
            ops.selective_scan(dt, xc, Bm, Cm, A)
        assert ops.launch_counts()["selective_scan"] == 2

    @pytest.mark.parametrize("change", ["d_state", "dtype", "contiguous"])
    def test_rejects_what_the_kernel_does_not_take(self, dev, change):
        dt, xc, Bm, Cm, A = self._inputs(dev, 1, 8, 32, 8, torch.float32)
        if change == "d_state":
            Bm, Cm, A = Bm[..., :4], Cm[..., :4], A[:, :4].contiguous()
        elif change == "dtype":
            dt, xc = dt.half(), xc.half()
            Bm, Cm = Bm.half(), Cm.half()
        else:  # the same shape, time innermost
            dt = dt.transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError):
            ops.selective_scan(dt, xc, Bm, Cm, A)


class TestMoeExpertKernel:
    """``moe_expert_ffn`` (``csrc/moe_expert_ffn.cu``) against its plain
    version at shapes with ragged K, column and token tiles: d 264 (four
    64-wide K tiles and 8 more), f 200 (gate and up in 64-column tiles, 8
    left over), 5 experts of which 3 are picked."""

    E, D, F = 5, 264, 200
    USED = (1, 0, 1, 1, 0)

    @classmethod
    def _inputs(cls, dev, T, act, dtype, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        wi_shape = ((cls.E, cls.D, 2, cls.F) if act in ("swiglu", "geglu")
                    else (cls.E, cls.D, cls.F))
        x = torch.randn(T, cls.D, generator=g, device=dev).to(dtype)
        wi = (torch.randn(*wi_shape, generator=g, device=dev)
              / cls.D ** 0.5).to(dtype)
        wo = (torch.randn(cls.E, cls.F, cls.D, generator=g, device=dev)
              / cls.F ** 0.5).to(dtype)
        used = torch.tensor(cls.USED + (1,), dtype=torch.int32, device=dev)
        return x, wi, wo, used

    @staticmethod
    def _err(got, want):
        """(max |got - want| / max |want|, RMS of got - want) over the
        picked experts' rows."""
        d = got.float() - want.float()
        return (float(d.abs().max() / want.float().abs().max()),
                float(d.pow(2).mean().sqrt()))

    @pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
    @pytest.mark.parametrize("T", [1, 2, 5, 32, 33, 64, 70, 200])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_matches_plain(self, dev, act, T, dtype):
        """float32: within 1e-5 of the plain version (FFMA along K in
        order against cuBLAS's blocked sums).  bfloat16: within 1e-2 of
        the plain version run in float32 on the same bfloat16 inputs, and
        its RMS error no larger than the plain bfloat16 version's: the
        kernel sums in float32 and rounds h and out once each (2^-9
        relative), where the plain version also rounds gate, up, the
        activation and their product."""
        x, wi, wo, used = self._inputs(dev, T, act, dtype)
        ops.reset_launch_counts()
        got = ops.moe_expert_ffn(x, wi, wo, used, act=act)
        assert ops.launch_counts()["moe_expert_ffn"] == 1
        assert got.shape == (self.E, T, self.D) and got.dtype == dtype
        picked = [e for e, u in enumerate(self.USED) if u]
        want = ref.moe_expert_ffn(x.float(), wi.float(), wo.float(), used,
                                  act=act)[picked]
        rel, rms = self._err(got[picked], want)
        if dtype == torch.float32:
            assert rel <= 1e-5
        else:
            plain = ref.moe_expert_ffn(x, wi, wo, used, act=act)[picked]
            assert rel <= 1e-2
            assert rms <= self._err(plain, want)[1]

    def test_a_ranks_slice_of_the_experts(self, dev):
        """``_dropless_combine`` on experts [e0, e0 + E') of a layer (a
        ``"model"`` rank's slice, e0 > 0) against the CPU run of the same
        slice: the kernel reads the slice in place; the assignments to
        other ranks' experts weigh 0."""
        import dataclasses

        from repro_torch.models import moe
        from repro_torch.models.common import materialize

        cfg = get_config("olmoe_1b_7b").reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2))
        p = materialize(moe.moe_spec(cfg), torch.Generator().manual_seed(0),
                        dtype=torch.float32)
        xt = torch.randn(6, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
        r = moe.route(cfg, p, xt)
        e0, n = 4, 2  # a (1, 4) mesh's third rank
        part = {k: p[k][e0:e0 + n] for k in ("wi", "wo")}
        want = moe._dropless_combine(cfg, part, xt, r, r.top_p, e0)
        on = {k: v.to(dev) for k, v in part.items()}
        r_dev = moe.Routing(*(t.to(dev) for t in r))
        ops.reset_launch_counts()
        got = moe._dropless_combine(cfg, on, xt.to(dev), r_dev,
                                    r_dev.top_p, e0)
        assert ops.launch_counts()["moe_expert_ffn"] == 1
        mine = ((r.top_e >= e0) & (r.top_e < e0 + n)).any(-1)
        assert mine.any() and not mine.all()
        assert not want[~mine].any() and not got.cpu()[~mine].any()
        assert float((got.cpu() - want).abs().max()
                     / want.abs().max()) <= 1e-5

    def test_reads_only_the_picked_experts(self, dev):
        """One token picks 2 of 8 experts: the other 6 experts' weights
        are NaN on the card, and the layer still equals the CPU's on clean
        weights; ``moe.experts_streamed`` counts the 2 (none gathered),
        under a profiler, without a synchronise."""
        import dataclasses

        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import moe
        from repro_torch.models.common import materialize
        from repro_torch.telemetry import serving

        cfg = get_config("olmoe_1b_7b").reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2))
        p = materialize(moe.moe_spec(cfg), torch.Generator().manual_seed(0),
                        dtype=torch.float32)
        x = torch.randn(1, 1, cfg.d_model,
                        generator=torch.Generator().manual_seed(2))
        want, _ = moe.moe_ffn(cfg, p, x, dropless=True, losses=False)
        top = moe.route(cfg, p, x.reshape(1, -1)).top_e.reshape(-1)
        pd = {k: v.to(dev) for k, v in p.items()}
        other = torch.ones(8, dtype=torch.bool)
        other[top] = False
        for k in ("wi", "wo"):
            pd[k][other.to(dev)] = float("nan")
        xd = x.to(dev)
        torch.cuda.synchronize()
        serving.reset_serve_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, _ = moe.moe_ffn(cfg, pd, xd, dropless=True,
                                     losses=False)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counters = serving.serve_counters()
        serving.reset_serve_counters()
        assert counters["moe.experts_streamed"] == 2
        assert "moe.experts_gathered" not in counters
        assert torch.isfinite(got).all()
        assert float((got.cpu() - want).abs().max()
                     / want.abs().max()) <= 1e-5

    def test_launches_are_counted_and_grad_refused(self, dev):
        x, wi, wo, used = self._inputs(dev, 3, "swiglu", torch.bfloat16)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.moe_expert_ffn(x, wi, wo, used, act="swiglu")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ops.launch_counts()["moe_expert_ffn"] == 1
        wi.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.moe_expert_ffn(x, wi, wo, used, act="swiglu")
        with torch.no_grad():
            ops.moe_expert_ffn(x, wi, wo, used, act="swiglu")
        assert ops.launch_counts()["moe_expert_ffn"] == 2

    @pytest.mark.parametrize("change", ["dtype", "contiguous", "width",
                                        "used"])
    def test_rejects_what_the_kernel_does_not_take(self, dev, change):
        x, wi, wo, used = self._inputs(dev, 3, "swiglu", torch.bfloat16)
        if change == "dtype":
            x, wi, wo = x.half(), wi.half(), wo.half()
        elif change == "contiguous":  # the same shape, experts innermost
            wo = wo.permute(1, 2, 0).contiguous().permute(2, 0, 1)
        elif change == "width":  # d not a whole number of 16-byte chunks
            x, wi, wo = x[:, :260], wi[:, :260].contiguous(), wo[..., :260]
            x, wo = x.contiguous(), wo.contiguous()
        else:
            used = used.long()
        with pytest.raises(ValueError):
            ops.moe_expert_ffn(x, wi, wo, used, act="swiglu")


class TestJambaOnTheCard:
    def test_serve_matches_cpu_at_depth_5(self, dev):
        """Reduced Jamba's first 5 layers ((mamba, mlp), (mamba, moe),
        (mamba, mlp), (mamba, moe), (attn, mlp)) served on the card
        against the CPU on the same float32 weights: logits within 1e-4
        relative with identical greedy tokens; one flash launch and 4
        ``selective_scan`` launches a prefill, none in decode; one
        ``moe_expert_ffn`` launch a MoE layer in decode."""
        import dataclasses

        cfg = dataclasses.replace(
            lm_serve.make_config("jamba_1p5_large_398b", reduced=True),
            n_layers=5)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=1)
        prompt = lm_serve.make_prompt(cfg, 2, 40, cpu)
        want = lm_serve.serve(cfg, params, prompt, gen=6, keep_logits=True)
        ops.reset_launch_counts()
        got = lm_serve.serve(cfg, params.to(dev), prompt.to(dev), gen=6,
                             keep_logits=True)
        counts = ops.launch_counts()
        assert counts["flash_attention"] == 1
        assert counts["selective_scan"] == 4
        assert counts["moe_expert_ffn"] == 2 * 5  # 2 MoE layers a step
        assert torch.equal(got.tokens.cpu(), want.tokens)
        for a, b in zip([got.prefill_logits] + got.step_logits,
                        [want.prefill_logits] + want.step_logits):
            rel = float((a.cpu() - b).abs().max() / b.abs().max())
            assert rel <= 1e-4


def _split_rank(rank, world, out_dir, device):
    """One ``gloo`` rank on ``device`` of the (1, 2) mesh: reduced Jamba
    (5 layers) and xLSTM prefill and 4 teacher-forced decode steps on its
    slices, the gathered logits and the scan and flash launches saved."""
    import dataclasses
    import os

    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    mesh = make_mesh((1, 2), ("data", "model"))
    out = {}
    for arch, n_layers in (("jamba_1p5_large_398b", 5), ("xlstm_125m", 4)):
        cfg = dataclasses.replace(lm_serve.make_config(arch, reduced=True),
                                  n_layers=n_layers)
        whole = lm_serve.make_params(cfg, torch.device("cpu"), seed=1)
        params = tf.shard_params(whole.to(dev), mesh)
        prompt = lm_serve.make_prompt(cfg, 2, 40, torch.device("cpu"))
        ops.reset_launch_counts()
        with use_mesh(mesh), torch.no_grad():
            logits, caches = tf.prefill(
                cfg, params, {"tokens": prompt.to(dev)}, max_len=44)
            got = [tf.gather_logits(cfg, logits).cpu()]
            for t in range(4):
                tok = prompt[:, t:t + 1].to(dev)
                logits, caches = tf.decode_step(cfg, params, caches, tok,
                                                40 + t)
                got.append(tf.gather_logits(cfg, logits).cpu())
        out[arch] = (got, dict(ops.launch_counts()))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


class TestInnerSplitOnTheCard:
    def test_split_mixers_on_two_ranks_match_the_cpu(self, dev, tmp_path):
        """Reduced Jamba (5 layers: Mamba, MoE, attention) and xLSTM split
        over two ``gloo`` processes on the card (mesh (1, 2)): the
        prefill's and 4 decode steps' logits within 1e-4 relative of one
        rank on the CPU; a rank's prefill launches 4 ``selective_scan``s
        at its channels and one flash kernel."""
        import dataclasses
        import os

        from repro_torch.distributed import ranks
        from repro_torch.models import transformer as tf

        ranks.run("test_torch_cuda:_split_rank", 2,
                  args=[str(tmp_path), str(dev)],
                  path=[os.path.dirname(os.path.abspath(__file__))],
                  timeout=300)
        got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
        cpu = torch.device("cpu")
        for arch, n_layers in (("jamba_1p5_large_398b", 5),
                               ("xlstm_125m", 4)):
            cfg = dataclasses.replace(
                lm_serve.make_config(arch, reduced=True), n_layers=n_layers)
            params = lm_serve.make_params(cfg, cpu, seed=1)
            prompt = lm_serve.make_prompt(cfg, 2, 40, cpu)
            with torch.no_grad():
                logits, caches = tf.prefill(cfg, params, {"tokens": prompt},
                                            max_len=44)
                want = [logits]
                for t in range(4):
                    logits, caches = tf.decode_step(
                        cfg, params, caches, prompt[:, t:t + 1], 40 + t)
                    want.append(logits)
            for r in range(2):
                logs, counts = got[r][arch]
                for a, b in zip(logs, want):
                    rel = float((a.float() - b.float()).abs().max()
                                / b.float().abs().max())
                    assert rel <= 1e-4, (arch, r, rel)
                if arch.startswith("jamba"):
                    assert counts["selective_scan"] == 4
                    assert counts["flash_attention"] == 1
