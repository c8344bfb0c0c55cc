"""The port's asynchronous data-parallel training against the JAX package.

``GradientWorkersProblem`` and ``BlockGradientWorkersProblem`` at the
benchmark's tiny config (``benchmarks/async_dp_lm.py``: gemma_2b reduced
to one layer, d_model 32, vocab 64), batch 4 x 16, with the reference's
θ carried over, run through each package's engine on the virtual
backend for the benchmark's fast budget (120 updates), with and without
coordinator Anderson (m=5, a fire every 8 arrivals) and with worker 0 a
0.05 s straggler.  Then DiLoCo in sync and async mode (pod 0 a 3 s
straggler), with Anderson.

At the benchmark's learning rate (0.25; DiLoCo's inner 0.1) the training
map is chaotic in float32: the reference run against itself, started
from θ0 perturbed by 1e-7 relative, is 4.6e-2 apart after five full
steps (``TestChaos`` measures it), and its block-coordinate run is still
2e-2 apart after 120 updates at lr 0.003.  No two float32 libraries can
agree to 1e-4 there, so the packages are held to the same decisions at
a learning rate where the reference is stable (0.001: a 1e-7
perturbation of θ0 stays below 2e-6 over 120 updates of either design):
identical ``worker_updates``, ``accel_fires`` and ``accel_accepts``
(DiLoCo: ``outer_updates``, ``accel_accepts``, ``accel_rejects``,
virtual walls) and losses within 1e-4 relative.  At the benchmark's
rate the launcher's runs must reduce the loss, and DiLoCo's schedule
must match the reference's; the gaps are printed (``-s``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AndersonConfig as JAndersonConfig  # noqa: E402
from repro.core import FaultProfile as JFaultProfile  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402
from repro.models.transformer import init_params as j_init_params  # noqa: E402
from repro.training import async_dp as j_async_dp  # noqa: E402
from repro.training import diloco as j_diloco  # noqa: E402

from repro_torch import AndersonConfig, FaultProfile, RunConfig  # noqa: E402
from repro_torch import run_fixed_point  # noqa: E402
from repro_torch.core.fixedpoint import contiguous_blocks  # noqa: E402
from repro_torch.launch import async_dp_lm  # noqa: E402
from repro_torch.training import async_dp, diloco  # noqa: E402
from repro_torch.training.compression import Compressor  # noqa: E402

TINY = async_dp_lm.CONFIGS["tiny"]
BUDGET = 120  # the benchmark's fast budget
RTOL = 1e-4
#: a learning rate at which the reference is not chaotic (module docstring)
STABLE_LR = 0.001


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _cfgs():
    return (j_get_config("gemma_2b").reduced(**TINY),
            async_dp_lm.make_config("tiny"))


DESIGNS = {
    "full_grad": (j_async_dp.GradientWorkersProblem,
                  async_dp.GradientWorkersProblem, {}),
    "block_grad": (j_async_dp.BlockGradientWorkersProblem,
                   async_dp.BlockGradientWorkersProblem,
                   dict(local_steps=4)),
}


def _problems(design, lr):
    jcls, tcls, kw = DESIGNS[design]
    jcfg, tcfg = _cfgs()
    jp = jcls(jcfg, batch=4, seq=16, lr=lr, **kw)
    tp = tcls(tcfg, batch=4, seq=16, lr=lr, params=jp.initial(),
              device="cpu", **kw)
    return jp, tp


def _run_cfgs(accel: bool):
    kw = dict(mode="async", tol=1e-9, max_updates=BUDGET, compute_time=5e-3,
              record_every=10**9, seed=0)
    j = dict(kw, faults={0: JFaultProfile(delay_mean=0.05)})
    t = dict(kw, faults={0: FaultProfile(delay_mean=0.05)})
    if accel:
        j.update(accel=JAndersonConfig(m=5), fire_every=8)
        t.update(accel=AndersonConfig(m=5), fire_every=8)
    return JRunConfig(**j), RunConfig(**t)


class TestProblems:
    @pytest.mark.parametrize("design", sorted(DESIGNS))
    def test_problem_matches_reference(self, design):
        jp, tp = _problems(design, 0.25)
        x0 = jp.initial()
        assert tp.n == jp.n and np.array_equal(tp.initial(), x0)
        assert _rel(tp.loss(x0), jp.loss(x0)) <= RTOL
        assert _rel(tp.residual_norm(x0), jp.residual_norm(x0)) <= RTOL
        blk = contiguous_blocks(jp.n, 4)[1]
        got, want = tp.block_update(x0, blk), jp.block_update(x0, blk)
        assert got.dtype == np.float64 and _rel(got, want) <= RTOL
        assert tp._step == jp._step
        assert _rel(tp.full_map(x0), jp.full_map(x0)) <= RTOL

    @pytest.mark.parametrize("accel", [False, True], ids=["plain", "anderson"])
    @pytest.mark.parametrize("design", sorted(DESIGNS))
    def test_run_matches_reference(self, design, accel):
        jp, tp = _problems(design, STABLE_LR)
        jrc, trc = _run_cfgs(accel)
        want, got = j_run(jp, jrc), run_fixed_point(tp, trc)
        assert ((got.worker_updates, got.accel_fires, got.accel_accepts)
                == (want.worker_updates, want.accel_fires,
                    want.accel_accepts))
        assert got.worker_updates == BUDGET
        assert got.accel_fires == (BUDGET // 8 if accel else 0)
        jl, tl = jp.loss(want.x), tp.loss(got.x)
        gap = _rel(tl, jl)
        print(f"{design} accel={accel} lr={STABLE_LR}: loss port {tl:.6f} "
              f"ref {jl:.6f} rel gap {gap:.2e}; iterate rel gap "
              f"{_rel(got.x, want.x):.2e}")
        assert gap <= RTOL
        assert tl < tp.loss(tp.initial())

    def test_start_from_a_model_copies_it(self):
        jcfg, tcfg = _cfgs()
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32)
        from repro_torch import convert

        model = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        a = async_dp.GradientWorkersProblem(tcfg, params=model, device="cpu")
        b = async_dp.GradientWorkersProblem(tcfg, params=model, device="cpu")
        theta = np.asarray(ravel_pytree(jparams)[0], np.float64)
        assert np.array_equal(a.initial(), theta)
        a.full_map(theta + 1.0)  # writes a's buffers only
        assert np.array_equal(b.flat.theta.numpy(), theta.astype(np.float32))
        assert a.model is not model and b.model is not model

    @pytest.mark.parametrize("design", sorted(DESIGNS))
    def test_start_from_a_trainable_model(self, design):
        """A model already bound to its own flat buffer: the problem's copy
        is bound to a buffer of its own, so its evaluations move θ and
        score the iterate they are given, as from an untrainable copy."""
        from repro_torch import convert

        _, tcls, kw = DESIGNS[design]
        jcfg, tcfg = _cfgs()
        arrays = jax.tree.map(np.asarray, j_init_params(
            jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
        model = convert.lm_params_from_arrays(tcfg, arrays, device="cpu",
                                              trainable=True)
        plain = convert.lm_params_from_arrays(tcfg, arrays, device="cpu")
        a = tcls(tcfg, lr=0.25, params=model, device="cpu", **kw)
        b = tcls(tcfg, lr=0.25, params=plain, device="cpu", **kw)
        assert a.flat is not model.flat and a.flat.bound()
        x0 = a.initial()
        assert np.array_equal(x0, b.initial())
        x1 = a.full_map(x0)
        assert np.max(np.abs(x1 - x0)) > 0
        assert np.array_equal(x1, b.full_map(x0))
        assert a.loss(x1) != a.loss(x0) and a.loss(x1) == b.loss(x1)
        blk = contiguous_blocks(a.n, 4)[1]
        assert np.array_equal(a.block_update(x1, blk),
                              b.block_update(x1, blk))
        np.testing.assert_array_equal(model.flat.theta.numpy(),
                                      x0.astype(np.float32))

    def test_launcher_runs_on_the_cpu(self, capsys):
        """The benchmark's rate (0.25) and budget through the launcher:
        both designs reduce the loss plain, Anderson fires every 8."""
        rows = async_dp_lm.main(["--fast", "--device", "cpu"])
        assert [r["name"] for r in rows] == ["async_dp/full_grad",
                                             "async_dp/block_grad"]
        for r in rows:
            assert r["plain"] < r["loss0"] and r["fires"] == BUDGET // 8
            assert r["worker_updates"] == [BUDGET, BUDGET]
        assert capsys.readouterr().out.count("async_dp/") == 2


def _diloco_cfgs(mode, inner_lr):
    kw = dict(n_pods=4, inner_steps=3, outer_steps=4, mode=mode, seed=0,
              inner_lr=inner_lr)
    faults = {"async": ({0: JFaultProfile(delay_mean=3.0)},
                        {0: FaultProfile(delay_mean=3.0)}),
              "sync": (None, None)}[mode]
    return (j_diloco.DiLoCoConfig(accel=JAndersonConfig(m=5),
                                  faults=faults[0], **kw),
            diloco.DiLoCoConfig(accel=AndersonConfig(m=5), faults=faults[1],
                                **kw))


def _trainers(jd, td):
    jt = j_diloco.DiLoCoTrainer(_cfgs()[0], jd, batch=4, seq=16)
    tt = diloco.DiLoCoTrainer(_cfgs()[1], td, batch=4, seq=16,
                              params=jt.theta.copy(), device="cpu")
    return jt, tt


class TestDiLoCo:
    @pytest.mark.parametrize("compress", [False, True],
                             ids=["exact", "topk"])
    @pytest.mark.parametrize("mode", ["sync", "async"])
    def test_matches_reference(self, mode, compress):
        jd, td = _diloco_cfgs(mode, STABLE_LR)
        if compress:
            from repro.training.compression import Compressor as JCompressor

            jd.compressor = JCompressor(top_k_frac=0.1)
            td.compressor = Compressor(top_k_frac=0.1)
        jt, tt = _trainers(jd, td)
        theta0 = jt.theta.copy()
        want, got = jt.run(), tt.run()
        assert ((got.outer_updates, got.accel_accepts, got.accel_rejects)
                == (want.outer_updates, want.accel_accepts,
                    want.accel_rejects))
        assert got.outer_updates == 4
        assert got.wall_times == want.wall_times
        gap = _rel(got.losses, want.losses)
        print(f"diloco {mode} compress={compress} lr={STABLE_LR}: losses "
              f"port {got.losses} ref {want.losses} rel gap {gap:.2e}")
        assert gap <= RTOL
        assert got.losses[-1] < tt.eval_loss(theta0)

    @pytest.mark.parametrize("mode", ["sync", "async"])
    def test_benchmark_rate_run(self, mode):
        """inner lr 0.1 (the default): same schedule, both reduce the loss."""
        jd, td = _diloco_cfgs(mode, 0.1)
        jt, tt = _trainers(jd, td)
        l0 = tt.eval_loss(jt.theta.copy())
        want, got = jt.run(), tt.run()
        assert got.outer_updates == want.outer_updates == 4
        assert got.wall_times == want.wall_times
        print(f"diloco {mode} lr=0.1: loss0 {l0:.4f}, port {got.losses}, "
              f"ref {want.losses}, rel gap {_rel(got.losses, want.losses):.2e}")
        assert got.losses[-1] < l0 and want.losses[-1] < l0


class TestChaos:
    def test_reference_amplifies_a_1e7_perturbation(self):
        """At lr 0.25 the reference against itself from θ0·(1 + 1e-7·ξ):
        past 1e-4 within five full steps; at STABLE_LR it stays below
        1e-5 over thirty."""
        jcfg, _ = _cfgs()
        gaps = {}
        for lr, steps in ((0.25, 5), (STABLE_LR, 30)):
            a = j_async_dp.GradientWorkersProblem(jcfg, batch=4, seq=16, lr=lr)
            b = j_async_dp.GradientWorkersProblem(jcfg, batch=4, seq=16, lr=lr)
            xa = a.initial()
            xb = xa * (1 + 1e-7 * np.random.default_rng(0).standard_normal(
                xa.shape))
            for _ in range(steps):
                xa, xb = a.full_map(xa), b.full_map(xb)
            gaps[lr] = _rel(xb, xa)
        print(f"reference self-gap after a 1e-7 perturbation: {gaps}")
        assert gaps[0.25] > 1e-4 and gaps[STABLE_LR] < 1e-5
