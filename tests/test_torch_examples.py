"""The port's four examples (``repro_torch.examples``) at small sizes on
the CPU, against the same calls to the JAX package.

* quickstart: every Jacobi and value-iteration run of the example at a
  12 x 12 grid and a 40-state Garnet MDP on the virtual clock, whose
  runs are deterministic: worker updates, rounds and Anderson's fire,
  accept and reject counts exact, virtual wall times to 1e-12, the
  residual and the iterate to 1e-9 (Jacobi) and 1e-7 (value iteration,
  measured 3.9e-9) relative.
* serve_batched: the reference's weights (``repro_torch.convert``), the
  same greedy tokens and the same teacher-forcing agreement.
* train_lm: the crash and the resume from the reference's weights, the
  resumed losses within 1e-3 of the reference's (measured 4.1e-4 after
  20 steps), falling.
* diloco_async: the three runs from the reference's θ, the same accept
  and reject counts and virtual walls; losses within 1e-4 at a stable
  inner lr (the example's is chaotic in float32).

Each example runs on the card by default and raises without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as j_core  # noqa: E402
from repro import problems as j_problems  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward_train as j_forward_train  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.training.compression import Compressor as JCompressor  # noqa: E402
from repro.training.diloco import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.training.diloco import DiLoCoTrainer as JDiLoCoTrainer  # noqa: E402
from repro.training.train_loop import SimulatedCrash as JSimulatedCrash  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    diloco_async,
    quickstart,
    serve_batched,
    train_lm,
)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _j_cfg(port_cfg, arch):
    """The reference's config of an example (the port's, field for
    field)."""
    kw = {f: getattr(port_cfg, f) for f in (
        "n_layers", "d_model", "d_ff", "vocab_size", "n_heads", "n_kv_heads",
        "head_dim", "window")}
    return j_get_config(arch).reduced(**kw)


def _port_params(tcfg, jparams, trainable=False):
    return convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
        trainable=trainable)


# --------------------------------------------------------------------- #
# quickstart
# --------------------------------------------------------------------- #
GRID, VI_STATES = 12, 40

#: relative tolerance of the residual and the iterate: Jacobi's float64
#: sweeps, value iteration's Bellman backups (measured 3.9e-9 for the
#: residual, whose last digits follow the order of the max and sum)
QUICKSTART_TOL = {"jacobi": 1e-9, "vi": 1e-7}


def _ref_quickstart():
    """The reference example's calls, at the test's sizes."""
    CT, OH = 4.5e-3, 2.7e-3
    jac = j_problems.JacobiProblem(grid=GRID, sweeps=10)
    straggler = {0: j_core.FaultProfile(delay_mean=0.1)}
    kw = dict(tol=1e-5, max_updates=500_000, compute_time=CT)
    RC, AC = j_core.RunConfig, j_core.AndersonConfig
    out = dict(
        jacobi_sync=j_core.run_fixed_point(jac, RC(
            mode="sync", sync_overhead=OH, faults=straggler, **kw)),
        jacobi_async=j_core.run_fixed_point(jac, RC(
            mode="async", faults=straggler, **kw)),
        jacobi_sync_anderson=j_core.run_fixed_point(jac, RC(
            mode="sync", sync_overhead=OH, accel=AC(m=20), **kw)),
        jacobi_async_0=j_core.run_fixed_point(jac, RC(mode="async", **kw)),
        jacobi_async_anderson=j_core.run_fixed_point(jac, RC(
            mode="async", accel=AC(m=5), fire_every=8, **kw)))
    vi = j_problems.ValueIterationProblem(j_problems.GarnetMDP(
        S=VI_STATES, A=4, b=5, gamma=0.95, seed=0))
    kw = dict(tol=1e-6, max_updates=500_000, compute_time=CT)
    out["vi_async"] = j_core.run_fixed_point(vi, RC(
        mode="async", faults=straggler, **kw))
    out["vi_async_anderson"] = j_core.run_fixed_point(vi, RC(
        mode="async", faults=straggler, accel=AC(m=5), fire_every=4, **kw))
    out["densities"] = (j_core.coupling_density(jac),
                        j_core.coupling_density(vi))
    return out


@pytest.fixture(scope="module")
def quickstart_runs():
    lines = []
    got = quickstart.run(grid=GRID, vi_states=VI_STATES, device="cpu",
                         log=lines.append)
    return got, _ref_quickstart(), lines


@pytest.mark.parametrize("name", [
    "jacobi_sync", "jacobi_async", "jacobi_sync_anderson", "jacobi_async_0",
    "jacobi_async_anderson", "vi_async", "vi_async_anderson"])
def test_quickstart_run_matches_reference(quickstart_runs, name):
    got, want, _ = quickstart_runs
    g, w = got[name], want[name]
    for field in ("worker_updates", "rounds", "converged", "accel_fires",
                  "accel_accepts", "accel_rejects"):
        assert getattr(g, field) == getattr(w, field), field
    tol = QUICKSTART_TOL[name.split("_")[0]]
    assert g.wall_time == pytest.approx(w.wall_time, rel=1e-12)
    assert g.residual_norm == pytest.approx(w.residual_norm, rel=tol)
    assert _rel(g.x, w.x) <= tol


def test_quickstart_prints_the_reference_lines(quickstart_runs):
    _, want, lines = quickstart_runs
    text = "\n".join(lines)
    assert f"coupling density: {want['densities'][0]:.2e}" in text
    assert f"coupling density: {want['densities'][1]:.2f}" in text
    assert "Anderson SURVIVES" in text and "straggler speedup" in text


# --------------------------------------------------------------------- #
# serve_batched
# --------------------------------------------------------------------- #
def test_serve_batched_matches_reference():
    tcfg = serve_batched.example_config()
    jcfg = _j_cfg(tcfg, "gemma2_2b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    B, S0, steps = 2, 12, 10
    got = serve_batched.run(B, S0, steps, device="cpu",
                            params=_port_params(tcfg, jparams), log=[].append)
    # the reference example's calls
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.integers(1, jcfg.vocab_size, (B, S0)))
    logits, caches = j_prefill(jcfg, jparams, {"tokens": prompt},
                               max_len=S0 + steps)
    toks = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    gen = [toks]
    for t in range(steps - 1):
        logits, caches = j_decode_step(jcfg, jparams, caches, toks,
                                       jnp.asarray(S0 + t, jnp.int32))
        toks = jnp.argmax(logits[:, 0], axis=-1)[:, None]
        gen.append(toks)
    gen = jnp.concatenate(gen, axis=1)
    full = jnp.concatenate([prompt, gen], axis=1)
    ref_logits, _ = j_forward_train(jcfg, jparams, {"tokens": full})
    ref_next = jnp.argmax(ref_logits[:, S0 - 1: S0 + steps - 1], axis=-1)
    match = float(jnp.mean((ref_next == gen).astype(jnp.float32)))
    assert np.array_equal(got["tokens"].numpy(), np.asarray(gen))
    assert got["match"] == match > 0.99


# --------------------------------------------------------------------- #
# train_lm
# --------------------------------------------------------------------- #
#: the resumed losses against the reference's: 20 AdamW steps at lr 3e-3
#: from losses near 35 carry float32 rounding in another library
#: (measured 4.1e-4; ``test_torch_training`` holds 3 steps to 1e-4)
TRAIN_LM_TOL = 1e-3


def test_train_lm_crash_and_resume_match_reference(tmp_path):
    tcfg = train_lm.example_config()
    jcfg = _j_cfg(tcfg, "gemma_2b")
    steps, every = 20, 5
    kw = dict(steps=steps, batch=4, seq=16, lr=3e-3, checkpoint_every=every,
              log_every=10)
    jdir = str(tmp_path / "ref")
    with pytest.raises(JSimulatedCrash):
        j_train(jcfg, JTrainConfig(checkpoint_dir=jdir,
                                   crash_at_step=steps // 2, **kw), log=None)
    want = j_train(jcfg, JTrainConfig(checkpoint_dir=jdir, **kw), log=None)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lines = []
    got = train_lm.run(steps, str(tmp_path / "port"), device="cpu", batch=4,
                       seq=16, checkpoint_every=every,
                       params=_port_params(tcfg, jparams), log=lines.append)
    assert len(got["losses"]) == len(want["losses"]) == steps - steps // 2
    assert _rel(got["losses"], want["losses"]) <= TRAIN_LM_TOL
    text = "\n".join(lines)
    assert "CRASH: injected fault at step 10" in text
    assert "resumed from step 10" in text


def test_train_lm_default_checkpoint_is_not_the_reference_one():
    assert train_lm.DEFAULT_CKPT != "/tmp/repro_ckpt"
    assert train_lm.DEFAULT_CKPT.endswith("repro_torch_ckpt")


# --------------------------------------------------------------------- #
# diloco_async
# --------------------------------------------------------------------- #
#: the example's inner learning rate, and one at which the reference's
#: training map is not chaotic in float32
DILOCO_LRS = {"example": 0.15, "stable": 0.001}


@pytest.mark.parametrize("lr", sorted(DILOCO_LRS))
def test_diloco_async_matches_reference(lr):
    """At the example's inner lr (0.15) the reference against the port is
    chaotic in float32 (sync: the first outer loss agrees to 2e-6, the
    third differs by 4e-2; async: 3e-2 at the first, as
    ``test_torch_async_dp`` measures for its map), so there the schedule
    (virtual walls, accepts, rejects) and each run's falling loss are
    held; at 0.001 every loss too."""
    tcfg = diloco_async.example_config()
    jcfg = _j_cfg(tcfg, "gemma_2b")
    inner, outer, batch, seq = 2, 3, 4, 16
    faults = {0: j_core.FaultProfile(delay_mean=3.0)}
    kw = dict(n_pods=4, inner_steps=inner, inner_lr=DILOCO_LRS[lr],
              outer_steps=outer, faults=faults)
    theta = None
    want = {}
    for name, dcfg in {
        "sync": JDiLoCoConfig(**kw),
        "async": JDiLoCoConfig(mode="async", **kw),
        "async+anderson+topk": JDiLoCoConfig(
            mode="async", accel=j_core.AndersonConfig(m=4),
            compressor=JCompressor(top_k_frac=0.2), **kw),
    }.items():
        tr = JDiLoCoTrainer(jcfg, dcfg, batch=batch, seq=seq)
        theta = tr.theta.copy() if theta is None else theta
        assert np.array_equal(tr.theta, theta)  # every run from one θ
        want[name] = tr.run()
    got = diloco_async.run(inner, outer, batch, seq, device="cpu",
                           params=theta, inner_lr=DILOCO_LRS[lr],
                           log=[].append)
    for name, w in want.items():
        g = got["runs"][name]
        assert (g.accel_accepts, g.accel_rejects) == \
            (w.accel_accepts, w.accel_rejects), name
        assert g.wall_times == pytest.approx(w.wall_times, rel=1e-12)
        if lr == "stable":
            assert _rel(g.losses, w.losses) <= 1e-4, name
        assert g.losses[-1] < got["start"][name]
    assert got["speedup"] == pytest.approx(
        want["sync"].wall_times[-1] / want["async"].wall_times[-1])


# --------------------------------------------------------------------- #
# the card by default
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("example", [quickstart, serve_batched, train_lm,
                                     diloco_async],
                         ids=["quickstart", "serve_batched", "train_lm",
                              "diloco_async"])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        example.main([])
    with pytest.raises(RuntimeError):
        example.main(["--device", "cuda"])
