"""The port's durable solves (``repro_torch.recover``) against the JAX
package's, with ``device="cpu"`` problems on the port's side.

* The on-disk format is the reference's: a checkpoint the port writes at a
  given ``wu`` of a virtual run holds the same counters, membership, rng
  state, history and loop state as the JAX package's at the same ``wu``
  of the same run, and equal arrays (Jacobi: byte for byte; value
  iteration: 1e-12 relative); and a checkpoint the JAX package wrote
  resumes in the port.
* Virtual resumes at several ``wu`` are bit-identical to the
  uninterrupted run, and checkpointing never changes a trajectory; a
  one-worker thread resume is bit-identical too.
* The Anderson window restored on the CPU yields the same Gram rows and
  proposal bytes as the live ring buffer, in both Gram modes.
* A scripted ``coordinator_crash`` raises :class:`CoordinatorCrash`, and
  the resume is at-most-once: no fire replays, no arrival is counted
  twice.
* The process backend (spawned CPU worker processes): a crash keeps the
  pool warm and the resume reuses it with zero spawns; a dispose during a
  resume waits until the lease drains.
* ``resume_config`` strips the scenario and the trace capture; the format
  version and half-written files are checked.
"""

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chaos as jc  # noqa: E402
import repro.problems as jp  # noqa: E402
import repro.recover as jrec  # noqa: E402
from repro.core import AndersonConfig as JAnderson  # noqa: E402
from repro.core import FaultProfile as JFault  # noqa: E402
from repro.core import RunConfig as JRunConfig  # noqa: E402
from repro.core import run_fixed_point as j_run  # noqa: E402

import repro_torch.chaos as tc  # noqa: E402
import repro_torch.problems as tp  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AndersonConfig,
    AndersonState,
    CoordinatorCrash,
    FaultProfile,
    RunConfig,
    RunResult,
    run_fixed_point,
)
from repro_torch.core.anderson import _gram  # noqa: E402
from repro_torch.core.engine.coordinator import Coordinator  # noqa: E402
from repro_torch.recover import (  # noqa: E402
    SolveCheckpoint,
    capture,
    latest_checkpoint,
    list_checkpoints,
    resolve_checkpoint,
    restore_coordinator,
    resume_config,
    resume_fixed_point,
    submit_resume,
)


def _sha(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _jac(grid=16):
    return tp.JacobiProblem(grid=grid, sweeps=5, seed=0, device="cpu")


def _vi():
    return tp.ValueIterationProblem(tp.GarnetMDP(S=60, A=4, b=5, gamma=0.9,
                                                 seed=0, device="cpu"))


_VBASE = dict(executor="virtual", mode="async", n_workers=4, seed=7,
              max_updates=600, tol=1e-300, compute_time=1e-3)


def _vcfg(**kw):
    base = dict(_VBASE, faults=FaultProfile(delay_mean=2e-3, delay_std=1e-3),
                accel=AndersonConfig(m=5), fire_every=4)
    base.update(kw)
    return RunConfig(**base)


def _jcfg(**kw):
    base = dict(_VBASE, faults=JFault(delay_mean=2e-3, delay_std=1e-3),
                accel=JAnderson(m=5), fire_every=4)
    base.update(kw)
    return JRunConfig(**base)


# --------------------------------------------------------------------- #
class TestCheckpointFiles:
    def test_save_load_round_trip(self, tmp_path):
        run_fixed_point(_jac(), _vcfg(checkpoint_every=200,
                                      checkpoint_dir=str(tmp_path)))
        paths = list_checkpoints(str(tmp_path))
        assert [os.path.basename(p) for p in paths] == [
            "ckpt-00000200.json", "ckpt-00000400.json", "ckpt-00000600.json"]
        ck = SolveCheckpoint.load(paths[0])
        assert ck.tag == "ckpt-00000200" and ck.wu == 200
        assert ck.meta["format"] == 1 and ck.meta["executor"] == "virtual"
        assert ck.arrays["x"].dtype == np.float64
        assert {"accel_X", "accel_G", "accel_F"} <= set(ck.arrays)
        ck2 = SolveCheckpoint.load(paths[0][:-5] + ".npz")
        np.testing.assert_array_equal(ck.arrays["x"], ck2.arrays["x"])

    def test_resolve_checkpoint_forms(self, tmp_path):
        run_fixed_point(_jac(), _vcfg(checkpoint_every=300,
                                      checkpoint_dir=str(tmp_path)))
        assert resolve_checkpoint(str(tmp_path)).tag == "ckpt-00000600"
        by_path = resolve_checkpoint(list_checkpoints(str(tmp_path))[0])
        assert by_path.tag == "ckpt-00000300"
        assert resolve_checkpoint(by_path) is by_path
        with pytest.raises(TypeError):
            resolve_checkpoint(42)
        (tmp_path / "empty").mkdir()
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            resolve_checkpoint(str(tmp_path / "empty"))

    def test_format_version_checked(self, tmp_path):
        run_fixed_point(_jac(), _vcfg(checkpoint_every=600,
                                      checkpoint_dir=str(tmp_path)))
        path = list_checkpoints(str(tmp_path))[0]
        meta = json.loads(open(path).read())
        meta["format"] = 999
        open(path, "w").write(json.dumps(meta))
        with pytest.raises(ValueError, match="format"):
            SolveCheckpoint.load(path)

    def test_no_half_written_checkpoints(self, tmp_path):
        run_fixed_point(_jac(), _vcfg(checkpoint_every=200,
                                      checkpoint_dir=str(tmp_path)))
        assert [n for n in os.listdir(tmp_path) if n.endswith(".tmp")] == []
        assert sorted(os.listdir(tmp_path)) == sorted(
            f"ckpt-{w:08d}.{e}" for w in (200, 400, 600)
            for e in ("json", "npz"))

    def test_capture_restore_preserves_coordinator_state(self):
        prob = _jac()
        cfg = _vcfg()
        r = run_fixed_point(prob, cfg)
        coord, coord2 = Coordinator(prob, cfg), Coordinator(prob, cfg)
        coord.x = r.x.copy()
        coord.wu, coord.drops = 123, 4
        coord.preempt_worker(2)
        coord._sdc_norms = [0.5, 0.25]
        coord._sdc_strikes = {2: 1}
        coord._sdc_block_rejects = {(0, 64, None): 2}
        ck = capture(coord, t=1.5)
        restore_coordinator(coord2, ck)
        np.testing.assert_array_equal(coord2.x, coord.x)
        assert (coord2.wu, coord2.drops) == (123, 4)
        assert coord2.worker_blocks == coord.worker_blocks
        assert coord2.preempt_gen == coord.preempt_gen
        assert coord2._sdc_norms == [0.5, 0.25]
        assert coord2._sdc_strikes == {2: 1}
        assert coord2._sdc_block_rejects == {(0, 64, None): 2}
        assert coord2.resumed_from == ck.tag

    def test_checkpoint_validation(self):
        for kw, match in ((dict(mode="sync"), "async"),
                          (dict(checkpoint_dir=None), "checkpoint_dir"),
                          (dict(checkpoint_every=0), ">= 1"),
                          (dict(accel_eval="worker"), "accel_eval")):
            base = dict(mode="async", n_workers=4, max_updates=100,
                        checkpoint_every=10, checkpoint_dir="ckpt")
            base.update(kw)
            with pytest.raises(ValueError, match=match):
                run_fixed_point(_jac(), RunConfig(**base))


# --------------------------------------------------------------------- #
def _both_checkpoints(tmp_path, kind, every, **kw):
    """The same virtual run through both packages, checkpointing every
    ``every`` updates into two directories."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jprob = (jp.JacobiProblem(grid=16, sweeps=5, seed=0) if kind == "jacobi"
             else jp.ValueIterationProblem(jp.GarnetMDP(
                 S=60, A=4, b=5, gamma=0.9, seed=0)))
    tprob = _jac() if kind == "jacobi" else _vi()
    jscn = kw.pop("jscenario", None)
    tscn = kw.pop("tscenario", None)
    jr = j_run(jprob, _jcfg(checkpoint_every=every, checkpoint_dir=str(jd),
                            scenario=jscn, **kw))
    tr = run_fixed_point(tprob, _vcfg(checkpoint_every=every,
                                      checkpoint_dir=str(td),
                                      scenario=tscn, **kw))
    return jr, tr, jd, td


class TestCheckpointParity:
    @pytest.mark.parametrize("kind,scenario", [
        ("jacobi", None), ("jacobi", "spot_wave"), ("vi", None),
        ("vi", "rolling_restart")])
    def test_port_checkpoint_equals_reference(self, tmp_path, kind,
                                              scenario):
        kw = {}
        if scenario is not None:
            kw = dict(jscenario=jc.get_scenario(scenario, 4).scaled(0.05),
                      tscenario=tc.get_scenario(scenario, 4).scaled(0.05))
        jr, tr, jd, td = _both_checkpoints(tmp_path, kind, 150, **kw)
        jpaths, tpaths = list_checkpoints(str(jd)), list_checkpoints(str(td))
        assert [os.path.basename(p) for p in tpaths] == [
            os.path.basename(p) for p in jpaths]
        assert len(tpaths) == 4
        exact = kind == "jacobi"
        for jpath, tpath in zip(jpaths, tpaths):
            jm, tm = (json.loads(open(p).read()) for p in (jpath, tpath))
            for key in ("format", "tag", "t", "wu", "executor", "seed",
                        "n_workers", "rng", "membership", "sdc", "accel",
                        "loop", "arrays"):
                assert tm[key] == jm[key], key
            ta = SolveCheckpoint.load(tpath).arrays
            ja = jrec.SolveCheckpoint.load(jpath).arrays
            assert sorted(ta) == sorted(ja)
            # VI: iterates (x, the window's X and G, the heap's values)
            # within 1e-12 of their largest entry; residuals F = G - X
            # within 2e-12 of the iterate's scale (a difference of two
            # such vectors); a residual norm moves by at most
            # (1 + gamma) ||dx||_2 <= 2 sqrt(n) max|dx|.  The last Anderson
            # coefficients are held by shape only: near convergence the
            # window's rows are nearly collinear and the KKT solve turns
            # the window's 1e-12 into ~1e-7, while the extrapolated
            # iterates it produces still agree to 1e-12 (x above).
            x = ja["x"]
            scale = np.max(np.abs(x))
            res_tol = 2 * np.sqrt(x.size) * 1e-12 * scale
            for k in ja:
                if exact:
                    assert ta[k].tobytes() == ja[k].tobytes(), k
                elif k == "accel_F":
                    assert np.max(np.abs(ta[k] - ja[k])) <= 2e-12 * scale
                elif k == "accel_last_alpha":
                    assert ta[k].shape == ja[k].shape
                else:
                    assert _rel(ta[k], ja[k]) <= 1e-12, k
            jcnt, tcnt = dict(jm["counters"]), dict(tm["counters"])
            assert set(tcnt) == set(jcnt)
            if not exact:
                assert abs(tcnt.pop("res_norm") - jcnt.pop("res_norm")) \
                    <= res_tol
            assert tcnt == jcnt
            jh, th = np.array(jm["history"]), np.array(tm["history"])
            np.testing.assert_array_equal(th[:, :2], jh[:, :2])
            if exact:
                np.testing.assert_array_equal(th, jh)
            else:
                np.testing.assert_allclose(th[:, 2], jh[:, 2], rtol=0,
                                           atol=res_tol)
        if scenario is not None:
            assert tr.preemptions == jr.preemptions > 0

    def test_reference_checkpoint_resumes_in_the_port(self, tmp_path):
        """The format is shared: resuming the JAX package's checkpoint in
        the port finishes on the JAX run's bytes."""
        jr, tr, jd, _ = _both_checkpoints(tmp_path, "jacobi", 200)
        ck = SolveCheckpoint.load(list_checkpoints(str(jd))[0])
        resumed = resume_fixed_point(_jac(), _vcfg(), ck)
        assert _sha(resumed.x) == _sha(jr.x) == _sha(tr.x)
        assert resumed.wall_time == jr.wall_time
        assert resumed.resumed_from == ck.tag


# --------------------------------------------------------------------- #
class TestVirtualResume:
    def test_checkpointing_never_changes_the_trajectory(self, tmp_path):
        golden = run_fixed_point(_jac(), _vcfg())
        ckpted = run_fixed_point(_jac(), _vcfg(
            checkpoint_every=200, checkpoint_dir=str(tmp_path)))
        assert _sha(golden.x) == _sha(ckpted.x)
        assert golden.wall_time == ckpted.wall_time
        assert golden.history == ckpted.history
        assert ckpted.checkpoints_written == 3

    @pytest.mark.parametrize("every,index", [(200, 0), (200, 1), (75, 0),
                                             (75, 4), (75, 6)])
    def test_resume_bit_identical_to_uninterrupted(self, tmp_path, every,
                                                   index):
        prob = _jac()
        golden = run_fixed_point(prob, _vcfg())
        cfg = _vcfg(checkpoint_every=every, checkpoint_dir=str(tmp_path))
        run_fixed_point(prob, cfg)
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[index])
        resumed = resume_fixed_point(prob, cfg, ck)
        assert _sha(resumed.x) == _sha(golden.x)
        assert resumed.worker_updates == golden.worker_updates
        assert resumed.wall_time == golden.wall_time
        assert (resumed.accel_fires, resumed.accel_accepts) == (
            golden.accel_fires, golden.accel_accepts)
        assert resumed.history == golden.history
        assert resumed.resumed_from == ck.tag

    def test_vi_resume_bit_identical(self, tmp_path):
        golden = run_fixed_point(_vi(), _vcfg())
        cfg = _vcfg(checkpoint_every=250, checkpoint_dir=str(tmp_path))
        run_fixed_point(_vi(), cfg)
        resumed = resume_fixed_point(_vi(), cfg, SolveCheckpoint.load(
            list_checkpoints(str(tmp_path))[0]))
        assert _sha(resumed.x) == _sha(golden.x)

    def test_scenario_checkpoint_resumes_on_the_default_loop(self,
                                                             tmp_path):
        """A chaos-loop checkpoint carries the membership; its resume (with
        the script stripped) continues the same run in both packages."""
        _, _, jd, td = _both_checkpoints(
            tmp_path, "jacobi", 150,
            jscenario=jc.get_scenario("spot_wave", 4).scaled(0.05),
            tscenario=tc.get_scenario("spot_wave", 4).scaled(0.05))
        jck = jrec.SolveCheckpoint.load(list_checkpoints(str(jd))[1])
        tck = SolveCheckpoint.load(list_checkpoints(str(td))[1])
        jres = jrec.resume_fixed_point(
            jp.JacobiProblem(grid=16, sweeps=5, seed=0), _jcfg(), jck)
        tres = resume_fixed_point(_jac(), _vcfg(), tck)
        assert _sha(tres.x) == _sha(jres.x)
        assert tres.worker_updates == jres.worker_updates == 600
        assert tres.service_fractions == jres.service_fractions

    def test_scripted_run_resumes_to_its_own_bytes(self, tmp_path):
        """Resumed from a checkpoint taken after the script is over (the
        default loop, script stripped), a scripted run ends on the
        uninterrupted scripted run's bytes."""
        scn = tc.get_scenario("rolling_restart", 4).scaled(0.05)
        last = max(ev.t for ev in scn.events)
        cfg = _vcfg(scenario=scn, checkpoint_every=150,
                    checkpoint_dir=str(tmp_path))
        full = run_fixed_point(_jac(), cfg)
        assert full.preemptions == 4 and full.joins == 4
        ck = next(c for c in map(SolveCheckpoint.load,
                                 list_checkpoints(str(tmp_path)))
                  if c.t > last and c.wu < 600)
        res = resume_fixed_point(_jac(), cfg, ck)
        assert _sha(res.x) == _sha(full.x)
        assert (res.worker_updates, res.accel_fires, res.wall_time) == (
            full.worker_updates, full.accel_fires, full.wall_time)

    def test_resume_with_selection_rng_and_noise(self, tmp_path):
        prob = _jac()
        base = dict(executor="virtual", mode="async", n_workers=4, seed=3,
                    max_updates=500, tol=1e-300, compute_time=1e-3,
                    selection="uniform", selection_k=32,
                    faults=FaultProfile(delay_mean=1e-3, delay_std=5e-4,
                                        noise_std=1e-9, drop_prob=0.05))
        golden = run_fixed_point(prob, RunConfig(**base))
        cfg = RunConfig(**base, checkpoint_every=200,
                        checkpoint_dir=str(tmp_path))
        run_fixed_point(prob, cfg)
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[0])
        resumed = resume_fixed_point(prob, cfg, ck)
        assert _sha(resumed.x) == _sha(golden.x)
        assert resumed.drops == golden.drops

    def test_resume_config_strips_control_plane(self, tmp_path):
        cfg = _vcfg(checkpoint_every=200, checkpoint_dir=str(tmp_path),
                    scenario=tc.FaultScenario().pause(0.1).resume(0.2))
        run_fixed_point(_jac(), cfg)
        rc = resume_config(dataclasses.replace(cfg, capture_trace=True))
        assert rc.scenario is None and not rc.capture_trace
        assert rc.resume_from.tag == "ckpt-00000600"
        assert rc.checkpoint_every == 200  # the chain keeps extending
        with pytest.raises(ValueError, match="needs a checkpoint"):
            resume_config(_vcfg())

    def test_resume_validation(self, tmp_path):
        cfg = _vcfg(checkpoint_every=200, checkpoint_dir=str(tmp_path))
        run_fixed_point(_jac(), cfg)
        ck = latest_checkpoint(str(tmp_path))
        with pytest.raises(ValueError, match="scenario"):
            run_fixed_point(_jac(), dataclasses.replace(
                cfg, resume_from=ck, scenario=tc.FaultScenario().pause(0.1)))
        with pytest.raises(ValueError, match="n_workers"):
            resume_fixed_point(_jac(), dataclasses.replace(
                cfg, n_workers=2), ck)
        with pytest.raises(ValueError, match="not resumable"):
            resume_fixed_point(_jac(), dataclasses.replace(
                cfg, executor="thread"), ck)


# --------------------------------------------------------------------- #
class TestWindowRestore:
    """``AndersonState.restore`` compacts the window and rebuilds the
    incremental Gram by replaying its rows; on the CPU that must give the
    live ring buffer's bytes, or a resumed accelerated Jacobi run leaves
    the uninterrupted run's trajectory."""

    @pytest.mark.parametrize("gram", ["exact", "incremental"])
    @pytest.mark.parametrize("pushes", [3, 6, 11])
    def test_restored_window_proposes_the_same_bytes(self, gram, pushes):
        r = np.random.default_rng(pushes)
        live = AndersonState(AndersonConfig(m=4, gram=gram), device="cpu")
        for _ in range(pushes):  # 6 and 11 evict, wrap and compact the ring
            x = r.standard_normal(1537)
            live.push(x, x + 0.1 * r.standard_normal(1537))
            live.propose()  # a fire: one push, one proposal
        back = AndersonState(AndersonConfig(m=4, gram=gram), device="cpu")
        back.restore(live.snapshot())
        h = live.depth
        if gram == "incremental":
            assert back._B[:h, :h].tobytes() == live._B[:h, :h].tobytes()
        assert _gram(back._window(back._F)).tobytes() == \
            _gram(live._window(live._F)).tobytes()
        assert back.propose().tobytes() == live.propose().tobytes()
        x = r.standard_normal(1537)
        for st in (live, back):  # one more push after the restore
            st.push(x, 0.5 * x)
        assert back.propose().tobytes() == live.propose().tobytes()

    def test_incremental_gram_resume_bit_identical(self, tmp_path):
        acc = AndersonConfig(m=5, gram="incremental")
        golden = run_fixed_point(_jac(), _vcfg(accel=acc))
        cfg = _vcfg(accel=acc, checkpoint_every=100,
                    checkpoint_dir=str(tmp_path))
        run_fixed_point(_jac(), cfg)
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[2])
        assert _sha(resume_fixed_point(_jac(), cfg, ck).x) == _sha(golden.x)


# --------------------------------------------------------------------- #
class TestThreadResume:
    def test_one_worker_resume_bit_identical(self, tmp_path):
        prob = _jac()
        base = dict(executor="thread", mode="async", n_workers=1, seed=3,
                    max_updates=400, tol=1e-300, accel=AndersonConfig(m=5),
                    fire_every=4)
        golden = run_fixed_point(prob, RunConfig(**base))
        cfg = RunConfig(**base, checkpoint_every=20,
                        checkpoint_dir=str(tmp_path))
        run_fixed_point(prob, cfg)
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[1])
        resumed = resume_fixed_point(prob, cfg, ck)
        assert _sha(resumed.x) == _sha(golden.x)
        assert resumed.worker_updates == golden.worker_updates
        assert resumed.accel_fires == golden.accel_fires == 100
        assert resumed.resumed_from == ck.tag
        assert resumed.wall_time >= ck.t  # the clock continues

    def test_multiworker_resume_converges(self, tmp_path):
        prob = _jac(8)
        cfg = RunConfig(executor="thread", mode="async", n_workers=4,
                        seed=5, tol=1e-8, max_updates=10**5,
                        faults=FaultProfile(delay_mean=1e-4),
                        checkpoint_every=100, checkpoint_dir=str(tmp_path))
        first = run_fixed_point(prob, cfg)
        assert first.converged and first.checkpoints_written > 0
        resumed = resume_fixed_point(prob, cfg)
        assert resumed.converged and resumed.resumed_from is not None


# --------------------------------------------------------------------- #
class TestCoordinatorCrash:
    def test_virtual_crash_then_resume_at_most_once(self, tmp_path):
        """The crash raises; the resume from the last checkpoint before it
        finishes on the uninterrupted run's bytes, with its fire and
        arrival counts: no fire replays and no arrival counts twice."""
        golden = run_fixed_point(_jac(), _vcfg())
        cfg = _vcfg(checkpoint_every=100, checkpoint_dir=str(tmp_path),
                    scenario=tc.FaultScenario().coordinator_crash(0.2))
        with pytest.raises(CoordinatorCrash, match="killed the coordinator"):
            run_fixed_point(_jac(), cfg)
        ck = latest_checkpoint(str(tmp_path))
        assert 0 < ck.wu < 600 and ck.t <= 0.2
        resumed = resume_fixed_point(_jac(), cfg)
        assert resumed.resumed_from == ck.tag
        assert _sha(resumed.x) == _sha(golden.x)
        assert resumed.worker_updates == golden.worker_updates == 600
        assert (resumed.accel_fires, resumed.accel_accepts) == (
            golden.accel_fires, golden.accel_accepts)
        assert resumed.history == golden.history

    def test_thread_crash_then_resume_at_most_once(self, tmp_path):
        """One fault-free thread worker: the resumed run lands exactly on
        the budget, fires exactly once per ``fire_every`` applied updates
        (a replayed fire would add one) and ends on the uninterrupted
        run's bytes."""
        prob = _jac()
        base = dict(executor="thread", mode="async", n_workers=1, seed=5,
                    max_updates=1500, tol=1e-300, accel=AndersonConfig(m=5),
                    fire_every=4, faults=FaultProfile(delay_mean=1e-3))
        golden, cfg, ck = _crash_and_checkpoint(prob, base, tmp_path)
        resumed = resume_fixed_point(prob, cfg, ck)
        assert resumed.worker_updates == 1500
        assert resumed.accel_fires == 1500 // 4
        assert resumed.resumed_from == ck.tag
        assert _sha(resumed.x) == _sha(golden.x)

    def test_thread_multiworker_crash_resume_lands_on_budget(self, tmp_path):
        prob = _jac()
        base = dict(executor="thread", mode="async", n_workers=2, seed=5,
                    max_updates=1500, tol=1e-300,
                    faults=FaultProfile(delay_mean=2e-3, delay_std=1e-3))
        _, cfg, ck = _crash_and_checkpoint(prob, base, tmp_path)
        resumed = resume_fixed_point(prob, cfg, ck)
        assert resumed.worker_updates == 1500
        assert resumed.resumed_from == ck.tag


def _crash_and_checkpoint(prob, base, tmp_path):
    """Run ``base`` through with checkpoints every 25 updates, then again
    with a scripted crash at a quarter of that run's wall (so the crash
    lands mid-run however loaded the machine is).  Returns the through
    run, the crashing config and the crash run's latest checkpoint."""
    through = run_fixed_point(prob, RunConfig(
        **base, checkpoint_every=25, checkpoint_dir=str(tmp_path / "a")))
    cfg = RunConfig(**base, checkpoint_every=25,
                    checkpoint_dir=str(tmp_path / "b"),
                    scenario=tc.FaultScenario().coordinator_crash(
                        through.wall_time / 4))
    with pytest.raises(CoordinatorCrash):
        run_fixed_point(prob, cfg)
    ck = latest_checkpoint(cfg.checkpoint_dir)
    assert ck is not None and ck.wu < base["max_updates"]
    return through, cfg, ck


# --------------------------------------------------------------------- #
class TestProcessRecovery:
    def test_crash_keeps_pool_warm_and_resume_reuses_it(self, tmp_path):
        from repro_torch.core.engine.process import pool_stats, shutdown_pools

        prob = _jac(8)
        base = dict(executor="process", mode="async", n_workers=2, seed=5,
                    max_updates=1200, tol=1e-300,
                    faults=FaultProfile(delay_mean=2e-3, delay_std=1e-3))
        try:
            _, cfg, ck = _crash_and_checkpoint(prob, base, tmp_path)
            stats = pool_stats()
            assert stats, "CoordinatorCrash disposed the warm pool"
            pids = sorted(p for st in stats.values() for p in st["pids"])
            assert ck.meta["loop"]["kind"] == "process_async"
            resumed = resume_fixed_point(prob, cfg)
            assert resumed.worker_updates == 1200
            assert resumed.resumed_from == ck.tag
            pids2 = sorted(p for st in pool_stats().values()
                           for p in st["pids"])
            assert pids == pids2, "resume respawned pool workers"
        finally:
            shutdown_pools()

    def test_dispose_during_resume_defers_until_lease_drains(self,
                                                             tmp_path):
        from repro_torch.core.engine.process import (
            _POOLS,
            pool_stats,
            shutdown_pools,
        )

        prob = _jac(8)
        cfg = RunConfig(
            executor="process", mode="async", n_workers=2, seed=5,
            max_updates=800, tol=1e-300,
            faults=FaultProfile(delay_mean=2e-3, delay_std=1e-3),
            checkpoint_every=100, checkpoint_dir=str(tmp_path))
        try:
            run_fixed_point(prob, cfg)  # warm pool + checkpoint chain
            ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[2])
            session = submit_resume(prob, cfg, ck)
            deadline = time.monotonic() + 30
            while True:
                stats = pool_stats()
                if stats and any(st["leases"] > 0 for st in stats.values()):
                    break
                assert time.monotonic() < deadline, "lease never acquired"
                time.sleep(0.01)
            (key,) = list(stats)
            _POOLS.dispose(key)  # must not kill the leased pool mid-run
            res = session.result()
            assert res.worker_updates == 800
            assert res.resumed_from == ck.tag
            assert key not in pool_stats()  # deferred teardown happened
        finally:
            shutdown_pools()


# --------------------------------------------------------------------- #
class TestRunResultDurableFields:
    def test_fields_round_trip(self, tmp_path):
        cfg = _vcfg(checkpoint_every=200, checkpoint_dir=str(tmp_path))
        run_fixed_point(_jac(), cfg)
        ck = SolveCheckpoint.load(list_checkpoints(str(tmp_path))[0])
        r = resume_fixed_point(_jac(), cfg, ck)
        assert r.checkpoints_written > 0 and r.resumed_from == ck.tag
        d = json.loads(json.dumps(r.to_dict()))
        back = RunResult.from_dict(d)
        for key in ("sdc_rejects", "quarantined", "checkpoints_written",
                    "resumed_from"):
            assert getattr(back, key) == getattr(r, key)
