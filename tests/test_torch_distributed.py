"""The port's sharding across ranks against the JAX package, on the CPU.

* Band-sharded Jacobi: ``band_sharded_jacobi_sweeps`` with 2 and 4 bands
  (a device list that repeats the CPU) equals the one-band
  ``jacobi_halo_sweeps`` byte for byte on a 64 x 64 block, interior and
  edge blocks alike, and the JAX package's ``band_sharded_jacobi_sweeps``
  on 2 and 4 forced host devices (a subprocess, as
  ``tests/test_distributed.py`` runs it); norms within rtol 1e-12.  A
  virtual-backend run whose block updates go through the device plan on
  bands keeps the ``jacobi_async_plain`` golden bytes, a device-plane run
  the bytes of the same run without bands, and the host path's block
  update takes no bands.
* Placements: ``sharding_for`` on every ``ParamSpec`` of two configs
  gives the JAX package's ``resolve_axes`` spec on the same mesh shapes,
  and one ``Shard``/``Replicate`` per mesh axis to match.
* On ``gloo`` ranks (``distributed.ranks.run``: one process a rank, one
  torch thread each, a ``file://`` store, a group timeout and a run
  limit, so a hang fails in ~2 minutes at most): ``moe_ffn_a2a`` on meshes
  (2, 4), (1, 8) and (4, 2) within 1e-4 of the JAX package's
  ``moe_ffn(dropless=True)`` on the same numpy weights for the two
  reduced configs of ``tests/test_distributed.py``, its gradient within
  1e-4 of the port's ``moe_ffn(dropless=True)`` gradient, its auxiliary
  losses and their gradient equal to the mean of each rank's; a MoE
  model's logits with ``moe.a2a`` under the mesh equal its one-rank
  logits; a (2, 4)-mesh train step against the port's one-rank
  ``make_train_step`` on the reduced gemma of ``tests/test_distributed.py``
  (loss within 1e-6 relative, gradients and the updated θ within 1e-5,
  the loss falls over 5 steps; also with 2 microbatches); and a
  checkpoint written by the JAX package's ``save`` restored onto 2 and 8
  ranks under the rule placements, whose pieces, put back together by
  the JAX package's own ``resolve_axes`` specs, are the saved bytes.

The rank programs are the ``_rank_*`` functions below, run from this
module in fresh interpreters (they import no JAX).
"""

import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import ranks, sharding  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    BASE_RULES,
    MeshShape,
    band_sharded_jacobi_sweeps,
    sharding_for,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import leaves  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

MOE_ARCHS = [("olmoe_1b_7b", 0), ("qwen2_moe_a2p7b", 2)]  # (arch, shared)
MOE_MESHES = [(2, 4), (1, 8), (4, 2)]
RESTORE_MESHES = {2: [(2, 1), (1, 2)], 8: [(2, 4)]}
BAND_CASES = ("interior", "top", "bottom", "whole")
GRID, SWEEPS = 64, 10


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _nest(flat: dict) -> dict:
    """``{"a|b": v}`` -> ``{"a": {"b": v}}``."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("|")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree: dict, prefix=()) -> dict:
    return {"|".join(p): v for p, v in leaves(tree, prefix)}


# --------------------------------------------------------------------- #
# Band-sharded Jacobi
# --------------------------------------------------------------------- #
def _band_inputs(case: str):
    rng = np.random.default_rng(BAND_CASES.index(case))
    blk, bg = (rng.standard_normal((GRID, GRID)) for _ in range(2))
    top, bot = (rng.standard_normal(GRID) for _ in range(2))
    if case in ("top", "whole"):
        top[:] = 0.0  # the grid's first block: a zero Dirichlet row
    if case in ("bottom", "whole"):
        bot[:] = 0.0
    return blk, top, bot, bg


@pytest.fixture(scope="module")
def jax_bands(tmp_path_factory):
    """The JAX package's band sweeps on 2 and 4 forced host devices."""
    out = tmp_path_factory.mktemp("jax_bands")
    inputs = {f"{c}|{i}": a for c in BAND_CASES
              for i, a in enumerate(_band_inputs(c))}
    np.savez(out / "in.npz", **inputs)
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import jax, numpy as np
        jax.config.update("jax_enable_x64", True)
        from jax.sharding import Mesh
        from repro.distributed.sharding import band_sharded_jacobi_sweeps
        d = np.load({str(out / "in.npz")!r})
        res = {{}}
        for n in (2, 4):
            mesh = Mesh(np.array(jax.devices()[:n]), ("band",))
            for c in {BAND_CASES!r}:
                blk, top, bot, bg = (d[f"{{c}}|{{i}}"] for i in range(4))
                new, norm = band_sharded_jacobi_sweeps(
                    blk, top, bot, bg, sweeps={SWEEPS}, mesh=mesh)
                res[f"{{n}}|{{c}}|new"] = np.asarray(new)
                res[f"{{n}}|{{c}}|norm"] = np.asarray(norm)
        np.savez({str(out / "out.npz")!r}, **res)
    """)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(out / "out.npz"))


class TestBandJacobi:
    @pytest.mark.parametrize("case", BAND_CASES)
    @pytest.mark.parametrize("bands", [2, 4])
    def test_equals_one_band_kernel(self, bands, case):
        blk, top, bot, bg = map(torch.from_numpy, _band_inputs(case))
        want, wnorm = ops.jacobi_halo_sweeps(blk, top, bot, bg,
                                             sweeps=SWEEPS)
        got, norm = band_sharded_jacobi_sweeps(blk, top, bot, bg,
                                               sweeps=SWEEPS,
                                               devices=["cpu"] * bands)
        assert got.dtype == torch.float64 and got.shape == blk.shape
        assert torch.equal(got, want)
        assert norm == pytest.approx(float(wnorm), rel=1e-12)

    @pytest.mark.parametrize("case", BAND_CASES)
    @pytest.mark.parametrize("bands", [2, 4])
    def test_equals_jax_band_sweeps(self, jax_bands, bands, case):
        blk, top, bot, bg = map(torch.from_numpy, _band_inputs(case))
        got, norm = band_sharded_jacobi_sweeps(blk, top, bot, bg,
                                               sweeps=SWEEPS,
                                               devices=["cpu"] * bands)
        want = jax_bands[f"{bands}|{case}|new"]
        assert got.numpy().tobytes() == want.tobytes()
        assert norm == pytest.approx(float(jax_bands[f"{bands}|{case}|norm"]),
                                     rel=1e-12)

    def test_band_devices_policy(self, monkeypatch):
        """The reference's ``band_mesh`` rule: >= 2 cards that divide the
        rows into bands of >= 2 rows; never for a block on the CPU."""
        assert sharding.band_devices(64) is None  # no card here
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert sharding.band_devices(64) == [torch.device("cuda", i)
                                             for i in range(4)]
        assert sharding.band_devices(64, "cuda:1") is not None
        assert sharding.band_devices(64, "cpu") is None
        assert sharding.band_devices(6) is None  # 4 does not divide 6
        assert sharding.band_devices(4) is None  # bands of 1 row
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert sharding.band_devices(64) is None

    def test_refuses_uneven_bands(self):
        blk, top, bot, bg = map(torch.from_numpy, _band_inputs("interior"))
        for n in (3, 64):
            with pytest.raises(ValueError, match="bands"):
                band_sharded_jacobi_sweeps(blk, top, bot, bg, sweeps=1,
                                           devices=["cpu"] * n)


def _banded(monkeypatch, calls):
    """Make every whole-rows Jacobi block take 2 CPU bands."""
    def fake(rows, device=None):
        calls.append(rows)
        return [torch.device("cpu")] * 2 if rows % 2 == 0 and rows >= 4 \
            else None
    monkeypatch.setattr(sharding, "band_devices", fake)


class TestBandsInTheEngine:
    def test_virtual_run_keeps_the_golden_bytes(self, monkeypatch):
        """``jacobi_async_plain`` of ``tests/test_torch_engine.py`` with
        every block update made by the device plan (the band path's only
        caller) on 2 bands: the committed golden."""
        from repro_torch.core import FaultProfile, RunConfig, run_fixed_point
        from repro_torch.problems import JacobiProblem

        class PlannedJacobi(JacobiProblem):
            """Block updates through a fresh device plan each."""

            def block_update(self, x, indices):
                plan = self.device_block_plan(indices, "kernel")
                plan.refresh(x[indices])
                new, _ = plan.step(*(x[s] for s in plan.needs))
                return new

        calls = []
        _banded(monkeypatch, calls)
        res = run_fixed_point(
            PlannedJacobi(grid=16, sweeps=5, seed=0, device="cpu"),
            RunConfig(mode="async", tol=1e-10, max_updates=600, seed=7,
                      faults=FaultProfile(delay_mean=0.002, delay_std=0.001),
                      compute_time=1e-3))
        sha = hashlib.sha256(np.ascontiguousarray(res.x).tobytes())
        assert calls, "no block update took the band path"
        assert (res.worker_updates, res.wall_time, sha.hexdigest()) == (
            600, 0.4318607003352541,
            "af8fd221f9b65b94b6d21a5e5dcc7dbef42cf475a86dd05ad8e08d5b43b1bfc9")

    def test_host_block_update_takes_no_bands(self, monkeypatch):
        """The host path's block update stays on the one fused call, as
        the reference's does: bands are the device plan's alone."""
        from repro_torch.problems import JacobiProblem

        calls = []
        _banded(monkeypatch, calls)
        p = JacobiProblem(grid=16, sweeps=5, seed=0, device="cpu")
        x = np.random.default_rng(0).standard_normal(p.n)
        p.block_update(x, np.arange(4 * 16, 8 * 16))
        assert calls == []

    def test_device_plane_run_equals_unbanded(self, monkeypatch):
        """One thread worker with the device plane on (its plan takes the
        bands): the bytes of the same run without bands."""
        from repro_torch.core import RunConfig, run_fixed_point
        from repro_torch.problems import JacobiProblem

        cfg = RunConfig(mode="async", executor="thread", n_workers=1,
                        device_plane="on", tol=1e-9, max_updates=300,
                        seed=1)
        want = run_fixed_point(JacobiProblem(grid=16, sweeps=3,
                                             device="cpu"), cfg)
        calls = []
        _banded(monkeypatch, calls)
        got = run_fixed_point(JacobiProblem(grid=16, sweeps=3,
                                            device="cpu"), cfg)
        assert calls and got.device_dispatches == got.worker_updates > 0
        assert got.worker_updates == want.worker_updates
        assert got.x.tobytes() == want.x.tobytes()


# --------------------------------------------------------------------- #
# Placements
# --------------------------------------------------------------------- #
PLACEMENT_MESHES = {"single_pod": (("data", "model"), (16, 16)),
                    "multi_pod": (("pod", "data", "model"), (2, 16, 16)),
                    "debug": (("data", "model"), (2, 4))}


@pytest.mark.parametrize("mesh_name", sorted(PLACEMENT_MESHES))
@pytest.mark.parametrize("arch", ["gemma2_2b", "qwen2_moe_a2p7b"])
def test_placements_agree_with_reference(arch, mesh_name):
    from jax.sharding import PartitionSpec
    from torch.distributed.tensor import Replicate, Shard

    from repro.distributed.sharding import BASE_RULES as J_RULES
    from repro.distributed.sharding import resolve_axes as j_resolve

    axes, sizes = PLACEMENT_MESHES[mesh_name]
    mesh = MeshShape(axes, sizes)

    class FakeMesh:
        shape = dict(zip(axes, sizes))

    n = 0
    for path, spec in leaves(tf.model_spec(get_config(arch))):
        got = sharding_for(spec.shape, spec.axes, BASE_RULES, mesh)
        want = j_resolve(spec.axes, spec.shape, J_RULES, FakeMesh())
        assert PartitionSpec(*got.spec) == want, path
        for a, p in zip(axes, got.placements):
            dims = [i for i, part in enumerate(want)
                    if a in (part if isinstance(part, tuple) else (part,))]
            assert p == (Shard(dims[0]) if dims else Replicate()), (path, a)
        n += 1
    assert n > 10


def _at(d, m):
    """A 2 x 3 mesh seen from rank (d, m), without a process group."""
    mesh = MeshShape(("data", "model"), (2, 3))
    return SimpleNamespace(axes=mesh.axes, shape=mesh.shape,
                           coords={"data": d, "model": m})


def test_local_slice_splits_like_torch_chunk():
    x = torch.arange(7 * 6).view(7, 6)
    pieces = {(d, m): sharding.local_slice(
        x, sharding.Sharding(_at(d, m), ("data", "model")))
        for d in range(2) for m in range(3)}
    assert pieces[(1, 2)].shape == (3, 2)
    assert torch.equal(torch.cat([torch.cat([pieces[(d, m)]
                                             for m in range(3)], 1)
                                  for d in range(2)]), x)
    rows = [sharding.local_slice(
        x, sharding.Sharding(_at(d, m), (("data", "model"), None)))
        for d in range(2) for m in range(3)]
    assert [r.shape[0] for r in rows] == [2, 2, 2, 1, 0, 0]
    assert torch.equal(torch.cat(rows), x)


# --------------------------------------------------------------------- #
# Rank programs (run in fresh interpreters: no JAX)
# --------------------------------------------------------------------- #
def _moe_cfg(arch: str, shared: int, a2a: bool = False):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0, pad_to=1,
        n_shared=shared, a2a=a2a))


def _gemma():
    return get_config("gemma_2b").reduced(
        n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
        n_kv_heads=4, head_dim=16)


def _tokens(batch=8, seq=32, vocab=256):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, vocab, (batch, seq)))


def _save(d, name, **arrays):
    np.savez(os.path.join(d, name), **{k: np.asarray(v)
                                       for k, v in arrays.items()})


def _data_piece(mesh, x: torch.Tensor) -> torch.Tensor:
    return sharding.local_slice(x, sharding.Sharding(mesh, ("data",)))


def _rank_moe(rank, mesh, d):
    """moe_ffn_a2a's output and gradients (sum of squares), and the
    auxiliary losses and their router gradient, for every arch."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models.moe_shard_map import moe_ffn_a2a

    tag = "x".join(map(str, mesh.sizes))
    for arch, shared in MOE_ARCHS:
        cfg = _moe_cfg(arch, shared)
        inp = np.load(os.path.join(d, f"moe_{arch}.npz"))
        params = _nest({k[2:]: torch.from_numpy(inp[k]).requires_grad_()
                        for k in inp.files if k.startswith("p|")})
        x = _data_piece(mesh, torch.from_numpy(inp["x"])).clone()
        x.requires_grad_()
        out, aux = moe_ffn_a2a(cfg, params, x, mesh)
        (out ** 2).sum().backward()
        grads = {f"g|{k}": v.grad for k, v in _flat(params).items()}
        res = dict(out=out.detach(), xgrad=x.grad, **grads,
                   lb=aux["moe_load_balance"].detach(),
                   z=aux["moe_router_z"].detach(),
                   dropped=aux["moe_dropped"])
        for v in _flat(params).values():
            v.grad = None
        _, aux = moe_ffn_a2a(cfg, params, x, mesh)
        (aux["moe_load_balance"] + aux["moe_router_z"]).backward()
        # the sharded step's rule: the data ranks' mean
        res["auxgrad"] = coll.all_reduce_sum(
            params["router"].grad, mesh.group("data")) / mesh.shape["data"]
        _save(d, f"moe_{arch}_{tag}_r{rank}.npz", **res)


def _rank_moe_model(rank, mesh, d):
    """A reduced MoE model's logits with ``moe.a2a`` under the mesh."""
    from repro_torch.models.common import use_mesh

    cfg = _moe_cfg("qwen2_moe_a2p7b", 2, a2a=True)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    toks = _data_piece(mesh, _tokens(8, 16))
    calls = []
    real = moe_mod.moe_ffn
    moe_mod.moe_ffn = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with use_mesh(mesh), torch.no_grad():
            logits, _ = tf.forward_train(cfg, params, {"tokens": toks})
    finally:
        moe_mod.moe_ffn = real
    _save(d, f"moe_model_r{rank}.npz", logits=logits, moe_ffn_calls=len(calls))


def _rank_step(rank, mesh, d, accum):
    """Five sharded train steps; the first's gradient chunk and θ."""
    from repro_torch.launch import inputs as inp
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    cfg = _gemma()
    shape = inp.ShapeSpec("tiny", seq=32, batch=8, kind="train")
    fn, in_sh, _, _, meta = steps.build_train(
        cfg, shape, mesh, dict(BASE_RULES), opt_cfg=AdamWConfig(),
        accum_override=accum)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    flat = tf.make_trainable(params)
    opt = sharding.local_tree(adamw_init(flat, AdamWConfig()), in_sh[1])
    batch = sharding.local_tree({"tokens": _tokens()}, in_sh[2])
    lo, hi = steps.shard_range(flat.n, meta["dp"], mesh.coord("data"))
    losses = []
    for i in range(5):
        params, opt, m = fn(params, opt, batch)
        losses.append(m["loss"])
        if i == 0:
            first = dict(grad=flat.grad[lo:hi].clone(),
                         theta=flat.theta.clone(), norm=m["grad_norm"])
    _save(d, f"step_a{accum}_r{rank}.npz", lo=lo, hi=hi, losses=losses,
          accum=meta["accum"], dp=meta["dp"], **first)


def _rank_restore(rank, mesh, d):
    """This rank's pieces of the JAX package's checkpoint."""
    from repro_torch.launch import steps
    from repro_torch.training import checkpoint as ckpt

    cfg = _gemma()
    spec = tf.model_spec(cfg)
    template = {k: torch.empty(s.shape, dtype=torch.bfloat16, device="meta")
                for k, s in _flat(spec).items()}
    shard = _flat(steps.param_shardings(cfg, mesh, dict(BASE_RULES)))
    tree, step, extra = ckpt.restore(os.path.join(d, "ckpt"),
                                     _nest(template), shardings=_nest(shard))
    assert (step, extra) == (3, {"from": "jax"})
    tag = "x".join(map(str, mesh.sizes))
    _save(d, f"restore_{tag}_r{rank}.npz",
          **{k: v.view(torch.int16) for k, v in _flat(tree).items()})


def _rank_main(rank, world, d):
    from repro_torch.distributed.sharding import make_mesh

    if world == 8:
        for shape in MOE_MESHES:
            _rank_moe(rank, make_mesh(shape, ("data", "model")), d)
        mesh = make_mesh((2, 4), ("data", "model"))
        _rank_moe_model(rank, mesh, d)
        for accum in (1, 2):
            _rank_step(rank, mesh, d, accum)
    for shape in RESTORE_MESHES[world]:
        _rank_restore(rank, make_mesh(shape, ("data", "model")), d)


# --------------------------------------------------------------------- #
# The gloo runs and their checks
# --------------------------------------------------------------------- #
def _jax_moe_cfg(arch, shared):
    from repro.configs import get_config as j_get_config

    cfg = j_get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=2, capacity_factor=8.0, pad_to=1,
        n_shared=shared))


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Inputs from the JAX package, then the 8-rank and 2-rank runs."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as j_moe
    from repro.models.common import materialize as j_materialize
    from repro.models.transformer import model_spec as j_model_spec
    from repro.training import checkpoint as j_ckpt

    d = str(tmp_path_factory.mktemp("gloo"))
    ref = {}
    for arch, shared in MOE_ARCHS:
        jcfg = _jax_moe_cfg(arch, shared)
        jp = j_materialize(j_moe.moe_spec(jcfg), jax.random.PRNGKey(0),
                           dtype=jnp.float32)
        # float32 whether or not another test turned JAX's x64 on
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, jcfg.d_model),
                              dtype=jnp.float32) * 0.5
        out, aux = j_moe.moe_ffn(jcfg, jp, x, dropless=True)
        flat = {f"p|{k}": np.asarray(v) for k, v in _flat(jp).items()}
        _save(d, f"moe_{arch}.npz", x=np.asarray(x), **flat)
        ref[arch] = np.asarray(out)
    from repro.configs import get_config as j_get_config

    jcfg = j_get_config("gemma_2b").reduced(
        n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
        n_kv_heads=4, head_dim=16)
    saved = j_materialize(j_model_spec(jcfg), jax.random.PRNGKey(3),
                          dtype=jnp.bfloat16)
    j_ckpt.save(os.path.join(d, "ckpt"), 3, saved, extra={"from": "jax"})
    saved = {k: np.asarray(v) for k, v in _flat(saved).items()}
    for world in (8, 2):
        ranks.run("test_torch_distributed:_rank_main", world, args=[d],
                  path=[HERE], timeout=110)
    return d, ref, saved


def _load(d, name):
    return dict(np.load(os.path.join(d, name)))


def _row_major(mesh_shape):
    return [(r // mesh_shape[1], r % mesh_shape[1])
            for r in range(mesh_shape[0] * mesh_shape[1])]


@pytest.mark.parametrize("mesh_shape", MOE_MESHES)
@pytest.mark.parametrize("arch", [a for a, _ in MOE_ARCHS])
def test_a2a_matches_jax_dropless(gloo, arch, mesh_shape):
    d, ref, _ = gloo
    tag = "x".join(map(str, mesh_shape))
    D = mesh_shape[0]
    out = np.concatenate([_load(d, f"moe_{arch}_{tag}_r{dd * mesh_shape[1]}"
                                   ".npz")["out"] for dd in range(D)])
    assert out.shape == ref[arch].shape
    assert float(np.max(np.abs(out - ref[arch]))) < 1e-4
    for r, (dd, m) in enumerate(_row_major(mesh_shape)):
        got = _load(d, f"moe_{arch}_{tag}_r{r}.npz")
        assert int(got["dropped"]) == 0
        # every model rank of a data rank leaves with the same tokens
        assert np.array_equal(got["out"], _load(
            d, f"moe_{arch}_{tag}_r{dd * mesh_shape[1]}.npz")["out"])


def _port_moe_grads(d, arch, shared):
    """The port's ``moe_ffn(dropless=True)`` gradients of sum(out^2)."""
    inp = np.load(os.path.join(d, f"moe_{arch}.npz"))
    params = _nest({k[2:]: torch.from_numpy(inp[k]).requires_grad_()
                    for k in inp.files if k.startswith("p|")})
    x = torch.from_numpy(inp["x"]).requires_grad_()
    out, _ = moe_mod.moe_ffn(_moe_cfg(arch, shared), params, x,
                             dropless=True)
    (out ** 2).sum().backward()
    return {k: v.grad.numpy() for k, v in _flat(params).items()}, \
        x.grad.numpy()


@pytest.mark.parametrize("mesh_shape", MOE_MESHES)
@pytest.mark.parametrize("arch,shared", MOE_ARCHS)
def test_a2a_gradient_matches_dropless(gloo, arch, shared, mesh_shape):
    d = gloo[0]
    want, want_x = _port_moe_grads(d, arch, shared)
    tag = "x".join(map(str, mesh_shape))
    D, M = mesh_shape
    per = [_load(d, f"moe_{arch}_{tag}_r{r}.npz") for r in range(D * M)]
    for key, w in want.items():
        # whole on every model rank; the data ranks' sum is the gradient
        for r, (dd, m) in enumerate(_row_major(mesh_shape)):
            assert np.array_equal(per[r][f"g|{key}"],
                                  per[dd * M][f"g|{key}"]), key
        got = sum(per[dd * M][f"g|{key}"] for dd in range(D))
        assert _rel(got, w) <= 1e-4, key
    got_x = np.concatenate([per[dd * M]["xgrad"] for dd in range(D)])
    assert _rel(got_x, want_x) <= 1e-4


@pytest.mark.parametrize("mesh_shape", MOE_MESHES)
def test_a2a_aux_is_the_mean_over_ranks(gloo, mesh_shape):
    """The losses are the mean of each rank's own (its token piece's),
    as the reference's pmean; their gradient after the step's mean over
    the data ranks is that mean's gradient."""
    d = gloo[0]
    arch, shared = MOE_ARCHS[1]
    cfg = _moe_cfg(arch, shared)
    inp = np.load(os.path.join(d, f"moe_{arch}.npz"))
    router = torch.from_numpy(inp["p|router"]).requires_grad_()
    xt = torch.from_numpy(inp["x"]).reshape(-1, cfg.d_model)
    lbs, zs = [], []
    for piece in xt.chunk(8):
        r = moe_mod.route(cfg, {"router": router}, piece)
        me = r.probs.mean(0)
        ce = torch.bincount(r.top_e.reshape(-1), minlength=8).float() / len(
            piece)
        lbs.append(cfg.moe.n_experts * (me * ce).sum()
                   * cfg.moe.aux_loss_coef)
        zs.append(torch.logsumexp(r.logits, -1).square().mean()
                  * cfg.moe.router_z_coef)
    lb, z = torch.stack(lbs).mean(), torch.stack(zs).mean()
    (lb + z).backward()
    lb, z = float(lb.detach()), float(z.detach())
    tag = "x".join(map(str, mesh_shape))
    for r in range(8):
        got = _load(d, f"moe_{arch}_{tag}_r{r}.npz")
        assert float(got["lb"]) == pytest.approx(lb, rel=1e-6)
        assert float(got["z"]) == pytest.approx(z, rel=1e-6)
        assert _rel(got["auxgrad"], router.grad.numpy()) <= 1e-5


def test_a2a_model_logits_equal_one_rank(gloo):
    d = gloo[0]
    cfg = _moe_cfg("qwen2_moe_a2p7b", 2)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    with torch.no_grad():
        want, _ = tf.forward_train(cfg, params, {"tokens": _tokens(8, 16)})
    got = [_load(d, f"moe_model_r{r}.npz") for r in range(8)]
    assert all(int(g["moe_ffn_calls"]) == 0 for g in got)
    logits = np.concatenate([got[dd * 4]["logits"] for dd in range(2)])
    assert _rel(logits, want.numpy()) <= 1e-5


@pytest.fixture(scope="module")
def one_rank_steps():
    """The port's one-rank step on the whole batch: per accum, (losses
    over 5 steps, the first step's gradient, θ and grad norm)."""
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    out = {}
    for accum in (1, 2):
        cfg = _gemma()
        params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
        flat = tf.make_trainable(params)
        st = adamw_init(flat, AdamWConfig())
        fn = steps.make_train_step(cfg, AdamWConfig(), accum)
        losses = []
        for i in range(5):
            params, st, m = fn(params, st, {"tokens": _tokens()})
            losses.append(m["loss"])
            if i == 0:
                first = (flat.grad.clone().numpy(), flat.theta.clone().numpy(),
                         m["grad_norm"])
        out[accum] = (np.array(losses), *first)
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_step_loss(gloo, one_rank_steps, accum):
    d = gloo[0]
    want = one_rank_steps[accum][0]
    for r in range(8):
        got = _load(d, f"step_a{accum}_r{r}.npz")
        assert (int(got["accum"]), int(got["dp"])) == (accum, 2)
        assert np.allclose(got["losses"], want, rtol=1e-6, atol=0)
        assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_step_gradients(gloo, one_rank_steps, accum):
    d = gloo[0]
    _, grad, _, norm = one_rank_steps[accum]
    pieces = []
    for dd in range(2):
        got = _load(d, f"step_a{accum}_r{dd * 4}.npz")
        assert int(got["lo"]) == sum(len(p) for p in pieces)
        pieces.append(got["grad"])
        assert float(got["norm"]) == pytest.approx(norm, rel=1e-5)
    got = np.concatenate(pieces)
    assert got.shape == grad.shape
    assert np.max(np.abs(got - grad)) <= 1e-5


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_step_updated_theta(gloo, one_rank_steps, accum):
    d = gloo[0]
    theta = one_rank_steps[accum][2]
    for r in range(8):
        got = _load(d, f"step_a{accum}_r{r}.npz")["theta"]
        assert np.max(np.abs(got - theta)) <= 1e-5


@pytest.mark.parametrize("world,mesh_shape",
                         [(w, s) for w, ss in RESTORE_MESHES.items()
                          for s in ss])
def test_restore_reassembles_the_saved_bytes(gloo, world, mesh_shape):
    """Each rank's pieces, put back by the JAX package's specs: the
    saved leaves, byte for byte."""
    from repro.distributed.sharding import BASE_RULES as J_RULES
    from repro.distributed.sharding import resolve_axes as j_resolve

    d, _, saved = gloo
    axes = ("data", "model")

    class FakeMesh:
        shape = dict(zip(axes, mesh_shape))

    tag = "x".join(map(str, mesh_shape))
    per = [_load(d, f"restore_{tag}_r{r}.npz") for r in range(world)]
    coords = _row_major(mesh_shape)
    spec = _flat(tf.model_spec(_gemma()))
    split = 0
    for key, want in saved.items():
        pspec = j_resolve(spec[key].axes, spec[key].shape, J_RULES,
                          FakeMesh())
        whole = np.zeros(want.shape, np.int16)
        for r, c in enumerate(coords):
            idx = []
            for dim, part in zip(want.shape, tuple(pspec) + (None,) * (
                    want.ndim - len(pspec))):
                names = () if part is None else (
                    part if isinstance(part, tuple) else (part,))
                i, n = 0, 1
                for a in names:
                    i, n = i * FakeMesh.shape[a] + c[axes.index(a)], \
                        n * FakeMesh.shape[a]
                idx.append(slice(i * dim // n, (i + 1) * dim // n))
            piece = per[r][key]
            assert piece.shape == whole[tuple(idx)].shape, key
            whole[tuple(idx)] = piece
            split += piece.size < want.size
        assert whole.tobytes() == want.view(np.int16).tobytes(), key
    assert split > 0  # some leaves were really cut
