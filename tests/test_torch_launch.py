"""The port's launch tools against the JAX package, on the CPU.

* Query-chunked training attention (``attn_chunk``) against the
  reference's ``attention`` by value and by gradient (``jax.grad``),
  and a reduced Gemma-2 train step with ``attn_chunk`` from the
  reference's weights (``repro_torch.convert``).
* The sharding rules (``resolve_axes``, ``bytes_per_device``), the cell
  planning of ``launch/inputs.py`` and the roofline's parameter and
  FLOP counts: exact, for every config and shape.
* ``opstats``' product FLOPs against ``repro.launch.hloparse.analyze``
  on the same reduced model's one-device compiled HLO: equal for the
  train step (the reference's recomputation included) and decode; for
  the prefill equal once the flash kernel's leaf (the visible pairs) is
  swapped for the reference's dense masked scores.  ``traffic_bytes`` is
  not compared: XLA fuses, eager does not.
* A dry-run cell end to end on the meta device.

Tolerances (relative error ``max|port - ref| / max|ref|``, float32 in
another library and order): chunked attention 1e-5 by value and
gradient; the train step's loss and gradient norm 1e-5, its parameters
after AdamW 1e-4 (measured 2.1e-5: Adam moves an element by about lr
whatever its gradient's size).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed import sharding as j_sharding  # noqa: E402
from repro.launch import hloparse  # noqa: E402
from repro.launch import inputs as j_inp  # noqa: E402
from repro.launch import roofline as j_roofline  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.common import ParamSpec as JParamSpec  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun, inputs, mesh, opstats, roofline  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import leaves  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402

META = torch.device("meta")


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _cfgs(arch, **kw):
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


# --------------------------------------------------------------------- #
# Query-chunked training attention
# --------------------------------------------------------------------- #
#: (causal, window, pos_offset, S) with attn_chunk 8
ATTN_CASES = {
    "causal": (True, None, 0, 32),
    "window": (True, 8, 0, 32),
    "pos_offset": (True, None, 3, 32),
    "window_pos_offset": (True, 8, 5, 32),
    "noncausal": (False, None, 0, 32),
    "ragged_full_mask": (True, 8, 0, 36),
    "one_chunk_full_mask": (True, None, 2, 8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_reference(case, monkeypatch):
    causal, window, pos_offset, S = ATTN_CASES[case]
    chunk = 8
    jcfg, tcfg = _cfgs("gemma2_2b")  # softcap 50, 4/2 heads of 16
    jcfg = dataclasses.replace(jcfg, attn_chunk=chunk)
    tcfg = dataclasses.replace(tcfg, attn_chunk=chunk)
    rng = np.random.default_rng(7)
    d, nq, nkv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {"wq": (d, nq, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
         "wo": (nq, hd, d)}
    p = {k: (0.25 * rng.standard_normal(s)).astype(np.float32)
         for k, s in p.items()}
    x = rng.standard_normal((2, S, d)).astype(np.float32)
    r = rng.standard_normal((2, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()

    def jf(params, xx):
        out = j_attn.attention(jcfg, params, xx, jnp.asarray(pos),
                               causal=causal, window=window,
                               pos_offset=pos_offset)
        return jnp.sum(out * r), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(p, x)
    chunked = []
    real = attn_mod._chunked_attn
    monkeypatch.setattr(attn_mod, "_chunked_attn",
                        lambda *a, **k: chunked.append(1) or real(*a, **k))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    q, k, v = attn_mod.project_qkv(tcfg, tp, tx, torch.as_tensor(pos))
    out = attn_mod._out_proj(attn_mod.train_attention(
        tcfg, q, k, v, causal=causal, window=window, pos_offset=pos_offset),
        tp["wo"])
    (out * torch.as_tensor(r)).sum().backward()
    assert bool(chunked) == (S > chunk and S % chunk == 0)
    assert _rel(out.detach().numpy(), jout) <= 1e-5
    assert _rel(tx.grad.numpy(), jgx) <= 1e-5
    for name in p:
        assert _rel(tp[name].grad.numpy(), jgp[name]) <= 1e-5, name


def test_chunked_prefill_matches_reference_chunked_prefill():
    """Without grad ``attn_chunk`` changes nothing in the port (the flash
    wrapper, its plain version here); the reference's prefill takes its
    chunked path.  Same logits and caches."""
    from repro.models.transformer import init_params as j_init_params
    from repro.models.transformer import prefill as j_prefill
    from repro_torch.models import prefill

    jcfg, tcfg = _cfgs("gemma2_2b")
    jcfg = dataclasses.replace(jcfg, attn_chunk=8)
    tcfg = dataclasses.replace(tcfg, attn_chunk=8)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    params = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 32))
    jl, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 40)
    tl, tc = prefill(tcfg, params, {"tokens": torch.as_tensor(toks)}, 40)
    assert _rel(tl.numpy(), jl) <= 1e-5
    k0 = np.asarray(jc["stack"]["1"].k[0])  # first global layer's keys
    assert _rel(tc[1].k.numpy(), k0) <= 1e-5


def test_train_step_with_attn_chunk_matches_reference():
    from repro.models.transformer import init_params as j_init_params

    jcfg, tcfg = _cfgs("gemma2_2b")
    jcfg = dataclasses.replace(jcfg, attn_chunk=8)
    tcfg = dataclasses.replace(tcfg, attn_chunk=8)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    model = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
        trainable=True)
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (4, 32)).astype(np.int32)
    jo = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    to = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    jstate = j_opt.adamw_init(jparams, jo)
    jnew, _, jm = jax.jit(j_make_train_step(jcfg, jo, 2))(
        jparams, jstate, {"tokens": jnp.asarray(toks)})
    state = opt.adamw_init(model.flat, to)
    model, _, m = make_train_step(tcfg, to, 2)(
        model, state, {"tokens": torch.as_tensor(toks)})
    assert _rel(m["loss"], float(jm["loss"])) <= 1e-5
    assert _rel(m["grad_norm"], float(jm["grad_norm"])) <= 1e-5
    # Adam moves an element by about lr whatever its gradient's size, so
    # a near-zero gradient's rounding shows at lr's scale (2.1e-5 here)
    assert _rel(model.flat.theta.numpy(),
                np.asarray(ravel_pytree(jnew)[0])) <= 1e-4


# --------------------------------------------------------------------- #
# Sharding rules
# --------------------------------------------------------------------- #
MESHES = {
    "production": mesh.make_production_mesh(),
    "multi_pod": mesh.make_production_mesh(multi_pod=True),
    "debug": mesh.make_debug_mesh(),
    "one_card": dryrun.ONE_CARD,
}


def test_mesh_shapes_are_the_reference_ones():
    assert dict(MESHES["production"].shape) == {"data": 16, "model": 16}
    assert dict(MESHES["multi_pod"].shape) == {"pod": 2, "data": 16,
                                               "model": 16}
    assert dict(MESHES["debug"].shape) == {"data": 2, "model": 4}
    assert MESHES["multi_pod"].size == 512 and str(MESHES["debug"]) == "2x4"


def _reference_apply_variant():
    """The reference's ``apply_variant``, compiled from its source alone:
    importing ``repro.launch.dryrun`` would run its first lines, which set
    ``XLA_FLAGS`` for 512 host devices in this process."""
    import ast
    import pathlib

    import repro.launch

    path = pathlib.Path(repro.launch.__file__).with_name("dryrun.py")
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "apply_variant")
    ns = {"dataclasses": dataclasses}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["apply_variant"]


def _rule_sets():
    out = {"base": (j_sharding.BASE_RULES, sharding.BASE_RULES),
           "long_decode": (j_sharding.long_decode_rules(),
                           sharding.long_decode_rules())}
    cfg = get_config("gemma_2b")
    for variant in ("no_fsdp", "fsdp_pod", "kv_seq_data", "expert_fsdp",
                    "moe_cap_shard", "tp_only", "fsdp_all"):
        _, jr = _reference_apply_variant()(
            j_get_config("gemma_2b"), dict(j_sharding.BASE_RULES), None,
            variant)
        _, tr, _, _ = dryrun.apply_variant(cfg, dict(sharding.BASE_RULES),
                                           variant)
        out[variant] = (jr, tr)
    return out


RULES = _rule_sets()


def test_rule_tables_are_the_reference_ones():
    for name, (jr, tr) in RULES.items():
        assert jr == tr, name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_axes_and_bytes_per_device_match_reference(arch):
    jspec = j_tf.model_spec(j_get_config(arch))
    tspec = tf.model_spec(get_config(arch))
    jleaves = jax.tree.leaves(jspec,
                              is_leaf=lambda x: isinstance(x, JParamSpec))
    tleaves = [s for _, s in leaves(tspec)]
    assert len(jleaves) == len(tleaves)
    for mname, m in MESHES.items():
        for rname, (jr, tr) in RULES.items():
            for js, ts in zip(jleaves, tleaves):
                assert (js.shape, js.axes) == (ts.shape, ts.axes)
                want = tuple(j_sharding.resolve_axes(js.axes, js.shape, jr, m))
                assert sharding.resolve_axes(ts.axes, ts.shape, tr, m) \
                    == want, (mname, rname, ts)
            assert sharding.bytes_per_device(tspec, tr, m) == \
                j_sharding.bytes_per_device(jspec, jr, m), (mname, rname)


# --------------------------------------------------------------------- #
# Cell planning
# --------------------------------------------------------------------- #
def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _ref_cache_leaves(caches):
    flat, _ = jax.tree_util.tree_flatten_with_path(caches)
    return [(tuple(getattr(k, "key", getattr(k, "name", None)) for k in path),
             tuple(leaf.shape), _dtype_name(leaf.dtype))
            for path, leaf in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_planning_matches_reference(arch):
    jcfg0, tcfg0 = j_get_config(arch), get_config(arch)
    for name, tshape in inputs.SHAPES.items():
        jshape = j_inp.SHAPES[name]
        assert dataclasses.astuple(tshape) == dataclasses.astuple(jshape)
        assert inputs.cell_is_runnable(tcfg0, tshape) == \
            j_inp.cell_is_runnable(jcfg0, jshape)
        jcfg = j_inp.adjusted_config(jcfg0, jshape)
        tcfg = inputs.adjusted_config(tcfg0, tshape)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for dp in (1, 2, 16, 32, 256, 512):
            assert inputs.grad_accum_for(tcfg, tshape, dp) == \
                j_inp.grad_accum_for(jcfg, jshape, dp)
        assert inputs.rules_for(tcfg, tshape) == j_inp.rules_for(jcfg, jshape)
        tspecs, taxes = inputs.batch_specs(tcfg, tshape)
        jspecs, jaxes = j_inp.batch_specs(jcfg, jshape)
        assert taxes == jaxes and set(tspecs) == set(jspecs)
        for k, t in tspecs.items():
            assert t.device == META
            assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                (jspecs[k].shape, _dtype_name(jspecs[k].dtype)), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_trees_match_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for batch, max_len in ((128, 32768), (1, 524288), (3, 100)):
        jc = j_inp.cache_abstract(jcfg, batch, max_len)
        tc = inputs.cache_abstract(tcfg, batch, max_len)
        got = [(path, tuple(t.shape), _dtype_name(t.dtype))
               for path, t in inputs.tree_leaves_with_path(tc)]
        assert got == _ref_cache_leaves(jc)
        assert all(t.device == META
                   for _, t in inputs.tree_leaves_with_path(tc))
        jaxes = jax.tree.structure(jc).flatten_up_to(
            j_inp.cache_axes(jcfg, jc))
        taxes = [ax for _, ax in inputs.tree_leaves_with_path(
            inputs.cache_axes(tcfg, tc))]
        assert [tuple(a) for a in jaxes] == taxes


# --------------------------------------------------------------------- #
# Roofline and model FLOPs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_flop_counts_match_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert roofline.active_params(tcfg) == j_roofline.active_params(jcfg)
    for name, shape in inputs.SHAPES.items():
        jshape = j_inp.SHAPES[name]
        for kind in ("train", "prefill", "decode"):
            assert roofline.model_flops(tcfg, shape, kind) == \
                j_roofline.model_flops(jcfg, jshape, kind)
            for accum, n_dev in ((1, 1), (16, 256), (4, 512)):
                args = (kind, accum, n_dev, 3.5e9, 1.25e9)
                assert roofline.analytic_memory_bytes(tcfg, shape, *args) \
                    == j_roofline.analytic_memory_bytes(jcfg, jshape, *args)


class TestModelFlops:
    """The reference's ``tests/test_launch.py::TestModelFlops`` on the
    port's counts."""

    def test_active_params_moe_scaling(self):
        total, active = roofline.active_params(get_config("olmoe_1b_7b"))
        assert 6e9 < total < 8e9
        assert active < total / 3

    def test_dense_param_counts_match_public_sizes(self):
        expected = {
            "gemma_2b": (2.4e9, 2.8e9),
            "gemma2_2b": (2.4e9, 2.9e9),
            "gemma3_4b": (3.5e9, 4.5e9),
            "minitron_8b": (7.5e9, 8.5e9),
            "qwen2_vl_72b": (70e9, 75e9),
            "whisper_large_v3": (1.4e9, 1.7e9),
            "jamba_1p5_large_398b": (380e9, 410e9),
            "qwen2_moe_a2p7b": (13e9, 15.5e9),
            "xlstm_125m": (0.08e9, 0.2e9),
        }
        for arch, (lo, hi) in expected.items():
            total, _ = roofline.active_params(get_config(arch))
            assert lo < total < hi, (arch, total)

    def test_train_flops_exceed_prefill(self):
        cfg = get_config("gemma_2b")
        t = roofline.model_flops(cfg, inputs.SHAPES["train_4k"], "train")
        p = roofline.model_flops(cfg, inputs.SHAPES["prefill_32k"],
                                 "prefill")
        assert t > p / 3


def test_compute_term_divides_by_the_dtype_peak():
    st = opstats.OpStats()
    st.add_dot(989e12, torch.bfloat16)
    st.add_dot(67e12, torch.float32)
    assert st.dot_flops == 989e12 + 67e12
    assert roofline.compute_seconds(st.dot_flops_by_dtype) == \
        pytest.approx(2.0, rel=1e-12)
    cfg = get_config("gemma_2b")
    rep = roofline.roofline_from_stats(st, cfg, inputs.SHAPES["train_4k"],
                                       "train", 1, 1, 1e9, 0.0)
    assert rep.compute_s == pytest.approx(2.0, rel=1e-12)
    assert rep.collective_s == 0.0 and rep.collectives == {}
    assert rep.bottleneck == "compute"


# --------------------------------------------------------------------- #
# opstats against hloparse
# --------------------------------------------------------------------- #
@pytest.fixture
def x64_off():
    """The reference's HLO compiled with x64 off, as its dry run runs it:
    ``hloparse`` reads ``s32`` loop bounds, and ``repro.problems``, which
    another test file of the same process may import, turns x64 on."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", was)


def _abstract_tokens(B, S):
    return {"tokens": torch.empty(B, S, dtype=torch.int32, device=META)}


def _dense_attention_flops(cfg, B, S, T):
    """The reference's masked scores: every (query, key) pair of every
    attention layer, both products."""
    n_attn = sum(m in ("attn", "local") for m, _ in tf.layer_kinds(cfg))
    return n_attn * 4 * B * cfg.n_heads * cfg.hd * S * T


DENSE = {"gemma_2b": {}, "gemma2_2b": dict(n_layers=4)}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", sorted(DENSE))
def test_opstats_train_dot_flops_equal_hloparse(arch, accum, x64_off):
    jcfg, tcfg = _cfgs(arch, **DENSE[arch])
    B, S = 4, 16
    jo = j_opt.AdamWConfig()
    jparams = j_tf.abstract_params(jcfg, dtype=jnp.float32)
    jstate = jax.eval_shape(lambda p: j_opt.adamw_init(p, jo), jparams)
    text = jax.jit(j_make_train_step(jcfg, jo, accum)).lower(
        jparams, jstate,
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile().as_text()
    want = hloparse.analyze(text)
    params = tf.abstract_params(tcfg, dtype=torch.float32)
    state = opt.adamw_init(tf.make_trainable(params), opt.AdamWConfig())
    _, st = opstats.analyze(make_train_step(tcfg, opt.AdamWConfig(), accum),
                            params, state, _abstract_tokens(B, S))
    assert st.dot_flops == want.dot_flops > 0
    assert st.dot_flops_by_dtype == {"torch.float32": st.dot_flops}
    assert st.leaves == {} and st.total_wire == 0.0


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_opstats_prefill_and_decode_dot_flops_equal_hloparse(arch, x64_off):
    jcfg, tcfg = _cfgs(arch, **DENSE[arch])
    B, S, L = 4, 16, 20
    jparams = j_tf.abstract_params(jcfg, dtype=jnp.float32)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    text = jax.jit(lambda p, b: j_tf.prefill(jcfg, p, b, max_len=L)).lower(
        jparams, {"tokens": tok}).compile().as_text()
    want = hloparse.analyze(text).dot_flops
    params = tf.abstract_params(tcfg, dtype=torch.float32)
    with torch.no_grad():
        _, st = opstats.analyze(tf.prefill, tcfg, params,
                                _abstract_tokens(B, S), L)
    flash = st.leaves["flash_attention"]
    assert flash["calls"] == tcfg.n_layers
    # the kernel does the visible pairs' products; the reference's jnp
    # attention every pair's under the mask
    assert st.dot_flops - flash["dot_flops"] + \
        _dense_attention_flops(tcfg, B, S, S) == want
    assert flash["dot_flops"] < _dense_attention_flops(tcfg, B, S, S)

    caches = jax.eval_shape(lambda: j_tf.init_caches(jcfg, B, L,
                                                     jnp.float32))
    text = jax.jit(lambda p, c, t, pos: j_tf.decode_step(jcfg, p, c, t, pos)
                   ).lower(jparams, caches,
                           jax.ShapeDtypeStruct((B, 1), jnp.int32),
                           jax.ShapeDtypeStruct((), jnp.int32)
                           ).compile().as_text()
    want = hloparse.analyze(text).dot_flops
    _, st = opstats.analyze(tf.decode_step, tcfg, params,
                            tf.abstract_caches(tcfg, B, L, torch.float32),
                            _abstract_tokens(B, 1)["tokens"], S)
    assert st.dot_flops == want > 0


def test_kernel_entry_points_are_leaves():
    """A wrapper inside the trace runs neither its kernel nor its plain
    version: it counts its bound's work and returns shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import kernel_bench as kb

    q = torch.empty(2, 64, 8, 32, device=META, dtype=torch.bfloat16)
    kv = torch.empty(2, 64, 4, 32, device=META, dtype=torch.bfloat16)
    dt = torch.empty(2, 64, 48, device=META)
    bc = torch.empty(2, 64, 8, device=META)
    A = torch.empty(48, 8, device=META)
    real = (ops.flash_attention, ops.selective_scan)
    with opstats.counting() as st:
        o = ops.flash_attention(q, kv, kv, window=16)
        y, h = ops.selective_scan(dt, dt, bc, bc, A)
    assert (ops.flash_attention, ops.selective_scan) == real
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert y.shape == (2, 64, 48) and h.shape == (2, 48, 8)
    nb, fl = kb.flash_work(2, 64, 8, 4, 32, 16, 2)
    assert st.leaves["flash_attention"] == {"calls": 1, "bytes": nb,
                                            "dot_flops": fl, "flops": 0.0}
    assert st.dot_flops_by_dtype == {"torch.bfloat16": fl}
    nb, fl, _ = kb.selective_scan_work(2, 64, 48, 8, 4)
    assert st.leaves["selective_scan"]["flops"] == fl == st.leaf_flops
    assert st.op_counts == {}  # no aten op ran for either
    x = torch.randn(3, 8, dtype=torch.float64)
    alpha = torch.ones(3, dtype=torch.float64)
    with opstats.counting() as st:
        out = ops.anderson_mix(x, x, alpha)
    assert torch.equal(out, ref.anderson_mix(x, x, alpha))
    assert st.leaves["anderson_mix"]["calls"] == 1 and st.op_counts == {}


def test_flop_counter_is_a_diagnostic_beside_it():
    a = torch.empty(4, 8, device=META)
    b = torch.empty(8, 3, device=META)
    _, st = opstats.analyze(lambda: torch.einsum("ik,kj->ij", a, b) + 1,
                            flop_counter=True)
    assert st.dot_flops == st.flop_counter_flops == 2 * 4 * 3 * 8
    assert st.traffic_bytes == (32 + 24 + 12) * 4 + (12 + 12) * 4


# --------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------- #
class _NoStorage(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on any op that makes a tensor with storage beyond a small host
    constant (the optimizer's step scalars, a RoPE frequency table of
    head_dim / 2 entries): nothing of a model's, a cache's or a batch's
    size is allocated."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device != META:
                assert t.numel() <= 256, (func, t.shape, t.device)
        return out


def test_train_cell_extrapolates_microbatches_exactly():
    _, cfg = _cfgs("gemma2_2b", n_layers=4)
    B, S, accum = 8, 16, 4
    from repro_torch.models import layers

    with _NoStorage():
        got = dryrun.trace_step(cfg, "train", B, S, accum)
    layers._rope_freqs_on.cache_clear()  # the trace filled it once
    params = tf.abstract_params(cfg, dtype=torch.float32)
    state = opt.adamw_init(tf.make_trainable(params), opt.AdamWConfig())
    _, whole = opstats.analyze(make_train_step(cfg, opt.AdamWConfig(), accum),
                               params, state, _abstract_tokens(B, S))
    assert got.dot_flops == whole.dot_flops > 0
    assert got.op_counts == whole.op_counts
    assert got.traffic_bytes == whole.traffic_bytes


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dry_run_cell_end_to_end(kind):
    _, cfg = _cfgs("qwen2_moe_a2p7b")  # MoE: routing runs on meta too
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    shape = inputs.ShapeSpec("small", 16, 4, kind)
    with _NoStorage():
        rec = dryrun.dry_run(cfg, shape)
    n = sum(int(np.prod(s.shape)) for _, s in leaves(tf.model_spec(cfg)))
    res = rec["resident_bytes"]
    if kind == "train":
        assert rec["accum"] == inputs.grad_accum_for(cfg, shape, 1) == 1
        assert res == {"params": 4 * n, "grads": 4 * n, "adamw": 8 * n,
                       "total": 16 * n}
        assert set(rec["dot_flops_by_dtype"]) == {"torch.float32"}
    else:
        caches = inputs.cache_abstract(cfg, 4, 16, torch.bfloat16)
        cache_b = sum(t.numel() * 2 for _, t in
                      inputs.tree_leaves_with_path(caches))
        assert res == {"params": 2 * n, "caches": cache_b,
                       "total": 2 * n + cache_b}
        # bfloat16 products, beside the router's float32 logits
        by = rec["dot_flops_by_dtype"]
        assert set(by) == {"torch.bfloat16", "torch.float32"}
        assert by["torch.bfloat16"] > 10 * by["torch.float32"]
    assert rec["fits_hbm"] and rec["status"] == "OK"
    peak = {"torch.bfloat16": mesh.PEAK_FLOPS_BF16,
            "torch.float32": mesh.PEAK_FLOPS_F32}
    assert rec["compute_s"] == pytest.approx(
        sum(f / peak[dt] for dt, f in rec["dot_flops_by_dtype"].items()),
        rel=1e-12)
    assert rec["collective_s"] == 0.0
    assert rec["model_flops"] == roofline.model_flops(cfg, shape, kind)
    if kind == "prefill":
        assert rec["leaves"]["flash_attention"]["calls"] == cfg.n_layers


def test_dryrun_cli_one_cell_and_multi_pod(tmp_path, capsys):
    assert dryrun.main(["--arch", "xlstm_125m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    line = capsys.readouterr().out
    assert "[xlstm_125m x decode_32k x 1x1 x baseline] OK" in line
    assert "fits=True" in line
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "long_500k"]) == 0
    assert "SKIP" in capsys.readouterr().out
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k",
                        "--multi-pod"]) == 0
    line = capsys.readouterr().out
    assert "[gemma_2b x decode_32k x 2x16x16 x baseline] OK" in line
    assert "all-reduce:n=" in line
    rec = dryrun.run_cell("gemma_2b", "decode_32k", multi_pod=True,
                          verbose=False)
    assert rec["n_devices"] == 512 and rec["collective_s"] > 0


def test_variants():
    cfg = get_config("gemma2_2b")
    rules = dict(sharding.BASE_RULES)
    c, r, accum, note = dryrun.apply_variant(cfg, rules, "chunk512")
    assert c.attn_chunk == 512 and r == rules and not note
    c, r, accum, note = dryrun.apply_variant(cfg, rules, "no_fsdp")
    assert c == cfg and r["embed"] is None and "no effect" in note
    assert dryrun.apply_variant(cfg, rules, "accum8")[2] == 8
    assert dryrun.apply_variant(cfg, rules, "fsdp_all16")[2] == 16
    with pytest.raises(ValueError):
        dryrun.apply_variant(cfg, rules, "nonsense")


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_loop_is_scaled_from_two_lengths(kind):
    """The dry run traces the sLSTM's time loop at 3 and 4 steps and
    scales it: the same product FLOPs as the whole loop traced step by
    step; a prefill's every count, a train step's traffic within 2% (a
    few zero-fills of the backward are counted apart)."""
    _, cfg = _cfgs("xlstm_125m", n_layers=4)  # [m, m, m, s]
    B, S = 2, 11
    got = dryrun.trace_step(cfg, kind, B, S)
    want = dryrun.trace_step(cfg, kind, B, S, scale=False)
    assert got.dot_flops == want.dot_flops > 0
    if kind == "prefill":
        assert got.op_counts == want.op_counts
        assert got.traffic_bytes == want.traffic_bytes
    else:
        assert got.traffic_bytes == pytest.approx(want.traffic_bytes,
                                                  rel=0.02)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_periods_are_scaled_from_two_depths(kind):
    """A stack of more than 3 periods is traced at 2 and 3 and scaled:
    every count equal to the whole stack's trace."""
    _, cfg = _cfgs("gemma2_2b", n_layers=10)  # 5 periods of (local, attn)
    assert cfg.n_periods == 5
    B, S, accum = 4, 16, (2 if kind == "train" else 1)
    got = dryrun.trace_step(cfg, kind, B, S, accum)
    want = dryrun.trace_step(cfg, kind, B, S, accum, scale=False)
    assert got.dot_flops == want.dot_flops > 0
    assert got.op_counts == want.op_counts
    assert got.traffic_bytes == want.traffic_bytes
    assert got.leaves == want.leaves



def test_train_step_splits_every_input():
    """With ``accum > 1`` every input of the batch is split into the
    microbatches (the reference's tree map): a vision-language step keeps
    its vision block and M-RoPE positions."""
    from repro.models.transformer import init_params as j_init_params

    jcfg, tcfg = _cfgs("qwen2_vl_72b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    model = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
        trainable=True)
    rng = np.random.default_rng(4)
    B, S = 4, 16
    batch = {
        "tokens": rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32),
        "vision_embeds": rng.standard_normal(
            (B, 4, tcfg.d_model)).astype(np.float32),
        "positions": np.stack([np.broadcast_to(np.arange(S), (B, S)),
                               rng.integers(0, 4, (B, S)),
                               rng.integers(0, 4, (B, S))],
                              1).astype(np.int32)}
    jo = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    to = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    _, _, jm = jax.jit(j_make_train_step(jcfg, jo, 2))(
        jparams, j_opt.adamw_init(jparams, jo),
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, m = make_train_step(tcfg, to, 2)(
        model, opt.adamw_init(model.flat, to),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert _rel(m["loss"], float(jm["loss"])) <= 1e-5
    assert _rel(m["grad_norm"], float(jm["grad_norm"])) <= 1e-5


@pytest.mark.parametrize("arch", ["gemma_2b", "qwen2_vl_72b"])
def test_microbatches_are_scaled_from_the_second(arch):
    """A step of more than 3 microbatches is traced with 3 and the
    second's counts are added for each of the rest: every count equal to
    the whole step's (Qwen2-VL accumulates in a bfloat16 buffer)."""
    _, cfg = _cfgs(arch)
    assert cfg.n_periods <= 2
    got = dryrun.trace_step(cfg, "train", 8, 8, 8)
    want = dryrun.trace_step(cfg, "train", 8, 8, 8, scale=False)
    assert got.op_counts == want.op_counts
    assert got.traffic_bytes == want.traffic_bytes
    assert got.dot_flops == want.dot_flops > 0
