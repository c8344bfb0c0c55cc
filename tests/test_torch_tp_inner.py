"""The ``"inner"`` split of Mamba and xLSTM, the MoE router's split and
sequence-split decode caches, against the JAX package and the port's one
rank, on the CPU.

Every rank of a ``gloo`` mesh (``distributed.ranks.run``) holds its
slices of the reference's numpy weights
(``convert.lm_params_from_arrays(..., shardings=steps.tp_shardings(...))``)
and runs the prefill, teacher-forced decode steps and ``lm_loss`` on its
piece of the batch, under ``use_mesh(mesh, rules, batch)``:

* reduced Jamba (Mamba, attention and MoE layers: 8 layers, d_model 64,
  4 heads of 16, 2 KV heads, 8 experts) and reduced xLSTM ([m, m, m, s],
  4 heads) at meshes (1, 2), (1, 4) and (2, 2).  At (1, 4) Jamba's 2 KV
  heads do not split (each rank projects them all for its cache) and its
  caches lie along the sequence over ``"model"``;
* a reduced xLSTM with 2 heads at (1, 4): heads whole, ``inner`` split
  (the mLSTM state's ``C`` and ``n`` along the key dimension, the sLSTM's
  recurrence gathered once);
* batch-1 Jamba decode under ``long_decode_rules`` at (2, 1) and (2, 2),
  where ``cache_seq`` spans ``("data", "model")`` and the batch is whole;
* a reduced Gemma-2 (window 8) whose 6-token prompt's ring caches wrap
  inside its 6 decode steps, at (1, 2) and (1, 4).

Each run's logits (gathered over the vocabulary) and loss are held to the
JAX package's ``prefill``, ``decode_step`` and ``lm_loss`` on the same
weights and tokens; every rank also runs in float64 (float64 weights
and flat buffers) and its logits, loss and every gradient leaf (put
together from the slices) are held to the port's one rank in float64.
The placements of every parameter and every cache of every config, at
the production meshes, are held to the reference's ``resolve_axes``;
the collectives of one (1, 2) Jamba prefill to the dry run's count.

Tolerances, ``max|port - ref| / max|ref|``.  The float64 runs compute in
float64 throughout (:func:`_float64_points`), so the split is held to the
port's one rank at ``EXACT`` 1e-10: logits, loss and every gradient
leaf (at (2, 2) the one rank's loss and gradient are the means of the
two data pieces', since each data rank's MoE auxiliary losses are its
piece's).  Against the JAX package in float32, the logits' limit is 1e-5
(``tests/test_torch_tp.py``'s), raised to ``FACTOR`` times the JAX
package's own float32 distance from the float64 answer on the same
weights and tokens where that is larger: these reduced models amplify
float32 rounding in the reference itself (that distance, as
:func:`_limit` measures it on this file's inputs: Jamba's logits 4.5e-5,
5.6e-5 at batch 1; xLSTM's decode logits 5.8e-4, 1.2e-4 with 2 heads;
the ring-cache Gemma-2 2.3e-6, which keeps 1e-5).  The loss, 1e-5.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import ranks, sharding  # noqa: E402
from repro_torch.distributed.sharding import (BASE_RULES,  # noqa: E402
                                              MeshShape, long_decode_rules)
from repro_torch.launch import dryrun, inputs, steps  # noqa: E402
from repro_torch.models import attention, layers, mamba, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.attention import SeqKVCache  # noqa: E402
from repro_torch.models.common import tree_map, use_mesh  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

#: case -> (arch, reduced overrides, batch, prompt, decode steps, long)
CASES = {
    "jamba": ("jamba_1p5_large_398b", dict(n_layers=8), 2, 12, 4, False),
    "xlstm": ("xlstm_125m", dict(n_layers=4), 2, 12, 4, False),
    "xlstm2h": ("xlstm_125m", dict(n_layers=4, n_heads=2, n_kv_heads=2), 2,
                12, 4, False),
    "ring": ("gemma2_2b", dict(n_layers=2, d_model=64, d_ff=128,
                               vocab_size=256, n_heads=4, n_kv_heads=2,
                               head_dim=16), 2, 6, 6, False),
    "long": ("jamba_1p5_large_398b", dict(n_layers=8), 1, 12, 4, True),
}
#: world size -> mesh ("data", "model") -> the cases its ranks run
RUNS = {2: {(1, 2): ["jamba", "xlstm", "ring"], (2, 1): ["long"]},
        4: {(1, 4): ["jamba", "xlstm", "xlstm2h", "ring"],
            (2, 2): ["jamba", "xlstm", "long"]}}
#: the logits' limit against the JAX package, and how many times the JAX
#: package's own float32 distance from the float64 answer may raise it
TOL, FACTOR = 1e-5, 4.0
LOSS_TOL = 1e-5
EXACT = 1e-10


def _cfg(case):
    arch, over = CASES[case][:2]
    return get_config(arch).reduced(**over)


def _rules(case):
    return long_decode_rules() if CASES[case][5] else dict(BASE_RULES)


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _fill(spec, flat, prefix):
    if isinstance(spec, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in spec.items()}
    return flat[prefix[:-1]]


@contextlib.contextmanager
def _float64_points(dtype):
    """For a float64 model, the layers' float32 points in float64 (the
    float64 answer as ``chip_smoke.py``'s ``[lm-xlstm-parity]`` takes it:
    the modules' ``f32``; the plain kernels and the training logits follow
    float64 inputs), so that it computes in float64 throughout."""
    if dtype != np.float64:
        yield
        return
    mods = (layers, attention, mamba, xlstm, moe)
    tf.clear_host_tables()
    for m in mods:
        m.f32 = torch.float64
    try:
        yield
    finally:
        for m in mods:
            m.f32 = torch.float32
        tf.clear_host_tables()


def _tag(mesh_shape):
    return "x".join(map(str, mesh_shape))


def _inputs(case):
    _, _, B, S, steps_, _ = CASES[case]
    r = np.random.default_rng(7)
    V = _cfg(case).vocab_size
    return {"tokens": r.integers(0, V, (B, S)).astype(np.int32),
            "next": r.integers(0, V, (steps_, B, 1)).astype(np.int32)}


# --------------------------------------------------------------------- #
# Rank programs (fresh interpreters: no JAX)
# --------------------------------------------------------------------- #
def _piece(mesh, x, B):
    """The rank's piece of the batch (whole on one rank, or where the
    data axis does not divide it, as the step builders split it)."""
    if mesh is None or B % mesh.shape["data"]:
        return x
    return sharding.local_slice(x, sharding.Sharding(mesh, ("data",)))


def _serve(cfg, params, data, mesh, rules, out, prefix):
    """Prefill and teacher-forced decode; the gathered logits, and the
    caches' kinds after the prefill."""
    B, S = data["tokens"].shape
    steps_ = data["next"].shape[0]
    tokens = _piece(mesh, torch.from_numpy(data["tokens"]), B)
    with use_mesh(mesh, rules, B), torch.no_grad():
        logits, caches = tf.prefill(cfg, params, {"tokens": tokens},
                                    max_len=S + steps_)
        out[f"{prefix}prefill"] = tf.gather_logits(cfg, logits)
        out[f"{prefix}seq"] = torch.tensor([isinstance(c, SeqKVCache)
                                            for c in caches])
        for t in range(steps_):
            tok = _piece(mesh, torch.from_numpy(data["next"][t]), B)
            logits, caches = tf.decode_step(cfg, params, caches, tok, S + t)
            out[f"{prefix}decode{t}"] = tf.gather_logits(cfg, logits)


def _prefill_collectives(cfg, params, data, mesh, rules):
    """The collectives of one ``steps.build_prefill`` call (its caches in
    bfloat16, the step the dry run traces), by op: count, operand
    bytes."""
    B, S = data["tokens"].shape
    shape = inputs.ShapeSpec("t", S + data["next"].shape[0], B, "prefill")
    fn = steps.build_prefill(cfg, shape, mesh, rules)[0]
    with coll.tally() as seen:
        fn(params, {"tokens": _piece(mesh, torch.from_numpy(data["tokens"]),
                                     B)})
    return {f"c|{op}": np.array([r["count"], r["operand_bytes"]])
            for op, r in seen.items()}


def _loss_and_grad(cfg, params, batch, mesh, prefix, dtype):
    flat = tf.make_trainable(params, dtype)
    with use_mesh(mesh):
        loss, _ = tf.lm_loss(cfg, params, batch)
    loss.backward()
    out = {f"{prefix}{k}": v for k, v in _flat(flat.tree(flat.grad)).items()}
    out[f"{prefix}loss"] = loss.detach()
    return out


def _rank_case(rank, mesh, d, case):
    cfg, rules = _cfg(case), _rules(case)
    data = dict(np.load(os.path.join(d, f"{case}.npz")))
    weights = _fill(tf.model_spec(cfg), data, "w|")
    shard = steps.tp_shardings(cfg, mesh, rules)
    B = data["tokens"].shape[0]
    out, moved = {}, {}
    for prefix, dt in (("f|", np.float32), ("d|", np.float64)):
        w = tree_map(lambda a: a.astype(dt), weights)
        params = convert.lm_params_from_arrays(cfg, w, device="cpu",
                                               shardings=shard)
        with _float64_points(dt):
            _serve(cfg, params, data, mesh, rules, out, prefix)
            if prefix == "f|":
                moved = _prefill_collectives(cfg, params, data, mesh, rules)
            if CASES[case][5]:
                continue
            batch = {"tokens": _piece(mesh, torch.from_numpy(data["tokens"]),
                                      B)}
            if dt == np.float64:
                out.update(_loss_and_grad(cfg, params, batch, mesh, "g|",
                                          torch.float64))
            else:
                with use_mesh(mesh), torch.no_grad():
                    out["f|loss"] = tf.lm_loss(cfg, params, batch)[0]
    np.savez(os.path.join(d, f"{case}_{_tag(mesh.sizes)}_r{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()}, **moved)


def _rank_main(rank, world, d):
    from repro_torch.distributed.sharding import make_mesh

    torch.set_num_threads(1)
    for shape, cases in RUNS[world].items():
        mesh = make_mesh(shape, ("data", "model"))
        for case in cases:
            _rank_case(rank, mesh, d, case)


# --------------------------------------------------------------------- #
# The JAX package's answers, the port's one rank and the gloo runs
# --------------------------------------------------------------------- #
def _jax_answers(case, d):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import decode_step as j_decode_step
    from repro.models import init_params as j_init_params
    from repro.models import prefill as j_prefill
    from repro.models.transformer import lm_loss as j_lm_loss

    arch, over = CASES[case][:2]
    jcfg = j_get_config(arch).reduced(**over)
    jp = j_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    data = _inputs(case)
    tokens = jnp.asarray(data["tokens"])
    S, steps_ = tokens.shape[1], data["next"].shape[0]
    ref = {}
    logits, caches = j_prefill(jcfg, jp, {"tokens": tokens},
                               max_len=S + steps_)
    ref["prefill"] = np.asarray(logits)
    for t in range(steps_):
        logits, caches = j_decode_step(jcfg, jp, caches,
                                       jnp.asarray(data["next"][t]), S + t)
        ref[f"decode{t}"] = np.asarray(logits)
    if not CASES[case][5]:
        # the whole batch's loss, and the mean of its two halves' (each
        # data rank's loss is its piece's, the MoE losses included)
        ref["loss"] = np.asarray(j_lm_loss(jcfg, jp, {"tokens": tokens})[0])
        ref["loss2"] = np.mean([np.asarray(j_lm_loss(
            jcfg, jp, {"tokens": tokens[i:i + 1]})[0]) for i in range(2)])
    np.savez(os.path.join(d, f"{case}.npz"), **data,
             **{f"w|{k}": np.asarray(v) for k, v in _flat(jp).items()})
    # the port's one rank in float64 on the same weights
    cfg = _cfg(case)
    w64 = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
    one = {}
    with _float64_points(np.float64):
        _serve(cfg, convert.lm_params_from_arrays(cfg, w64, device="cpu"),
               data, None, None, one, "d|")
        if not CASES[case][5]:
            tokens = torch.from_numpy(data["tokens"])
            one.update(_loss_and_grad(
                cfg, convert.lm_params_from_arrays(cfg, w64, device="cpu"),
                {"tokens": tokens}, None, "g|", torch.float64))
            halves = [_loss_and_grad(
                cfg, convert.lm_params_from_arrays(cfg, w64, device="cpu"),
                {"tokens": tokens[i:i + 1]}, None, "g2|", torch.float64)
                for i in range(2)]
            one.update({k: (halves[0][k] + halves[1][k]) / 2
                        for k in halves[0]})
    ref.update({k: v.numpy() for k, v in one.items()})
    return ref


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_inner"))
    return d, {case: _jax_answers(case, d) for case in CASES}


@pytest.fixture(scope="module")
def gloo2(answers):
    ranks.run("test_torch_tp_inner:_rank_main", 2, args=[answers[0]],
              path=[HERE], timeout=150)
    return answers


@pytest.fixture(scope="module")
def gloo4(answers):
    ranks.run("test_torch_tp_inner:_rank_main", 4, args=[answers[0]],
              path=[HERE], timeout=150)
    return answers


def _got(request, case, mesh_shape):
    D, M = mesh_shape
    d, ref = request.getfixturevalue("gloo2" if D * M == 2 else "gloo4")
    return [dict(np.load(os.path.join(d, f"{case}_{_tag(mesh_shape)}_"
                                      f"r{r}.npz")))
            for r in range(D * M)], ref[case]


def _whole(got, key, mesh_shape, batch):
    """A batch-split output (logits) from the data ranks' pieces; every
    model rank of a data rank must hold the same."""
    D, M = mesh_shape
    for r in range(D * M):
        assert np.array_equal(got[r][key], got[r - r % M][key]), key
    if batch % D:  # whole on every data rank
        for dd in range(1, D):
            assert np.array_equal(got[dd * M][key], got[0][key]), key
        return got[0][key]
    return np.concatenate([got[dd * M][key] for dd in range(D)])


CASE_MESHES = [(case, m) for w in sorted(RUNS) for m, cs in RUNS[w].items()
               for case in cs]


def _logit_keys(ref):
    return ["prefill"] + sorted(k for k in ref if k.startswith("decode"))


def _limit(ref, keys) -> float:
    """``TOL``, or ``FACTOR`` times the JAX package's own float32 distance
    from the float64 answer over ``keys`` where that is larger."""
    own = max(_rel(ref[k], ref[f"d|{k}"]) for k in keys)
    return max(TOL, FACTOR * own)


@pytest.mark.parametrize("case,mesh_shape", CASE_MESHES)
def test_logits_match_jax(request, case, mesh_shape):
    """Prefill and decode logits against the JAX package's (the prefill
    and the decode steps each under their own limit)."""
    got, ref = _got(request, case, mesh_shape)
    B = CASES[case][2]
    keys = _logit_keys(ref)
    for group in (keys[:1], keys[1:]):
        tol = _limit(ref, group)
        for key in group:
            whole = _whole(got, f"f|{key}", mesh_shape, B)
            assert whole.shape == ref[key].shape, key
            assert _rel(whole, ref[key]) <= tol, key


@pytest.mark.parametrize("case,mesh_shape", CASE_MESHES)
def test_float64_split_matches_one_rank(request, case, mesh_shape):
    """The split run in float64 against the port's one rank in float64:
    logits, and where there is a loss, it and every gradient leaf (the
    slices put together, the data ranks' means averaged)."""
    got, ref = _got(request, case, mesh_shape)
    D, M = mesh_shape
    B = CASES[case][2]
    for key in _logit_keys(ref):
        assert _rel(_whole(got, f"d|{key}", mesh_shape, B),
                    ref[f"d|{key}"]) <= EXACT, key
    if CASES[case][5]:
        return
    one = "g|" if D == 1 else "g2|"  # the one rank on each data piece
    loss = np.mean([got[dd * M]["g|loss"] for dd in range(D)])
    assert _rel(loss, ref[f"{one}loss"]) <= EXACT
    split = 0
    for key, spec in _placed(_cfg(case), mesh_shape, _rules(case)).items():
        dim = spec.index("model") if "model" in spec else None
        split += dim is not None
        per_data = []
        for dd in range(D):
            pieces = [got[dd * M + m][f"g|{key}"] for m in range(M)]
            if dim is None:
                for p in pieces[1:]:
                    assert np.array_equal(p, pieces[0]), key
                per_data.append(pieces[0])
            else:
                per_data.append(np.concatenate(pieces, axis=dim))
        g = sum(per_data) / D
        assert g.shape == ref[f"{one}{key}"].shape, key
        assert _rel(g, ref[f"{one}{key}"]) <= EXACT, key
    assert split > 0


@pytest.mark.parametrize("case,mesh_shape",
                         [c for c in CASE_MESHES if not CASES[c[0]][5]])
def test_loss_matches_jax(request, case, mesh_shape):
    got, ref = _got(request, case, mesh_shape)
    D, M = mesh_shape
    loss = np.mean([got[dd * M]["f|loss"] for dd in range(D)])
    assert _rel(loss, ref["loss" if D == 1 else "loss2"]) <= LOSS_TOL


@pytest.mark.parametrize("case,mesh_shape", CASE_MESHES)
def test_caches_lie_where_the_rules_put_them(request, case, mesh_shape):
    """Attention caches are split along the sequence wherever the cache
    axes divide their length; recurrent states never are."""
    got, _ = _got(request, case, mesh_shape)
    kinds = [m for m, _ in tf.layer_kinds(_cfg(case))]
    want = [m in ("attn", "local") for m in kinds]
    assert got[0]["f|seq"].tolist() == want


def _placed(cfg, mesh_shape, rules):
    """Leaf -> its ``"model"`` placement on a (data, model) mesh."""
    shard = steps.tp_shardings(cfg, MeshShape(("data", "model"), mesh_shape),
                               rules)
    return {k: s.spec for k, s in _flat(shard).items()}


def test_mixers_and_router_are_split():
    """At (1, 2) every Mamba, mLSTM, sLSTM and router leaf that the rules
    place on ``"model"`` is cut: the 4-head xLSTM by heads, the 2-head one
    (at 4 ranks) only along ``inner``."""
    spec = _placed(_cfg("jamba"), (1, 2), BASE_RULES)
    for leaf in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                 "dt_bias", "A_log", "D", "out_proj"):
        assert "model" in spec[f"stack/0/mixer/{leaf}"], leaf
    assert spec["stack/1/ffn/router"] == (None, None, "model")
    spec = _placed(_cfg("xlstm"), (1, 4), BASE_RULES)
    assert spec["stack/0/mixer/wqkv"][3] == "model"
    assert spec["stack/3/mixer/wr"][1] == "model"
    spec = _placed(_cfg("xlstm2h"), (1, 4), BASE_RULES)
    assert "model" not in spec["stack/0/mixer/wqkv"]
    assert "model" not in spec["stack/3/mixer/wr"]
    assert spec["stack/0/mixer/wz"] == (None, None, "model")


# --------------------------------------------------------------------- #
# Placements against the reference's resolve_axes
# --------------------------------------------------------------------- #
ARCHS = ["jamba_1p5_large_398b", "xlstm_125m", "gemma3_4b",
         "whisper_large_v3", "qwen2_moe_a2p7b", "gemma2_2b", "qwen2_vl_72b",
         "olmoe_1b_7b", "minitron_8b", "gemma_2b"]


def _axes_of(part):
    return () if part is None else (part if isinstance(part, tuple)
                                    else (part,))


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference_resolve_axes(arch):
    """Every parameter's ``"model"`` placement (the port's tensor-parallel
    layout keeps θ whole along the data axes) and every cache tensor's
    placement, at 16x16 and 2x16x16 under each serve cell's rules, equal
    the reference's ``resolve_axes`` of its logical axes."""
    from repro.configs import get_config as j_get_config
    from repro.distributed.sharding import resolve_axes as j_resolve
    from repro.launch import inputs as j_inp
    from repro.models.transformer import model_spec as j_model_spec

    jcfg = j_get_config(arch)
    for mesh in (dryrun.MESHES["16x16"], dryrun.MESHES["2x16x16"]):
        class Stand:  # the reference reads only .shape
            shape = dict(mesh.shape)

        specs = _flat(j_model_spec(jcfg))
        mine = {k: s.spec for k, s in _flat(steps.tp_shardings(
            get_config(arch), mesh, BASE_RULES)).items()}
        assert set(specs) == set(mine)
        for k, s in specs.items():
            want = tuple("model" if "model" in _axes_of(p) else None
                         for p in j_resolve(s.axes, s.shape, BASE_RULES,
                                            Stand()))
            assert mine[k] == want, k
        for name, shape in j_inp.SHAPES.items():
            if shape.kind == "train" or not j_inp.cell_is_runnable(
                    jcfg, shape)[0]:
                continue
            _hold_caches(arch, name, mesh, Stand(), j_get_config(arch),
                         j_inp, j_resolve)


def _hold_caches(arch, name, mesh, stand, jcfg, j_inp, j_resolve):
    """Each cache tensor's placement of one serve cell (the port's per-layer
    list against the reference's stacked tree)."""
    jshape = j_inp.SHAPES[name]
    jcfg = j_inp.adjusted_config(jcfg, jshape)
    jrules = j_inp.rules_for(jcfg, jshape)
    jc = j_inp.cache_abstract(jcfg, jshape.batch, jshape.seq)
    axes = j_inp.cache_axes(jcfg, jc)
    want = {}
    for (path, leaf), (_, ax) in zip(_leaves(jc), _leaves(axes, True)):
        want[path] = j_resolve(tuple(ax), tuple(leaf.shape), jrules, stand)
    shape = inputs.SHAPES[name]
    cfg = inputs.adjusted_config(get_config(arch), shape)
    whole = tf.abstract_caches(cfg, shape.batch, shape.seq, torch.bfloat16,
                               enc_len=shape.seq // inputs.STUB_DIV)
    got = tf.cache_shardings(cfg, whole, mesh, inputs.rules_for(cfg, shape))
    L, n_stacked = len(cfg.period), cfg.n_periods * len(cfg.period)
    for i, c in enumerate(got):
        stacked = i < n_stacked
        where = (("stack", str(i % L)) if stacked
                 else ("rest", str(i - n_stacked)))
        parts = ([("", c.kv), ("cross", c.cross)]
                 if isinstance(c, tf.CrossCache) else [("", c)])
        for head, node in parts:
            for field, s in zip(node._fields, node):
                path = ((head,) if head else ()) + where + (field,)
                ref = tuple(want[path])
                assert s.spec == (ref[1:] if stacked else ref), (name, path)


def _leaves(tree, is_axes=False):
    """(path, leaf) of a cache tree (dict keys, NamedTuple fields), the
    leaves tensors or axes tuples."""
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, tuple) and not hasattr(
            x, "_fields")) if is_axes else None)
    return [(tuple(getattr(k, "key", getattr(k, "name", None))
                   for k in p), leaf) for p, leaf in flat]


# --------------------------------------------------------------------- #
# The dry run counts the split layers' collectives
# --------------------------------------------------------------------- #
def test_dry_run_counts_the_prefill_collectives(gloo2):
    """The (1, 2) Jamba prefill traced on the meta device issues the
    collectives the gloo ranks' ``build_prefill`` issued, with the same
    bytes:
    ``x_proj``'s all-reduces, the router's gathers and the KV all-to-all
    among them."""
    d = gloo2[0]
    real = dict(np.load(os.path.join(d, "jamba_1x2_r0.npz")))
    cfg = dataclasses.replace(_cfg("jamba"), param_dtype="float32")
    B, S, steps_ = CASES["jamba"][2:5]
    st = dryrun.trace_step(cfg, "prefill", B, S, max_len=S + steps_,
                           mesh=MeshShape(("data", "model"), (1, 2)))
    seen = {k[2:]: tuple(v) for k, v in real.items() if k.startswith("c|")}
    counted = {op: (st.coll_counts[op], st.coll_operand_bytes[op])
               for op in st.coll_counts}
    assert {"all-reduce", "all-gather", "all-to-all"} <= set(counted)
    assert counted == seen


@pytest.mark.parametrize("case", ["jamba", "xlstm2h"])
def test_init_params_on_a_mesh_draws_the_ranks_slices(case):
    """``init_params(mesh=)`` keeps each rank's slices of the same draws:
    ``shard_params`` of the whole model, leaf by leaf."""
    cfg = _cfg(case)
    whole = tf.init_params(cfg, torch.Generator().manual_seed(3),
                           dtype=torch.float32, device="cpu")
    for r in range(4):
        rank = sharding.traced_rank(MeshShape(("data", "model"), (1, 4)), r)
        got = tf.init_params(cfg, torch.Generator().manual_seed(3),
                             dtype=torch.float32, device="cpu", mesh=rank)
        want = tf.shard_params(whole, rank)
        for (k, a), (_, b) in zip(got.named_parameters(),
                                  want.named_parameters()):
            assert torch.equal(a, b), k


def test_restore_fills_split_mixer_slices(tmp_path):
    """A checkpoint of whole leaves restored under the tensor-parallel
    placements holds each rank's Mamba, attention and router slices, as
    ``shard_params`` cuts them."""
    from repro_torch.training import checkpoint as ckpt

    cfg = _cfg("jamba")
    whole = tf.init_params(cfg, torch.Generator().manual_seed(2),
                           dtype=torch.float32, device="cpu")
    ckpt.save(str(tmp_path), 1, tf.make_trainable(whole).tree())
    template = tree_map(lambda s: torch.empty(s.shape, device="meta"),
                        tf.model_spec(cfg))
    for r in range(2):
        rank = sharding.traced_rank(MeshShape(("data", "model"), (1, 2)), r)
        tree, _, _ = ckpt.restore(
            str(tmp_path), template,
            shardings=steps.tp_shardings(cfg, rank, BASE_RULES))
        want = tf.make_trainable(tf.shard_params(whole, rank)).tree()
        got = _flat(tree)
        for k, v in _flat(want).items():
            assert torch.equal(got[k], v), k
