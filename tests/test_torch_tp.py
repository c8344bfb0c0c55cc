"""Tensor parallelism along ``"model"`` against the JAX package and the
port's one rank, and the multi-rank dry run, on the CPU.

* Layers against the JAX package: a reduced Gemma-2 (2 layers, d_model
  64, d_ff 128, vocab 256, 4 heads of 16, 2 KV heads) on meshes (1, 2),
  (1, 4) and (2, 2) of ``gloo`` ranks (``distributed.ranks.run``).  At
  (1, 4) the 2 KV heads do not split: each rank reads the KV head of its
  q head from the whole ``wk``/``wv``, whose gradient is summed over
  ``"model"``.  Every rank holds its slices of the reference's numpy
  weights (``convert.lm_params_from_arrays(..., shardings=
  steps.tp_shardings(...))``) and runs the prefill, 4 decode steps,
  ``lm_loss`` and its gradient on its piece of the batch; the logits
  (gathered over the vocabulary), the loss and every gradient leaf
  (reassembled from the slices, summed over the data ranks) are held to
  the JAX package's ``prefill``, ``decode_step`` and ``lm_loss`` on the
  same weights and tokens.  A reduced Qwen1.5-MoE with shared experts
  (experts and shared FFN split) and a reduced Whisper prefill
  (cross-attention) at (1, 2) too.
* The train step at (2, 2) against the port's one-rank
  ``make_train_step``: the losses and θ after 2 steps.
* The dry run: per-rank product FLOPs of a traced rank times the
  ``"model"`` size equal the one-rank trace's on the reduced config; the
  collectives that the meta trace of the (2, 2) train step counts equal
  those the ``gloo`` run of the same step recorded; the ZeRO
  reduce-scatter and all-gather are counted; each op's wire bytes equal
  ``repro.launch.hloparse``'s on a one-line HLO of the same op; the
  parameter and cache bytes of every cell the reference admits, at
  16x16 and 2x16x16, equal the reference's rule count (its dry run's two
  helpers, compiled from its source: importing ``repro.launch.dryrun``
  would set ``XLA_FLAGS`` in this process), and so do the caches of the
  port's own layout on the rank in every serve cell.

Tolerances: relative error is ``max|port - ref| / max|ref|`` per tensor.
Logits (prefill and decode) and losses 1e-5 against the JAX package
(float32 math in another library and order, the partial sums added in
another order) for Gemma-2 and the MoE model; Whisper's prefill logits
1e-4, the tolerance ``tests/test_torch_whisper.py`` gives what its
encoder feeds.  Gradient leaves 5e-5 against the JAX package's float32
gradient: on this reduced Gemma-2 (its logits near the softcap) the
JAX package's own float32 gradient is up to 2.9e-5 from its float64
one (``wk`` of layer 1) and the port's one rank 1.95e-5 from it, so
1e-5 would hold the port to less than the reference's own rounding.  To
hold the split itself tightly, every rank also runs the loss and its
gradient in float64 (float64 weights and flat buffers; attention's
softmax and RoPE stay float32, in both runs): its gradient leaves and
loss are within 1e-6 of the port's one rank in float64 (measured
3.5e-7).  The tensor-parallel train step against the one
rank: losses 1e-6 relative, θ within 1e-6 (absolute, as
``tests/test_torch_distributed.py`` holds the sharded step's θ; AdamW's
normalised step turns the last-bit differences of near-zero gradients
into relative differences of a few 1e-6 on the norm scales' tiny
values).

The rank programs are the ``_rank_*`` functions below, run from this
module in fresh interpreters (they import no JAX).
"""

import ast
import dataclasses
import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import ranks, sharding  # noqa: E402
from repro_torch.distributed.sharding import BASE_RULES, MeshShape  # noqa: E402
from repro_torch.launch import dryrun, inputs, steps  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import tree_map, use_mesh  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

#: the reduced configs (arch -> overrides)
CFGS = {
    "gemma2_2b": dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256,
                      n_heads=4, n_kv_heads=2, head_dim=16),
    "qwen2_moe_a2p7b": dict(n_layers=2),
    "whisper_large_v3": dict(n_layers=2),
}
#: world size -> the meshes ("data", "model") its ranks run
MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
B, S, STEPS = 2, 12, 4
FRAMES = 10
TOL = {"gemma2_2b": 1e-5, "qwen2_moe_a2p7b": 1e-5, "whisper_large_v3": 1e-4}
GRAD_TOL = 5e-5
EXACT = 1e-6
TRAIN = dict(batch=4, seq=16, steps=2)


def _cfg(arch):
    return get_config(arch).reduced(**CFGS[arch])


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


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _fill(spec, flat, prefix):
    """The tree of ``spec`` (empty subtrees too) from ``flat``'s
    ``prefix + path`` entries."""
    if isinstance(spec, dict):
        return {k: _fill(v, flat, f"{prefix}{k}/") for k, v in spec.items()}
    return flat[prefix[:-1]]


def _tag(mesh_shape):
    return "x".join(map(str, mesh_shape))


def _inputs(cfg, seed=0):
    r = np.random.default_rng(seed)
    out = {"tokens": r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "next": r.integers(0, cfg.vocab_size,
                              (STEPS, B, 1)).astype(np.int32)}
    if cfg.kind == "encdec":
        out["audio_embeds"] = r.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return out


# --------------------------------------------------------------------- #
# Rank programs (run in fresh interpreters: no JAX)
# --------------------------------------------------------------------- #
def _piece(mesh, x):
    return sharding.local_slice(x, sharding.Sharding(mesh, ("data",)))


def _rank_layers(rank, mesh, d, arch):
    """Prefill, decode and the loss's gradient on this rank's slices."""
    cfg = _cfg(arch)
    data = dict(np.load(os.path.join(d, f"{arch}.npz")))
    weights = _fill(tf.model_spec(cfg), data, "w|")
    shard = steps.tp_shardings(cfg, mesh, BASE_RULES)
    params = convert.lm_params_from_arrays(cfg, weights, device="cpu",
                                           shardings=shard)
    batch = {k: _piece(mesh, torch.from_numpy(data[k]))
             for k in ("tokens", "audio_embeds") if k in data}
    out = {}
    with use_mesh(mesh), torch.no_grad():
        logits, caches = tf.prefill(cfg, params, batch, max_len=S + STEPS)
        out["prefill"] = tf.gather_logits(cfg, logits)
        if cfg.kind != "encdec":
            for t in range(STEPS):
                tok = _piece(mesh, torch.from_numpy(data["next"][t]))
                logits, caches = tf.decode_step(cfg, params, caches, tok,
                                                S + t)
                out[f"decode{t}"] = tf.gather_logits(cfg, logits)
    if cfg.kind != "encdec":
        out.update(_loss_and_grad(cfg, params, batch, mesh, "g|"))
        out.update(_loss_and_grad(cfg, convert.lm_params_from_arrays(
            cfg, tree_map(lambda a: a.astype(np.float64), weights),
            device="cpu", shardings=shard), batch, mesh, "d|",
            torch.float64))
    np.savez(os.path.join(d, f"{arch}_{_tag(mesh.sizes)}_r{rank}.npz"),
             **{k: v.numpy() for k, v in out.items()})


def _loss_and_grad(cfg, params, batch, mesh, prefix, dtype=torch.float32):
    """``lm_loss`` and its gradient leaves (reference paths, this rank's
    slices) in a flat buffer of ``dtype``."""
    flat = tf.make_trainable(params, dtype)
    with use_mesh(mesh):
        loss, _ = tf.lm_loss(cfg, params, batch)
    loss.backward()
    out = {f"{prefix}{k}": v for k, v in _flat(flat.tree(flat.grad)).items()}
    out[f"{prefix}loss"] = loss.detach()
    return out


def _train_tokens():
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (TRAIN["batch"], TRAIN["seq"])))


def _rank_train(rank, mesh, d):
    """Two (2, 2) train steps from the same whole weights, and the
    collectives the first one issued."""
    cfg = _cfg("gemma2_2b")
    fn, in_sh, _, _, meta = steps.build_train(
        cfg, inputs.ShapeSpec("tiny", TRAIN["seq"], TRAIN["batch"], "train"),
        mesh, dict(BASE_RULES), opt_cfg=AdamWConfig(lr=1e-3),
        accum_override=2)
    whole = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    params = tf.shard_params(whole, mesh)
    flat = tf.make_trainable(params)
    opt = sharding.local_tree(adamw_init(flat, AdamWConfig()), in_sh[1])
    batch = sharding.local_tree({"tokens": _train_tokens()}, in_sh[2])
    losses = []
    for i in range(TRAIN["steps"]):
        with coll.tally() as seen:
            params, opt, m = fn(params, opt, batch)
        if i == 0:
            first = seen
        losses.append(m["loss"])
    out = {f"t|{k}": v.numpy() for k, v in _flat(flat.tree()).items()}
    for op, rec in first.items():
        out[f"c|{op}"] = np.array([rec["count"], rec["operand_bytes"],
                                   rec["wire_bytes"]])
    np.savez(os.path.join(d, f"train_r{rank}.npz"), losses=losses,
             tp=meta["tp"], **out)


def _rank_main(rank, world, d):
    from repro_torch.distributed.sharding import make_mesh

    for shape in MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"))
        for arch in (CFGS if world == 2 else ["gemma2_2b"]):
            _rank_layers(rank, mesh, d, arch)
        if shape == (2, 2):
            _rank_train(rank, mesh, d)


# --------------------------------------------------------------------- #
# The JAX package's answers and the gloo runs
# --------------------------------------------------------------------- #
def _jax_answers(arch, d):
    """The JAX package's prefill, decode logits, loss and gradient on its
    own weights, saved beside the weights and inputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models import decode_step as j_decode_step
    from repro.models import init_params as j_init_params
    from repro.models.transformer import lm_loss as j_lm_loss
    from repro.models import prefill as j_prefill

    jcfg = j_get_config(arch).reduced(**CFGS[arch])
    jp = j_init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    data = _inputs(jcfg)
    batch = {k: jnp.asarray(data[k]) for k in ("tokens", "audio_embeds")
             if k in data}
    ref = {}
    logits, caches = j_prefill(jcfg, jp, batch, max_len=S + STEPS)
    ref["prefill"] = np.asarray(logits)
    if jcfg.kind != "encdec":
        for t in range(STEPS):
            logits, caches = j_decode_step(jcfg, jp, caches,
                                           jnp.asarray(data["next"][t]),
                                           S + t)
            ref[f"decode{t}"] = np.asarray(logits)
        (loss, _), g = jax.value_and_grad(
            lambda p: j_lm_loss(jcfg, p, batch), has_aux=True)(jp)
        ref["loss"] = np.asarray(loss)
        ref.update({f"g|{k}": np.asarray(v) for k, v in _flat(g).items()})
    np.savez(os.path.join(d, f"{arch}.npz"), **data,
             **{f"w|{k}": np.asarray(v) for k, v in _flat(jp).items()})
    if jcfg.kind != "encdec":  # the port's one rank in float64, same data
        cfg = _cfg(arch)
        weights = jax.tree.map(lambda a: np.asarray(a, np.float64), jp)
        ref.update({k: v.numpy() for k, v in _loss_and_grad(
            cfg, convert.lm_params_from_arrays(cfg, weights, device="cpu"),
            {"tokens": torch.from_numpy(data["tokens"])}, None, "d|",
            torch.float64).items()})
    return ref


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    return d, {arch: _jax_answers(arch, d) for arch in CFGS}


@pytest.fixture(scope="module")
def gloo2(jax_ref):
    ranks.run("test_torch_tp:_rank_main", 2, args=[jax_ref[0]],
              path=[HERE], timeout=110)
    return jax_ref


@pytest.fixture(scope="module")
def gloo4(jax_ref):
    ranks.run("test_torch_tp:_rank_main", 4, args=[jax_ref[0]],
              path=[HERE], timeout=110)
    return jax_ref


def _load(d, name):
    return dict(np.load(os.path.join(d, name)))


def _runs(request, mesh_shape):
    return request.getfixturevalue("gloo2" if np.prod(mesh_shape) == 2
                                   else "gloo4")


LAYER_CASES = [("gemma2_2b", m) for w in sorted(MESHES) for m in MESHES[w]] \
    + [("qwen2_moe_a2p7b", (1, 2)), ("whisper_large_v3", (1, 2))]


@pytest.mark.parametrize("arch,mesh_shape", LAYER_CASES)
def test_logits_match_jax(request, arch, mesh_shape):
    d, ref = _runs(request, mesh_shape)
    D, M = mesh_shape
    got = [_load(d, f"{arch}_{_tag(mesh_shape)}_r{r}.npz")
           for r in range(D * M)]
    for key in [k for k in ref[arch]
                if not k.startswith(("g|", "d|", "loss"))]:
        # every model rank of a data rank gathers the same logits
        for r in range(D * M):
            assert np.array_equal(got[r][key], got[r - r % M][key]), key
        whole = np.concatenate([got[dd * M][key] for dd in range(D)])
        assert whole.shape == ref[arch][key].shape
        assert _rel(whole, ref[arch][key]) <= TOL[arch], key


def _placed(cfg, mesh_shape):
    """Leaf -> its ``"model"`` placement on a (data, model) mesh."""
    shard = steps.tp_shardings(cfg, MeshShape(("data", "model"),
                                              mesh_shape), BASE_RULES)
    return {k: s.spec for k, s in _flat(shard).items()}


def _whole(got, key, dim, D, M):
    """A gradient leaf from every rank's slice: the model ranks' slices
    put back in place (a whole leaf must be the same on each of them),
    then the data ranks' mean (each rank's loss is its piece's mean)."""
    per_data = []
    for dd in range(D):
        pieces = [got[dd * M + m][key] for m in range(M)]
        if dim is None:
            for p in pieces[1:]:
                assert np.array_equal(p, pieces[0]), key
            per_data.append(pieces[0])
        else:
            per_data.append(np.concatenate(pieces, axis=dim))
    return sum(per_data) / D


@pytest.mark.parametrize("arch,mesh_shape",
                         [c for c in LAYER_CASES if c[0] != "whisper_large_v3"])
def test_loss_and_gradients_match_jax(request, arch, mesh_shape):
    """The loss and every gradient leaf against the JAX package
    (float32) and against the port's one rank in float64."""
    d, ref = _runs(request, mesh_shape)
    D, M = mesh_shape
    got = [_load(d, f"{arch}_{_tag(mesh_shape)}_r{r}.npz")
           for r in range(D * M)]
    loss = np.mean([got[dd * M]["g|loss"] for dd in range(D)])
    assert _rel(loss, ref[arch]["loss"]) <= TOL[arch]
    loss64 = np.mean([got[dd * M]["d|loss"] for dd in range(D)])
    assert _rel(loss64, ref[arch]["d|loss"]) <= EXACT
    split = 0
    for key, spec in _placed(_cfg(arch), mesh_shape).items():
        dim = spec.index("model") if "model" in spec else None
        split += dim is not None
        g32 = _whole(got, f"g|{key}", dim, D, M)
        assert g32.shape == ref[arch][f"g|{key}"].shape, key
        assert _rel(g32, ref[arch][f"g|{key}"]) <= GRAD_TOL, key
        g64 = _whole(got, f"d|{key}", dim, D, M)
        assert _rel(g64, ref[arch][f"d|{key}"]) <= EXACT, key
    assert split > 0


def test_replicated_kv_heads_at_four_ranks():
    """At (1, 4) the 2 KV heads stay whole on every rank while the 4 q
    heads split: each rank holds all of wk and wv."""
    spec = _placed(_cfg("gemma2_2b"), (1, 4))
    assert spec["stack/0/mixer/wq"] == (None, None, "model", None)
    assert spec["stack/0/mixer/wk"] == (None, None, None, None)
    from repro_torch.models.attention import local_heads

    assert local_heads(_cfg("gemma2_2b"), 4) == (1, 1)
    assert local_heads(_cfg("gemma2_2b"), 2) == (2, 1)


@pytest.fixture(scope="module")
def one_rank_train():
    """The port's one-rank step on the whole batch."""
    from repro_torch.training.optimizer import AdamWConfig as Cfg

    cfg = _cfg("gemma2_2b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    flat = tf.make_trainable(params)
    st = adamw_init(flat, Cfg())
    fn = steps.make_train_step(cfg, Cfg(lr=1e-3), 2)
    losses = []
    for _ in range(TRAIN["steps"]):
        params, st, m = fn(params, st, {"tokens": _train_tokens()})
        losses.append(m["loss"])
    return np.array(losses), {k: v.numpy() for k, v in
                              _flat(flat.tree()).items()}


def test_train_step_matches_one_rank(gloo4, one_rank_train):
    d = gloo4[0]
    losses, theta = one_rank_train
    got = [_load(d, f"train_r{r}.npz") for r in range(4)]
    assert all(int(g["tp"]) == 2 for g in got)
    for g in got:
        assert np.allclose(g["losses"], losses, rtol=1e-6, atol=0)
    for key, spec in _placed(_cfg("gemma2_2b"), (2, 2)).items():
        dim = spec.index("model") if "model" in spec else None
        for dd in range(2):  # θ is whole along the data axis
            pieces = [got[dd * 2 + m][f"t|{key}"] for m in range(2)]
            whole = (pieces[0] if dim is None
                     else np.concatenate(pieces, axis=dim))
            assert np.max(np.abs(whole - theta[key])) <= 1e-6, key


# --------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------- #
def test_meta_trace_counts_the_collectives_of_the_gloo_step(gloo4):
    """The (2, 2) train step traced on the meta device issues the
    collectives the gloo ranks' step issued, with the same bytes."""
    d = gloo4[0]
    real = _load(d, "train_r0.npz")
    st = dryrun.trace_step(_cfg("gemma2_2b"), "train", TRAIN["batch"] // 2,
                           TRAIN["seq"], 2, scale=False,
                           mesh=MeshShape(("data", "model"), (2, 2)),
                           rules=dict(BASE_RULES))
    ops = {k[2:] for k in real if k.startswith("c|")}
    assert ops == set(st.coll_counts) == {"all-reduce", "reduce-scatter",
                                          "all-gather"}
    for op in ops:
        count, operand, wire = real[f"c|{op}"]
        assert st.coll_counts[op] == count, op
        assert st.coll_operand_bytes[op] == operand, op
        assert st.coll_wire_bytes[op] == pytest.approx(wire, rel=1e-12)


def test_dry_run_counts_the_zero_exchange():
    """On a data-only mesh the step's collectives are ZeRO's: one
    reduce-scatter of the padded flat gradient and one all-gather of θ,
    plus the scalar all-reduces of the loss and the gradient norm."""
    cfg = _cfg("gemma2_2b")
    st = dryrun.trace_step(cfg, "train", 2, 8, 1, scale=False,
                           mesh=MeshShape(("data", "model"), (4, 1)))
    n = sum(p.numel() for p in tf.abstract_params(cfg).parameters())
    padded = -(-n // 4) * 4 * 4
    assert st.coll_counts == {"reduce-scatter": 1, "all-gather": 1,
                              "all-reduce": 2}
    assert st.coll_operand_bytes["reduce-scatter"] == padded
    assert st.coll_operand_bytes["all-gather"] == padded // 4
    assert st.coll_operand_bytes["all-reduce"] == 8  # two float32 scalars


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("M,kv", [(2, 2), (4, 4)])
def test_rank_flops_times_model_size_equal_one_rank(kind, M, kv):
    cfg = _cfg("gemma2_2b")
    cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    one = dryrun.trace_step(cfg, kind, 2, 16, scale=False)
    rank = dryrun.trace_step(cfg, kind, 2, 16, scale=False,
                             mesh=MeshShape(("data", "model"), (1, M)))
    assert rank.dot_flops * M == one.dot_flops > 0
    assert rank.coll_counts["all-reduce"] > 0


def _synthetic_hlo(op, operand, result, g):
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    extra = {"all-reduce": ", to_apply=%add",
             "reduce-scatter": ", dimensions={0}, to_apply=%add",
             "all-gather": ", dimensions={0}",
             "all-to-all": ", dimensions={0}"}[op]
    return (f"HloModule m\n\nENTRY %main (p: f32[{operand // 4}]) -> "
            f"f32[{result // 4}] {{\n"
            f"  %p = f32[{operand // 4}] parameter(0)\n"
            f"  ROOT %c = f32[{result // 4}] {op}(%p), "
            f"replica_groups={groups}{extra}\n}}\n")


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all"])
@pytest.mark.parametrize("g", [2, 16])
def test_wire_bytes_are_the_reference_ring_model(op, g):
    from repro.launch import hloparse

    operand = 4096 * g
    result = {"all-gather": operand * g, "reduce-scatter": operand // g}.get(
        op, operand)
    st = hloparse.analyze(_synthetic_hlo(op, operand, result, g), world=512)
    assert st.coll_counts == {op: 1}
    assert st.coll_operand_bytes[op] == operand
    assert coll.wire_bytes(op, operand, result, g) == \
        st.coll_wire_bytes[op]


def _reference_byte_helpers():
    """The reference dry run's ``_local_bytes_of_spec_tree`` and
    ``_local_cache_bytes``, compiled from its source alone."""
    import jax

    import repro.launch
    from repro.distributed.sharding import resolve_axes
    from repro.launch import inputs as j_inp
    from repro.models.transformer import model_spec

    path = pathlib.Path(repro.launch.__file__).with_name("dryrun.py")
    tree = ast.parse(path.read_text())
    names = ("_local_bytes_of_spec_tree", "_local_cache_bytes")
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in names]
    ns = {"jax": jax, "np": np, "inp": j_inp, "resolve_axes": resolve_axes,
          "model_spec": model_spec}
    exec(compile(ast.Module(fns, []), str(path), "exec"), ns)
    return [ns[n] for n in names]


def _reference_cells():
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro.configs import get_config as j_get_config
    from repro.launch import inputs as j_inp

    for arch in J_ARCH_IDS:
        for name, shape in j_inp.SHAPES.items():
            if j_inp.cell_is_runnable(j_get_config(arch), shape)[0]:
                yield arch, name


@pytest.mark.parametrize("arch", sorted(CFGS) + ["jamba_1p5_large_398b",
                                                 "qwen2_vl_72b", "gemma_2b",
                                                 "gemma3_4b", "minitron_8b",
                                                 "olmoe_1b_7b", "xlstm_125m"])
def test_rule_bytes_equal_the_reference_count(arch):
    from repro.configs import get_config as j_get_config
    from repro.launch import inputs as j_inp

    params_of, caches_of = _reference_byte_helpers()
    cells = [name for a, name in _reference_cells() if a == arch]
    assert cells
    for name in cells:
        jshape = j_inp.SHAPES[name]
        jcfg = j_inp.adjusted_config(j_get_config(arch), jshape)
        jrules = j_inp.rules_for(jcfg, jshape)
        tshape = inputs.SHAPES[name]
        tcfg = inputs.adjusted_config(get_config(arch), tshape)
        for mesh in (dryrun.MESHES["16x16"], dryrun.MESHES["2x16x16"]):
            class Stand:  # the reference reads only .shape
                shape = dict(mesh.shape)

            trules = inputs.rules_for(tcfg, tshape)
            got = dryrun.rule_bytes(tcfg, tshape.batch, tshape.seq, trules,
                                    mesh)
            assert got["params"] == params_of(jcfg, jrules, Stand()), name
            assert got["caches"] == caches_of(jcfg, jshape, jrules,
                                              Stand()), name
            if tshape.kind != "train":  # the port's own caches on the rank
                mine = dryrun.resident_bytes(tcfg, tshape.kind, tshape.batch,
                                             tshape.seq, trules, mesh)
                assert mine["caches"] == got["caches"], name


def test_multi_pod_cells_report_both_counts_and_collectives():
    rec = dryrun.run_cell("gemma2_2b", "train_4k", multi_pod=True,
                          verbose=False)
    assert rec["mesh"] == "2x16x16" and rec["tp"] == 16 and rec["dp"] == 32
    assert set(rec["rule_bytes"]) == {"params", "caches"}
    assert set(rec["resident_bytes"]) == {"params", "grads", "adamw",
                                          "total"}
    assert {"all-reduce", "reduce-scatter", "all-gather"} <= \
        set(rec["collectives"])
    assert rec["collective_s"] > 0
    # the 8 heads do not split over 16 ranks; the FFN and vocabulary do
    full = sum(p.numel() for p in tf.abstract_params(
        get_config("gemma2_2b")).parameters())
    assert rec["resident_bytes"]["params"] < 4 * full


def test_moe_a2a_variant_traces_the_all_to_all():
    rec = dryrun.run_cell("olmoe_1b_7b", "decode_32k", "moe_a2a",
                          verbose=False, mesh="16x16")
    assert rec["status"] == "OK" and not rec["variant_note"]
    # decode stays dropless (moe_ffn on the rank's experts)
    assert "all-to-all" not in rec["collectives"]
    st = dryrun.trace_step(
        dataclasses.replace(_cfg("qwen2_moe_a2p7b"), moe=dataclasses.replace(
            _cfg("qwen2_moe_a2p7b").moe, a2a=True)), "prefill", 2, 8,
        scale=False, mesh=MeshShape(("data", "model"), (1, 2)))
    assert st.coll_counts["all-to-all"] > 0


def test_restore_fills_a_ranks_slices(tmp_path):
    """A checkpoint of whole leaves restored under the tensor-parallel
    placements holds the rank's slices, as ``shard_params`` cuts them."""
    from repro_torch.training import checkpoint as ckpt

    cfg = _cfg("gemma2_2b")
    whole = tf.init_params(cfg, torch.Generator().manual_seed(2),
                           dtype=torch.float32, device="cpu")
    flat = tf.make_trainable(whole)
    ckpt.save(str(tmp_path), 1, flat.tree())
    template = tf.model_spec(cfg)
    template = {k: torch.empty(s.shape, device="meta")
                for k, s in _flat(template).items()}
    for r in range(4):
        rank = sharding.traced_rank(MeshShape(("data", "model"), (1, 4)), r)
        tree, _, _ = ckpt.restore(
            str(tmp_path), _nest(template),
            shardings=steps.tp_shardings(cfg, rank, BASE_RULES))
        want = tf.make_trainable(tf.shard_params(whole, rank)).tree()
        for k, v in _flat(want).items():
            assert torch.equal(_flat(tree)[k], v), k
