"""The port's LM training stack against the JAX package, on the CPU.

Reduced dense configs (gemma2_2b and gemma_2b ``reduced()``, gemma3_4b
with ``n_layers=10`` for a remainder of unstacked layers).  Reference
weights are drawn by ``repro``'s ``init_params`` and carried over with
``repro_torch.convert``; the reference functions run on the CPU.

Tolerances (relative error is ``max|port - ref| / max|ref|``, float32
math in another library and order): logits 1e-5, losses and every
gradient leaf 1e-4, parameters after AdamW 1e-5 (1e-4 with bfloat16
moments) and the moments 1e-4 (bfloat16: 2^-7).  θ order, data tokens, compression round trips and the
port's own crash/resume are held bit for bit.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models.transformer import forward_train as j_forward_train  # noqa: E402
from repro.models.transformer import init_params as j_init_params  # noqa: E402
from repro.models.transformer import lm_loss as j_lm_loss  # noqa: E402
from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro.training import optimizer as j_opt  # noqa: E402
from repro.training.compression import Compressor as JCompressor  # noqa: E402
from repro.training.data import DataConfig as JDataConfig  # noqa: E402
from repro.training.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.training.train_loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train_loop import train as j_train  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import forward_train, lm_loss, make_trainable  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.compression import Compressor  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    SimulatedCrash,
    TrainConfig,
    state_tree,
    train,
)

#: per-arch reduced overrides (gemma3_4b keeps an unstacked remainder)
REDUCED = {"gemma2_2b": {}, "gemma_2b": {}, "gemma3_4b": dict(n_layers=10)}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _cfgs(arch, **extra):
    kw = dict(REDUCED[arch], **extra)
    return j_get_config(arch).reduced(**kw), get_config(arch).reduced(**kw)


def _ref_params(jcfg, seed=0):
    return j_init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


def _port(tcfg, jparams, trainable=True):
    return convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
        trainable=trainable)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


class TestFlatLayout:
    @pytest.mark.parametrize("arch", sorted(REDUCED))
    def test_ravel_equals_ravel_pytree_bitwise(self, arch):
        jcfg, tcfg = _cfgs(arch)
        jparams = _ref_params(jcfg)
        theta, _ = ravel_pytree(jparams)
        flat = make_trainable(_port(tcfg, jparams, trainable=False))
        assert flat.n == theta.size
        assert np.array_equal(flat.ravel().numpy(), np.asarray(theta))

    @pytest.mark.parametrize("arch", sorted(REDUCED))
    def test_tree_and_unravel_round_trip(self, arch):
        jcfg, tcfg = _cfgs(arch)
        jparams = _ref_params(jcfg, seed=3)
        theta, unravel = ravel_pytree(jparams)
        model = convert.lm_params_from_theta(tcfg, np.asarray(theta, np.float64),
                                             device="cpu")
        ref_leaves = dict(_leaf_items(jax.tree.map(np.asarray, jparams)))
        got = dict(_leaf_items(model.flat.tree()))
        assert got.keys() == ref_leaves.keys()
        for k in got:
            assert np.array_equal(got[k].numpy(), ref_leaves[k]), k
        assert torch.equal(model.flat.ravel_tree(jparams), model.flat.theta)

    def test_parameters_are_views_of_theta(self):
        jcfg, tcfg = _cfgs("gemma_2b", n_layers=2)
        model = _port(tcfg, _ref_params(jcfg))
        flat = model.flat
        ptrs = {p.data_ptr() for p in model.parameters()}
        assert len(ptrs) == len(list(model.parameters()))
        base, end = flat.theta.data_ptr(), flat.theta.data_ptr() + 4 * flat.n
        assert all(base <= q < end for q in ptrs)
        assert all(p.requires_grad for p in model.parameters())
        # the second period's wq is the second half of the stacked leaf
        leaf = next(lf for lf in flat.leaves
                    if lf.path == ("stack", "0", "mixer", "wq"))
        half = (leaf.stop - leaf.start) // 2
        assert model.layers[1]["mixer"]["wq"].data_ptr() == (
            base + 4 * (leaf.start + half))
        assert make_trainable(model) is flat and flat.bound()

    def test_a_copy_of_a_trainable_model_is_rebound(self):
        """A deep copy's parameters own their storage: ``make_trainable``
        binds them to a new flat buffer holding their values, and the copy's
        backward pass fills its own flat gradient."""
        import copy

        jcfg, tcfg = _cfgs("gemma_2b", n_layers=2)
        model = _port(tcfg, _ref_params(jcfg))
        twin = copy.deepcopy(model)
        assert model.flat.bound() and not twin.flat.bound()
        flat = make_trainable(twin)
        assert flat is not model.flat and flat.bound()
        assert torch.equal(flat.theta, model.flat.theta)
        flat.unravel(np.zeros(flat.n, np.float32))
        assert all(not p.detach().any() for p in twin.parameters())
        assert model.flat.theta.abs().max() > 0
        flat.unravel(model.flat.theta)
        loss, _ = lm_loss(tcfg, twin, {"tokens": torch.as_tensor(
            _tokens(tcfg, 2, 8))})
        loss.backward()
        assert flat.grad.abs().max() > 0 and not model.flat.grad.any()


class TestDataAndCompression:
    @pytest.mark.parametrize("seed,worker,step", [(0, 0, 0), (1, 0, 7),
                                                  (7, 3, 10_000_000)])
    def test_synthetic_lm_tokens_bitwise(self, seed, worker, step):
        kw = dict(vocab_size=97, batch=3, seq=17, seed=seed)
        a = JSyntheticLM(JDataConfig(**kw)).batch(step, worker)["tokens"]
        b = SyntheticLM(DataConfig(**kw)).batch(step, worker)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)

    @pytest.mark.parametrize("kw", [dict(top_k_frac=0.1), dict(int8=True),
                                    dict(top_k_frac=0.05, int8=True),
                                    dict(top_k_frac=0.2,
                                         error_feedback=False)])
    def test_compressor_round_trips_bitwise(self, kw):
        j, t = JCompressor(**kw), Compressor(**kw)
        rng = np.random.default_rng(0)
        for _ in range(4):
            x = rng.standard_normal(1000)
            assert np.array_equal(j.roundtrip(x, "g"), t.roundtrip(x, "g"))
        assert j.compressed_bytes(1000) == t.compressed_bytes(1000)


class TestForwardAndLoss:
    @pytest.mark.parametrize("arch", sorted(REDUCED))
    def test_forward_train_logits(self, arch):
        jcfg, tcfg = _cfgs(arch)
        jparams = _ref_params(jcfg)
        toks = _tokens(tcfg, 2, 24)
        want, _ = j_forward_train(jcfg, jparams, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            got, aux = forward_train(tcfg, _port(tcfg, jparams),
                                     {"tokens": torch.as_tensor(toks)})
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 1e-5

    @pytest.mark.parametrize("arch", sorted(REDUCED))
    def test_lm_loss_and_every_gradient(self, arch):
        jcfg, tcfg = _cfgs(arch)
        jparams = _ref_params(jcfg)
        toks = _tokens(tcfg, 2, 24, seed=1)
        (jl, jaux), jg = jax.value_and_grad(
            lambda p: j_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(jparams)
        model = _port(tcfg, jparams)
        model.flat.grad.zero_()
        loss, aux = lm_loss(tcfg, model, {"tokens": torch.as_tensor(toks)})
        loss.backward()
        assert set(aux) == set(jaux)
        assert _rel(loss.item(), float(jl)) <= 1e-4
        assert _rel(aux["ce_loss"].item(), float(jaux["ce_loss"])) <= 1e-4
        got = dict(_leaf_items(model.flat.tree(model.flat.grad)))
        want = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k].numpy(), want[k]) <= 1e-4, k

    def test_periods_are_recomputed_in_the_backward_pass(self,
                                                           monkeypatch):
        """Remat: under grad each stacked period's sublayers run twice
        (forward and recompute), the unstacked remainder once; without
        grad every layer runs once."""
        from repro_torch.models import transformer as tf

        jcfg, tcfg = _cfgs("gemma3_4b")  # 1 period of 6 layers + 4 more
        model = _port(tcfg, _ref_params(jcfg))
        calls = []
        real = tf.apply_sublayer_full
        monkeypatch.setattr(tf, "apply_sublayer_full",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        toks = {"tokens": torch.as_tensor(_tokens(tcfg, 1, 8))}
        lm_loss(tcfg, model, toks)[0].backward()
        stacked = tcfg.n_periods * len(tcfg.period)
        assert len(calls) == 2 * stacked + len(tcfg.remainder) == 16
        calls.clear()
        with torch.no_grad():
            lm_loss(tcfg, model, toks)
        assert len(calls) == tcfg.n_layers

    def test_attn_chunk_matches_reference_under_grad(self):
        """Query-chunked training attention under grad gives the
        reference's chunked loss and gradient."""
        jcfg, tcfg = _cfgs("gemma_2b")
        jcfg = dataclasses.replace(jcfg, attn_chunk=8)
        tcfg = dataclasses.replace(tcfg, attn_chunk=8)
        jparams = _ref_params(jcfg)
        model = _port(tcfg, jparams)
        toks = _tokens(tcfg, 1, 16)
        (jl, _), jg = jax.value_and_grad(
            lambda p: j_lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)}),
            has_aux=True)(jparams)
        loss, _ = lm_loss(tcfg, model, {"tokens": torch.as_tensor(toks)})
        loss.backward()
        assert _rel(float(loss), float(jl)) <= 1e-4
        assert _rel(model.flat.grad.numpy(),
                    np.asarray(ravel_pytree(jg)[0])) <= 1e-4

    def test_training_attention_is_the_reference_math(self, monkeypatch):
        """Under grad the stack never reaches the flash wrapper; without
        grad (serving) it does."""
        jcfg, tcfg = _cfgs("gemma2_2b")
        model = _port(tcfg, _ref_params(jcfg))
        calls = []
        real = attn_mod.ops.flash_attention
        monkeypatch.setattr(attn_mod.ops, "flash_attention",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        toks = {"tokens": torch.as_tensor(_tokens(tcfg, 1, 16))}
        lm_loss(tcfg, model, toks)[0].backward()
        assert calls == []
        with torch.no_grad():
            lm_loss(tcfg, model, toks)
        assert len(calls) == tcfg.n_layers


def _ref_state_tree(jstate):
    return (int(jstate.step), jax.tree.map(np.asarray, jstate.m),
            jax.tree.map(np.asarray, jstate.v))


class TestAdamW:
    @pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
    def test_lr_schedule(self, step):
        cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
        jcfg = j_opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
        want = float(j_opt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert _rel(opt.lr_schedule(cfg, step), want) <= 1e-6

    @pytest.mark.parametrize("arch,state_dtype,clip", [
        ("gemma_2b", "float32", 1.0),
        ("gemma3_4b", "float32", None),
        ("gemma2_2b", "bfloat16", 0.05),
    ])
    def test_update_matches_reference(self, arch, state_dtype, clip):
        """Three updates on identical trees: stacked norms (ndim 2 in the
        reference) decay, final_norm and the remainder's norms do not."""
        jcfg, tcfg = _cfgs(arch)
        kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
                  state_dtype=state_dtype, weight_decay=0.1)
        jo, to = j_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
        jparams = _ref_params(jcfg)
        model = _port(tcfg, jparams)
        flat = model.flat
        jstate, tstate = j_opt.adamw_init(jparams, jo), opt.adamw_init(flat, to)
        assert tstate.m.dtype == getattr(torch, state_dtype)
        rng = np.random.default_rng(0)
        for _ in range(3):
            g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
                np.float32), jparams)
            jparams, jstate, jm = j_opt.adamw_update(g, jstate, jparams, jo)
            _, tstate, tm = opt.adamw_update(flat.ravel_tree(g), tstate, flat,
                                             to)
            assert _rel(tm["grad_norm"], float(jm["grad_norm"])) <= 1e-5
            assert _rel(tm["lr"], float(jm["lr"])) <= 1e-6
        assert tstate.step == int(jstate.step) == 3
        want_p = dict(_leaf_items(jax.tree.map(np.asarray, jparams)))
        # bfloat16 moments: a last-place difference in float32 may round
        # to the neighbouring bfloat16 (2^-8 relative), which the next
        # step's update carries into θ at lr * 2^-8
        p_tol = 1e-5 if state_dtype == "float32" else 1e-4
        for k, t in _leaf_items(flat.tree()):
            assert _rel(t.numpy(), want_p[k]) <= p_tol, k
        for name in ("m", "v"):
            want = dict(_leaf_items(jax.tree.map(
                lambda a: np.asarray(a, np.float32), getattr(jstate, name))))
            got = flat.tree(getattr(tstate, name).float())
            for k, t in _leaf_items(got):
                tol = 1e-4 if state_dtype == "float32" else 2 ** -7
                assert _rel(t.numpy(), want[k]) <= tol, (name, k)

    @pytest.mark.parametrize("arch,decayed,kept", [
        ("gemma_2b", [("stack", "0", "norm1", "scale")],
         [("final_norm", "scale")]),
        ("gemma3_4b", [("stack", "0", "mixer", "q_norm", "scale")],
         [("rest", "0", "norm1", "scale"),
          ("rest", "1", "mixer", "k_norm", "scale")]),
    ])
    def test_weight_decay_follows_the_reference_leaf_rank(self, arch,
                                                          decayed, kept):
        """With a zero gradient only weight decay moves a parameter."""
        jcfg, tcfg = _cfgs(arch)
        model = _port(tcfg, _ref_params(jcfg))
        flat = model.flat
        flat.unravel(torch.ones(flat.n))
        cfg = opt.AdamWConfig(lr=0.5, warmup_steps=0, grad_clip=None)
        opt.adamw_update(torch.zeros(flat.n), opt.adamw_init(flat, cfg),
                         flat, cfg)
        tree = dict(_leaf_items(flat.tree()))
        for path in decayed:
            assert torch.all(tree["/".join(path)] < 1), path
        for path in kept:
            assert torch.all(tree["/".join(path)] == 1), path


def _j_train_steps(jcfg, jparams, toks_list, accum, state_dtype="float32"):
    jo = j_opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3,
                           state_dtype=state_dtype)
    fn = jax.jit(j_make_train_step(jcfg, jo, accum))
    state = j_opt.adamw_init(jparams, jo)
    losses = []
    for toks in toks_list:
        jparams, state, m = fn(jparams, state, {"tokens": jnp.asarray(toks)})
        losses.append(float(m["loss"]))
    return jparams, state, losses


class TestTrainStep:
    @pytest.mark.parametrize("accum,state_dtype", [(1, "float32"),
                                                   (2, "float32"),
                                                   (2, "bfloat16")])
    def test_steps_match_reference(self, accum, state_dtype):
        jcfg, tcfg = _cfgs("gemma2_2b")
        jparams = _ref_params(jcfg)
        toks = [_tokens(tcfg, 4, 16, seed=s) for s in range(3)]
        jparams, jstate, jl = _j_train_steps(jcfg, jparams, toks, accum,
                                             state_dtype)
        to = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=3,
                             state_dtype=state_dtype)
        model = _port(tcfg, _ref_params(jcfg))
        step = steps.make_train_step(tcfg, to, accum)
        state = opt.adamw_init(model.flat, to)
        tl = []
        for t in toks:
            model, state, m = step(model, state, {"tokens": torch.as_tensor(t)})
            tl.append(m["loss"])
        assert _rel(tl, jl) <= 1e-4
        assert _rel(model.flat.theta.numpy(),
                    np.asarray(ravel_pytree(jparams)[0])) <= 1e-4

    @pytest.mark.parametrize("accum", [1, 2])
    def test_train_loop_matches_reference(self, accum):
        jcfg, tcfg = _cfgs("gemma_2b")
        kw = dict(steps=3, batch=4, seq=16, accum=accum, log_every=1)
        want = j_train(jcfg, JTrainConfig(**kw), log=None)["losses"]
        got = train(tcfg, TrainConfig(**kw), log=None,
                    params=_port(tcfg, _ref_params(jcfg, seed=0),
                                 trainable=False))["losses"]
        assert len(got) == 3 and _rel(got, want) <= 1e-4

    def test_mesh_is_refused(self):
        _, tcfg = _cfgs("gemma_2b")
        with pytest.raises(NotImplementedError, match="1.6"):
            steps.make_train_step(tcfg, opt.AdamWConfig(), 1, mesh=object())

    def test_train_profile_runs_on_the_cpu(self, capsys):
        """``train_profile`` times a step and traces a step and an AdamW
        update (no device times on the CPU)."""
        from repro_torch.launch import train_profile

        out = train_profile.main(["--reduced", "--device", "cpu"])
        assert out["step_s"] > 0 and out["accum"] == train_profile.ACCUM
        assert out["seq"] == train_profile.REDUCED_SEQ
        for key in ("step", "adamw"):
            assert out[key]["wall_ms"] > 0 and out[key]["busy_share"] is None
        text = capsys.readouterr().out
        assert "[step] traced wall" in text and "[adamw] traced wall" in text

    def test_cli_runs_on_the_cpu(self, capsys):
        out = train_cli.main(["--arch", "gemma_2b", "--reduced", "--steps",
                              "2", "--batch", "2", "--seq", "8", "--device",
                              "cpu"])
        assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
        assert "final loss" in capsys.readouterr().out


class TestCheckpoints:
    def test_crash_then_resume_is_bitwise(self, tmp_path):
        _, tcfg = _cfgs("gemma2_2b")
        kw = dict(steps=6, batch=2, seq=16, checkpoint_every=2,
                  log_every=100)
        whole = train(tcfg, TrainConfig(**kw), log=None, device="cpu")
        d = str(tmp_path / "ck")
        with pytest.raises(SimulatedCrash):
            train(tcfg, TrainConfig(checkpoint_dir=d, crash_at_step=3, **kw),
                  log=None, device="cpu")
        assert ckpt.latest_step(d) == 2
        resumed = train(tcfg, TrainConfig(checkpoint_dir=d, **kw), log=None,
                        device="cpu")
        assert resumed["losses"] == whole["losses"][2:]
        assert torch.equal(resumed["params"].flat.theta,
                           whole["params"].flat.theta)
        for a, b in zip(resumed["opt_state"][1:], whole["opt_state"][1:]):
            assert torch.equal(a, b)
        assert ckpt.latest_step(d) == 6

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
    def test_reference_checkpoint_restores_in_the_port(self, tmp_path,
                                                       state_dtype):
        jcfg, tcfg = _cfgs("gemma3_4b")
        jparams = _ref_params(jcfg, seed=2)
        jo = j_opt.AdamWConfig(state_dtype=state_dtype)
        g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         jparams)
        jparams, jstate, _ = j_opt.adamw_update(
            g, j_opt.adamw_init(jparams, jo), jparams, jo)
        j_ckpt.save(str(tmp_path), 1, (jparams, jstate), extra={"a": 1})
        model = _port(tcfg, _ref_params(jcfg, seed=5))
        state = opt.adamw_init(model.flat, opt.AdamWConfig(
            state_dtype=state_dtype))
        (p, o), step, extra = ckpt.restore(str(tmp_path),
                                           state_tree(model, state))
        assert (step, extra, int(o.step)) == (1, {"a": 1}, 1)
        want = np.asarray(ravel_pytree(jparams)[0])
        assert np.array_equal(model.flat.ravel_tree(p).numpy(), want)
        m = model.flat.ravel_tree(o.m, state.m.dtype)
        jm = convert.adamw_state_from_arrays(model, *_ref_state_tree(jstate))
        assert m.dtype == getattr(torch, state_dtype)
        assert torch.equal(m, jm.m)

    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
    def test_port_checkpoint_restores_in_the_reference(self, tmp_path,
                                                       state_dtype):
        jcfg, tcfg = _cfgs("gemma3_4b")
        model = _port(tcfg, _ref_params(jcfg, seed=2))
        to = opt.AdamWConfig(state_dtype=state_dtype)
        state = opt.adamw_init(model.flat, to)
        _, state, _ = opt.adamw_update(torch.full((model.flat.n,), 0.01),
                                       state, model.flat, to)
        ckpt.save(str(tmp_path), 4, state_tree(model, state))
        manifest = json.load(open(os.path.join(
            str(tmp_path), "step_00000004", "manifest.json")))
        assert manifest["dtypes"]["1|step"] == "int32"
        assert manifest["dtypes"]["1|m|final_norm|scale"] == state_dtype
        jparams = _ref_params(jcfg, seed=7)
        jo = j_opt.AdamWConfig(state_dtype=state_dtype)
        (jp, js), step, _ = j_ckpt.restore(
            str(tmp_path), (jparams, j_opt.adamw_init(jparams, jo)))
        assert step == 4 and int(js.step) == 1
        assert np.array_equal(np.asarray(ravel_pytree(jp)[0]),
                              model.flat.theta.numpy())
        for name in ("m", "v"):
            got = np.asarray(ravel_pytree(jax.tree.map(
                lambda a: a.astype(jnp.float32), getattr(js, name)))[0])
            assert np.array_equal(got, getattr(state, name).float().numpy())

    def test_sharded_restore_is_refused(self, tmp_path):
        """Refused: shardings that do not match the template, and leaves
        placed on a mesh shape without ranks.  (Sharded restores onto 2
        and 8 ranks: tests/test_torch_distributed.py.)"""
        from repro_torch.distributed.sharding import MeshShape, Sharding

        ckpt.save(str(tmp_path), 1, {"x": torch.zeros(4)})
        with pytest.raises(ValueError, match="matching the template"):
            ckpt.restore(str(tmp_path), {"x": torch.zeros(4)}, shardings={})
        shard = Sharding(MeshShape(("data",), (2,)), ("data",))
        with pytest.raises(ValueError, match="mesh of ranks"):
            ckpt.restore(str(tmp_path), {"x": torch.zeros(4)},
                         shardings={"x": shard})

    def test_manager_keeps_the_last_k(self, tmp_path):
        mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
        t = torch.zeros(3)
        for s in range(1, 5):
            t += 1
            mgr.save(s, {"x": t})
        mgr.wait()
        assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                                 "step_00000004"]
        (tree, step, _) = mgr.restore_latest({"x": torch.zeros(3)})
        assert step == 4 and torch.equal(tree["x"], torch.full((3,), 4.0))
