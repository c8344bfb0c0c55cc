"""The port's encoder-decoder family (Whisper) against the JAX package, on
the CPU.

Reduced whisper-large-v3 (``reduced(n_layers=3)``: 2 encoder and 3
decoder layers, d 64, 4 heads of 16, GELU, sinusoidal positions).
Parameters are drawn by the reference's ``init_params`` (float32) and
carried over with ``repro_torch.convert.lm_params_from_arrays``; frame
embeddings, prompts and layer inputs are seeded numpy, so both packages
compute on identical data.  The layer tests also run with ``qk_norm`` on
(nonzero norm scales), which Whisper does not set, so that the k-norm the
prefill's cross-attention applies and the cached cross K/V do not is
held too.

Tolerances: relative error is ``max|port - ref| / max|ref|``, held to
1e-5 in float32 (the math in another library and order, ~1e-7 per op)
for layer outputs and the first decoder layer's self-attention cache.
What the encoder's output feeds (the encoder output itself, the cross
K/V, the later layers' caches, the logits of the prefill, of decode and
of ``forward_train``) gets 1e-4:
the reduced model amplifies float32 rounding, in the reference as much
as in the port.  Measured against the same weights in float64 (attention
too): the reference's float32 encoder output is 1.9e-5 away, the port's
7.2e-6; the reference's ``forward_train`` logits up to 2.6e-5, the
port's up to 2.7e-5 (the frames and prompts of ``test_encode`` and the
training test).  The loss gets 1e-4, as ``tests/test_torch_training.py``
holds the decoders; every gradient leaf 5e-4: against the float64
gradient (``jax_enable_x64``) on the training test's batch, the
reference's own float32 gradient is up to 1.66e-4 away per leaf, the
port's up to 1.30e-4, so the two differ by up to 2.6e-4.  Greedy tokens must
be identical, the sinusoidal table equal byte for byte, and the flat
parameter vector equal to ``ravel_pytree``'s bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.common import materialize as j_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    CrossCache,
    decode_step,
    forward_train,
    init_caches,
    lm_loss,
    make_trainable,
    model_spec,
    prefill,
)

ARCH = "whisper_large_v3"
RTOL, ENC_TOL, LOSS_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4, 5e-4
KW = dict(n_layers=3)
B, SE, S = 2, 12, 10  # batch, encoder frames, decoder prompt


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cfgs(**extra):
    return (j_get_config(ARCH).reduced(**KW, **extra),
            get_config(ARCH).reduced(**KW, **extra))


def _x(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


def _batch(cfg, seed=0, Se=SE, S=S):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            "audio_embeds": _x(r, B, Se, cfg.d_model)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params)."""
    jcfg, tcfg = _cfgs()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _attn_params(cfg, qk_norm, seed):
    """One attention block's weights from the reference's ``materialize``
    (norm scales drawn nonzero so that the norms act)."""
    spec = j_attn.cross_attn_spec(cfg)
    if qk_norm:
        spec = jax.tree.map(lambda s: dataclasses.replace(s, init="normal"),
                            spec, is_leaf=lambda s: hasattr(s, "init"))
    jp = j_materialize(spec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)


class TestLayers:
    @pytest.mark.parametrize("S_,d,offset", [(1500, 1280, 0), (7, 64, 0),
                                             (5, 10, 448)])
    def test_sinusoidal_positions_bytes(self, S_, d, offset):
        got = layers.sinusoidal_positions(S_, d, offset)
        want = j_layers.sinusoidal_positions(S_, d, offset)
        assert got.dtype == want.dtype == np.float64
        assert got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("qk_norm", [False, True])
    def test_cross_attention(self, qk_norm):
        """``attention(..., kv=(ctx, ctx))``: q from x, k/v from the
        context, QK-norm on both, no RoPE, every key visible."""
        jcfg, tcfg = _cfgs(qk_norm=qk_norm)
        jp, tp = _attn_params(jcfg, qk_norm, 1)
        r = np.random.default_rng(2)
        x, ctx = _x(r, B, S, jcfg.d_model), _x(r, B, SE, jcfg.d_model)
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        want = j_attn.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                causal=False,
                                kv=(jnp.asarray(ctx), jnp.asarray(ctx)))
        got = attn_mod.attention(tcfg, tp, torch.as_tensor(x),
                                 torch.as_tensor(pos), causal=False,
                                 kv=(torch.as_tensor(ctx),) * 2)
        assert got.shape == (B, S, tcfg.d_model)
        assert _rel(_np(got), want) <= RTOL

    @pytest.mark.parametrize("qk_norm", [False, True])
    def test_precompute_cross_kv(self, qk_norm):
        jcfg, tcfg = _cfgs(qk_norm=qk_norm)
        jp, tp = _attn_params(jcfg, qk_norm, 3)
        enc = _x(np.random.default_rng(4), B, SE, jcfg.d_model)
        jk, jv = j_attn.precompute_cross_kv(jcfg, jp, jnp.asarray(enc))
        tk, tv = attn_mod.precompute_cross_kv(tcfg, tp, torch.as_tensor(enc))
        assert _rel(_np(tk), jk) <= RTOL and _rel(_np(tv), jv) <= RTOL

    @pytest.mark.parametrize("qk_norm", [False, True])
    def test_decode_cross_attention(self, qk_norm):
        jcfg, tcfg = _cfgs(qk_norm=qk_norm)
        jp, tp = _attn_params(jcfg, qk_norm, 5)
        r = np.random.default_rng(6)
        x = _x(r, B, 1, jcfg.d_model)
        k, v = (_x(r, B, SE, jcfg.n_kv_heads, jcfg.hd) for _ in range(2))
        want = j_attn.decode_cross_attention(jcfg, jp, jnp.asarray(x),
                                             jnp.asarray(k), jnp.asarray(v))
        got = attn_mod.decode_cross_attention(tcfg, tp, torch.as_tensor(x),
                                              torch.as_tensor(k),
                                              torch.as_tensor(v))
        assert _rel(_np(got), want) <= RTOL

    def test_encode(self, model):
        jcfg, jparams, tcfg, tparams = model
        batch = _batch(tcfg, seed=7)
        want, _ = jax.jit(lambda p, b: j_tf._encode(jcfg, p, b))(
            jparams, _j(batch))
        with torch.no_grad():
            got = tf._encode(tcfg, tparams, _t(batch))
        assert got.shape == (B, SE, tcfg.d_model)
        assert _rel(_np(got), want) <= ENC_TOL


class TestServingPath:
    def _j_prefill(self, jcfg, jparams, batch, max_len):
        fn = jax.jit(lambda p, b: j_prefill(jcfg, p, b, max_len=max_len))
        return fn(jparams, _j(batch))

    def test_init_caches(self, model):
        _, _, tcfg, _ = model
        caches = init_caches(tcfg, B, 24, torch.float32, device="cpu")
        assert len(caches) == tcfg.n_layers
        for c in caches:
            assert isinstance(c, CrossCache)
            assert c.kv.k.shape == (B, 24, tcfg.n_kv_heads, tcfg.hd)
            # the reference's placeholder length; the prefill writes Se
            assert c.cross.k.shape == c.cross.v.shape == (
                B, 1, tcfg.n_kv_heads, tcfg.hd)

    def test_prefill_logits_and_caches(self, model):
        """Logits, each layer's self-attention cache and its cross K/V
        against the reference's ``caches["cross"]``."""
        jcfg, jparams, tcfg, tparams = model
        batch = _batch(tcfg, seed=8)
        jl, jc = self._j_prefill(jcfg, jparams, batch, S + 6)
        tl, tc = prefill(tcfg, tparams, _t(batch), max_len=S + 6)
        assert tl.shape == (B, 1, tcfg.vocab_size)
        assert _rel(_np(tl), jl) <= ENC_TOL
        assert len(tc) == tcfg.n_layers == jcfg.n_periods
        for p, c in enumerate(tc):
            assert isinstance(c, CrossCache)
            tol = RTOL if p == 0 else ENC_TOL  # layer 0 precedes cross
            assert _rel(_np(c.kv.k), jc["stack"]["0"].k[p]) <= tol
            assert _rel(_np(c.kv.v), jc["stack"]["0"].v[p]) <= tol
            cross = jc["cross"]["stack"]["0"]
            assert c.cross.k.shape == (B, SE, tcfg.n_kv_heads, tcfg.hd)
            assert _rel(_np(c.cross.k), cross["k"][p]) <= ENC_TOL
            assert _rel(_np(c.cross.v), cross["v"][p]) <= ENC_TOL

    def test_decode_steps(self, model):
        """6 greedy decode steps against the reference's ``decode_step``
        (the one-position sinusoidal embedding in float32, the cross K/V
        from the prefill)."""
        jcfg, jparams, tcfg, tparams = model
        batch, steps = _batch(tcfg, seed=9), 6
        jl, jc = self._j_prefill(jcfg, jparams, batch, S + steps)
        tl, tc = prefill(tcfg, tparams, _t(batch), max_len=S + steps)
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t, pos))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        for t in range(steps):
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S + t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc, tt, S + t)
            assert _rel(_np(tl), jl) <= ENC_TOL, f"step {t}"
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
            tt = tl[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))

    def test_prefill_launch_roles(self, model, monkeypatch):
        """Every prefill attention goes through the kernel wrapper: one
        non-causal launch per encoder layer, then per decoder layer a
        causal self-attention launch and a non-causal cross launch whose
        keys are the encoder's frames; decode launches none."""
        _, _, tcfg, tparams = model
        calls = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            calls.append((q.shape[1], k.shape[1], kw["causal"]))
            return real(q, k, v, **kw)

        monkeypatch.setattr(ops, "flash_attention", spy)
        batch = _t(_batch(tcfg, seed=10))
        _, caches = prefill(tcfg, tparams, batch, max_len=S + 2)
        enc = [(SE, SE, False)] * tcfg.n_enc_layers
        dec = [(S, S, True), (S, SE, False)] * tcfg.n_layers
        assert calls == enc + dec
        decode_step(tcfg, tparams, caches, batch["tokens"][:, -1:], S)
        assert len(calls) == len(enc + dec)


class TestTraining:
    def test_forward_train_loss_and_every_gradient(self, model):
        """``lm_loss`` and its gradient, encoder leaves included, against
        ``jax.value_and_grad`` of the reference's."""
        jcfg, jparams, tcfg, _ = model
        batch = _batch(tcfg, seed=11, S=12)
        want_logits, _ = j_tf.forward_train(jcfg, jparams, _j(batch))
        (jl, jaux), jg = jax.value_and_grad(
            lambda p: j_tf.lm_loss(jcfg, p, _j(batch)), has_aux=True)(jparams)
        port = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
            trainable=True)
        with torch.no_grad():
            logits, _ = forward_train(tcfg, port, _t(batch))
        assert _rel(_np(logits), want_logits) <= ENC_TOL
        port.flat.grad.zero_()
        loss, aux = lm_loss(tcfg, port, _t(batch))
        loss.backward()
        assert set(aux) == set(jaux)
        assert _rel(loss.item(), float(jl)) <= LOSS_TOL
        got = dict(_leaf_items(port.flat.tree(port.flat.grad)))
        want = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
        assert got.keys() == want.keys()
        assert any(k.startswith("encoder/") for k in want)
        for k in want:
            assert _rel(got[k].numpy(), want[k]) <= GRAD_TOL, k


class TestWeights:
    def test_model_spec_has_the_encoder_and_cross_leaves(self):
        jcfg, tcfg = _cfgs()

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return (tuple(tree.shape), tuple(tree.axes), tree.init)

        spec = model_spec(tcfg)
        assert shapes(spec) == shapes(j_tf.model_spec(jcfg))
        assert set(spec["stack"]["0"]) >= {"norm_x", "cross"}
        assert spec["encoder"]["stack"]["0"]["mixer"]["wq"].shape[0] == (
            tcfg.n_enc_layers)

    def test_flat_order_is_ravel_pytree(self, model):
        jcfg, jparams, tcfg, _ = model
        theta, _ = ravel_pytree(jparams)
        port = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        flat = make_trainable(port)
        assert flat.n == theta.size
        assert np.array_equal(flat.ravel().numpy(), np.asarray(theta))
        heads = [leaf.path[0] for leaf in flat.leaves]
        assert heads.index("encoder") == heads.index("embed") + 1
        assert heads.index("final_norm") > heads.index("encoder")

    def test_converters_round_trip(self, model):
        jcfg, jparams, tcfg, _ = model
        theta, _ = ravel_pytree(jparams)
        port = convert.lm_params_from_theta(tcfg, np.asarray(theta),
                                            device="cpu")
        want = dict(_leaf_items(jax.tree.map(np.asarray, jparams)))
        got = dict(_leaf_items(port.flat.tree()))
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k
        p = 1  # the second encoder layer is the stacked leaf's row 1
        assert np.array_equal(
            port.encoder.layers[p]["mixer"]["wq"].detach().numpy(),
            want["encoder/stack/0/mixer/wq"][p])

    def test_converter_checks_the_encoder(self, model):
        _, jparams, tcfg, _ = model
        tree = jax.tree.map(np.asarray, jparams)
        del tree["encoder"]
        with pytest.raises(ValueError, match="expected keys"):
            convert.lm_params_from_arrays(tcfg, tree, device="cpu")

    def test_init_params_draws_the_encoder(self):
        _, tcfg = _cfgs()
        p = tf.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        assert len(p.encoder.layers) == tcfg.n_enc_layers
        assert all("cross" in layer and "norm_x" in layer
                   for layer in p.layers)
        n = sum(int(np.prod(s.shape)) for _, s in
                tf.leaves(model_spec(tcfg)))
        assert sum(t.numel() for t in p.parameters()) == n


class TestLmServe:
    def test_reduced_cpu_end_to_end(self, capsys):
        res = lm_serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4", "--device",
                             "cpu"])
        assert res.tokens.shape == (2, 4)
        assert bool(torch.isfinite(res.prefill_logits).all())
        assert "decoded 4 tokens x batch 2" in capsys.readouterr().out

    def test_serve_is_prefill_and_decode_with_the_frames(self):
        cfg = lm_serve.make_config(ARCH, reduced=True)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=2)
        prompt = lm_serve.make_prompt(cfg, 2, 6, cpu)
        inputs = lm_serve.audio_inputs(cfg, 2, 20, cpu, torch.float32)
        assert inputs["audio_embeds"].shape == (2, 20, cfg.d_model)
        res = lm_serve.serve(cfg, params, prompt, 4, keep_logits=True,
                             inputs=inputs)
        logits, caches = prefill(cfg, params, {"tokens": prompt, **inputs},
                                 max_len=10)
        assert torch.equal(logits, res.prefill_logits)
        tok = logits[:, -1].argmax(-1)[:, None]
        for t in range(3):
            step, caches = decode_step(cfg, params, caches, tok, 6 + t)
            assert torch.equal(step, res.step_logits[t])
            tok = step[:, 0].argmax(-1)[:, None]

    def test_profile_counts_flash_launches_by_role(self):
        """``lm_profile`` on the CPU: a whole clip's frames are made for
        an encoder-decoder and the prefill's flash calls are counted by
        role (the plain version runs them here; no device times)."""
        from repro_torch.launch import lm_profile
        from repro_torch.launch.inputs import WHISPER_FRAMES

        out = lm_profile.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu", "--batch", "2", "--prompt-len", "8",
                               "--gen", "3"])
        cfg = lm_serve.make_config(ARCH, reduced=True)
        roles = out["flash_roles"]
        assert {r: v["launches"] for r, v in roles.items()} == {
            "encoder": cfg.n_enc_layers, "self": cfg.n_layers,
            "cross": cfg.n_layers}
        assert all(v["dtypes"] == ["float32"] for v in roles.values())
        assert out["frames"] == WHISPER_FRAMES == 1500
        assert out["decode_steps"] == 2
