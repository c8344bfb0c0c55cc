"""The port's vision-language family (Qwen2-VL) against the JAX package, on
the CPU.

Reduced qwen2-vl-72b (``reduced(n_layers=3)``: d 64, 4 heads of 16 over 2
KV heads, SwiGLU, untied embeddings, M-RoPE sections (2, 3, 3)).
Parameters are drawn by the reference's ``init_params`` (float32) and
carried over with ``repro_torch.convert.lm_params_from_arrays``; prompts,
vision embeddings and position ids are seeded numpy, so both packages
compute on identical data.  The three M-RoPE streams (t, h, w) always
differ from each other (with t = h = w M-RoPE is plain RoPE and tests
nothing), and the decode's M-RoPE ids differ from the cache index, as
after a vision block.

Tolerances: relative error is ``max|port - ref| / max|ref|``, held to
1e-5 in float32 (the math in another library and order, ~1e-7 per op)
for M-RoPE, layer outputs, logits and every KV cache; 1e-4 for the loss
and every gradient leaf, as ``tests/test_torch_training.py`` holds the
decoders.  Greedy tokens must be identical and the flat parameter vector
equal to ``ravel_pytree``'s bit for bit.
"""

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
from repro_torch.launch.inputs import STUB_DIV  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    forward_train,
    lm_loss,
    make_trainable,
    prefill,
)

ARCH = "qwen2_vl_72b"
RTOL, GRAD_TOL = 1e-5, 1e-4
KW = dict(n_layers=3)
B, S, NV = 2, 16, 4  # batch, prompt, vision positions (S // STUB_DIV)


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


def _streams(r, *shape):
    """(..., 3, S) position ids whose t, h and w rows all differ."""
    pos = r.integers(0, 4096, shape).astype(np.int32)
    assert (pos[..., 0, :] != pos[..., 1, :]).any()
    assert (pos[..., 1, :] != pos[..., 2, :]).any()
    return pos


def _vision_batch(cfg, steps, seed=0):
    """A prompt whose first NV positions are seeded vision embeddings on
    a 1 x 2 x 2 patch grid, its M-RoPE ids (text at t = h = w from 2) and
    the decode steps' ids, as ``lm_serve.vision_inputs`` lays them out."""
    r = np.random.default_rng(seed)
    inputs, dec = lm_serve.vision_inputs(cfg, B, S, steps + 1,
                                         torch.device("cpu"), torch.float32)
    batch = {"tokens": r.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
             "vision_embeds": _x(r, B, NV, cfg.d_model),
             "positions": inputs["positions"].numpy()}
    return batch, dec.numpy()


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


def _attn_params(cfg, seed):
    jp = j_materialize(j_attn.attn_spec(cfg), jax.random.PRNGKey(seed),
                       dtype=jnp.float32)
    return jp, jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)


class TestLayers:
    @pytest.mark.parametrize("hd,sections,theta", [
        (16, (2, 3, 3), 1e6),      # the reduced config's
        (128, (16, 24, 24), 1e6),  # the published config's
        (32, (4, 6, 6), 1e4),
    ])
    def test_apply_mrope(self, hd, sections, theta):
        r = np.random.default_rng(hd)
        x = _x(r, 2, 9, 3, hd)
        pos = _streams(r, 2, 3, 9)
        got = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos),
                                 theta, sections)
        want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                                    sections)
        assert _rel(_np(got), want) <= RTOL
        # distinct streams rotate otherwise than RoPE by any one of them
        for i in range(3):
            rope = layers.apply_rope(torch.as_tensor(x),
                                     torch.as_tensor(pos[:, i]), theta)
            assert _rel(_np(rope), want) > 1e-2

    def test_equal_streams_are_rope(self):
        r = np.random.default_rng(1)
        x = _x(r, 2, 5, 2, 16)
        p = r.integers(0, 100, (2, 5)).astype(np.int32)
        got = layers.apply_mrope(torch.as_tensor(x),
                                 torch.as_tensor(np.stack([p] * 3, 1)), 1e6,
                                 (2, 3, 3))
        rope = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(p), 1e6)
        assert _rel(_np(got), _np(rope)) <= 1e-6

    def test_attention_with_mrope(self):
        """Prefill attention (through the kernel wrapper) with (B, 3, S)
        positions against the reference's ``attention``."""
        jcfg, tcfg = _cfgs()
        jp, tp = _attn_params(jcfg, 2)
        r = np.random.default_rng(3)
        x, pos = _x(r, B, S, jcfg.d_model), _streams(r, B, 3, S)
        want = j_attn.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
        got = attn_mod.attention(tcfg, tp, torch.as_tensor(x),
                                 torch.as_tensor(pos))
        assert _rel(_np(got), want) <= RTOL
        plain = attn_mod.attention(tcfg, tp, torch.as_tensor(x),
                                   torch.as_tensor(pos[:, 0]))
        assert _rel(_np(plain), want) > 1e-3

    def test_decode_attention_with_mrope(self):
        """One decode step whose M-RoPE ids (B, 3, 1) differ from the cache
        index, against the reference's ``decode_attention``."""
        jcfg, tcfg = _cfgs()
        jp, tp = _attn_params(jcfg, 4)
        r = np.random.default_rng(5)
        T, pos = 12, 7
        k, v = (_x(r, B, T, jcfg.n_kv_heads, jcfg.hd) for _ in range(2))
        x, mp = _x(r, B, 1, jcfg.d_model), _streams(r, B, 3, 1)
        want, wc = j_attn.decode_attention(
            jcfg, jp, jnp.asarray(x), j_attn.KVCache(jnp.asarray(k),
                                                     jnp.asarray(v)),
            jnp.asarray(pos, jnp.int32), positions=jnp.asarray(mp))
        cache = attn_mod.KVCache(torch.as_tensor(k.copy()),
                                 torch.as_tensor(v.copy()))
        got, gc = attn_mod.decode_attention(tcfg, tp, torch.as_tensor(x),
                                            cache, pos,
                                            positions=torch.as_tensor(mp))
        assert _rel(_np(got), want) <= RTOL
        assert _rel(_np(gc.k), wc.k) <= RTOL
        assert _rel(_np(gc.v), wc.v) <= RTOL

    def test_input_embed_merges_the_vision_block(self, model):
        jcfg, jparams, tcfg, tparams = model
        batch, _ = _vision_batch(tcfg, 1, seed=6)
        jx, jpos = j_tf._input_embed(jcfg, jparams, _j(batch))
        with torch.no_grad():
            x, pos = tf._input_embed(tcfg, tparams, _t(batch))
        np.testing.assert_array_equal(_np(x), np.asarray(jx))
        np.testing.assert_array_equal(_np(pos), np.asarray(jpos))
        np.testing.assert_array_equal(_np(x[:, :NV]), batch["vision_embeds"])


class TestServingPath:
    def _j_prefill(self, jcfg, jparams, batch, max_len):
        fn = jax.jit(lambda p, b: j_prefill(jcfg, p, b, max_len=max_len))
        return fn(jparams, _j(batch))

    def test_prefill_logits_and_caches(self, model):
        """Vision block and M-RoPE ids: logits and every layer's cache (keys
        after M-RoPE)."""
        jcfg, jparams, tcfg, tparams = model
        batch, _ = _vision_batch(tcfg, 1, seed=7)
        jl, jc = self._j_prefill(jcfg, jparams, batch, S + 6)
        tl, tc = prefill(tcfg, tparams, _t(batch), max_len=S + 6)
        assert _rel(_np(tl), jl) <= RTOL
        assert len(tc) == tcfg.n_layers == jcfg.n_periods
        for p, c in enumerate(tc):
            assert _rel(_np(c.k), jc["stack"]["0"].k[p]) <= RTOL
            assert _rel(_np(c.v), jc["stack"]["0"].v[p]) <= RTOL

    def test_decode_steps(self, model):
        """6 greedy decode steps, each with M-RoPE ids continuing the
        text's (apart from the cache index), against the reference's
        ``decode_step``."""
        jcfg, jparams, tcfg, tparams = model
        steps = 6
        batch, dec = _vision_batch(tcfg, steps, seed=8)
        assert dec.shape == (B, 3, steps)
        assert int(dec[0, 0, 0]) != S  # the ids are not the cache index
        jl, jc = self._j_prefill(jcfg, jparams, batch, S + steps)
        tl, tc = prefill(tcfg, tparams, _t(batch), max_len=S + steps)
        jstep = jax.jit(lambda p, c, t, pos, mp: j_decode_step(
            jcfg, p, c, t, pos, mrope_positions=mp))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        for t in range(steps):
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            mp = dec[:, :, t:t + 1]
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S + t, jnp.int32),
                           jnp.asarray(mp))
            tl, tc = decode_step(tcfg, tparams, tc, tt, S + t,
                                 torch.as_tensor(mp))
            assert _rel(_np(tl), jl) <= RTOL, f"step {t}"
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
            tt = tl[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))
        for p, c in enumerate(tc):
            assert _rel(_np(c.k), jc["stack"]["0"].k[p]) <= RTOL

    def test_prefill_goes_through_the_kernel_wrapper(self, model,
                                                     monkeypatch):
        _, _, tcfg, tparams = model
        calls = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            calls.append(kw["causal"])
            return real(q, k, v, **kw)

        monkeypatch.setattr(ops, "flash_attention", spy)
        batch, _ = _vision_batch(tcfg, 1, seed=9)
        prefill(tcfg, tparams, _t(batch), max_len=S + 1)
        assert calls == [True] * tcfg.n_layers


class TestTraining:
    def test_forward_train_loss_and_every_gradient(self, model):
        jcfg, jparams, tcfg, _ = model
        batch, _ = _vision_batch(tcfg, 1, seed=10)
        want_logits, _ = j_tf.forward_train(jcfg, jparams, _j(batch))
        (jl, jaux), jg = jax.value_and_grad(
            lambda p: j_tf.lm_loss(jcfg, p, _j(batch)), has_aux=True)(jparams)
        port = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
            trainable=True)
        with torch.no_grad():
            logits, _ = forward_train(tcfg, port, _t(batch))
        assert _rel(_np(logits), want_logits) <= RTOL
        port.flat.grad.zero_()
        loss, aux = lm_loss(tcfg, port, _t(batch))
        loss.backward()
        assert set(aux) == set(jaux)
        assert _rel(loss.item(), float(jl)) <= GRAD_TOL
        got = dict(_leaf_items(port.flat.tree(port.flat.grad)))
        want = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
        assert got.keys() == want.keys()
        for k in want:
            assert _rel(got[k].numpy(), want[k]) <= GRAD_TOL, k


class TestWeights:
    def test_flat_order_is_ravel_pytree(self, model):
        _, jparams, tcfg, _ = model
        theta, _ = ravel_pytree(jparams)
        flat = make_trainable(convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
        assert flat.n == theta.size
        assert np.array_equal(flat.ravel().numpy(), np.asarray(theta))

    def test_converters_round_trip(self, model):
        _, jparams, tcfg, _ = model
        theta, _ = ravel_pytree(jparams)
        port = convert.lm_params_from_theta(tcfg, np.asarray(theta),
                                            device="cpu")
        want = dict(_leaf_items(jax.tree.map(np.asarray, jparams)))
        got = dict(_leaf_items(port.flat.tree()))
        assert got.keys() == want.keys()
        assert "embed/unembed" in got  # untied
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k


class TestInputs:
    def test_vision_grid(self):
        assert lm_serve.vision_grid(2048) == (1, 32, 64)
        assert lm_serve.vision_grid(64) == (1, 8, 8)
        assert lm_serve.vision_grid(NV) == (1, 2, 2)
        with pytest.raises(ValueError):
            lm_serve.vision_grid(20)

    def test_vision_inputs_positions(self):
        """The serve cell's layout: 2048 vision positions of 8192 on a
        1 x 32 x 64 grid, text from 64 at t = h = w, decode after it."""
        cfg = get_config(ARCH).reduced()
        S_, gen = 8192, 5
        inputs, dec = lm_serve.vision_inputs(cfg, 2, S_, gen,
                                             torch.device("cpu"),
                                             torch.float32)
        nv = S_ // STUB_DIV
        assert inputs["vision_embeds"].shape == (2, nv, cfg.d_model)
        pos = inputs["positions"]
        assert pos.shape == (2, 3, S_) and pos.dtype == torch.int32
        i = torch.arange(nv)
        assert torch.equal(pos[0, 0, :nv], torch.zeros(nv, dtype=torch.int32))
        assert torch.equal(pos[0, 1, :nv], (i // 64).int())
        assert torch.equal(pos[0, 2, :nv], (i % 64).int())
        text = torch.arange(64, 64 + S_ - nv, dtype=torch.int32)
        for row in range(3):
            assert torch.equal(pos[1, row, nv:], text)
        want = torch.arange(64 + S_ - nv, 64 + S_ - nv + gen - 1,
                            dtype=torch.int32)
        assert dec.shape == (2, 3, gen - 1)
        assert torch.equal(dec[0, 2], want)

    def test_serve_is_prefill_and_decode_with_the_ids(self):
        cfg = lm_serve.make_config(ARCH, reduced=True)
        cpu = torch.device("cpu")
        params = lm_serve.make_params(cfg, cpu, seed=2)
        prompt = lm_serve.make_prompt(cfg, 2, 16, cpu)
        inputs, dec = lm_serve.vision_inputs(cfg, 2, 16, 4, cpu,
                                             torch.float32)
        res = lm_serve.serve(cfg, params, prompt, 4, keep_logits=True,
                             inputs=inputs, decode_positions=dec)
        logits, caches = prefill(cfg, params, {"tokens": prompt, **inputs},
                                 max_len=20)
        assert torch.equal(logits, res.prefill_logits)
        tok = logits[:, -1].argmax(-1)[:, None]
        for t in range(3):
            step, caches = decode_step(cfg, params, caches, tok, 16 + t,
                                       dec[:, :, t:t + 1])
            assert torch.equal(step, res.step_logits[t])
            tok = step[:, 0].argmax(-1)[:, None]

    def test_reduced_cpu_end_to_end(self, capsys):
        res = lm_serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "8", "--gen", "4", "--device",
                             "cpu"])
        assert res.tokens.shape == (2, 4)
        assert "decoded 4 tokens x batch 2" in capsys.readouterr().out

    def test_profile_cuts_the_depth_and_makes_the_vision_block(self):
        from repro_torch.launch import lm_profile

        out = lm_profile.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu", "--layers", "2", "--prompt-len",
                               "16", "--gen", "3"])
        assert out["n_layers"] == 2 and out["frames"] is None
        assert out["flash_roles"]["self"]["launches"] == 2
