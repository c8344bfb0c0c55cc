"""The port's LM serving path against the JAX package, on the CPU.

The four dense decoder configs the port carries run at a reduced size
(``reduced()`` of gemma2_2b, gemma_2b and minitron_8b, and gemma3_4b with
``n_layers=10`` so that its 6-layer period leaves a 4-layer remainder).
Parameters are drawn by the reference's ``init_params`` (float32) and
carried over with ``repro_torch.convert.lm_params_from_arrays``, so both
packages compute on identical weights and prompts.

Tolerances: relative error is ``max|port - ref| / max|ref|`` (float32 math
in another library and order; ~1e-7 per op), held to 1e-5 for logits and
every KV cache.  Greedy tokens must be identical.  On the CPU the port's
prefill attention takes the plain flash-attention version (materialised
float32 scores); the kernel itself is held to that plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.transformer import model_spec as j_model_spec  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, PORTED, ModelConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    init_caches,
    init_params,
    model_spec,
    prefill,
)

RTOL = 1e-5
#: per-arch reduced overrides (gemma3_4b keeps a remainder)
REDUCED = {"gemma2_2b": {}, "gemma_2b": {}, "minitron_8b": {},
           "gemma3_4b": dict(n_layers=10)}


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    for arch, kw in REDUCED.items():
        jcfg = j_get_config(arch).reduced(**kw)
        tcfg = get_config(arch).reduced(**kw)
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32)
        tree = jax.tree.map(np.asarray, jparams)
        out[arch] = (jcfg, jparams, tcfg,
                     convert.lm_params_from_arrays(tcfg, tree, device="cpu"))
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S))


def _j_prefill(jcfg, jparams, toks, max_len):
    fn = jax.jit(lambda p, t: j_prefill(jcfg, p, {"tokens": t},
                                        max_len=max_len))
    return fn(jparams, jnp.asarray(toks))


def _j_caches(jcfg, caches):
    """The reference's stacked caches, one (k, v) per layer in order."""
    out = []
    for p in range(jcfg.n_periods):
        for i in range(len(jcfg.period)):
            c = caches["stack"][str(i)]
            out.append((np.asarray(c.k[p]), np.asarray(c.v[p])))
    for i in range(len(jcfg.remainder)):
        c = caches["rest"][str(i)]
        out.append((np.asarray(c.k), np.asarray(c.v)))
    return out


class TestConfigs:
    @pytest.mark.parametrize("arch", PORTED)
    def test_same_fields_as_reference(self, arch):
        for kw in (None, REDUCED[arch]):
            j = j_get_config(arch)
            t = get_config(arch)
            if kw is not None:
                j, t = j.reduced(**kw), t.reduced(**kw)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.hd, t.n_periods, t.remainder) == (j.hd, j.n_periods,
                                                        j.remainder)

    @pytest.mark.parametrize("arch", PORTED)
    def test_model_spec_matches_reference(self, arch):
        cfg = get_config(arch).reduced(**REDUCED[arch])
        jcfg = j_get_config(arch).reduced(**REDUCED[arch])

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return (tuple(tree.shape), tuple(tree.axes), tree.init)

        assert shapes(model_spec(cfg)) == shapes(j_model_spec(jcfg))

    @pytest.mark.parametrize("arch", sorted(set(ARCH_IDS) - set(PORTED)))
    def test_unported_families_raise_naming_the_item(self, arch):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item 1.7"):
            get_config(arch)

    @pytest.mark.parametrize("change,item", [
        (dict(period=(("mamba", "mlp"),)), "1.7c"),
        (dict(period=(("mlstm", "none"),)), "1.7d"),
        (dict(period=(("attn", "moe"),)), "1.7b"),
        (dict(kind="encdec", n_enc_layers=2), "1.7e"),
        (dict(vision_stub=True), "1.7f"),
    ])
    def test_unported_layers_raise(self, change, item):
        cfg = dataclasses.replace(get_config("gemma_2b").reduced(), **change)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            model_spec(cfg)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            init_params(cfg, device="cpu")

    def test_cross_attention_raises(self):
        cfg = get_config("gemma_2b").reduced()
        x = torch.zeros(1, 2, cfg.d_model)
        with pytest.raises(NotImplementedError, match="1.7e"):
            attn_mod.attention(cfg, {}, x, torch.zeros(1, 2), kv=(x, x))


class TestLayers:
    """Each layer function on identical inputs in both packages."""

    def setup_method(self):
        self.r = np.random.default_rng(5)

    def _x(self, *shape):
        return self.r.standard_normal(shape).astype(np.float32)

    def test_rmsnorm_one_plus_scale(self):
        x, s = self._x(3, 5, 64), self._x(64)
        got = layers.rmsnorm({"scale": torch.as_tensor(s)},
                             torch.as_tensor(x), 1e-6)
        want = j_layers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x),
                                1e-6)
        assert _rel(_np(got), want) <= 1e-6

    @pytest.mark.parametrize("act", ["geglu", "swiglu", "relu2", "gelu"])
    def test_mlp(self, act):
        cfg = dataclasses.replace(get_config("gemma_2b").reduced(),
                                  ffn_act=act)
        d, f = cfg.d_model, cfg.d_ff
        wi = self._x(d, 2, f) if act in ("geglu", "swiglu") else self._x(d, f)
        wo, x = self._x(f, d), self._x(2, 7, d)
        got = layers.mlp({"wi": torch.as_tensor(wi), "wo": torch.as_tensor(wo)},
                         torch.as_tensor(x), act)
        want = j_layers.mlp({"wi": jnp.asarray(wi), "wo": jnp.asarray(wo)},
                            jnp.asarray(x), act)
        assert _rel(_np(got), want) <= 1e-6

    def test_gelu_is_the_tanh_approximation(self):
        x = np.linspace(-6, 6, 1001, dtype=np.float32)
        got = torch.nn.functional.gelu(torch.as_tensor(x), approximate="tanh")
        assert _rel(_np(got), jax.nn.gelu(jnp.asarray(x))) <= 1e-6
        exact = torch.nn.functional.gelu(torch.as_tensor(x))
        assert _rel(_np(exact), jax.nn.gelu(jnp.asarray(x))) > 1e-5

    @pytest.mark.parametrize("theta", [1e4, 1e6])
    def test_rope(self, theta):
        x = self._x(2, 9, 3, 32)
        pos = np.tile(np.arange(4090, 4099, dtype=np.int32), (2, 1))
        got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
        want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        assert _rel(_np(got), want) <= 1e-5
        np.testing.assert_array_equal(layers.rope_freqs(32, theta),
                                      j_layers.rope_freqs(32, theta))

    def test_embed_scale_rounded_to_dtype(self):
        cfg = get_config("gemma2_2b").reduced(d_model=48)
        emb = self._x(cfg.vocab_size, 48)
        toks = np.array([[1, 5, 7]])
        got = layers.embed({"embedding": torch.as_tensor(emb)}, cfg,
                           torch.as_tensor(toks))
        want = j_layers.embed({"embedding": jnp.asarray(emb)}, cfg,
                              jnp.asarray(toks))
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    @pytest.mark.parametrize("arch", ["gemma2_2b", "minitron_8b"])
    def test_logits_softcap_and_untied(self, arch):
        cfg = get_config(arch).reduced()
        p = {"embedding": self._x(cfg.vocab_size, cfg.d_model) * 10}
        if not cfg.tie_embeddings:
            p["unembed"] = self._x(cfg.d_model, cfg.vocab_size) * 10
        x = self._x(2, 1, cfg.d_model)
        got = layers.logits({k: torch.as_tensor(v) for k, v in p.items()},
                            cfg, torch.as_tensor(x))
        want = j_layers.logits({k: jnp.asarray(v) for k, v in p.items()},
                               cfg, jnp.asarray(x))
        assert _rel(_np(got), want) <= 1e-6
        if cfg.logit_softcap:
            assert float(np.abs(_np(got)).max()) <= cfg.logit_softcap


class TestServingPath:
    @pytest.mark.parametrize("arch", list(REDUCED))
    def test_attention_matches_reference(self, models, arch):
        """``attention`` (prefill, through the kernel wrapper) of every
        sublayer of the period against the reference's ``attention``."""
        from repro.models.attention import attention as j_attention

        jcfg, jparams, tcfg, tparams = models[arch]
        B, S = 2, 16  # S > window 8
        x = np.random.default_rng(2).standard_normal(
            (B, S, tcfg.d_model)).astype(np.float32)
        pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        for i, (mixer, _) in enumerate(tcfg.period):
            window = tcfg.window if mixer == "local" else None
            jp = jax.tree.map(lambda a: a[0], jparams["stack"][str(i)]["mixer"])
            want = j_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               window=window)
            got = attn_mod.attention(tcfg, tparams.layers[i]["mixer"],
                                     torch.as_tensor(x), torch.as_tensor(pos),
                                     window=window)
            assert _rel(_np(got), want) <= RTOL

    @pytest.mark.parametrize("arch", list(REDUCED))
    def test_init_caches_match_reference(self, models, arch):
        from repro.models.transformer import init_caches as j_init_caches

        jcfg, _, tcfg, _ = models[arch]
        want = _j_caches(jcfg, j_init_caches(jcfg, 2, 24, jnp.float32))
        got = init_caches(tcfg, 2, 24, torch.float32, device="cpu")
        assert len(got) == len(want) == tcfg.n_layers
        for (jk, jv), c in zip(want, got):
            assert c.k.shape == jk.shape and c.v.shape == jv.shape
            assert not c.k.any() and not c.v.any()

    @pytest.mark.parametrize("arch", list(REDUCED))
    def test_prefill_logits_and_caches(self, models, arch):
        jcfg, jparams, tcfg, tparams = models[arch]
        B, S, max_len = 2, 16, 24  # S > window 8: the ring path
        toks = _tokens(tcfg, B, S)
        jl, jc = _j_prefill(jcfg, jparams, toks, max_len)
        tl, tc = prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         max_len=max_len)
        assert tl.shape == (B, 1, tcfg.vocab_size)
        assert _rel(_np(tl), jl) <= RTOL
        jcs = _j_caches(jcfg, jc)
        assert len(tc) == len(jcs) == tcfg.n_layers
        for (jk, jv), c in zip(jcs, tc):
            assert c.k.shape == jk.shape
            assert _rel(_np(c.k), jk) <= RTOL
            assert _rel(_np(c.v), jv) <= RTOL

    @pytest.mark.parametrize("arch", list(REDUCED))
    def test_greedy_decode(self, models, arch):
        jcfg, jparams, tcfg, tparams = models[arch]
        B, S0, steps = 2, 12, 8
        toks = _tokens(tcfg, B, S0, seed=1)
        max_len = S0 + steps
        jl, jc = _j_prefill(jcfg, jparams, toks, max_len)
        tl, tc = prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         max_len=max_len)
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t, pos))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        for t in range(steps):
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S0 + t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc, tt, S0 + t)
            assert _rel(_np(tl), jl) <= RTOL, f"step {t}"
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
            tt = tl[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))

    def test_ring_cache_beyond_window(self, models):
        """Teacher-forced decode well past the window of 8 (the ring cache
        wraps twice), each step's logits against the reference's."""
        jcfg, jparams, tcfg, tparams = models["gemma2_2b"]
        assert tcfg.window == 8
        B, S, S0 = 1, 20, 4
        toks = _tokens(tcfg, B, S, seed=2)
        jl, jc = _j_prefill(jcfg, jparams, toks[:, :S0], S)
        tl, tc = prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks[:, :S0])},
                         max_len=S)
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t, pos))
        for t in range(S0, S):
            tok = toks[:, t:t + 1]
            jl, jc = jstep(jparams, jc, jnp.asarray(tok),
                           jnp.asarray(t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc, torch.as_tensor(tok), t)
            assert _rel(_np(tl), jl) <= RTOL, f"position {t}"
        for (jk, jv), c in zip(_j_caches(jcfg, jc), tc):
            assert _rel(_np(c.k), jk) <= RTOL
            assert _rel(_np(c.v), jv) <= RTOL

    def test_prefill_goes_through_the_kernel_wrapper(self, models,
                                                     monkeypatch):
        _, _, tcfg, tparams = models["gemma3_4b"]
        calls = []
        real = ops.flash_attention

        def spy(q, k, v, **kw):
            calls.append(kw)
            return real(q, k, v, **kw)

        monkeypatch.setattr(ops, "flash_attention", spy)
        toks = torch.as_tensor(_tokens(tcfg, 1, 10))
        _, caches = prefill(tcfg, tparams, {"tokens": toks}, max_len=12)
        assert len(calls) == tcfg.n_layers == 10
        windows = [c["window"] for c in calls]
        assert windows == [8, 8, 8, 8, 8, None, 8, 8, 8, 8]
        assert all(c["causal"] and c["softcap"] is None for c in calls)
        decode_step(tcfg, tparams, caches, toks[:, -1:], 10)
        assert len(calls) == 10  # decode stays plain torch ops


class TestLmServe:
    def test_refuses_without_cuda_unless_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            lm_serve.main(["--arch", "gemma2_2b", "--reduced"])

    def test_reduced_cpu_end_to_end(self, capsys):
        res = lm_serve.main(["--arch", "gemma2_2b", "--reduced", "--batch",
                             "2", "--prompt-len", "12", "--gen", "5",
                             "--device", "cpu"])
        assert res.tokens.shape == (2, 5)
        assert bool(torch.isfinite(res.prefill_logits).all())
        assert res.prefill_s > 0 and res.decode_ms_per_step > 0
        out = capsys.readouterr().out
        assert "prefill 2 x 12 tokens" in out
        assert "decoded 5 tokens x batch 2" in out

    def test_serve_matches_the_model_functions(self):
        """``serve`` is prefill + greedy decode_step, nothing else."""
        cfg = lm_serve.make_config("gemma_2b", reduced=True)
        params = lm_serve.make_params(cfg, torch.device("cpu"), seed=3)
        prompt = lm_serve.make_prompt(cfg, 2, 9, torch.device("cpu"))
        res = lm_serve.serve(cfg, params, prompt, gen=4, keep_logits=True)
        logits, caches = prefill(cfg, params, {"tokens": prompt}, max_len=13)
        toks = [logits[:, -1].argmax(-1)[:, None]]
        for t in range(3):
            step, caches = decode_step(cfg, params, caches, toks[-1], 9 + t)
            torch.testing.assert_close(step, res.step_logits[t], rtol=0,
                                       atol=0)
            toks.append(step[:, 0].argmax(-1)[:, None])
        assert torch.equal(torch.cat(toks, 1), res.tokens)

    def test_profile_runs_on_the_cpu(self):
        """``lm_profile`` traces one serve and splits it at the serve's
        prefill/decode ranges; without a card it records no device time
        and says so."""
        from repro_torch.launch import lm_profile

        out = lm_profile.main(["--reduced", "--prompt-len", "10", "--gen",
                               "3", "--device", "cpu"])
        assert out["decode_steps"] == 2
        for p in ("prefill", "decode"):
            assert out[p]["wall_ms"] > 0
            assert out[p]["busy_share"] is None and out[p]["kernels"] == []

    @pytest.mark.parametrize("name,group", [
        ("void (anonymous namespace)::flash_fwd_kernel<float, 256>(Params)",
         "flash_attention"),
        ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16", "matmul"),
        ("Memcpy HtoD (Pageable -> Device)", "copies"),
        ("void at::native::vectorized_elementwise_kernel<4>", "other"),
    ])
    def test_profile_kernel_groups(self, name, group):
        from repro_torch.launch.lm_profile import kernel_group

        assert kernel_group(name) == group


def test_model_config_type_is_the_ports():
    assert isinstance(get_config("gemma2_2b"), ModelConfig)
