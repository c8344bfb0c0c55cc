"""The port's MoE layer and MoE decoders against the JAX package, on the CPU.

``moe_ffn`` runs in both packages on the same weights (the reference's
``materialize`` of ``moe_spec``, carried over as numpy) and the same
inputs (numpy, seeded).  Routing is compared first: ``top_e`` must be
identical before any value is (``jax.lax.top_k`` and ``torch.topk`` may
break exact ties differently, and no tie occurs on these inputs).

Tolerances: outputs ``max|port - ref| / max|ref|`` at most 1e-5 (float32
in another library and order), the two auxiliary losses within 1e-6
relative, model logits within 1e-4.

``reduced()`` sets ``pad_to=1`` and ``capacity_factor=8.0``, so neither
padding experts nor capacity overflow occur there; the tests that need
them set them explicitly.  On overflow the reference writes every dropped
assignment to slot ``C - 1`` with duplicate scatter indices, and on XLA's
CPU the last write wins, so the kept token at that slot becomes the
padding row and gets an expert output of 0 with its routing weight still
applied (``repro/models/moe.py:92-95, 105-109``).  The port keeps that
token: the overflow test holds the port to the reference on every other
token, and on those tokens to the reference plus the dropped expert's
weighted output.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.common import materialize as j_materialize  # noqa: E402
from repro.models.transformer import lm_loss as j_lm_loss  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    lm_loss,
    make_trainable,
    prefill,
)

RTOL, AUX_TOL, LOGIT_TOL = 1e-5, 1e-6, 1e-4
ARCHS = ("qwen2_moe_a2p7b", "olmoe_1b_7b")


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cfgs(arch, **moe_kw):
    """(JAX cfg, port cfg), reduced, with ``moe_kw`` replacing MoE
    fields and ``ffn_act`` the activation."""
    act = moe_kw.pop("ffn_act", None)
    out = []
    for get in (j_get_config, get_config):
        cfg = get(arch).reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
        if act is not None:
            cfg = dataclasses.replace(cfg, ffn_act=act)
        out.append(cfg)
    return out


def _layer(jcfg, seed=0):
    """The reference's MoE parameters (float32) and the same as tensors."""
    jp = j_materialize(j_moe.moe_spec(jcfg), jax.random.PRNGKey(seed),
                       dtype=jnp.float32)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)
    return jp, tp


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _routes_equal(jcfg, jp, tcfg, tp, x):
    """The reference's top-k experts, asserted equal to the port's."""
    xt = x.reshape(-1, x.shape[-1])
    r = moe.route(tcfg, tp, torch.as_tensor(xt))
    logits = jnp.asarray(xt) @ jp["router"]
    if jcfg.moe.padded_experts != jcfg.moe.n_experts:
        pad = jnp.arange(jcfg.moe.padded_experts) >= jcfg.moe.n_experts
        logits = jnp.where(pad[None], -1e30, logits)
    _, j_top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    np.testing.assert_array_equal(_np(r.top_e), np.asarray(j_top))
    return r


def _both(jcfg, jp, tcfg, tp, x, dropless=False):
    _routes_equal(jcfg, jp, tcfg, tp, x)
    want, waux = j_moe.moe_ffn(jcfg, jp, jnp.asarray(x), dropless=dropless)
    got, gaux = moe.moe_ffn(tcfg, tp, torch.as_tensor(x), dropless=dropless)
    return want, waux, got, gaux


def _check_aux(waux, gaux):
    for k in ("moe_load_balance", "moe_router_z"):
        w, g = float(waux[k]), float(gaux[k])
        assert abs(g - w) <= AUX_TOL * max(abs(w), 1.0), k


class TestMoeFFN:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
    def test_ample_capacity(self, arch, act):
        jcfg, tcfg = _cfgs(arch, ffn_act=act)
        jp, tp = _layer(jcfg)
        x = _x(tcfg, 2, 16)
        want, waux, got, gaux = _both(jcfg, jp, tcfg, tp, x)
        assert got.shape == x.shape
        assert _rel(_np(got), want) <= RTOL
        _check_aux(waux, gaux)
        assert int(gaux["moe_dropped"]) == 0

    def test_padding_experts_never_routed(self):
        jcfg, tcfg = _cfgs("qwen2_moe_a2p7b", n_experts=6, pad_to=8,
                           n_shared=0)
        assert tcfg.moe.padded_experts == 8
        jp, tp = _layer(jcfg)
        x = _x(tcfg, 2, 16, seed=2)
        r = moe.route(tcfg, tp, torch.as_tensor(x.reshape(-1, tcfg.d_model)))
        assert int(r.top_e.max()) < 6
        assert float(r.probs[:, 6:].max()) == 0.0
        want, waux, got, gaux = _both(jcfg, jp, tcfg, tp, x)
        assert _rel(_np(got), want) <= RTOL
        _check_aux(waux, gaux)

    def test_full_routing_equals_dense_mixture(self):
        """top_k == E with ample capacity: the exact softmax-weighted
        mixture of every expert (the reference's own invariant)."""
        jcfg, tcfg = _cfgs("olmoe_1b_7b", n_experts=4, top_k=4,
                           capacity_factor=4.0)
        jp, tp = _layer(jcfg)
        x = _x(tcfg, 2, 8, seed=3)
        want, _, got, _ = _both(jcfg, jp, tcfg, tp, x)
        xt = torch.as_tensor(x.reshape(-1, tcfg.d_model))
        probs = torch.softmax(xt @ tp["router"], dim=-1)
        dense = torch.zeros_like(xt)
        for e in range(4):
            h = torch.einsum("td,dgf->tgf", xt, tp["wi"][e])
            dense += probs[:, e:e + 1] * ((torch.nn.functional.silu(h[:, 0])
                                           * h[:, 1]) @ tp["wo"][e])
        got = got.reshape(-1, tcfg.d_model)
        assert _rel(_np(got), _np(dense)) <= 2e-5
        assert _rel(_np(got), np.asarray(want).reshape(got.shape)) <= RTOL

    @pytest.mark.parametrize("arch", ARCHS)
    def test_overflow_keeps_the_slot_the_reference_drops(self, arch):
        """Capacity factor 0.5: assignments past the capacity are dropped
        in both packages.  The reference also loses the kept token at slot
        ``C - 1`` of every expert that overflows; the port keeps it."""
        jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
        jp, tp = _layer(jcfg)
        B, S = 2, 16
        x = _x(tcfg, B, S, seed=4)
        T, k, E = B * S, tcfg.moe.top_k, tcfg.moe.padded_experts
        C = moe.capacity(tcfg, T)
        assert C == max(int(T * k * 0.5 / E), 1)
        want, waux, got, gaux = _both(jcfg, jp, tcfg, tp, x)
        r = moe.route(tcfg, tp, torch.as_tensor(x.reshape(T, -1)))
        pos = _np(moe.capacity_positions(r.top_e))
        top_e = _np(r.top_e)
        counts = np.bincount(top_e.reshape(-1), minlength=E)
        assert int(gaux["moe_dropped"]) == int(np.maximum(counts - C, 0).sum()) > 0
        # the reference's lost slot: the assignment at position C - 1 of
        # every expert holding more than C
        lost = [(t, j) for t in range(T) for j in range(k)
                if pos[t, j] == C - 1 and counts[top_e[t, j]] > C]
        assert lost, "no expert overflowed"
        expected = np.asarray(want).reshape(T, -1).astype(np.float64)
        xt = torch.as_tensor(x.reshape(T, -1))
        for t, j in lost:
            e = int(top_e[t, j])
            one = {"wi": tp["wi"][e:e + 1], "wo": tp["wo"][e:e + 1]}
            out_e = moe._expert_ffn(tcfg.ffn_act, one,
                                    xt[t][None, None])[0, 0]
            expected[t] += float(r.top_p[t, j]) * _np(out_e)
        got = _np(got).reshape(T, -1)
        assert _rel(got, expected) <= RTOL
        rows = sorted({t for t, _ in lost})
        others = [t for t in range(T) if t not in rows]
        ref = np.asarray(want).reshape(T, -1)
        assert _rel(got[others], ref[others]) <= RTOL
        assert _rel(got[rows], ref[rows]) > 1e-3  # the port kept them
        _check_aux(waux, gaux)

    def test_gather_table_has_no_repeated_index(self, monkeypatch):
        """The dispatch table is written by one scatter whose indices are
        all distinct, also when experts overflow."""
        jcfg, tcfg = _cfgs("olmoe_1b_7b", capacity_factor=0.5)
        _, tp = _layer(jcfg)
        seen = []
        real = torch.Tensor.scatter_

        def spy(self, dim, index, src, *a, **kw):
            seen.append(index.clone())
            return real(self, dim, index, src, *a, **kw)

        monkeypatch.setattr(torch.Tensor, "scatter_", spy)
        _, aux = moe.moe_ffn(tcfg, tp, torch.as_tensor(_x(tcfg, 2, 16)))
        assert int(aux["moe_dropped"]) > 0
        assert seen and all(int(i.unique().numel()) == i.numel() for i in seen)

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("B,S", [(2, 1), (3, 1), (2, 5)])
    def test_dropless_decode(self, arch, B, S):
        """The port runs only the picked experts; the reference runs all E
        at C = T.  Same function."""
        jcfg, tcfg = _cfgs(arch, pad_to=16)
        jp, tp = _layer(jcfg)
        x = _x(tcfg, B, S, seed=5)
        want, waux, got, gaux = _both(jcfg, jp, tcfg, tp, x, dropless=True)
        assert _rel(_np(got), want) <= RTOL
        _check_aux(waux, gaux)
        assert int(gaux["moe_dropped"]) == 0

    def test_dropless_reads_only_the_picked_experts(self, monkeypatch):
        jcfg, tcfg = _cfgs("olmoe_1b_7b", n_experts=8, top_k=2)
        _, tp = _layer(jcfg)
        shapes = []
        real = moe._expert_ffn
        monkeypatch.setattr(moe, "_expert_ffn", lambda cfg, p, xin: (
            shapes.append(tuple(p["wi"].shape)) or real(cfg, p, xin)))
        moe.moe_ffn(tcfg, tp, torch.as_tensor(_x(tcfg, 1, 1)), dropless=True)
        moe.moe_ffn(tcfg, tp, torch.as_tensor(_x(tcfg, 2, 1)), dropless=True)
        assert [s[0] for s in shapes] == [2, 4]

    @pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
    def test_expert_kernel_takes_the_plain_version_on_the_cpu(self, act):
        """``ops.moe_expert_ffn`` on CPU tensors is its plain version: a
        picked expert's rows are ``_expert_ffn`` of that expert on every
        token, the other experts' rows zero, and nothing is launched."""
        jcfg, tcfg = _cfgs("olmoe_1b_7b", n_experts=8, top_k=2, ffn_act=act)
        _, tp = _layer(jcfg)
        x = torch.as_tensor(_x(tcfg, 1, 5, seed=7)).reshape(5, -1)
        # E + 1 entries, the last the dispatch's sink for other ranks'
        used = torch.tensor([1, 0, 0, 1, 1, 0, 0, 1, 1], dtype=torch.int32)
        ops.reset_launch_counts()
        got = ops.moe_expert_ffn(x, tp["wi"], tp["wo"], used, act=act)
        assert ops.launch_counts()["moe_expert_ffn"] == 0
        assert got.shape == (8, 5, tcfg.d_model)
        for e in range(8):
            if used[e]:
                one = {"wi": tp["wi"][e:e + 1], "wo": tp["wo"][e:e + 1]}
                want = moe._expert_ffn(act, one, x[None])[0]
                assert _rel(_np(got[e]), _np(want)) <= RTOL
            else:
                assert not got[e].any()

    @pytest.mark.parametrize("bad", ["act", "gated_wi", "wo", "used", "x"])
    def test_expert_kernel_refuses_inconsistent_inputs(self, bad):
        jcfg, tcfg = _cfgs("olmoe_1b_7b", n_experts=8, top_k=2)
        _, tp = _layer(jcfg)
        x = torch.as_tensor(_x(tcfg, 1, 3)).reshape(3, -1)
        wi, wo = tp["wi"], tp["wo"]
        used = torch.ones(9, dtype=torch.int32)
        act = "swiglu"
        if bad == "act":
            act = "tanh"
        elif bad == "gated_wi":  # a non-gated act's layout
            act = "gelu"
        elif bad == "wo":
            wo = wo.transpose(1, 2)
        elif bad == "used":
            used = used[:7]
        else:
            x = x[None]
        with pytest.raises(ValueError):
            ops.moe_expert_ffn(x, wi, wo, used, act=act)

    def test_backward_matches_reference(self):
        """Gradients through the gathers, the router and the aux losses
        (ample capacity: on overflow the reference's lost slot differs)."""
        jcfg, tcfg = _cfgs("qwen2_moe_a2p7b")
        jp, tp = _layer(jcfg)
        x = _x(tcfg, 2, 8, seed=6)

        def jloss(p, x):
            out, aux = j_moe.moe_ffn(jcfg, p, x)
            return (jnp.sum(out ** 2) * 1e-3 + aux["moe_load_balance"]
                    + aux["moe_router_z"])

        jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
        tp = {k: (v.requires_grad_(True) if isinstance(v, torch.Tensor) else
                  {kk: vv.requires_grad_(True) for kk, vv in v.items()})
              for k, v in tp.items()}
        xt = torch.as_tensor(x).requires_grad_(True)
        out, aux = moe.moe_ffn(tcfg, tp, xt)
        ((out ** 2).sum() * 1e-3 + aux["moe_load_balance"]
         + aux["moe_router_z"]).backward()
        assert _rel(_np(xt.grad), jg[1]) <= 1e-4
        for k in ("router", "wi", "wo"):
            assert _rel(_np(tp[k].grad), jg[0][k]) <= 1e-4, k


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32)
        tree = jax.tree.map(np.asarray, jparams)
        out[arch] = (jcfg, jparams, tcfg,
                     convert.lm_params_from_arrays(tcfg, tree, device="cpu"))
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S))


class TestMoeDecoders:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_greedy_decode(self, models, arch):
        jcfg, jparams, tcfg, tparams = models[arch]
        B, S0, steps = 2, 12, 8
        toks = _tokens(tcfg, B, S0, seed=1)
        jl, jc = jax.jit(lambda p, t: j_prefill(
            jcfg, p, {"tokens": t}, max_len=S0 + steps))(jparams,
                                                         jnp.asarray(toks))
        tl, tc = prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         max_len=S0 + steps)
        assert _rel(_np(tl), jl) <= LOGIT_TOL
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t, pos))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        for t in range(steps):
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S0 + t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc, tt, S0 + t)
            assert _rel(_np(tl), jl) <= LOGIT_TOL, f"step {t}"
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
            tt = tl[:, 0].argmax(-1)[:, None]
        np.testing.assert_array_equal(_np(tt), np.asarray(jt))

    def test_a2a_without_a_mesh_runs_moe_ffn(self, models):
        """``moe.a2a`` needs a device mesh (ROADMAP item 1.6); without one
        the reference runs ``moe_ffn`` (``transformer.py:187-195``) and so
        does the port: the same logits bit for bit."""
        _, _, tcfg, tparams = models["olmoe_1b_7b"]
        cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                a2a=True))
        toks = {"tokens": torch.as_tensor(_tokens(tcfg, 2, 8, seed=6))}
        want, _ = prefill(tcfg, tparams, toks, max_len=8)
        got, _ = prefill(cfg, tparams, toks, max_len=8)
        assert torch.equal(got, want)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_lm_loss_and_aux(self, models, arch):
        jcfg, jparams, tcfg, tparams = models[arch]
        toks = _tokens(tcfg, 2, 16, seed=2)
        jl, jaux = j_lm_loss(jcfg, jparams, {"tokens": jnp.asarray(toks)})
        with torch.no_grad():
            tl, taux = lm_loss(tcfg, tparams, {"tokens": torch.as_tensor(toks)})
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        assert set(taux) == set(jaux)
        for k in jaux:
            assert abs(float(taux[k]) - float(jaux[k])) <= \
                AUX_TOL * max(abs(float(jaux[k])), 1.0), k
        assert float(taux["moe_load_balance"]) > 0

    @pytest.mark.parametrize("arch", ARCHS)
    def test_flat_theta_and_gradient(self, arch):
        jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        jparams = j_init_params(jcfg, jax.random.PRNGKey(3),
                                dtype=jnp.float32)
        theta, unravel = ravel_pytree(jparams)
        model = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        flat = make_trainable(model)
        assert np.array_equal(flat.ravel().numpy(), np.asarray(theta))
        toks = _tokens(tcfg, 2, 12, seed=4)
        jgrad = jax.grad(lambda th: j_lm_loss(
            jcfg, unravel(th), {"tokens": jnp.asarray(toks)})[0])(theta)
        lm_loss(tcfg, model, {"tokens": torch.as_tensor(toks)})[0].backward()
        assert _rel(flat.grad.numpy(), jgrad) <= 1e-4


class TestLaunchers:
    def test_lm_serve_reduced_cpu(self, capsys):
        res = lm_serve.main(["--arch", "olmoe_1b_7b", "--reduced", "--batch",
                             "2", "--prompt-len", "12", "--gen", "5",
                             "--device", "cpu"])
        assert res.tokens.shape == (2, 5)
        assert bool(torch.isfinite(res.prefill_logits).all())
        assert "decoded 5 tokens x batch 2" in capsys.readouterr().out

    def test_prefill_launches_flash_per_layer_and_decode_none(self,
                                                             monkeypatch):
        cfg = lm_serve.make_config("qwen2_moe_a2p7b", reduced=True)
        params = lm_serve.make_params(cfg, torch.device("cpu"), seed=1)
        calls = []
        real = ops.flash_attention
        monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, **kw: (
            calls.append(kw) or real(q, k, v, **kw)))
        lm_serve.serve(cfg, params, lm_serve.make_prompt(
            cfg, 2, 10, torch.device("cpu")), gen=3)
        assert len(calls) == cfg.n_layers

    def test_lm_profile_reduced_cpu(self):
        from repro_torch.launch import lm_profile

        out = lm_profile.main(["--arch", "qwen2_moe_a2p7b", "--reduced",
                               "--prompt-len", "10", "--gen", "3",
                               "--device", "cpu", "--dtype", "bfloat16"])
        assert out["decode_steps"] == 2 and out["dtype"] == "bfloat16"
        assert out["prefill"]["busy_share"] is None
