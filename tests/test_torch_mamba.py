"""The port's Mamba block, its plain selective scan and the Jamba hybrid
against the JAX package, on the CPU.

Each block function runs in both packages on the same weights (the
reference's ``materialize`` of ``mamba_spec``, carried over as numpy) and
the same seeded numpy inputs, scaled by 0.5 as the reference's own
invariant tests do.  Tolerances, ``max|port - ref| / max|ref|``: 1e-5 for
block outputs, states and the plain scan in float32 (the doubling scan
combines the same pairs as ``jax.lax.associative_scan`` in another
order); 1e-5 for the plain scan on bfloat16 inputs too (both round
``dt * xc`` to bfloat16 once and compute the rest in float32); the
reference's own parallel-against-recurrent check keeps its ``rtol=1e-4,
atol=1e-5``.  With bfloat16 inputs the reference runs op by op here
(``jax.disable_jit``): compiled (``lax.scan`` in its chunked
``_ssm_apply`` and ``ssm_final_state``, or ``jit``), XLA on the CPU drops
the bfloat16 rounding of ``dt * xc`` the code writes, which moves the
final state by 1.7e-3; op by op it rounds as written, and the port's
plain scan lies 6.6e-8 from it.

Reduced Jamba's logits are ill-conditioned in the reference itself, so
they get tolerances from a measurement of it: on a 2 x 12 prompt (seed 0)
its prefill logits move by 2.5-5.2e-5 (relative) when its own weights are
perturbed by 1e-7 (relative, three seeded draws), and its float32 logits
lie 1.5e-5 from its float64 run on the same weights: ``LOGIT_TOL`` 1e-4
(the port measured 1.2e-5).  On the decode test's prompt (seed 2) the
same noise moves its prefill logits by 0.9-5.3e-4 and its 6 decode steps'
by up to 2.7e-3 (the residual stream moves ~1.6e-6; the final norm and
unembedding amplify it): ``DECODE_TOL`` 5e-3 there (the port measured
1.7e-4 and 8.8e-4).  The gradients get ``GRAD_TOL``, measured the same
way (docstring of :class:`TestTraining`).
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
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.common import materialize as j_materialize  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import lm_serve  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    forward_train,
    init_caches,
    lm_loss,
    make_trainable,
    prefill,
)

RTOL, LOGIT_TOL, DECODE_TOL = 1e-5, 1e-4, 5e-3
#: the lm_loss gradient's leaves (TestTraining's docstring)
GRAD_TOL = 1e-2
ARCH = "jamba_1p5_large_398b"


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(j_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _block(jcfg, seed=0):
    jp = j_materialize(j_mamba.mamba_spec(jcfg), jax.random.PRNGKey(seed),
                       dtype=jnp.float32)
    return jp, jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)


def _x(cfg, B, S, seed=1):
    return 0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _t(x):
    return torch.as_tensor(x)


def _states_close(got, want, tol=RTOL):
    assert type(got).__name__ == type(want).__name__ == "MambaState"
    for f, g, w in zip(want._fields, got, want):
        assert tuple(g.shape) == tuple(w.shape), f
        assert _rel(_np(g), w) <= tol, f


def _scan_inputs(cfg, B, S, seed=2):
    """Seeded (dt, xc, Bm, Cm, A) as numpy float32: dt in Mamba's init
    range [1e-3, 1e-1] (long memories), A = -exp(A_log) from a random
    A_log."""
    r = np.random.default_rng(seed)
    di, ds = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    dt = np.exp(r.uniform(np.log(1e-3), np.log(1e-1), (B, S, di)))
    xc = r.standard_normal((B, S, di))
    Bm, Cm = r.standard_normal((2, B, S, ds))
    A = -np.exp(r.uniform(-1.0, 1.5, (di, ds)))
    return tuple(a.astype(np.float32) for a in (dt, xc, Bm, Cm, A))


class TestSpec:
    @pytest.mark.parametrize("reduced", [True, False])
    def test_mamba_spec(self, reduced):
        jcfg, tcfg = j_get_config(ARCH), get_config(ARCH)
        if reduced:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        want = j_mamba.mamba_spec(jcfg)
        got = mamba.mamba_spec(tcfg)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k].shape, got[k].axes, got[k].init) == (
                want[k].shape, want[k].axes, want[k].init), k
        if not reduced:  # Jamba's published widths
            assert got["in_proj"].shape == (8192, 2, 16384)
            assert got["x_proj"].shape == (16384, 512 + 32)
            assert got["A_log"].shape == (16384, 16)

    def test_ssm_inputs(self):
        jcfg, tcfg = _cfgs()
        jp, tp = _block(jcfg)
        xc = np.random.default_rng(3).standard_normal(
            (2, 9, 2 * tcfg.d_model)).astype(np.float32)
        want = j_mamba._ssm_inputs(jcfg, jp, jnp.asarray(xc))
        got = mamba._ssm_inputs(tcfg, tp, _t(xc))
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert _rel(_np(g), w) <= RTOL


class TestBlock:
    @pytest.mark.parametrize("chunk,S", [(None, 16), (4, 16), (5, 16),
                                         (16, 16), (32, 16)])
    def test_mamba_block(self, chunk, S):
        """Unchunked, chunked (4 divides 16), a chunk that does not
        divide S, one chunk of S and a chunk longer than S (the last
        three take the reference's unchunked form)."""
        jcfg, tcfg = _cfgs(ssm_chunk=chunk)
        jp, tp = _block(jcfg)
        x = _x(tcfg, 2, S)
        want = j_mamba.mamba_block(jcfg, jp, jnp.asarray(x))
        got, st = mamba.mamba_block_with_state(tcfg, tp, _t(x))
        assert _rel(_np(got), want) <= RTOL
        assert _rel(_np(mamba.mamba_block(tcfg, tp, _t(x))), want) <= RTOL
        _states_close(st, j_tf._prefill_mamba_state(jcfg, jp, jnp.asarray(x)))

    @pytest.mark.parametrize("chunk,S", [(None, 12), (4, 12), (5, 12),
                                         (None, 2)])
    def test_ssm_final_state(self, chunk, S):
        jcfg, tcfg = _cfgs(ssm_chunk=chunk)
        dt, xc, Bm, _, A = _scan_inputs(tcfg, 2, S, seed=4)
        want = j_mamba.ssm_final_state(jcfg, *map(jnp.asarray,
                                                  (dt, A, Bm, xc)))
        got = mamba.ssm_final_state(tcfg, *map(_t, (dt, A, Bm, xc)))
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(_np(got), want) <= RTOL

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("chunk", [None, 8])
    def test_plain_scan_is_the_references(self, dtype, chunk):
        """``ref.selective_scan`` (through ``ops`` on the CPU) against
        ``_ssm_apply`` and ``ssm_final_state``, float32 and bfloat16
        inputs (A stays float32)."""
        jcfg, tcfg = _cfgs(ssm_chunk=chunk)
        dt, xc, Bm, Cm, A = _scan_inputs(tcfg, 2, 32, seed=5)
        jd = getattr(jnp, dtype)
        td = getattr(torch, dtype)
        jin = [jnp.asarray(a, jd) for a in (dt, xc, Bm, Cm)]
        tin = [_t(a).to(td) for a in (dt, xc, Bm, Cm)]
        with jax.disable_jit():  # op by op: the written rounding (docstring)
            wy = j_mamba._ssm_apply(jcfg, jin[0], jnp.asarray(A), jin[2],
                                    jin[3], jin[1])
            wh = j_mamba.ssm_final_state(jcfg, jin[0], jnp.asarray(A),
                                         jin[2], jin[1])
        y, h = ops.selective_scan(*tin, _t(A), chunk=chunk)
        assert y.dtype == h.dtype == torch.float32
        assert _rel(_np(y), wy) <= RTOL
        assert _rel(_np(h), wh) <= RTOL
        assert _rel(_np(mamba._ssm_apply(tcfg, tin[0], _t(A), tin[2],
                                         tin[3], tin[1])), wy) <= RTOL

    @pytest.mark.parametrize("chunk", [None, 4, 5])
    def test_plain_scan_from_h0_is_the_recurrence(self, chunk):
        """From a carried state ``h0`` (the kernel's option; the
        reference injects one between chunks): against the recurrence
        itself in float64, step by step."""
        dt, xc, Bm, Cm, A = _scan_inputs(_cfgs()[1], 2, 20, seed=6)
        h0 = np.random.default_rng(7).standard_normal(
            (2, A.shape[0], A.shape[1])).astype(np.float32)
        y, h = ref.selective_scan(*map(_t, (dt, xc, Bm, Cm, A, h0)),
                                  chunk=chunk)
        hw, ys = h0.astype(np.float64), []
        bx = (dt * xc).astype(np.float64)
        for t in range(dt.shape[1]):
            a = np.exp(dt[:, t, :, None].astype(np.float64) * A)
            hw = a * hw + bx[:, t, :, None] * Bm[:, t, None, :]
            ys.append(np.einsum("bin,bn->bi", hw, Cm[:, t]))
        assert _rel(_np(y), np.stack(ys, 1)) <= RTOL
        assert _rel(_np(h), hw) <= RTOL

    def test_plain_scan_in_float64(self):
        """``acc=float64`` (the card's error yardstick) keeps the inputs'
        rounding point and returns float64."""
        dt, xc, Bm, Cm, A = (_t(a).bfloat16() if a.ndim == 3 else _t(a)
                             for a in _scan_inputs(_cfgs()[1], 1, 24))
        y32, h32 = ref.selective_scan(dt, xc, Bm, Cm, A, chunk=8)
        y64, h64 = ref.selective_scan(dt, xc, Bm, Cm, A, chunk=8,
                                      acc=torch.float64)
        assert y64.dtype == h64.dtype == torch.float64
        assert _rel(_np(y32), y64.numpy()) <= RTOL
        assert _rel(_np(h32), h64.numpy()) <= RTOL

    @pytest.mark.parametrize("bad", ["xc", "Bm", "A", "h0"])
    def test_ops_checks_shapes(self, bad):
        dt, xc, Bm, Cm, A = map(_t, _scan_inputs(_cfgs()[1], 2, 6))
        h0 = torch.zeros(2, A.shape[0], A.shape[1])
        args = dict(dt=dt, xc=xc, Bm=Bm, Cm=Cm, A=A, h0=h0)
        args[bad] = args[bad][..., :-1]
        with pytest.raises(ValueError):
            ops.selective_scan(args["dt"], args["xc"], args["Bm"],
                               args["Cm"], args["A"], args["h0"])


class TestDecode:
    def test_mamba_decode_steps(self):
        jcfg, tcfg = _cfgs()
        jp, tp = _block(jcfg, seed=1)
        x = _x(tcfg, 2, 5, seed=8)
        jst = j_mamba.init_mamba_state(jcfg, 2, jnp.float32)
        tst = mamba.init_mamba_state(tcfg, 2, torch.float32, "cpu")
        _states_close(tst, jst)
        for t in range(5):
            wy, jst = j_mamba.mamba_decode(jcfg, jp,
                                           jnp.asarray(x[:, t:t + 1]), jst)
            gy, tst = mamba.mamba_decode(tcfg, tp, _t(x[:, t:t + 1]), tst)
            assert gy.shape == (2, 1, tcfg.d_model)
            assert _rel(_np(gy), wy) <= RTOL, t
            _states_close(tst, jst)

    def test_decode_from_a_prefilled_state(self):
        jcfg, tcfg = _cfgs()
        jp, tp = _block(jcfg, seed=2)
        x = _x(tcfg, 2, 10, seed=9)
        jst = j_tf._prefill_mamba_state(jcfg, jp, jnp.asarray(x[:, :9]))
        _, tst = mamba.mamba_block_with_state(tcfg, tp, _t(x[:, :9]))
        wy, wst = j_mamba.mamba_decode(jcfg, jp, jnp.asarray(x[:, 9:]), jst)
        gy, gst = mamba.mamba_decode(tcfg, tp, _t(x[:, 9:]), tst)
        assert _rel(_np(gy), wy) <= RTOL
        _states_close(gst, wst)

    @pytest.mark.parametrize("chunk", [None, 4])
    def test_parallel_matches_recurrent(self, chunk):
        """The reference's own invariant, on the port."""
        jcfg, tcfg = _cfgs(ssm_chunk=chunk)
        _, tp = _block(jcfg, seed=3)
        B, S = 2, 8
        x = _t(_x(tcfg, B, S, seed=10))
        y_par = mamba.mamba_block(tcfg, tp, x)
        state = mamba.init_mamba_state(tcfg, B, torch.float32, "cpu")
        ys = []
        for t in range(S):
            yt, state = mamba.mamba_decode(tcfg, tp, x[:, t:t + 1], state)
            ys.append(yt)
        np.testing.assert_allclose(_np(y_par), _np(torch.cat(ys, 1)),
                                   rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- #
# Reduced Jamba: every sublayer kind of its period
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (B, S))


def _j_caches(jcfg, caches):
    """The reference's stacked caches, one per layer in order."""
    out = []
    for p in range(jcfg.n_periods):
        for i in range(len(jcfg.period)):
            out.append(jax.tree.map(lambda a: np.asarray(a[p]),
                                    caches["stack"][str(i)]))
    for i in range(len(jcfg.remainder)):
        out.append(jax.tree.map(np.asarray, caches["rest"][str(i)]))
    return out


def _caches_close(got, want, tol):
    assert [type(c).__name__ for c in got] == \
        [type(c).__name__ for c in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape)
            assert _rel(_np(a), b) <= tol


def _leaf_items(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


class TestJambaDecoder:
    def test_period_holds_every_sublayer_kind(self, model):
        _, _, tcfg, tparams = model
        assert {layer.kind for layer in tparams.layers} == {
            ("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp")}
        assert tcfg.mamba.d_state == 8 and tcfg.n_layers == 8

    def test_init_caches_match_reference(self, model):
        jcfg, _, tcfg, _ = model
        want = _j_caches(jcfg, j_tf.init_caches(jcfg, 2, 16, jnp.float32))
        got = init_caches(tcfg, 2, 16, torch.float32, device="cpu")
        assert [type(c).__name__ for c in got] == \
            ["MambaState"] * 4 + ["KVCache"] + ["MambaState"] * 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(_np(a), b)

    @pytest.mark.parametrize("chunk", [None, 4])
    def test_prefill_logits_and_caches(self, model, chunk):
        jcfg, jparams, tcfg, tparams = model
        jcfg = dataclasses.replace(jcfg, ssm_chunk=chunk)
        tcfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
        toks = _tokens(tcfg, 2, 12, seed=1)
        jl, jc = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                           max_len=20)
        tl, tc = prefill(tcfg, tparams, {"tokens": _t(toks)}, max_len=20)
        assert tl.shape == (2, 1, tcfg.vocab_size)
        assert _rel(_np(tl), jl) <= LOGIT_TOL
        _caches_close(tc, _j_caches(jcfg, jc), LOGIT_TOL)

    def test_decode_steps_against_the_reference(self, model):
        jcfg, jparams, tcfg, tparams = model
        B, S0, steps = 2, 12, 6
        toks = _tokens(tcfg, B, S0, seed=2)
        jl, jc = jax.jit(lambda p, t: j_prefill(
            jcfg, p, {"tokens": t}, max_len=S0 + steps))(jparams,
                                                         jnp.asarray(toks))
        tl, tc = prefill(tcfg, tparams, {"tokens": _t(toks)},
                         max_len=S0 + steps)
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t, pos))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        tt = tl[:, -1].argmax(-1)[:, None]
        for t in range(steps):
            np.testing.assert_array_equal(_np(tt), np.asarray(jt))
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S0 + t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc, tt, S0 + t)
            assert _rel(_np(tl), jl) <= DECODE_TOL, f"step {t}"
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
            tt = tl[:, 0].argmax(-1)[:, None]
        _caches_close(tc, _j_caches(jcfg, jc), DECODE_TOL)

    @pytest.mark.parametrize("chunk", [None, 4])
    def test_prefill_then_decode_equals_a_longer_prefill(self, model, chunk):
        """Prefill S tokens and decode token S+1 against a prefill of S+1
        tokens (chunk-recurrent too: S = 12 and 16, chunk 4)."""
        _, _, tcfg, tparams = model
        cfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
        toks = _t(_tokens(cfg, 2, 17, seed=3))
        for S in (12, 16):
            _, caches = prefill(cfg, tparams, {"tokens": toks[:, :S]},
                                max_len=S + 1)
            step, _ = decode_step(cfg, tparams, caches, toks[:, S:S + 1], S)
            want, _ = prefill(cfg, tparams, {"tokens": toks[:, :S + 1]},
                              max_len=S + 1)
            assert _rel(_np(step), _np(want)) <= LOGIT_TOL

    def test_prefill_goes_through_the_scan_wrapper(self, model, monkeypatch):
        """One ``ops.selective_scan`` call a Mamba layer a prefill (on the
        card, one kernel launch), none in decode."""
        _, _, tcfg, tparams = model
        calls = []
        real = ops.selective_scan

        def spy(*a, **kw):
            calls.append(kw.get("chunk"))
            return real(*a, **kw)

        monkeypatch.setattr(ops, "selective_scan", spy)
        toks = _t(_tokens(tcfg, 2, 8, seed=4))
        _, caches = prefill(tcfg, tparams, {"tokens": toks}, max_len=9)
        assert len(calls) == 7
        decode_step(tcfg, tparams, caches, toks[:, :1], 8)
        assert len(calls) == 7


class TestTraining:
    """forward_train and lm_loss with every gradient leaf against
    ``jax.value_and_grad``.  Under grad the scan is the plain version
    (autograd sees it).  ``GRAD_TOL`` 1e-2: the reference's own gradient
    moves by 3.5e-3 to 6.4e-3 (relative, in its worst leaf: the attention
    layer's ``wq`` or a Mamba ``A_log``) under 1e-7 relative weight noise
    (three seeded draws); the port measured 2.0e-3 from it (``wq``)."""

    def test_forward_train_loss_and_every_gradient(self, model):
        jcfg, jparams, tcfg, _ = model
        toks = _tokens(tcfg, 2, 10, seed=5)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
        want_logits, _ = j_tf.forward_train(jcfg, jparams, jb)
        (jl, jaux), jg = jax.value_and_grad(
            lambda p: j_tf.lm_loss(jcfg, p, jb), has_aux=True)(jparams)
        port = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
            trainable=True)
        with torch.no_grad():
            logits, _ = forward_train(tcfg, port, tb)
        assert _rel(_np(logits), want_logits) <= LOGIT_TOL
        port.flat.grad.zero_()
        loss, aux = lm_loss(tcfg, port, tb)
        loss.backward()
        assert set(aux) == set(jaux)
        assert _rel(loss.item(), float(jl)) <= RTOL
        for k in ("moe_load_balance", "moe_router_z"):
            assert _rel(aux[k].item(), float(jaux[k])) <= RTOL, k
        got = dict(_leaf_items(port.flat.tree(port.flat.grad)))
        want = dict(_leaf_items(jax.tree.map(np.asarray, jg)))
        assert got.keys() == want.keys()
        assert any("A_log" in k for k in got)
        for k in want:
            assert _rel(got[k].numpy(), want[k]) <= GRAD_TOL, k

    def test_training_scan_is_the_plain_one(self, model, monkeypatch):
        """Under grad the scan bypasses the kernel wrapper."""
        _, jparams, tcfg, _ = model

        def refuse(*a, **kw):
            raise AssertionError("ops.selective_scan ran under grad")

        monkeypatch.setattr(ops, "selective_scan", refuse)
        port = convert.lm_params_from_arrays(
            tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
            trainable=True)
        loss, _ = lm_loss(tcfg, port, {"tokens": _t(_tokens(tcfg, 1, 6))})
        loss.backward()
        assert bool(torch.isfinite(port.flat.grad).all())


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
        mixer = {k.rsplit("/", 1)[1] for k in got if "/mixer/" in k}
        assert {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                "dt_bias", "A_log", "D", "out_proj"} <= mixer
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k

    def test_arrays_in_the_reference_layout(self, model):
        jcfg, jparams, _, tparams = model
        layer = tparams.layers[0]["mixer"]
        stacked = jparams["stack"]["0"]["mixer"]
        for k in ("in_proj", "conv_w", "x_proj", "A_log", "out_proj"):
            assert np.array_equal(_np(layer[k]), np.asarray(stacked[k][0]))
        assert tuple(layer["in_proj"].shape) == (jcfg.d_model, 2,
                                                 2 * jcfg.d_model)


class TestLaunchers:
    def test_lm_serve_reduced_cpu(self, capsys, monkeypatch):
        calls = []
        real = ops.selective_scan
        monkeypatch.setattr(ops, "selective_scan", lambda *a, **kw: (
            calls.append(1) or real(*a, **kw)))
        res = lm_serve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                             "--prompt-len", "12", "--gen", "4", "--device",
                             "cpu"])
        assert res.tokens.shape == (2, 4)
        assert bool(torch.isfinite(res.prefill_logits).all())
        assert "decoded 4 tokens x batch 2" in capsys.readouterr().out
        assert len(calls) == 7  # the reduced period's Mamba layers

    def test_lm_profile_reduced_cpu_at_depth_5(self):
        from repro_torch.launch import lm_profile

        out = lm_profile.main(["--arch", ARCH, "--reduced", "--layers", "5",
                               "--prompt-len", "16", "--gen", "3",
                               "--device", "cpu", "--dtype", "bfloat16"])
        assert out["n_layers"] == 5
        assert out["decode_steps"] == 2 and out["dtype"] == "bfloat16"
        assert out["flash_roles"]["self"]["launches"] == 1
        assert out["prefill"]["busy_share"] is None

    def test_kernel_group(self):
        from repro_torch.launch import lm_profile

        assert lm_profile.kernel_group(
            "void (anonymous namespace)::selective_scan_kernel"
            "<__nv_bfloat16, 16>(...)") == "selective_scan"


class TestScanTools:
    """The scan kernel's measuring tools, as far as they run without a
    card: the kernel group of the redesigned kernel's name, the SASS
    counter, the model-view inputs and the exponentials' floor."""

    def test_kernel_group_of_the_redesigned_kernel(self):
        from repro_torch.launch import lm_profile

        assert lm_profile.kernel_group(
            "void (anonymous namespace)::selective_scan_kernel"
            "<__nv_bfloat16, 16, true>((anonymous namespace)::Args)"
        ) == "selective_scan"

    def test_sass_report_reads_the_main_loop(self, tmp_path, monkeypatch):
        from repro_torch.launch import kernel_bench

        sass = tmp_path / "lib.sass"
        sass.write_text(
            "\tcode for sm_90a\n\t\tFunction : _Z21selective_scan_kernelv\n"
            "        /*0000*/                   S2R R0, SR_TID.X ;\n"
            "        /*0010*/                   FMUL R2, R0, R1 ;\n"
            "        /*0020*/                   MUFU.EX2 R3, R2 ;\n"
            "        /*0030*/                   FFMA R4, R3, R4, R5 ;\n"
            "        /*0040*/                   MUFU.EX2 R3, R2 ;\n"
            "        /*0050*/              @!P0 BRA 0x10 ;\n"
            "        /*0060*/                   EXIT ;\n"
            "\t\tFunction : _Z5otherv\n"
            "        /*0000*/                   EXIT ;\n")
        tool = tmp_path / "cuobjdump"
        tool.write_text('#!/bin/sh\ncat "$2"\n')
        tool.chmod(0o755)
        monkeypatch.setattr(kernel_bench, "_cuobjdump", lambda: str(tool))
        rep = kernel_bench.sass_report(sass, "selective_scan")
        assert list(rep) == ["_Z21selective_scan_kernelv"]
        got = rep["_Z21selective_scan_kernelv"]
        assert (got["instructions"], got["mufu_ex2"]) == (7, 2)
        assert (got["loop_instructions"], got["loop_mufu_ex2"]) == (5, 2)
        assert got["loop_per_ex2"] == 2.5
        assert got["loop_opcodes"] == {"FMUL": 1, "MUFU": 2, "FFMA": 1,
                                       "BRA": 1}

    def test_scan_inputs_reads_b_and_c_from_a_projection(self):
        from repro_torch.launch import kernel_bench

        gen = torch.Generator().manual_seed(0)
        dt, xc, Bm, Cm, A = kernel_bench.scan_inputs(
            torch, "cpu", gen, 2, 5, 8, 4, torch.bfloat16, proj=20)
        assert dt.shape == xc.shape == (2, 5, 8) and A.shape == (8, 4)
        assert Bm.shape == Cm.shape == (2, 5, 4)
        assert Bm.stride() == Cm.stride() == (100, 20, 1)
        assert Cm.data_ptr() - Bm.data_ptr() == 4 * Bm.element_size()
        assert bool((dt >= 1e-3 * 0.99).all() and (dt <= 0.1 * 1.01).all())
        assert bool((A < 0).all())

    def test_exp_floor(self):
        from repro_torch.launch import kernel_bench

        n_exp = kernel_bench.selective_scan_work(2, 8192, 16384, 16, 2)[2]
        assert n_exp == 2 * 8192 * 16384 * 16
        assert abs(kernel_bench.exp_floor_ms(n_exp, 132, 1.98e9)
                   - 1.0271) < 1e-4


#: the exponential forms :func:`emulated_scan_y` knows
EXP_FORMS = ("float64", "expf", "ex2", "ex2_2ulp", "ex2_bias")


def emulated_scan_y(form, seed=0, S=2048, di=64, ds=16):
    """y of the scan kernel's arithmetic, emulated in numpy: float32
    products and fused multiply-adds rounded once each, time in order,
    y's sum over the state in order; on the inputs ``chip_smoke.py``'s
    float64 check draws (dt log-uniform in [1e-3, 1e-1], xc, B and C
    standard normal, all bfloat16; A = -(1..ds)).  The exponential
    exp(dt * A) takes one of :data:`EXP_FORMS`: ``float64``, everything in
    float64 (the answer); ``expf``, exp(fl(dt * A)) rounded once, as a
    correctly rounded ``expf``; ``ex2``, 2^fl(dt * fl(A log2 e)) rounded
    once, the kernel's argument with an exact ``exp2``; ``ex2_2ulp``, as
    ``ex2`` times 1 + u 2^-23 with u uniform in [-1, 1] (a seeded random
    error within ``ex2.approx``'s 2 ulp); ``ex2_bias``, as ``ex2`` times
    1 - 2^-24 (one ulp low, every time)."""
    f32, f64 = np.float32, np.float64
    rng = np.random.default_rng(seed)

    def bf16(x):
        return _np(torch.from_numpy(np.asarray(x, f32)).to(
            torch.bfloat16).float())

    dt = bf16(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (S, di))))
    xc, Bm, Cm = (bf16(rng.standard_normal(shape))
                  for shape in ((S, di), (S, ds), (S, ds)))
    A = -np.tile(np.arange(1, ds + 1, dtype=f32), (di, 1))
    A2 = (A * f32(np.log2(np.e))).astype(f32)
    bx = bf16(dt * xc)  # the reference's dtype point, as the kernel's
    h = np.zeros((di, ds), f64 if form == "float64" else f32)
    y = np.zeros((S, di))
    for t in range(S):
        d = dt[t][:, None]
        if form == "float64":
            h = np.exp(d.astype(f64) * A) * h + bx[t][:, None] * Bm[t]
            y[t] = (h * Cm[t]).sum(1)
            continue
        if form == "expf":
            e = np.exp((d * A).astype(f64))
        else:
            e = np.exp2((d * A2).astype(f64))
            if form == "ex2_2ulp":
                e = e * (1 + 2.0 ** -23 * rng.uniform(-1, 1, e.shape))
            elif form == "ex2_bias":
                e = e * (1 - 2.0 ** -24)
        e = e.astype(f32)
        h = (e.astype(f64) * h + (bx[t][:, None] * Bm[t]).astype(f32)
             ).astype(f32)
        acc = np.zeros(di, f32)
        for n in range(ds):
            acc = (h[:, n].astype(f64) * Cm[t, n] + acc).astype(f32)
        y[t] = acc
    return y


@pytest.fixture(scope="module")
def scan_rms():
    """RMS of y against the float64 answer, by exponential form."""
    want = emulated_scan_y("float64")
    return {form: float(np.sqrt(((emulated_scan_y(form) - want) ** 2)
                                .mean())) for form in EXP_FORMS[1:]}


class TestScanExponentError:
    """Where the kernel's error against float64 comes from, by the
    emulation above.  On the card (an H100) the kernel's RMS error of y is
    2.2x the plain float32 scan's, where PR 23's ``expf`` kernel was 1.0x;
    ``chip_smoke.py`` holds it to ``SCAN_ERR_FACTOR`` = 4x.  Rounding A'
    = A log2 e once a state adds nothing; an unbiased error of up to
    2 ulp in each exponential gives ~1.9x; a bias of one ulp would give
    ~8x, which the factor of 4 catches."""

    def test_prescaled_argument_adds_no_error(self, scan_rms):
        assert scan_rms["ex2"] <= 1.1 * scan_rms["expf"]

    def test_unbiased_two_ulp_error_fits_the_smoke_factor(self, scan_rms):
        ratio = scan_rms["ex2_2ulp"] / scan_rms["expf"]
        assert 1.5 <= ratio <= 2.5

    def test_a_biased_exponential_fails_the_smoke_factor(self, scan_rms):
        assert scan_rms["ex2_bias"] > 4 * scan_rms["expf"]
