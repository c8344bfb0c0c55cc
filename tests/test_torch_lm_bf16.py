"""The port's bfloat16 LM serving path against the JAX package, on the CPU.

The reference's model configs default to ``param_dtype="bfloat16"``, and
its production prefill writes bfloat16 caches.  Here both packages run
reduced gemma2_2b (a window of 8, both softcaps) and gemma_2b on the same
bfloat16 weights: the reference's ``init_params(..., dtype=bfloat16)``,
carried over exactly (bfloat16 widened to float32 is exact, and back) with
``convert.lm_params_from_arrays``.  Prefill logits and every KV cache are
compared, then 4 decode steps teacher-forced on the reference's greedy
tokens (greedy tokens may split at a near-tie in bfloat16).

Tolerance: ``max|port - ref| / max|ref|`` at most 5e-2 for logits and
caches; measured at 1.42e-2 or less here (the largest on gemma2_2b's
caches, its logits 1.05e-2 to 1.39e-2; gemma_2b 6.3e-3 to 8.5e-3).  The two
paths round at different places: the reference's prefill attention
rounds its scores and weights to bfloat16 (``repro/models/attention.py``,
``_grouped_attn``), while the port's goes through the flash-attention
wrapper, whose plain version (on the CPU) computes in float32 as the
Pallas kernel does, and on the card through the bfloat16 tensor-core
kernel.  Each bfloat16 rounding is 2^-9 relative, and a reduced stack
compounds a few dozen of them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import aligned  # noqa: E402
from repro_torch.models.transformer import decode_step, prefill  # noqa: E402

RTOL = 5e-2
ARCHS = ("gemma2_2b", "gemma_2b")
B, S0, STEPS = 2, 16, 4  # S0 > window 8: the local layers' ring caches


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _j_caches(jcfg, caches):
    out = []
    for p in range(jcfg.n_periods):
        for i in range(len(jcfg.period)):
            c = caches["stack"][str(i)]
            out.append((c.k[p], c.v[p]))
    for i in range(len(jcfg.remainder)):
        c = caches["rest"][str(i)]
        out.append((c.k, c.v))
    return out


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX bfloat16 params, port cfg, port params)."""
    out = {}
    for arch in ARCHS:
        jcfg = j_get_config(arch).reduced(param_dtype="bfloat16")
        tcfg = get_config(arch).reduced(param_dtype="bfloat16")
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0),
                                dtype=jnp.bfloat16)
        tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                            jparams)
        tparams = convert.lm_params_from_arrays(tcfg, tree, device="cpu")
        out[arch] = (jcfg, jparams, tcfg, tparams.to(torch.bfloat16))
    return out


@pytest.fixture(scope="module")
def runs(models):
    """arch -> per-step (port logits, reference logits) and the prefill's
    caches, the decode teacher-forced on the reference's tokens."""
    out = {}
    for arch, (jcfg, jparams, tcfg, tparams) in models.items():
        toks = np.random.default_rng(0).integers(1, tcfg.vocab_size,
                                                 (B, S0))
        max_len = S0 + STEPS
        jl, jc = jax.jit(lambda p, t: j_prefill(
            jcfg, p, {"tokens": t}, max_len=max_len))(jparams,
                                                      jnp.asarray(toks))
        tl, tc = prefill(tcfg, tparams, {"tokens": torch.as_tensor(toks)},
                         max_len=max_len)
        # decode writes the port's caches in place: keep the prefill's
        caches = ([(c.k.clone(), c.v.clone()) for c in tc],
                  _j_caches(jcfg, jc))
        logits = [(tl, jl)]
        jstep = jax.jit(lambda p, c, t, pos: j_decode_step(jcfg, p, c, t,
                                                           pos))
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None]
        for t in range(STEPS):
            jl, jc = jstep(jparams, jc, jt, jnp.asarray(S0 + t, jnp.int32))
            tl, tc = decode_step(tcfg, tparams, tc,
                                 torch.as_tensor(np.array(jt)), S0 + t)
            logits.append((tl, jl))
            jt = jnp.argmax(jl[:, 0], axis=-1)[:, None]
        out[arch] = (logits, caches)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_caches_are_bfloat16(models, runs, arch):
    _, _, tcfg, tparams = models[arch]
    assert tcfg.param_dtype == "bfloat16"
    assert all(p.dtype == torch.bfloat16 for p in tparams.parameters())
    tl, jl = runs[arch][0][0]
    assert tl.dtype == torch.bfloat16 and jl.dtype == jnp.bfloat16
    tc, jc = runs[arch][1]
    assert len(tc) == len(jc) == tcfg.n_layers
    for (k, _), (jk, _) in zip(tc, jc):
        assert k.dtype == torch.bfloat16 and jk.dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(runs, arch):
    tl, jl = runs[arch][0][0]
    assert tl.shape == (B, 1, jl.shape[-1])
    assert _rel(_np(tl), _np(jl)) <= RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_match_reference(runs, arch):
    tc, jc = runs[arch][1]
    for (k, v), (jk, jv) in zip(tc, jc):
        assert k.shape == jk.shape
        assert _rel(_np(k), _np(jk)) <= RTOL
        assert _rel(_np(v), _np(jv)) <= RTOL


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_reference(runs, arch, step):
    tl, jl = runs[arch][0][1 + step]
    assert _rel(_np(tl), _np(jl)) <= RTOL


def test_prefill_attention_goes_through_the_wrapper_in_bfloat16(
        models, monkeypatch):
    """Every layer's prefill attention reaches ``ops.flash_attention``
    with bfloat16 q, k and v (on the card: the tensor-core kernel)."""
    _, _, tcfg, tparams = models["gemma2_2b"]
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append(((q.dtype, k.dtype, v.dtype), kw["softcap"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, tcfg.vocab_size, (1, 12)))
    prefill(tcfg, tparams, {"tokens": toks}, max_len=14)
    assert len(seen) == tcfg.n_layers
    assert all(d == (torch.bfloat16,) * 3 for d, _ in seen)
    assert all(cap == tcfg.attn_softcap for _, cap in seen)


# ---- the launcher's copy decision (a pure function, no card needed) ----

@pytest.mark.parametrize("itemsize,ptr,strides,want", [
    # bfloat16: 16-byte start and strides of 8 elements (TMA)
    (2, 0, (8192, 1024, 256), True),
    (2, 16, (8 * 3, 8, 8), True),
    (2, 8, (8192, 1024, 256), False),     # start on 8 bytes
    (2, 0, (8192, 1028, 256), False),     # 8-byte (4-element) row stride
    (2, 0, (8192, 1024, 4), False),       # 8-byte head stride
    (2, 0, (4100, 1024, 256), False),     # 8-byte batch stride
    # float32: the same 16 bytes are 4 elements
    (4, 0, (8192, 1028, 256), True),
    (4, 16, (4, 4, 4), True),
    (4, 0, (8192, 1026, 256), False),
    (4, 4, (8192, 1024, 256), False),
])
def test_alignment_rule_is_sixteen_bytes(itemsize, ptr, strides, want):
    shape = (2, 8, 4, 256)
    assert aligned(ptr, shape, strides + (1,), itemsize) is want


def test_alignment_rule_ignores_size_one_dims_and_refuses_zero_strides():
    # a zero stride of a dimension with one entry is never stepped over
    assert aligned(0, (1, 8, 4, 64), (0, 256, 64, 1), 2)
    # an expanded (stride-0) dimension is copied rather than read in place
    assert not aligned(0, (2, 8, 4, 64), (0, 256, 64, 1), 2)


@pytest.mark.parametrize("dtype,step", [(torch.bfloat16, 8),
                                        (torch.float32, 4)])
def test_alignment_rule_on_real_views(dtype, step):
    """Views of a (B, S, 2 heads, 64) tensor: the head slice keeps its
    strides; a slice of the head dim by one element shifts the start."""
    base = torch.zeros(2, 8, 2, 64 + step, dtype=dtype)
    view = base[..., :64]
    assert aligned(view.data_ptr(), view.shape, view.stride(),
                   view.element_size()) is (base.data_ptr() % 16 == 0)
    half = torch.zeros(2, 8, 2, 64 + step // 2, dtype=dtype)[..., :64]
    assert not aligned(half.data_ptr(), half.shape, half.stride(),
                       half.element_size())


# ---- lm_profile --dtype ----

def test_profile_runs_in_bfloat16_on_the_cpu():
    """``lm_profile --dtype bfloat16`` serves the config's own bfloat16
    weights; without a card it records no device time."""
    from repro_torch.launch import lm_profile

    out = lm_profile.main(["--reduced", "--prompt-len", "10", "--gen", "3",
                           "--device", "cpu", "--dtype", "bfloat16"])
    assert out["dtype"] == "bfloat16" and out["decode_steps"] == 2
    for p in ("prefill", "decode"):
        assert out[p]["wall_ms"] > 0 and out[p]["kernels"] == []


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::flash_bf16_kernel<4, true>(CUtensorMap_st,"
    " CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
    "void (anonymous namespace)::flash_fwd_kernel<256>((anonymous "
    "namespace)::Params)",
])
def test_profile_groups_both_flash_kernels(name):
    from repro_torch.launch.lm_profile import kernel_group

    assert kernel_group(name) == "flash_attention"


def test_profile_groups_cublas_nvjet_kernels_as_matmul():
    """cuBLAS's bfloat16 GEMMs on Hopper are ``nvjet_*`` kernels."""
    from repro_torch.launch.lm_profile import kernel_group

    assert kernel_group("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN") == \
        "matmul"
