"""The port's flash attention against the JAX package's, on the CPU.

Identical numpy inputs go to the Pallas kernel (``repro.kernels.ops``,
interpret mode, 64 x 64 blocks, as ``tests/test_kernels.py`` runs it), to
``repro.kernels.ref.ref_attention`` and to the port's wrapper on CPU
tensors, which takes the plain PyTorch version (materialised float32
scores).  Tolerances are ``TestFlashAttention``'s: 2e-5 in float32 (the
online softmax and the one-shot softmax round differently), 2e-2 in
bfloat16 (inputs and output rounded to 8 bits of mantissa; the inputs are
rounded identically on both sides).  The CUDA kernel is held against the
plain version on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402

#: TestFlashAttention's sweep: B, S, nq, nkv, hd, causal, window, softcap
SWEEP = [
    (1, 128, 4, 4, 64, True, None, None),   # MHA causal
    (2, 256, 8, 2, 64, True, None, None),   # GQA 4:1
    (2, 128, 4, 1, 128, True, None, None),  # MQA
    (1, 256, 4, 2, 64, True, 64, None),     # sliding window
    (1, 128, 2, 2, 64, True, None, 30.0),   # softcap (gemma2)
    (2, 128, 4, 4, 64, False, None, None),  # bidirectional
    (1, 256, 8, 2, 64, True, 32, 50.0),     # window + cap + GQA
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, qshape, kshape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(qshape).astype(np.float32),
            r.standard_normal(kshape).astype(np.float32),
            r.standard_normal(kshape).astype(np.float32))


def _port(arrays, tdt, **kw):
    q, k, v = (torch.as_tensor(a).to(tdt) for a in arrays)
    return ops.flash_attention(q, k, v, **kw).float().numpy()


def _jax(fn, arrays, jdt, **kw):
    q, k, v = (jnp.asarray(a, jdt) for a in arrays)
    return np.asarray(fn(q, k, v, **kw), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,nq,nkv,hd,causal,window,softcap", SWEEP)
def test_sweep_matches_pallas_and_ref(dtype, B, S, nq, nkv, hd, causal,
                                      window, softcap):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(S * nq + hd, (B, S, nq, hd), (B, S, nkv, hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _port(arrays, tdt, **kw)
    assert got.shape == (B, S, nq, hd)
    pallas = _jax(jops.flash_attention, arrays, jdt, block_q=64, block_kv=64,
                  **kw)
    want = _jax(jref.ref_attention, arrays, jdt, **kw)
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_q_offset_192():
    """Decode-style: 64 queries at positions 192.. against 256 keys."""
    arrays = _inputs(7, (2, 64, 4, 64), (2, 256, 4, 64))
    got = _port(arrays, torch.float32, causal=True, q_offset=192)
    for fn, extra in ((jops.flash_attention, dict(block_q=64, block_kv=64)),
                      (jref.ref_attention, {})):
        want = _jax(fn, arrays, jnp.float32, causal=True, q_offset=192,
                    **extra)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_are_zero():
    """Queries at negative positions see no key under the causal mask:
    their rows come out as zeros in all three, not as a uniform average."""
    arrays = _inputs(11, (1, 64, 2, 32), (1, 64, 2, 32))
    kw = dict(causal=True, window=8, q_offset=-10)
    got = _port(arrays, torch.float32, **kw)
    assert np.all(got[:, :10] == 0.0)
    assert np.all(np.abs(got[:, 10:]).sum(-1) > 0)
    for fn, extra in ((jops.flash_attention, dict(block_q=64, block_kv=64)),
                      (jref.ref_attention, {})):
        want = _jax(fn, arrays, jnp.float32, **kw, **extra)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Skv,q_offset,window,softcap", [
    (50, 77, 27, None, None),   # ragged, last query sees every key
    (77, 50, -27, 20, 50.0),    # more queries than keys, window + cap
])
def test_ragged_lengths_match_ref(Sq, Skv, q_offset, window, softcap):
    arrays = _inputs(Sq + Skv, (2, Sq, 4, 32), (2, Skv, 2, 32))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    got = _port(arrays, torch.float32, **kw)
    want = _jax(jref.ref_attention, arrays, jnp.float32, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("qshape,kshape,vshape,match", [
    ((1, 64, 4, 64), (64, 2, 64), (64, 2, 64), "expected"),
    ((1, 64, 4, 64), (1, 64, 2, 64), (1, 32, 2, 64), "k/v mismatch"),
    ((1, 64, 3, 64), (1, 64, 2, 64), (1, 64, 2, 64), "not a multiple"),
])
def test_rejects_bad_shapes(qshape, kshape, vshape, match):
    q, k, v = (torch.zeros(s) for s in (qshape, kshape, vshape))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        jops.flash_attention(*(jnp.zeros(s) for s in (qshape, kshape, vshape)))


def test_cpu_calls_are_not_counted():
    ops.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 16)
    ops.flash_attention(q, q, q)
    assert ops.launch_counts()["flash_attention"] == 0
