"""The reference against the port's plain CPU path on the same float32
weights: prefill logits (with capacity drops) and decode steps after a
prefill, for both families; and the fp8 control well away from both."""

import pytest
import torch

from bench_tiny import tiny
from harness.port import Port
from harness.reference import Reference, state_rows
from harness.weights import make_weights

SEED = 2**31 + 101


def _setup(family, capacity_factor=1.25):
    spec, cfg = tiny(family, capacity_factor)
    port = Port(spec, cfg)
    w = make_weights(spec, SEED, "cpu", dtype=torch.float32)
    return spec, port, port.build_model(w), w


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("family", ["jamba", "qwen"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_prefill_logits_match(family, cf):
    spec, port, model, w = _setup(family, cf)
    tokens = torch.randint(1, spec.vocab, (4, 48),
                           generator=torch.Generator().manual_seed(3))
    _, got = port.serve_call(model, tokens)
    want, _ = Reference(spec, w).forward(tokens, capacity=True)
    assert _rel(got, want[:, 0]) < 1e-4


def test_capacity_half_drops_assignments():
    """At capacity factor 0.5 some assignments must drop, and the
    reference dropping none differs: the drops are being compared."""
    spec, port, model, w = _setup("qwen", 0.5)
    tokens = torch.randint(1, spec.vocab, (4, 48),
                           generator=torch.Generator().manual_seed(3))
    _, got = port.serve_call(model, tokens)
    dropless, _ = Reference(spec, w).forward(tokens, capacity=False)
    assert _rel(got, dropless[:, 0]) > 1e-3


@pytest.mark.parametrize("family", ["jamba", "qwen"])
def test_decode_steps_match_the_reference_after_its_prefill(family):
    spec, port, model, w = _setup(family)
    B, S0, n = 5, 24, 6
    prompt = torch.randint(1, spec.vocab, (B, S0),
                           generator=torch.Generator().manual_seed(4))
    logits, caches = port.prefill(model, prompt, S0 + n + 1)
    toks = logits.argmax(-1)[:, None]
    got, fed = [logits], [toks]
    for t in range(n):
        logits, caches = port.decode_step(model, caches, toks, S0 + t)
        toks = logits.argmax(-1)[:, None]
        got.append(logits)
        fed.append(toks)
    ref = Reference(spec, w)
    rows = torch.tensor([1, 3])
    p, st = ref.forward(prompt, capacity=True)
    c, _ = ref.forward(torch.cat(fed, 1)[rows, :n], state_rows(st, rows),
                       pos0=S0, capacity=False, want=torch.arange(n))
    want = torch.cat([p[rows], c], 1)
    assert _rel(torch.stack(got, 1)[rows], want) < 1e-4


@pytest.mark.parametrize("family", ["jamba", "qwen"])
def test_fp8_control_differs(family):
    spec, port, model, w = _setup(family)
    tokens = torch.randint(1, spec.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(5))
    want, _ = Reference(spec, w).forward(tokens)
    ctl, _ = Reference(spec, w, "fp8").forward(tokens)
    assert _rel(ctl, want) > 1e-2
