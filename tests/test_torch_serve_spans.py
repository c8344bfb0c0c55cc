"""The LM serving path's spans and counters (``telemetry.serving``).

Under ``torch.profiler`` a reduced Jamba (depth 5: Mamba, attention,
dense and MoE layers) and a reduced Qwen1.5-MoE (shared experts) serve
through ``lm_serve.serve``: every range is a registered span, and the
ranges nest as the serving path does (a layer holds one mixer and one
FFN; a MoE sublayer its route, dispatch, experts and combine; a Mamba
mixer its projections, conv, selective parameters and scan).  With no
profiler the spans are one shared null context, no counter moves, and
the tokens and logits are the traced run's bit for bit.  The MoE
counters are held to the routing they count.  A ``cuda`` test proves
on the card that spans and counters take no synchronise.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import lm_serve
from repro_torch.models import decode_step, moe as moe_mod, prefill
from repro_torch.telemetry import SERVE_COUNTERS, SERVE_SPANS, serving

MIXERS = {n for n in SERVE_SPANS if n.startswith("lm.mixer.")}
FFNS = {"lm.ffn.mlp", "lm.moe"}
MOE_PARTS = {"lm.moe.route", "lm.moe.dispatch", "lm.moe.experts",
             "lm.moe.combine"}
MAMBA_PARTS = {"lm.mamba.proj", "lm.mamba.conv", "lm.mamba.ssm",
               "lm.mamba.scan"}


def _cfg(family, capacity_factor=None):
    if family == "jamba":
        cfg = dataclasses.replace(
            lm_serve.make_config("jamba_1p5_large_398b", reduced=True),
            n_layers=5)
    else:
        cfg = dataclasses.replace(
            lm_serve.make_config("qwen2_moe_a2p7b", reduced=True),
            n_layers=2)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _model(family, device="cpu", **kw):
    cfg = _cfg(family, **kw)
    params = lm_serve.make_params(cfg, torch.device(device), seed=1)
    prompt = lm_serve.make_prompt(cfg, 2, 12, torch.device(device))
    return cfg, params, prompt


def _traced(fn, cuda=False):
    """``fn()`` under the profiler: (its result, the program's host
    ranges as (name, start_ns, end_ns), in order of start)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
    from torch.autograd import DeviceType

    ranges = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.is_user_annotation() and e.device_type() == DeviceType.CPU),
        key=lambda r: (r[1], -r[2]))
    return out, ranges


def _nesting(ranges):
    """(the index of each range's parent or None, {index: [names of the
    ranges directly inside it]}), nesting by time."""
    parent, kids = [], {i: [] for i in range(len(ranges))}
    stack = []
    for i, (name, a, b) in enumerate(ranges):
        while stack and ranges[stack[-1]][2] <= a:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        if stack:
            assert b <= ranges[stack[-1]][2], (name, ranges[stack[-1]][0])
            kids[stack[-1]].append(name)
        stack.append(i)
    return parent, kids


@pytest.fixture(autouse=True)
def _zeroed():
    serving.reset_serve_counters()
    yield
    serving.reset_serve_counters()


@pytest.mark.parametrize("family", ["jamba", "qwen"])
def test_every_range_is_a_registered_span_and_they_nest(family):
    cfg, params, prompt = _model(family)
    gen = 3
    _, ranges = _traced(lambda: lm_serve.serve(cfg, params, prompt, gen))
    names = [r[0] for r in ranges]
    assert set(names) <= set(SERVE_SPANS), set(names) - set(SERVE_SPANS)
    parent, kids = _nesting(ranges)
    passes = gen  # the prefill and gen - 1 decode steps
    assert names.count("lm.layer") == cfg.n_layers * passes
    assert names.count("lm.embed") == names.count("lm.head") == passes
    assert names.count(lm_serve.SYNC) == 3
    moe_layers = sum(1 for layer in params.layers if layer.kind[1] == "moe")
    assert names.count("lm.moe") == moe_layers * passes > 0
    for i, (name, _, _) in enumerate(ranges):
        if name == "lm.layer":
            assert len([k for k in kids[i] if k in MIXERS]) == 1
            assert len([k for k in kids[i] if k in FFNS]) == 1
        elif name == "lm.moe":
            want = MOE_PARTS | ({"lm.moe.shared"} if cfg.moe.n_shared
                                else set())
            assert sorted(kids[i]) == sorted(want), kids[i]
        elif name == "lm.mixer.mamba":
            assert set(kids[i]) == MAMBA_PARTS
            assert kids[i].count("lm.mamba.proj") == 2
        elif name in MAMBA_PARTS:
            assert ranges[parent[i]][0] == "lm.mixer.mamba"
        elif name in MOE_PARTS:
            assert ranges[parent[i]][0] == "lm.moe"
    for phase in (lm_serve.PREFILL, lm_serve.DECODE):
        assert names.count(phase) == 1


def test_the_registry_names_every_mixer_and_the_serve_ranges():
    assert set(serving.MIXER_SPANS.values()) <= set(SERVE_SPANS)
    for name in (lm_serve.PREFILL, lm_serve.DECODE, lm_serve.SYNC):
        assert name in SERVE_SPANS
    assert all(SERVE_SPANS.values()) and all(SERVE_COUNTERS.values())


def test_without_a_profiler_a_span_is_the_shared_null_context():
    a, b = serving.span("lm.layer"), serving.span("lm.moe")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert not serving.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert serving.recording()
        assert isinstance(serving.span("lm.layer"),
                          torch.profiler.record_function)


@pytest.mark.parametrize("family", ["jamba", "qwen"])
def test_untraced_counts_nothing_and_equals_the_traced_run(family):
    cfg, params, prompt = _model(family)
    plain = lm_serve.serve(cfg, params, prompt, 4, keep_logits=True)
    assert serving.serve_counters() == {}
    traced, _ = _traced(lambda: lm_serve.serve(cfg, params, prompt, 4,
                                               keep_logits=True))
    assert serving.serve_counters()  # the traced run counted
    assert torch.equal(plain.tokens, traced.tokens)
    assert torch.equal(plain.prefill_logits, traced.prefill_logits)
    for a, b in zip(plain.step_logits, traced.step_logits, strict=True):
        assert torch.equal(a, b)


def _routed(monkeypatch):
    """Every routing ``moe_ffn`` makes, appended to the list returned."""
    seen = []
    real = moe_mod.route

    def route(cfg, params, xt):
        r = real(cfg, params, xt)
        seen.append(r.top_e.clone())
        return r

    monkeypatch.setattr(moe_mod, "route", route)
    return seen


def test_capacity_counters_hold_to_the_routing(monkeypatch):
    cfg, params, prompt = _model("qwen", capacity_factor=0.5)
    seen = _routed(monkeypatch)
    _traced(lambda: prefill(cfg, params, {"tokens": prompt}, max_len=16))
    got = serving.serve_counters()
    T, k, E = prompt.numel(), cfg.moe.top_k, cfg.moe.padded_experts
    C = moe_mod.capacity(cfg, T)
    assert len(seen) == cfg.n_layers
    dropped = sum(int(np.maximum(np.bincount(e.reshape(-1).numpy(),
                                             minlength=E) - C, 0).sum())
                  for e in seen)
    assert got["moe.dropped"] == dropped > 0
    assert got["moe.slots"] == E * C * len(seen)
    assert got["moe.assignments"] == T * k * len(seen)
    assert "moe.experts_gathered" not in got


def test_decode_counters_hold_to_the_routing(monkeypatch):
    cfg, params, prompt = _model("jamba")
    _, caches = prefill(cfg, params, {"tokens": prompt}, max_len=16)
    seen = _routed(monkeypatch)
    toks = prompt[:, -1:]
    _traced(lambda: decode_step(cfg, params, caches, toks, 12))
    got = serving.serve_counters()
    E, T = cfg.moe.padded_experts, prompt.shape[0]
    assert len(seen) == 2
    assert got["moe.experts_gathered"] == min(E, T * cfg.moe.top_k) * 2
    assert got["moe.experts_picked"] == sum(len(set(e.reshape(-1).tolist()))
                                            for e in seen)
    assert "moe.slots" not in got


def test_the_streamed_experts_are_counted_on_the_card_only():
    """``moe.experts_streamed`` is registered; a CPU decode copies the
    picked experts and counts them as gathered, never as streamed."""
    assert "in place" in SERVE_COUNTERS["moe.experts_streamed"]
    cfg, params, prompt = _model("jamba")
    _, caches = prefill(cfg, params, {"tokens": prompt}, max_len=16)
    _traced(lambda: decode_step(cfg, params, caches, prompt[:, -1:], 12))
    got = serving.serve_counters()
    assert got["moe.experts_gathered"] > 0
    assert "moe.experts_streamed" not in got


@pytest.mark.cuda
def test_spans_and_counters_take_no_synchronise():
    """A prefill and a decode step on the card, untraced and then traced
    with the counters on, under the CUDA sync debug mode's "error": none
    of them synchronises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, params, prompt = _model("jamba", device="cuda")

    def calls():
        logits, caches = prefill(cfg, params, {"tokens": prompt},
                                 max_len=16)
        return decode_step(cfg, params, caches, logits.argmax(-1), 12)

    def run(traced):
        """The calls with any synchronise an error (the profiler's own,
        as it stops, outside)."""
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with (profile(activities=acts) if traced
              else contextlib.nullcontext()):
            torch.cuda.set_sync_debug_mode("error")
            try:
                calls()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    calls()  # the kernel library's build, cuBLAS handles
    run(False)
    serving.reset_serve_counters()
    run(True)
    got = serving.serve_counters()
    # the card's decode reads the picked experts in place: none is copied
    assert got["moe.assignments"] > 0 and got["moe.experts_streamed"] > 0
    assert "moe.experts_gathered" not in got
