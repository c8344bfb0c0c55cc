"""A run with the timed path broken underneath does not read correct.

Each fault that a one-card serving cell can have is planted in the
system under test and a whole tiny run is made on the CPU, the
harness's look for a card skipped, under the cell's own limits:

* a step that returns its state unchanged: every FFN sublayer hands its
  input back (prefill and decode), and a decode step hands back the
  caches it was given, so the Mamba states never move;
* half of the batch left out: the program computes the first half of
  the sequences only and answers the second half with the first half's
  logits and tokens (full-shape output, the rest wrong);
* an answer altered where it is produced: every served row's logits
  shifted by one token, and the tokens with them.

The exchange between chips does not exist in a one-card cell.  A fault
confined to one served row (one token or one row's logits) is not
caught by the prefill cells' numbers: see PERF.md, Open questions."""

import pytest
import torch

from bench_tiny import DECODE_MIX, PREFILL_MIX, run_tiny, tiny_cell


def faulty(port, fault, monkeypatch):
    real_serve, real_step = port.serve_call, port.decode_step
    if fault == "ffn_unchanged":
        from repro_torch.models import transformer

        monkeypatch.setattr(transformer, "_apply_ffn",
                            lambda cfg, params, sub, x, aux, decode=False:
                            (x, aux))

    def altered(logits):
        return torch.roll(logits, 1, dims=-1)

    def first_half(t, B):
        return t[torch.arange(B) % ((B + 1) // 2)]

    def serve_call(model, tokens):
        if fault == "half_batch":
            B = tokens.shape[0]
            tok, logits = real_serve(model, tokens[:(B + 1) // 2])
            return first_half(tok, B), first_half(logits, B)
        tok, logits = real_serve(model, tokens)
        if fault == "altered":
            logits = altered(logits)
            tok = logits.argmax(-1)
        return tok, logits

    def decode_step(model, caches, tokens, pos):
        logits, new = real_step(model, caches, tokens, pos)
        if fault == "half_batch":
            return first_half(logits, logits.shape[0]), new
        if fault == "stale_state":
            return logits, caches
        if fault == "altered":
            logits = altered(logits)
        return logits, new

    port.serve_call, port.decode_step = serve_call, decode_step
    return port


PREFILL_FAULTS = ("ffn_unchanged", "half_batch", "altered")
CASES = [(c, f, PREFILL_MIX, x) for c, f in (("jamba.prefill", "jamba"),
                                            ("qwen_moe.prefill", "qwen"))
         for x in PREFILL_FAULTS]
CASES += [("jamba.decode", "jamba", DECODE_MIX, x)
          for x in PREFILL_FAULTS + ("stale_state",)]


@pytest.mark.parametrize("name,family,mix,fault", CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in CASES])
def test_fault_reads_incorrect(name, family, mix, fault, monkeypatch):
    cell, port = tiny_cell(name, family, mix)
    assert run_tiny(cell, port)["correct"] is True
    out = run_tiny(cell, faulty(port, fault, monkeypatch))
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba.prefill", "qwen_moe.prefill",
                                  "jamba.decode"])
def test_half_batch_fails_the_cells_limits_on_the_card(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the cell's own size")
    import time

    from harness.cell import run_cell
    from harness.manifest import load_cell, load_manifest
    from harness.port import Port

    cell = load_cell(load_manifest(), name)
    port = faulty(Port(cell.spec), "half_batch", monkeypatch)
    out = run_cell(cell, 2**31 + 979, 3.0, False, "cuda:0",
                   time.perf_counter(), log=lambda s: None, port=port)
    assert out["correct"] is False, out["checks"]
