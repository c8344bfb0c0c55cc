"""The control: the float32 reference computed in fp8 (the precision
below the configurations' bfloat16) in the program's place.  It has to
read as not correct under each cell's limits, on the card at the cell's
own size (the ``cuda`` tests, run there), and it reads well apart from
the program at a small size on the CPU."""

import pytest
import torch

from bench_tiny import DECODE_MIX, PREFILL_MIX, run_tiny, tiny_cell
from harness import check

SEEDS = [2**31 + s for s in range(3)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,family", [("jamba.prefill", "jamba"),
                                         ("qwen_moe.prefill", "qwen")])
def test_tiny_prefill_control_reads_far_from_the_program(name, family,
                                                         seed):
    cell, port = tiny_cell(name, family, PREFILL_MIX)
    out = run_tiny(cell, port, seed=seed, controls=("fp8",))
    for n in ("rel_p50", "rel_p75"):
        program = check.number(out["_rows"]["program"], n)
        assert check.number(out["_rows"]["fp8"], n) > 3 * program


@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_decode_control_serves_other_tokens(seed):
    cell, port = tiny_cell("jamba.decode", "jamba", DECODE_MIX)
    out = run_tiny(cell, port, seed=seed, controls=("fp8",))
    for n in ("rel_p75", "gap_mean"):
        program = check.number(out["_rows"]["program"], n)
        assert check.number(out["_rows"]["fp8"], n) > 3 * program


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jamba.prefill", "qwen_moe.prefill",
                                  "jamba.decode"])
def test_control_fails_the_cells_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the cell's own size")
    import time

    from harness.cell import run_cell
    from harness.manifest import load_cell, load_manifest

    cell = load_cell(load_manifest(), name)
    out = run_cell(cell, 2**31 + 977, 3.0, False, "cuda:0",
                   time.perf_counter(), log=lambda s: None,
                   controls=("fp8",))
    assert out["correct"] is True, out["checks"]
    assert check.judge(out["_controls"]["fp8"],
                       cell.limits)["correct"] is False
