"""A whole run of a tiny cell on the CPU: the last line's keys, the
metrics each cell reports, and the run's refusals."""

import json
import subprocess
import sys

import pytest

from bench_tiny import DECODE_MIX, PREFILL_MIX, run_tiny, tiny_cell
from harness.manifest import BENCH, ROOT, load_manifest, metric_entries

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name,family,mix", [
    ("jamba.prefill", "jamba", PREFILL_MIX),
    ("qwen_moe.prefill", "qwen", PREFILL_MIX),
    ("jamba.decode", "jamba", DECODE_MIX)])
def test_result_line(name, family, mix, trace):
    cell, port = tiny_cell(name, family, mix)
    out = run_tiny(cell, port, trace=trace)
    out = {k: v for k, v in out.items() if not k.startswith("_")}
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    entries = cell.per_layer if trace else cell.end_to_end
    for m in entries:
        if trace and m["source"] == "device_trace" and "idle" not in \
                m["name"]:
            continue  # no device operations on the CPU
        assert m["name"] in out["metrics"], m["name"]
        assert out["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = load_manifest()
    for w in man["workloads"]:
        m = metric_entries(man, w["name"])
        names = [e["name"] for e in m["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert m["per_layer"], w["name"]
        assert {e["moves"] for e in m["per_layer"]} <= set(names)


def test_every_metric_has_a_reader():
    man = load_manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_refuses_without_a_card_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "jamba.prefill", "--seed", str(2**31 + 3),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "{" not in p.stdout


def test_refuses_without_the_port(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "jamba.prefill", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("name,want", [("rel_max", 0.5), ("rel_mean", 0.2),
                                       ("rel_p50", 0.1),
                                       ("rel_over0.05", 0.6),
                                       ("rel_over0.3", 0.4)])
def test_the_comparisons_statistics(name, want):
    import torch

    from harness import check

    r = {"rel": torch.tensor([0.01, 0.02, 0.1, 0.37, 0.5]),
         "gap": torch.zeros(5)}
    assert check.number(r, name) == pytest.approx(want)
