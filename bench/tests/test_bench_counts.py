"""The frozen FLOP and byte counts against hand counts."""

import pytest

from bench_tiny import tiny
from harness import counts
from harness.manifest import BENCH
from harness.spec import load_spec


def test_tiny_jamba_token_flops_by_hand():
    spec, _ = tiny("jamba")
    d, di, n, r, dc, f, E = 64, 128, 8, 4, 4, 96, 4
    mamba = d * 2 * di + dc * di + di * (r + 2 * n) + r * di + di * d
    attn = 2 * d * 4 * 16 + 2 * d * 2 * 16
    mlp = 3 * d * f
    moe = d * E + 2 * 3 * d * f  # router over the real experts, top-2
    # layers: (mamba, mlp) (mamba, moe) (mamba, mlp) (mamba, moe) (attn, mlp)
    want = 2 * (4 * mamba + attn + 3 * mlp + 2 * moe)
    assert counts.token_flops(spec) == want


def test_tiny_qwen_prefill_flops_by_hand():
    spec, _ = tiny("qwen")
    d, hd, H, f, E, V = 64, 16, 4, 32, 6, 512
    layer = 4 * d * H * hd + d * E + 4 * 3 * d * f + 3 * d * 64
    B, S = 2, 64
    want = (2 * 2 * layer * B * S + 2 * 2 * B * S * S * H * hd
            + 2 * B * d * V)
    assert counts.prefill_flops(spec, B, S) == want


def test_scan_bytes_at_the_kernel_tables_shape():
    """PERF.md's selective_scan row: (2, 8192, 16384) bfloat16, d_state
    16, bound 0.6423 ms at 3.35 TB/s."""
    spec = load_spec(BENCH / "configs" / "jamba-1.5-large-d5.json")
    s = counts.scan_bytes(spec, 2, 8192) / counts.HBM_BYTES_S
    assert s * 1e3 == pytest.approx(0.6423, abs=5e-4)


def test_jamba_prefill_call_flops():
    """About 2.0e14 model FLOPs a 16384-token call at depth 5."""
    spec = load_spec(BENCH / "configs" / "jamba-1.5-large-d5.json")
    per_token = counts.token_flops(spec) / 2
    assert per_token == pytest.approx(6.06e9, rel=0.01)
    for B, S in ((8, 2048), (1, 16384)):
        assert counts.prefill_flops(spec, B, S) == pytest.approx(
            2.0e14, rel=0.03)


def test_qwen_active_weights():
    """2.07 B active weights a token (Qwen1.5-MoE-A2.7B's 2.7 B with the
    embedding and head)."""
    spec = load_spec(BENCH / "configs" / "qwen1.5-moe-a2.7b.json")
    assert counts.token_flops(spec) / 2 == pytest.approx(2.07e9, rel=0.01)


def test_jamba_decode_step_is_bound_by_bytes():
    """Every weight once and every expert once: ~47 GB a step at batch
    32, a 14 ms floor, far above the FLOPs' 0.4 ms."""
    spec = load_spec(BENCH / "configs" / "jamba-1.5-large-d5.json")
    b = counts.decode_bytes(spec, 32, 600)
    assert b == pytest.approx(47e9, rel=0.03)
    assert counts.decode_flops(spec, 32, 600) / counts.PEAK_BF16_FLOPS \
        < 1e-3
    assert counts.step_floor_s(spec, 32, 600) == pytest.approx(
        b / counts.HBM_BYTES_S)


def test_tiny_decode_bytes_by_hand():
    spec, _ = tiny("jamba")
    d, di, n, r, dc, f, E, V, B, pos = 64, 128, 8, 4, 4, 96, 4, 512, 3, 10
    mamba = (d * 2 * di + dc * di + di * (r + 2 * n) + r * di + di * d
             + 3 * di + di * n)
    attn = 2 * d * 4 * 16 + 2 * d * 2 * 16
    w = (B * d + d * V + 5 * 2 * d + 4 * mamba + attn + 3 * 3 * d * f
         + 2 * (d * E + E * 3 * d * f) + d)
    state = (2 * B * 2 * 16 * (pos + 1) * 2
             + 4 * 2 * (B * (dc - 1) * di * 2 + B * di * n * 4))
    assert counts.decode_bytes(spec, B, pos) == w * 2 + state
