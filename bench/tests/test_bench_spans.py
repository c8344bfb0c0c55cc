"""``harness.spans`` on synthetic profiler events: each device operation
put down to the innermost host span open at its launch (by the launch
call's correlation id, else the CPU operator's, else the device-side
mirror of the ranges), self and total device time, and the window's idle
time split by the innermost open span.  Then ``tools/cell_spans.py`` on
the tiny cells: its counters over the window and the spans it reads."""

import sys
from dataclasses import dataclass

import pytest
from torch.autograd import DeviceType

from harness import spans
from harness.manifest import ROOT


@dataclass
class Ev:
    """The methods of a Kineto event that ``read_spans`` calls."""
    n: str
    kind: str
    start: int
    dur: int
    corr: int = 0
    linked: int = 0
    cuda: bool = False

    def name(self):
        return self.n

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.kind in ("user_annotation", "gpu_user_annotation")


class Prof:
    def __init__(self, events):
        self.profiler = self
        self.kineto_results = self
        self._events = events

    def events(self):
        return self._events


def host(name, a, b):
    return Ev(name, "user_annotation", a, b - a)


def kernel(name, a, b, corr=0, linked=0):
    return Ev(name, "kernel", a, b - a, corr, linked, cuda=True)


#: the window [0, 1000): a call [100, 900) holding a layer [200, 600)
#: holding a MoE sublayer [300, 500); a sync [700, 800) inside the call
HOST = [host("bench.window", 0, 1000), host("bench.call", 100, 900),
        host("lm.layer", 200, 600), host("lm.moe", 300, 500),
        host("lm_serve.sync", 700, 800), host("other.range", 0, 1000)]


def trace(*device):
    return spans.read_spans(Prof(HOST + list(device)))


def test_an_operation_belongs_to_the_innermost_span_at_its_launch():
    # launch calls' CUPTI ids collide with the operators' own ids
    st = trace(Ev("aten::mm", "cpu_op", 120, 400, corr=7),
               Ev("cudaLaunchKernel", "cuda_runtime", 350, 5, corr=7,
                  linked=2),
               kernel("moe_k", 600, 650, corr=7, linked=2),
               Ev("cudaLaunchKernel", "cuda_runtime", 250, 5, corr=8,
                  linked=3),
               kernel("norm_k", 650, 660, corr=8, linked=3))
    assert st.links == {"launch": 2}
    dev = spans.device_seconds(st)
    assert dev["lm.moe"] == {"self": 50e-9, "total": 50e-9}
    assert dev["lm.layer"] == {"self": 10e-9, "total": 60e-9}
    assert dev["bench.window"]["total"] == pytest.approx(60e-9)
    assert dev["bench.call"]["self"] == 0.0
    assert "other.range" not in dev  # not a program or benchmark span


def test_operator_then_mirror_then_unattributed():
    st = trace(Ev("aten::mm", "cpu_op", 210, 20, corr=5),
               kernel("gemm", 300, 340, corr=99, linked=5),
               Ev("lm.moe", "gpu_user_annotation", 400, 100, cuda=True),
               kernel("gather", 420, 430),
               kernel("lost", 950, 960))
    assert st.links == {"operator": 1, "mirror": 1, "none": 1}
    dev = spans.device_seconds(st)
    assert dev["lm.layer"]["self"] == pytest.approx(40e-9)
    assert dev["lm.moe"]["self"] == pytest.approx(10e-9)
    assert dev[spans.UNATTRIBUTED]["self"] == pytest.approx(10e-9)
    s = spans.summary(st, 1)
    assert s["self_sum_ms"] == pytest.approx(s["device_ms"])
    assert s["attributed_share"] == pytest.approx(50 / 60)
    assert s["lm_share"] == pytest.approx(50 / 60)


def test_a_mirrored_operation_takes_the_span_after_the_last_launch():
    """The port's own kernels come without a launch record: the mirror
    names the span, and the one open at or next opened after the launch
    of the operation before stands for theirs, cut at the mirror."""
    more = [host("lm.layer", 610, 690), host("lm.moe", 620, 680),
            host("lm.moe.experts", 630, 640)]
    st = spans.read_spans(Prof(HOST + more + [
        Ev("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=1, linked=1),
        kernel("norm", 700, 710, corr=1),  # launched in the first layer
        Ev("lm.moe", "gpu_user_annotation", 720, 60, cuda=True),
        kernel("scan", 720, 730),  # the first lm.moe after t = 210
        Ev("cudaLaunchKernel", "cuda_runtime", 635, 2, corr=2, linked=1),
        kernel("bmm", 740, 760, corr=2),  # in the second layer's experts
        kernel("gate", 765, 770)]))  # after it: the moe it is inside
    assert st.links == {"launch": 2, "mirror": 2}
    chains = {o.name: o.chain for o in st.ops}
    assert chains["scan"] == ("bench.window", "bench.call", "lm.layer",
                              "lm.moe")
    assert chains["gate"] == chains["scan"]
    assert chains["bmm"][-1] == "lm.moe.experts"


def test_idle_time_split_by_the_innermost_span():
    st_events = (Ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=1,
                    linked=1),
                 kernel("a", 250, 350, corr=1),
                 Ev("cudaLaunchKernel", "cuda_runtime", 160, 5, corr=2,
                    linked=1),
                 kernel("b", 450, 750, corr=2))
    st = trace(*st_events)
    idle = spans.idle_seconds(st)
    # gaps [0, 250), [350, 450), [750, 1000)
    assert idle == pytest.approx({
        "bench.window": 200e-9, "bench.call": 200e-9, "lm.layer": 50e-9,
        "lm.moe": 100e-9, "lm_serve.sync": 50e-9})
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in st.gaps()) / 1e9)
    # the wait on the device is not the program's idle time
    assert spans.program_idle_seconds(st) == pytest.approx(150e-9)
    more = trace(*st_events, Ev("cudaMalloc", "cuda_runtime", 10,
                                spans.LONG_NS, corr=9, linked=1))
    assert spans.longest_gaps(more, top=1)[0]["host_call"] == "cudaMalloc"
    longest = spans.longest_gaps(st, top=2)
    assert [g["ms"] for g in longest] == pytest.approx([250e-6, 250e-6])
    assert longest[0]["span"] == "bench.window"
    assert longest[0]["program_span"] == spans.NONE
    assert longest[0]["host_call"] == spans.NONE
    assert longest[1]["span"] == "bench.call"


def test_timeline_of_nested_and_empty_spans():
    line = spans.Timeline([spans.HostSpan("a", 0, 10),
                           spans.HostSpan("b", 2, 6),
                           spans.HostSpan("c", 6, 6),
                           spans.HostSpan("d", 6, 8)])
    assert line.chain(-1) == () and line.chain(0) == ("a",)
    assert line.chain(3) == ("a", "b") and line.chain(6) == ("a", "d")
    assert line.chain(10) == ()
    parts = list(line.parts(1, 12))
    assert [p[1] for p in parts] == [("a",), ("a", "b"), ("a", "d"),
                                     ("a",), ()]
    assert sum(p[0] for p in parts) == pytest.approx(11e-9)


def test_a_trace_needs_one_window():
    with pytest.raises(RuntimeError, match="bench.window"):
        spans.read_spans(Prof([host("lm.layer", 0, 5)]))


@pytest.mark.parametrize("name,family,mix_name", [
    ("qwen_moe.prefill", "qwen", "PREFILL_MIX"),
    ("jamba.decode", "jamba", "DECODE_MIX")])
def test_cell_spans_counts_the_window(name, family, mix_name):
    import bench_tiny

    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import cell_spans
    finally:
        sys.path.remove(str(ROOT / "tools"))
    cell, port = bench_tiny.tiny_cell(name, family,
                                      getattr(bench_tiny, mix_name))
    s = cell_spans.run(cell, 2**31 + 7, 0.3, "cpu", port=port,
                       log=lambda line: None)
    assert s["correct"] is True and s["n"] > 0
    c = s["counters"]
    if family == "qwen":
        moe_layers = 2
        assert c["moe.slots"] % (s["n"] * moe_layers) == 0
        assert 0 < s["slot_fill"] <= 100 * c["moe.assignments"] / c[
            "moe.slots"]
    else:
        # 2 MoE layers a step, a batch of 6 picking at most 4 experts
        assert c["moe.experts_gathered"] == 4 * 2 * s["n"]
        assert 0 < c["moe.experts_picked"] <= c["moe.experts_gathered"]
        assert s["slot_fill"] is None
    # no device on the CPU: the program's ranges are there, no operations
    assert s["program_ranges"] > 0 and s["device_ms"] == 0
