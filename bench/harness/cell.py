"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics and the result line.

Set-up makes the weights from the seed on the device, builds the port's
model on them and warms up every shape the cell's traffic uses (the
prefill cells: each of the mix's shapes once; the decode cell: the
prompts' prefill and a few steps).  The window then runs the traffic for
``seconds``; with ``trace`` the profiler records it.  After the window
the program's state is freed and the reference runs on a sample of what
the window served, drawn from the seed.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, counts
from .manifest import Cell, reader
from .port import Port
from .reference import Reference, state_rows
from .spec import ModelSpec
from .trace import Trace, breakdown, read_trace
from .traffic import call_shapes, prompt_pool
from .weights import derive_seed, make_weights

__all__ = ["RunView", "run_cell", "FORBIDDEN", "forbidden_modules"]

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class RunView:
    """What a metric's reader reads: the cell's configuration and mix,
    the host clock's readings of the window, the calls or steps it
    completed, and the trace of a traced run (None otherwise)."""

    spec: ModelSpec
    mix: Dict
    setup_s: float
    window_s: float
    calls: List[Tuple[int, int]] = field(default_factory=list)
    steps: List[int] = field(default_factory=list)  # each step's position
    batch: int = 0
    itl_ms: List[float] = field(default_factory=list)
    trace: Optional[Trace] = None

    @property
    def loop(self) -> str:
        return self.mix["loop"]


class _Clock:
    """Marks on the device's stream (CUDA events), or host times on the
    CPU, whose differences are milliseconds."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name: str, on: bool):
    if on:
        return torch.profiler.record_function("bench." + name)
    return contextlib.nullcontext()


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _per(launches: Dict[str, int], n: int) -> str:
    """The serving kernels' launches per call or step."""
    return ", ".join(f"{k} {launches.get(k, 0) / max(n, 1):g}"
                     for k in ("flash_attention", "selective_scan"))


#: exponentials an SM issues a clock (MUFU.EX2) and the card's largest SM
#: clock (``nvidia-smi --query-gpu=clocks.max.sm``: 1980 MHz on the H100)
EX2_PER_CLOCK, SM_CLOCK_HZ = 16, 1.98e9


def _scan_floor(view: RunView, device, log: Callable) -> None:
    """Print the Mamba scans' exponentials floor (one exp2 a channel, a
    state element and a step) beside their device time in the trace."""
    s = view.trace.seconds_by_group().get("selective_scan")
    if not s or device.type != "cuda":
        return
    m = view.spec.mamba
    n = sum(mx == "mamba" for mx, _ in view.spec.kinds)
    exps = sum(n * B * S * m.d_inner * m.d_state for B, S in view.calls)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    floor = exps / (EX2_PER_CLOCK * sms * SM_CLOCK_HZ)
    log(f"[scan] exponentials' floor {floor * 1e3:.3f} ms at {sms} SMs "
        f"against the scans' {s * 1e3:.3f} ms of device time "
        f"({100 * floor / s:.1f}%)")


# --------------------------------------------------------------------- #
# The prefill loop
# --------------------------------------------------------------------- #
def _prefill_run(cell: Cell, port: Port, model, weights, seed: int,
                 seconds: float, trace: bool, device, t0: float,
                 log: Callable) -> Tuple[RunView, Callable, Dict]:
    spec, mix = cell.spec, cell.mix
    names = tuple(cell.limits["numbers"])
    tokens = mix["shapes"][0][0] * mix["shapes"][0][1]
    k = len(mix["shapes"])
    n_max = k * math.ceil(seconds / mix["min_call_s"] / k) + k
    shapes = call_shapes(mix, seed, n_max)
    pool = prompt_pool(n_max + 1, tokens, spec.vocab, seed, device)
    for B, S in dict.fromkeys(tuple(s) for s in mix["shapes"]):
        port.serve_call(model, pool[n_max].view(B, S))  # warm-up
    _sync(device)
    port.reset_launch_counts()
    setup_s = time.perf_counter() - t0
    prof = _profiler(device) if trace else contextlib.nullcontext()
    done: List[Tuple[int, int, torch.Tensor, torch.Tensor]] = []
    with prof:
        with _span("window", trace):
            t_start = time.perf_counter()
            while (time.perf_counter() - t_start < seconds
                   and len(done) < n_max):
                B, S = shapes[len(done)]
                with _span("call", trace):
                    tok, logits = port.serve_call(
                        model, pool[len(done)].view(B, S))
                done.append((B, S, tok, logits))
            _sync(device)
            window_s = time.perf_counter() - t_start
    launches = port.launch_counts()
    view = RunView(spec, mix, setup_s, window_s,
                   calls=[(B, S) for B, S, _, _ in done],
                   trace=read_trace(prof) if trace else None)
    log(f"[launches] {len(done)} calls: " + _per(launches, len(done))
        + " a call")
    if view.trace is not None and spec.mamba is not None:
        _scan_floor(view, device, log)

    def compare(precision: str = "float32") -> Dict:
        # one call of each shape the window served, drawn from the seed
        rng = np.random.default_rng(derive_seed(seed, "check"))
        picked = sorted(int(rng.choice([i for i, c in enumerate(done)
                                        if c[:2] == shape]))
                        for shape in dict.fromkeys(c[:2] for c in done))
        ref = Reference(spec, weights)
        ctl = Reference(spec, weights, precision) if precision != "float32" \
            else None
        parts = []
        for i in picked:
            B, S, tok, logits = done[i]
            want, _ = ref.forward(pool[i].view(B, S), capacity=True)
            if ctl is not None:
                got, _ = ctl.forward(pool[i].view(B, S), capacity=True)
                logits, tok = got[:, 0], got[:, 0].argmax(-1)
            parts.append(check.rows(logits.reshape(B, -1), tok.reshape(B),
                                    want[:, 0]))
            log(f"[check] {precision} call {i} ({B}, {S}): "
                + ", ".join(f"{k} {v:.6g}" for k, v in
                            check.readings(parts[-1], names).items()))
        return check.cat_rows(parts)

    return view, compare, {"attempted": len(done), "failed": 0}


# --------------------------------------------------------------------- #
# The decode loop
# --------------------------------------------------------------------- #
def _decode_run(cell: Cell, port: Port, model, weights, seed: int,
                seconds: float, trace: bool, device, t0: float,
                log: Callable) -> Tuple[RunView, Callable, Dict]:
    spec, mix = cell.spec, cell.mix
    names = tuple(cell.limits["numbers"])
    B, S0, warm = mix["batch"], mix["prompt_len"], mix["warmup_steps"]
    floor = counts.step_floor_s(spec, B, S0)
    max_steps = min(math.ceil(seconds / floor) + 8,
                    mix.get("max_steps", 1 << 30))
    max_len = S0 + warm + max_steps + 1
    prompt = prompt_pool(1, B * S0, spec.vocab, seed, device).view(B, S0)
    rng = np.random.default_rng(derive_seed(seed, "check"))
    rows = torch.as_tensor(np.sort(rng.choice(B, mix["check_rows"],
                                              replace=False)),
                           device=device)
    logits, caches = port.prefill(model, prompt, max_len)
    toks = logits.argmax(-1)[:, None]
    served, kept = [toks], [logits[rows]]
    pos = S0
    for _ in range(warm):
        logits, caches = port.decode_step(model, caches, toks, pos)
        toks = logits.argmax(-1)[:, None]
        served.append(toks)
        kept.append(logits[rows])
        pos += 1
    _sync(device)
    port.reset_launch_counts()
    setup_s = time.perf_counter() - t0
    clock = _Clock(device)
    prof = _profiler(device) if trace else contextlib.nullcontext()
    steps: List[int] = []
    with prof:
        with _span("window", trace):
            t_start = time.perf_counter()
            marks = [clock.mark()]
            while (time.perf_counter() - t_start < seconds
                   and pos < max_len - 1):
                with _span("step", trace):
                    logits, caches = port.decode_step(model, caches, toks,
                                                      pos)
                    toks = logits.argmax(-1)[:, None]
                    served.append(toks)
                    kept.append(logits[rows])
                    marks.append(clock.mark())
                steps.append(pos)
                pos += 1
                if len(marks) > 2:  # the host keeps at most 2 steps ahead
                    with _span("wait", trace):
                        clock.wait(marks[-3])
            _sync(device)
            window_s = time.perf_counter() - t_start
    launches = port.launch_counts()
    itl = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    view = RunView(spec, mix, setup_s, window_s, steps=steps, batch=B,
                   itl_ms=itl, trace=read_trace(prof) if trace else None)
    log(f"[launches] {len(steps)} steps: " + _per(launches, len(steps))
        + " a step")
    del caches, logits
    state = {"served": served, "kept": kept}

    def compare(precision: str = "float32") -> Dict:
        served_all = torch.cat(state["served"], 1)  # (B, n)
        n_tok = served_all.shape[1]
        ref = Reference(spec, weights)
        want_p, st = ref.forward(prompt, capacity=True)
        st = state_rows(st, rows)
        feed = served_all[rows, :n_tok - 1]
        pos_all = torch.arange(n_tok - 1, device=device)
        want_c, _ = ref.forward(feed, st, pos0=S0, capacity=False,
                                want=pos_all)
        ref_l = torch.cat([want_p[rows], want_c], 1)  # (R, n, V)
        if precision == "float32":
            cand_l = torch.stack(state["kept"], 1)  # (R, n, V)
            cand_t = served_all[rows]
        else:
            ctl = Reference(spec, weights, precision)
            got_p, cst = ctl.forward(prompt, capacity=True)
            got_c, _ = ctl.forward(feed, state_rows(cst, rows), pos0=S0,
                                   capacity=False, want=pos_all)
            cand_l = torch.cat([got_p[rows], got_c], 1)
            cand_t = cand_l.argmax(-1)
        r = check.rows(cand_l, cand_t, ref_l)
        q = max(n_tok // 4, 1)
        for j in range(0, n_tok, q):
            part = {k: v.view(len(rows), n_tok)[:, j:j + q].reshape(-1)
                    for k, v in r.items()}
            log(f"[check] {precision} tokens {j}..: "
                + ", ".join(f"{k} {v:.6g}" for k, v in
                            check.readings(part, names).items()))
        return r

    return view, compare, {"attempted": len(steps), "failed": 0}


_LOOPS = {"prefill": _prefill_run, "decode": _decode_run}


# --------------------------------------------------------------------- #
# A run
# --------------------------------------------------------------------- #
def _metrics(entries: List[Dict], view: RunView) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = reader(m["name"])(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t0: float, log: Callable = print,
             port: Optional[Port] = None,
             controls: Tuple[str, ...] = ()) -> Dict:
    """Run ``cell`` once; returns the result line's object and, under
    ``"_stderr"``, the lines that end standard error.  ``controls``
    (e.g. ``("fp8",)``) also read the comparison's numbers for the
    reference in that precision in the program's place (under
    ``"_controls"``; the calibration script's use)."""
    device = torch.device(device)
    marks = [("imports", time.perf_counter())]
    port = port or Port(cell.spec)
    marks.append(("port's imports", time.perf_counter()))
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
        marks.append(("context", time.perf_counter()))
        port.load_library()
        marks.append(("library", time.perf_counter()))
    weights = make_weights(cell.spec, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    model = port.build_model(weights)
    marks.append(("model", time.perf_counter()))
    view, compare, counted = _LOOPS[cell.mix["loop"]](
        cell, port, model, weights, seed, seconds, trace, device, t0, log)
    marks.append(("warm-up", t0 + view.setup_s))
    log("[setup] " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, b), (_, a) in
        zip(marks, [("", t0)] + marks[:-1])) + f"; setup_s {view.setup_s:.3f}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run's process holds {found} once the "
                           f"window has closed")
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = _metrics(entries, view)
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    per_row = compare()
    values = check.readings(per_row, cell.limits["numbers"])
    log(f"[reference] the comparison took "
        f"{time.perf_counter() - t_ref:.3f} s")
    verdict = check.judge(values, cell.limits)
    out: Dict = {"correct": verdict["correct"], **counted,
                 "metrics": metrics,
                 "device": {"platform": "gpu" if device.type == "cuda"
                            else device.type,
                            "kind": (torch.cuda.get_device_name(device)
                                     if device.type == "cuda" else "cpu"),
                            "count": cell.chips,
                            "memory_peak_bytes": int(peak)}}
    if view.trace is not None:
        groups = view.trace.seconds_by_group()
        total = sum(groups.values()) or 1.0
        log("[groups] device seconds by kernel group: " + ", ".join(
            f"{g} {t:.4f} ({t / total:.3f})" for g, t in
            sorted(groups.items(), key=lambda kv: -kv[1])))
        out["device"]["busy_s"] = view.trace.busy_s
        out["device"]["window_s"] = view.trace.window_s
        out["breakdown"] = breakdown(view.trace)
    out["checks"] = verdict["checks"]
    out["_stderr"] = [f"check {k} {c['value']!r} limit {c['limit']!r}"
                      for k, c in verdict["checks"].items()]
    out["_rows"] = {"program": per_row}
    for p in controls:
        t_ref = time.perf_counter()
        out["_rows"][p] = compare(p)
        out.setdefault("_controls", {})[p] = check.readings(
            out["_rows"][p], cell.limits["numbers"])
        log(f"[reference] the {p} control took "
            f"{time.perf_counter() - t_ref:.3f} s")
    return out
