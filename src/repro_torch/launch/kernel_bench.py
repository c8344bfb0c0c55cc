"""Time the Jacobi halo, flash-attention, Bellman and Anderson-mix kernels
of one source tree on the card.

To compare two versions of the kernels, run it once per source tree, in
turns (parent, change, change, parent), on one card.  It imports
``repro_torch`` from ``--src`` (default: the tree it lives in), builds
that tree's kernels there and times each kernel with CUDA events around
20 back-to-back calls after warm-up:

* ``jacobi_halo_sweeps`` at (512, 2048), (25, 100) and (2048, 2048), 10
  sweeps (a device-plane block of the g = 2048 smoke grid with four
  workers, the paper's 100 x 100 grid with four, and the whole smoke grid
  with one), each also traced with ``torch.profiler`` for its device time
  and CUDA launches per call (:func:`device_profile`);
* ``flash_attention`` at the Gemma-2-2B serve shape, q (2, 8192, 8, 256),
  k/v (2, 8192, 4, 256), causal, softcap 50: a local layer (window 4096)
  and a global one (no window), each in float32 and bfloat16, with CUPTI
  device time and the SHA-256 of the output bytes (equal hashes across
  two trees: equal bits); the bfloat16 rows also with the softcap off
  beside ``scaled_dot_product_attention`` (the local layer's boolean mask;
  ``is_causal`` at the global one);
* ``bellman`` at (10^6, 4, 5) and ``bellman_block`` at (250000, 4, 5)
  gathering from a 10^6-state v (the value-iteration smoke shapes);
* ``anderson_mix`` with beta = 1 at (6, 4,194,304), (6, 1,000,000) and
  (9, 1,048,576), the Jacobi, VI and SCF smoke windows, beside ``a @ G``
  (one PyTorch call for the same function), each also with its CUPTI
  device time, the wrapper's host microseconds per call, the kernel the
  launcher chose and the SHA-256 of the output bytes at beta = 0 and 1
  (fixed seed: equal hashes across two trees mean equal bits), and again
  with G one element off a 16-byte boundary (where the launcher takes
  8-byte loads), with whether its bits equal the aligned call's.  At VI's
  shape, whose 56 MB nearly fit the 50 MB L2, a 128 MB scratch write runs
  before every call, as a fire finds its window cold: the event times
  subtract the write's own, the device times leave its kernel out by name;
* ``selective_scan`` at the [lm-jamba] prefill's shape, dt and xc (2, 8192,
  16384) bfloat16, d_state 16 (:data:`SCAN_SHAPE`), with B and C
  contiguous and as the model's views (the last columns of a (2, 8192,
  544) ``x_proj`` output), by events and CUPTI, beside the byte bound and
  the exponentials' floor (16 a clock an SM at the card's maximum SM
  clock); with the registers and spills ``ptxas`` reported, the SASS of
  each instantiation counted by ``cuobjdump`` (:func:`sass_report`:
  instructions per ``MUFU.EX2`` in its main loop), and the kernel timed
  back to back against right after bursts of bfloat16 matrix products,
  with the SM clock and power ``nvidia-smi`` sampled in each
  (:func:`scan_under_load`).

Each row carries its bound (the larger of bytes over the memory rate and
operations over the float32 rate outside the tensor cores, or the float64
rate; NVIDIA's H100 data sheet for the part ``nvidia-smi`` names) and the
largest deviation from the tree's plain version.  ``chip_smoke.py`` uses
the same timing and the same work counts (:func:`jacobi_halo_work`,
:func:`flash_work`, :func:`bellman_work`, :func:`anderson_work`; its
``selective_scan`` row :func:`selective_scan_work`).  Run it by path so
that ``--src`` decides which ``repro_torch`` is imported:

    python3 src/repro_torch/launch/kernel_bench.py [--src DIR/src] \\
        [--label NAME] [--only KERNEL] [--out FILE.json]

(``--only selective_scan`` times that group alone, ~1 min.)
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

#: (bytes/s, float64 FLOP/s, float32 FLOP/s outside the tensor cores,
#: bfloat16 dense tensor FLOP/s) by part, from NVIDIA's H100 data sheet
PEAKS = {"PCIe": (2.0e12, 26e12, 51e12, 756e12),
         "NVL": (3.9e12, 30e12, 60e12, 835e12),
         "SXM": (3.35e12, 34e12, 67e12, 989e12)}


def peaks(name: str):
    """The data-sheet peaks of the card called ``name`` (SXM if unknown)."""
    for part, vals in PEAKS.items():
        if part in name:
            return vals
    return PEAKS["SXM"]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3,
            between=None) -> float:
    """Milliseconds per call: ``reps`` calls back to back between two CUDA
    events, after warm-up, so the host's launch cost hides behind the
    device's work (timing each call alone adds the wrapper's host time).
    ``between``, where given, runs before every call (an L2 flush); its own
    time, measured the same way, is subtracted."""
    if between is not None:
        return (time_ms(torch, lambda: (between(), fn()), reps, warmup)
                - time_ms(torch, between, reps, warmup))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_kernels(torch, fn, reps: int, warmup: int):
    """The device kernels CUPTI records through ``torch.profiler`` over
    ``reps`` calls of ``fn`` after warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_profile(torch, fn, reps: int = 20, warmup: int = 3,
                   between=None):
    """Device milliseconds and CUDA launches per call: the kernels that
    CUPTI records through ``torch.profiler`` over ``reps`` calls, their
    times summed, each divided by ``reps``.  ``between``, where given, runs
    before every call, and the kernels it launches alone are left out by
    name."""
    skip = set()
    call = fn
    if between is not None:
        skip = {e.name for e in _device_kernels(torch, between, 1, 1)}
        call = lambda: (between(), fn())  # noqa: E731
    # CUPTI now and then hands back a profile without its device records
    # (every kernel of it missing): such a profile is taken again, at most
    # twice more
    for _ in range(3):
        kernels = [e for e in _device_kernels(torch, call, reps, warmup)
                   if e.name not in skip]
        if kernels:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device kernels")
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / reps,
            len(kernels) / reps)


def host_us(torch, fn, calls: int = 1000) -> float:
    """The host microseconds per call of ``fn``: ``calls`` calls on the
    host clock, without synchronising, over ``calls``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def ptxas_report(log: str, source: str):
    """``(kernel, registers, spill stores, spill loads)`` of every entry
    that ``ptxas -v`` reported for ``source`` in a build log (empty when
    the library was reused and nothing was compiled)."""
    if f"== {source}\n" not in log:
        return []
    part = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    rows, name, spills = [], None, (0, 0)
    for line in part.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout
        rows = [(n, *r[1:]) for n, r in zip(names.splitlines(), rows)]
    return rows


def jacobi_halo_work(rows: int, g: int, sweeps: int):
    """Bytes and operations of one ``jacobi_halo_sweeps`` call on a (rows,
    g) block: the block, ``b`` and the output once each and the two halo
    rows; four adds and a scaling per cell and sweep, and a subtract,
    multiply and add per cell for the norm."""
    return (3 * rows * g + 2 * g) * 8, sweeps * rows * g * 5 + 3 * rows * g


#: (rows, g, sweeps) of the ``jacobi_halo_sweeps`` timings
HALO_SHAPES = ((512, 2048, 10), (25, 100, 10), (2048, 2048, 10))


def attention_pairs(Sq, Skv, causal, window, q_offset=0) -> int:
    """Unmasked (query, key) pairs of one head: what the work needs."""
    import numpy as np

    qpos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(Sq, np.int64))
    return int(np.clip(hi - lo, 0, None).sum())


def flash_work(B, S, nq, nkv, hd, window, itemsize):
    """Bytes and operations of one causal self-attention over ``S`` tokens:
    q, k and v read and o written once; 4 operations per head dim for each
    visible (query, key) pair (the multiply-adds of both products)."""
    nbytes = (2 * B * S * nq * hd + 2 * B * S * nkv * hd) * itemsize
    return nbytes, 4 * B * nq * hd * attention_pairs(S, S, True, window)


def selective_scan_work(B, S, di, ds, itemsize):
    """Bytes, operations and exponentials of one ``selective_scan`` call:
    dt and xc (B, S, di) in the input type, B and C (B, S, ds), A and the
    final state read or written once, y (B, S, di) float32 written once;
    per channel and step one product dt * xc, and per state the products
    dt * A and (dt * xc) * B and two multiply-adds (the state's and y's),
    beside one exponential (on the special-function units, 16 a clock an
    SM on Hopper: not in the data sheet's float32 rate)."""
    nbytes = (2 * B * S * di + 2 * B * S * ds) * itemsize + (
        B * S * di + di * ds + B * di * ds) * 4
    return nbytes, B * S * di * (6 * ds + 1), B * S * di * ds


def moe_expert_ffn_work(picked, T, d, f, itemsize, gated=True):
    """Bytes and operations of one ``moe_expert_ffn`` call whose tokens
    picked ``picked`` experts: those experts' ``wi`` (d x 2f gated, else
    d x f) and ``wo`` (f x d) read once, the tokens (T, d) read once and
    their rows of the output (T, d) written once (h, the products' (T, f)
    intermediate, need not leave the chip: it is not counted); two
    operations a weight element and token."""
    w = d * f * (3 if gated else 2)
    nbytes = (picked * w + T * d + picked * T * d) * itemsize
    return nbytes, 2 * picked * T * w


#: the [lm-jamba] prefill's scan (B, S, d_inner, d_state), bfloat16, and
#: the width of the x_proj output whose last 2 d_state columns are B and C
SCAN_SHAPE = (2, 8192, 16384, 16)
SCAN_PROJ = 544


def scan_inputs(torch, dev, gen, B, S, di, ds, dtype, proj=None):
    """Seeded selective-scan inputs: dt in Mamba's init range [1e-3, 1e-1]
    (long memories), xc, B and C standard normal, all in ``dtype``; A =
    -exp(U(-1, 1.5)) float32.  With ``proj``, B and C are the last 2 ds
    columns of a (B, S, proj) tensor (the model's in-place views)."""
    kw = dict(generator=gen, device=dev)
    dt = torch.exp(torch.empty(B, S, di, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=gen)).to(dtype)
    xc = torch.randn(B, S, di, **kw).to(dtype)
    if proj is None:
        Bm, Cm = (torch.randn(B, S, ds, **kw).to(dtype) for _ in range(2))
    else:
        full = torch.randn(B, S, proj, **kw).to(dtype)
        Bm, Cm = full[..., proj - 2 * ds:proj - ds], full[..., proj - ds:]
    A = -torch.exp(torch.empty(di, ds, device=dev).uniform_(
        -1.0, 1.5, generator=gen))
    return dt, xc, Bm, Cm, A


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi``), in Hz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def exp_floor_ms(n_exp: float, sms: int, clock_hz: float) -> float:
    """The least time for ``n_exp`` exponentials on the special-function
    units: 16 a clock an SM (Hopper)."""
    return n_exp / (16 * sms * clock_hz) * 1e3


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    return str(default) if default.exists() else None


def sass_report(lib, match: str):
    """Per kernel of the library ``lib`` whose mangled name holds
    ``match``: its SASS instructions and ``MUFU.EX2`` ops, and in its main
    loop (the backward branch whose body holds the most ``MUFU.EX2``) the
    instructions, the ``MUFU.EX2`` ops, their ratio and the count of each
    opcode.  Empty when the toolkit has no ``cuobjdump``."""
    tool = _cuobjdump()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        if match not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
        ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for _, t in ins]
        best = (0, 0, 0)  # (MUFU.EX2 ops, start, end) of the main loop
        for (addr, t), op in zip(ins, ops):
            m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", t)
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                n = sum(o == "MUFU.EX2" for (a, _), o in zip(ins, ops)
                        if lo <= a <= addr)
                if n > best[0]:
                    best = (n, lo, addr)
        loop = [o for (a, _), o in zip(ins, ops)
                if best[0] and best[1] <= a <= best[2]]
        out[name] = dict(
            instructions=len(ins),
            mufu_ex2=sum(o == "MUFU.EX2" for o in ops),
            loop_instructions=len(loop), loop_mufu_ex2=best[0],
            loop_per_ex2=len(loop) / best[0] if best[0] else None,
            loop_opcodes=dict(collections.Counter(
                o.split(".")[0] for o in loop).most_common()))
    return out


def bellman_work(idx, block=False):
    """Bytes and operations of one ``bellman`` call over ``idx`` (rows, A,
    b): the index, probability and reward rows, the distinct ``v`` entries
    gathered and the output, each once; a multiply-add per successor, the
    discount, reward and max per action.  ``block`` counts
    ``bellman_block``, which also reads ``v_old`` and reduces the norm."""
    rows, A, b = idx.shape
    touched = int(idx.unique().numel())
    nbytes = idx.numel() * 4 + (idx.numel() + rows * A + touched
                                + rows * (2 if block else 1)) * 8
    flops = rows * A * (2 * b + 2) + rows * A + (3 * rows if block else 0)
    return nbytes, flops


def anderson_work(h: int, N: int):
    """Bytes and operations of one ``anderson_mix`` call with beta = 1 on an
    (h, N) window: G, the h coefficients and the output once each; a
    multiply-add per window entry."""
    return (h * N + h + N) * 8, 2 * h * N


#: (h, N, cold) of the ``anderson_mix`` timings: the Jacobi, VI and SCF
#: windows; ``cold`` flushes the L2 before every call
ANDERSON_SHAPES = ((6, 2048 * 2048, False), (6, 10 ** 6, True),
                   (9, 1024 * 1024, False))

#: bytes of the scratch written to flush the 50 MB L2
L2_FLUSH_BYTES = 128 * 2 ** 20


def l2_flush(torch, dev):
    """A function that writes :data:`L2_FLUSH_BYTES` of scratch on ``dev``,
    evicting what the L2 held."""
    scratch = torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.float64,
                          device=dev)
    return lambda: scratch.fill_(0.0)


def out_sha256(out) -> str:
    """SHA-256 of a tensor's bytes (copied to the host; any dtype, so
    bfloat16 too)."""
    import torch

    raw = out.detach().cpu().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def mix_kernel_of(X, G, beta: float) -> str:
    """Which loads the launcher of this tree takes for the window (its
    plan's kernel), or the one-thread-per-column kernel of trees before
    the launch plan."""
    from repro_torch.kernels import anderson_mix as mix

    plan_of = getattr(mix, "plan_of", None)
    return plan_of(X, G, beta).kernel if plan_of else "per-column"


def bound_ms(nbytes: float, flops: float, bw: float, peak: float):
    """The least time for the work: bytes over ``bw`` or operations over
    ``peak``, whichever is longer, and which one it is."""
    tb, tf = nbytes / bw * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


#: the kernel groups :func:`bench` times, in order (``--only`` picks one)
GROUPS = ("jacobi_halo_sweeps", "flash_attention", "bellman", "anderson_mix",
          "selective_scan")


def bench(torch, card: str, only=None):
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda", 0)
    bw, fp64, fp32, bf16 = peaks(card)
    rows = []
    _build.load_library()

    def row(name, shape, err, fn, nbytes, flops, peak, between=None,
            **extra):
        b, by = bound_ms(nbytes, flops, bw, peak)
        ms = time_ms(torch, fn, between=between)
        rows.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms,
                         bound_ms=b, bound_by=by, bound_share=b / ms,
                         **extra))
        more = "".join(f", {k} {v:.4g}" if isinstance(v, float)
                       else f", {k} {v}" for k, v in extra.items())
        print(f"[bench] {name} {shape}: {ms:.4f} ms, bound {b:.4f} ms ({by},"
              f" {100 * b / ms:.1f}%), err {err:.2e}{more}", flush=True)

    if only in (None, "jacobi_halo_sweeps"):
        bench_halo(torch, dev, ops, ref, row, fp64)
    if only in (None, "flash_attention"):
        bench_flash(torch, dev, ops, ref, row, fp32, bf16)
    if only in (None, "bellman"):
        bench_bellman(torch, dev, ops, ref, row, fp64)
    if only in (None, "anderson_mix"):
        for name, regs, st, ld in ptxas_report(_build.build_info().log,
                                               "anderson_mix.cu"):
            print(f"[bench] ptxas {name}: {regs} registers, spill stores "
                  f"{st} B, loads {ld} B", flush=True)
        bench_anderson(torch, dev, ops, ref, row, fp64)
    if only in (None, "selective_scan"):
        rows.append(dict(name="selective_scan_under_load",
                         **bench_scan(torch, dev, ops, ref, row, fp32)))
    return rows


def bench_halo(torch, dev, ops, ref, row, fp64):
    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for shape in HALO_SHAPES:
        r, g, sweeps = shape
        xb, bb = (torch.randn(r, g, generator=gen, **f64) for _ in range(2))
        top, bot = (torch.randn(g, generator=gen, **f64) for _ in range(2))

        def halo():
            return ops.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps)

        out, norm = halo()
        want, wnorm = ref.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps)
        dev_ms, launches = device_profile(torch, halo)
        row("jacobi_halo_sweeps", list(shape),
            float((out - want).abs().max()), halo,
            *jacobi_halo_work(*shape), fp64,
            norm_rel_err=float((norm - wnorm).abs() / wnorm.abs()),
            device_ms=dev_ms, launches_per_call=launches)


def bench_flash(torch, dev, ops, ref, row, fp32, bf16):
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, nq, nkv, hd = 2, 8192, 8, 4, 256
    qf = torch.randn(B, S, nq, hd, generator=gen, device=dev)
    kf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    vf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    pos = torch.arange(S, device=dev)
    for label, window, dt in (("local", 4096, torch.float32),
                              ("global", None, torch.float32),
                              ("local", 4096, torch.bfloat16),
                              ("global", None, torch.bfloat16)):
        q, k, v = qf.to(dt), kf.to(dt), vf.to(dt)
        kw = dict(causal=True, window=window, softcap=50.0)
        out = ops.flash_attention(q, k, v, **kw)
        err = float((out.float() - ref.flash_attention(q, k, v, **kw).float())
                    .abs().max())
        extra = dict(out_sha256=out_sha256(out))
        del out
        torch.cuda.empty_cache()
        if dt == torch.bfloat16:
            # SDPA has no softcap: the kernel without it beside SDPA with
            # the layer's mask (local) or is_causal (global, the flash
            # backend)
            nocap = dict(causal=True, window=window)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                sdpa_kw = dict(is_causal=True)
            else:
                sdpa_kw = dict(attn_mask=(pos[:, None] >= pos[None, :])
                               & (pos[:, None] - pos[None, :] < window))

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True,
                                                      **sdpa_kw)

            extra.update(
                ms_softcap_off=time_ms(torch, lambda: ops.flash_attention(
                    q, k, v, **nocap)),
                device_ms_softcap_off=device_profile(
                    torch, lambda: ops.flash_attention(q, k, v, **nocap))[0],
                library_ms=time_ms(torch, sdpa),
                library_device_ms=device_profile(torch, sdpa)[0])
        row(f"flash_attention_{label}_{str(dt).split('.')[-1]}",
            [B, S, nq, nkv, hd, window], err,
            lambda: ops.flash_attention(q, k, v, **kw),
            *flash_work(B, S, nq, nkv, hd, window, q.element_size()),
            fp32 if dt == torch.float32 else bf16,
            device_ms=device_profile(
                torch, lambda: ops.flash_attention(q, k, v, **kw))[0],
            **extra)
    del q, k, v, qf, kf, vf
    torch.cuda.empty_cache()


def bench_bellman(torch, dev, ops, ref, row, fp64):
    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    S, A, b, gamma = 10 ** 6, 4, 5, 0.95
    idx = torch.randint(0, S, (S, A, b), generator=gen, device=dev,
                        dtype=torch.int32)
    probs = torch.rand(S, A, b, generator=gen, **f64)
    probs /= probs.sum(-1, keepdim=True)
    R = torch.rand(S, A, generator=gen, **f64)
    v = torch.randn(S, generator=gen, **f64)
    err = float((ops.bellman(idx, probs, R, v, gamma=gamma)
                 - ref.bellman(idx, probs, R, v, gamma=gamma)).abs().max())
    row("bellman", [S, A, b], err,
        lambda: ops.bellman(idx, probs, R, v, gamma=gamma),
        *bellman_work(idx), fp64)
    n = S // 4
    bi, bp, bR = idx[:n], probs[:n], R[:n]
    v_old = torch.randn(n, generator=gen, **f64)
    err = float((ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)[0]
                 - ref.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)[0]
                 ).abs().max())
    row("bellman_block", [n, A, b, S], err,
        lambda: ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma),
        *bellman_work(bi, block=True), fp64)
    del idx, probs, R, v
    torch.cuda.empty_cache()


def bench_anderson(torch, dev, ops, ref, row, fp64):
    f64 = dict(dtype=torch.float64, device=dev)
    flush = l2_flush(torch, dev)
    for h, N, cold in ANDERSON_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(5)
        X, G = (torch.randn(h, N, generator=gen, **f64) for _ in range(2))
        a = torch.randn(h, generator=gen, **f64)
        a = a / a.sum()
        between = flush if cold else None
        want = ref.anderson_mix(X, G, a, beta=1.0)
        err = float((ops.anderson_mix(X, G, a, beta=1.0) - want).abs().max())
        sha = {str(b): out_sha256(ops.anderson_mix(X, G, a, beta=b))
               for b in (0.0, 1.0)}

        def kernel():
            return ops.anderson_mix(X, G, a, beta=1.0)

        def library():
            return a @ G

        dev_ms, launches = device_profile(torch, kernel, between=between)
        row("anderson_mix", [h, N], err, kernel, *anderson_work(h, N), fp64,
            between=between, kernel=mix_kernel_of(X, G, 1.0), l2_flush=cold,
            device_ms=dev_ms, launches_per_call=launches,
            host_us=host_us(torch, kernel),
            plain_ms=time_ms(torch, lambda: ref.anderson_mix(X, G, a,
                                                             beta=1.0),
                             between=between),
            library_ms=time_ms(torch, library, between=between),
            library_device_ms=device_profile(torch, library,
                                             between=between)[0],
            library_host_us=host_us(torch, library), out_sha256=sha)
        # The same window one element off a 16-byte boundary, where the
        # launcher takes 8-byte loads.
        Go = torch.empty(h * N + 1, **f64)[1:].view(h, N)
        Go.copy_(G)

        def scalar():
            return ops.anderson_mix(X, Go, a, beta=1.0)

        got = scalar()
        row("anderson_mix", [h, N, "one element off"],
            float((got - want).abs().max()), scalar, *anderson_work(h, N),
            fp64, between=between, kernel=mix_kernel_of(X, Go, 1.0),
            l2_flush=cold,
            device_ms=device_profile(torch, scalar, between=between)[0],
            bits_equal_aligned=bool(torch.equal(got, kernel())))
        del X, G, Go, got, want
    torch.cuda.empty_cache()


#: bfloat16 (8192, 8192) products in a burst before each loaded scan
#: (~50 ms on an H100 SXM, about a Jamba layer's products)
LOAD_GEMMS = 30
#: seconds of each window of :func:`scan_under_load`, and the seconds at
#: its start whose clock samples are left out (the clock settling)
LOAD_SECONDS, LOAD_SETTLE = 3.0, 0.5


def scan_under_load(torch, dev, kernel):
    """The scan's event time (median of single calls) and the SM clock and
    power draw ``nvidia-smi`` sampled every 20 ms (medians), over a window
    of calls back to back and over a window where each call follows a
    burst of :data:`LOAD_GEMMS` bfloat16 products, as in a prefill, where
    the layer's products precede the scan."""
    import datetime
    import statistics

    a = torch.randn(8192, 8192, device=dev).to(torch.bfloat16)
    c = torch.empty_like(a)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def burst():
        for _ in range(LOAD_GEMMS):
            torch.matmul(a, a, out=c)

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    out, windows = {}, {}
    try:
        for label, before in (("alone", None), ("after_products", burst)):
            kernel()
            torch.cuda.synchronize()
            times, t_start = [], time.time()
            while time.time() - t_start < LOAD_SECONDS:
                if before is not None:
                    before()
                e0.record()
                kernel()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            windows[label] = (t_start + LOAD_SETTLE, time.time())
            out[f"{label}_ms"] = statistics.median(times)
            out[f"{label}_calls"] = len(times)
    finally:
        smi.terminate()
        text = smi.communicate(timeout=30)[0]
    samples = []
    for line in text.splitlines():
        try:
            ts, mhz, watts = (f.strip() for f in line.split(","))
            t = datetime.datetime.strptime(ts, "%Y/%m/%d %H:%M:%S.%f")
            samples.append((t.timestamp(), float(mhz), float(watts)))
        except ValueError:
            continue
    for label, (lo, hi) in windows.items():
        got = [(m, w) for t, m, w in samples if lo <= t <= hi]
        out[f"{label}_sm_mhz"] = (statistics.median(m for m, _ in got)
                                  if got else None)
        out[f"{label}_power_w"] = (statistics.median(w for _, w in got)
                                   if got else None)
        out[f"{label}_samples"] = len(got)
    return out


def bench_scan(torch, dev, ops, ref, row, fp32):
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as scan_mod

    info = _build.build_info()
    for name, regs, st, ld in ptxas_report(info.log, "selective_scan.cu"):
        print(f"[bench] ptxas {name}: {regs} registers, spill stores {st} B,"
              f" loads {ld} B", flush=True)
    for name, rep in sass_report(info.path, "selective_scan").items():
        print(f"[bench] sass {name}: {json.dumps(rep)}", flush=True)
    B, S, di, ds = SCAN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(4)
    dt, xc, Bm, Cm, A = scan_inputs(torch, dev, gen, B, S, di, ds,
                                    torch.bfloat16)
    views = scan_inputs(torch, dev, gen, B, S, di, ds, torch.bfloat16,
                        proj=SCAN_PROJ)[2:4]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor_hz = max_sm_clock_hz()
    slab = slice(0, 512)
    want = {layout: ref.selective_scan(dt[..., slab], xc[..., slab], b_, c_,
                                       A[slab])
            for layout, (b_, c_) in (("contiguous", (Bm, Cm)),
                                     ("views", views))}
    nbytes, flops, n_exp = selective_scan_work(B, S, di, ds, 2)
    floor = exp_floor_ms(n_exp, sms, floor_hz)
    for layout, (b_, c_) in (("contiguous", (Bm, Cm)), ("views", views)):

        def kernel(b_=b_, c_=c_):
            return scan_mod.selective_scan(dt, xc, b_, c_, A)

        y, h = kernel()
        wy, wh = want[layout]
        err = max(float((y[..., slab] - wy).abs().max()),
                  float((h[:, slab] - wh).abs().max()))
        del y, h
        dev_ms, launches = device_profile(torch, kernel)
        row("selective_scan", [B, S, di, ds, "bfloat16", layout], err,
            kernel, nbytes, flops, fp32, device_ms=dev_ms,
            launches_per_call=launches, exp_floor_ms=floor,
            exp_floor_share=floor / dev_ms)
    del want
    load = scan_under_load(torch, dev, lambda: ops.selective_scan(
        dt, xc, *views, A))
    print(f"[bench] selective_scan views under load: {json.dumps(load)}",
          flush=True)
    del dt, xc, Bm, Cm, A, views
    torch.cuda.empty_cache()
    return load


def main() -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=here,
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", choices=GROUPS, default=None,
                    help="time one kernel group only")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[bench] {args.label or args.src}: {card}", flush=True)
    result = dict(label=args.label or str(args.src), card=card,
                  rows=bench(torch, card, args.only))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
