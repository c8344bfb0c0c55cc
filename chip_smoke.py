#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout with no arguments:

    python3 chip_smoke.py [--report PATH]

Phases, each of which raises on failure (the exit code is then non-zero
and no result line is printed):

1. device — the card's name and power limit as ``nvidia-smi`` reports them;
2. build  — compile ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, all at once) and load the library;
3. kernels — each hand-written kernel against its plain PyTorch version at
   the shapes the main paths give it, with kernel, plain and (where one
   PyTorch call computes the same function) library times;
4. Jacobi main path — g = 2048 (n = 4,194,304), 4 thread workers, the
   device plane on, Anderson(m=5), worker 0 a 100 ms straggler; then one
   worker through the kernels against one through the numpy oracle;
5. value-iteration main path — Garnet S = 10^6, A = 4, b = 5, same config;
6. small-input parity — the ``jacobi_async_plain`` golden trajectory
   reproduced byte for byte on the card, and an accelerated VI run on the
   card against the same run on the CPU (plain versions);
7. LM serving main path — Gemma-2-2B at its published widths (26 layers,
   float32, weights from a seeded generator) through
   ``repro_torch.launch.lm_serve``: batched prefill of 2 x 8192 tokens
   (past the 4096 window, so the local layers' window mask and ring caches
   bind) and 32 greedy tokens; prefill attention must launch the flash
   kernel once per layer;
8. LM parity — Gemma-2-2B widths at depth 2 with window 128, prompt 512:
   prefill logits and 8 greedy decode steps on the card (kernel) against
   the same weights on the CPU (plain version).

The ``{"kernels": [...]}`` line carries, per kernel, the launches counted
on the main paths (counts are reset right before each path and read right
after), the largest deviation from the plain version, the mean time of
20 back-to-back calls between two CUDA events and the least time the card
could take (bytes
over memory bandwidth or operations over the peak rate of their type,
whichever is larger; NVIDIA H100 data-sheet figures).  The last line is
the device summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: main-path sizes: the Jacobi grid side and the Garnet state count
JACOBI_GRID = 2048
VI_STATES = 10 ** 6

#: LM serving main path: Gemma-2-2B, batch x prompt tokens, tokens generated
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma2_2b", 2, 8192, 32

#: the Jacobi golden of tests/test_hotpath_goldens.py (jacobi_async_plain)
_JACOBI_GOLDEN = (600, 0.4318607003352541,
                  "af8fd221f9b65b94b6d21a5e5dcc7dbef42cf475a86dd05ad8e08d5b43b1bfc9")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch.cuda.get_device_name(0) = {name}; "
          f"count = {torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    return name


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info()
    print(f"[build] {info.path.name} in {info.seconds:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")


def phase_kernels(torch, dev, name):
    """Each kernel against its plain version at the main-path shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.kernel_bench import (bellman_work, bound_ms, peaks,
                                                 time_ms)

    bw, fp64, fp32, bf16 = peaks(name)
    gen = torch.Generator(device=dev).manual_seed(0)
    f64 = dict(dtype=torch.float64, device=dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, **f64)

    def bound(nbytes, flops, peak=fp64):
        return bound_ms(nbytes, flops, bw, peak)

    rows_out = {}

    def record(key, shape, err, tol, kfn, pfn, nbytes, flops, lfn=None,
               source="", replaces="", extra=None, peak=fp64):
        check(err <= tol, f"{key}: max_abs_err {err:.3e} > tol {tol:.3e}")
        b_ms, b_by = bound(nbytes, flops, peak)
        row = dict(name=key, route="cuda", source=source, replaces=replaces,
                   shape=shape, max_abs_err=err, tol=tol,
                   ms=time_ms(torch, kfn), plain_ms=time_ms(torch, pfn),
                   bound_ms=b_ms, bound_by=b_by, bound_us=b_ms * 1e3,
                   library_ms=time_ms(torch, lfn) if lfn else None)
        row["kernel_ms"] = row["ms"]
        row.update(extra or {})
        rows_out[key] = row
        print(f"[kernels] {key} {shape}: err {err:.2e} (tol {tol:.0e}) "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")

    def err_of(a, b):
        return float((a - b).abs().max())

    # jacobi_halo_sweeps: one device-plane block of the g=2048 grid.
    g, sweeps = JACOBI_GRID, 10
    rows = g // 4
    xb, bb, top, bot = randn(rows, g), randn(rows, g), randn(g), randn(g)
    out, norm = ops.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps)
    want, wnorm = ref.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps)
    norm_rel = float((norm - wnorm).abs() / wnorm.abs())
    check(norm_rel <= 1e-12, f"halo norm rel err {norm_rel:.3e}")
    record("jacobi_halo_sweeps", [rows, g, sweeps], err_of(out, want), 0.0,
           lambda: ops.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps),
           lambda: ref.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps),
           (3 * rows * g + 2 * g) * 8, sweeps * rows * g * 5 + 3 * rows * g,
           source="src/repro_torch/csrc/jacobi_stencil.cu",
           replaces="src/repro/kernels/jacobi_stencil.py:78",
           extra=dict(norm_rel_err=norm_rel))

    # jacobi_sweep: the full map of the g=2048 grid, in both add orders;
    # timed in _full_sweep's ("jnp"), the problem's default.
    n = g * g
    x, b = randn(n), randn(n)
    pallas_err = err_of(ops.jacobi_sweep(x, b, g, "pallas"),
                        ref.jacobi_sweep(x, b, g, "pallas"))
    check(pallas_err == 0.0, f"jacobi_sweep (Pallas order) err {pallas_err}")
    record("jacobi_sweep", [n, "jnp order"],
           err_of(ops.jacobi_sweep(x, b, g, "jnp"),
                  ref.jacobi_sweep(x, b, g, "jnp")), 0.0,
           lambda: ops.jacobi_sweep(x, b, g, "jnp"),
           lambda: ref.jacobi_sweep(x, b, g, "jnp"), 3 * n * 8, 5 * n,
           source="src/repro_torch/csrc/jacobi_stencil.cu",
           replaces="src/repro/kernels/jacobi_stencil.py:109",
           extra=dict(pallas_order_max_abs_err=pallas_err))

    # bellman / bellman_block: the S=10^6 Garnet MDP and one worker block.
    S, A, B, gamma = VI_STATES, 4, 5, 0.95
    idx = torch.randint(0, S, (S, A, B), generator=gen, device=dev,
                        dtype=torch.int32)
    probs = torch.rand(S, A, B, generator=gen, **f64)
    probs /= probs.sum(-1, keepdim=True)
    R = torch.rand(S, A, generator=gen, **f64)
    v = randn(S)
    tv = ops.bellman(idx, probs, R, v, gamma=gamma)
    want = ref.bellman(idx, probs, R, v, gamma=gamma)
    record("bellman", [S, A, B], err_of(tv, want),
           1e-13 * float(want.abs().max()),
           lambda: ops.bellman(idx, probs, R, v, gamma=gamma),
           lambda: ref.bellman(idx, probs, R, v, gamma=gamma),
           *bellman_work(idx),
           source="src/repro_torch/csrc/bellman.cu",
           replaces="src/repro/kernels/bellman.py:80")
    rows_b = S // 4
    bi, bp, bR = idx[:rows_b], probs[:rows_b], R[:rows_b]
    v_old = randn(rows_b)
    tvb, nb = ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)
    wtv, wnb = ref.bellman_block(bi, bp, bR, v, v_old, gamma=gamma)
    check(float((nb - wnb).abs()) <= 1e-13 * float(wnb.abs()),
          "bellman_block norm disagrees")
    record("bellman_block", [rows_b, A, B, S], err_of(tvb, wtv),
           1e-13 * float(wtv.abs().max()),
           lambda: ops.bellman_block(bi, bp, bR, v, v_old, gamma=gamma),
           lambda: ref.bellman_block(bi, bp, bR, v, v_old, gamma=gamma),
           *bellman_work(bi, block=True),
           source="src/repro_torch/csrc/bellman.cu",
           replaces="src/repro/kernels/bellman.py:62")

    # anderson_mix: the Jacobi fire's (6, n) window (and VI's (6, S)),
    # every beta path checked, beta = 1 (the main path's) timed.
    h = 6
    errs = {}
    for N in (n, S):
        X, G = randn(h, N), randn(h, N)
        a = randn(h)
        a = a / a.sum()
        for beta in (1.0, 0.5, 0.0):
            got = ops.anderson_mix(X, G, a, beta=beta)
            want = ref.anderson_mix(X, G, a, beta=beta)
            errs[f"{N}/{beta}"] = err_of(got, want) / float(want.abs().max())
    X, G = randn(h, n), randn(h, n)
    a = randn(h)
    a = a / a.sum()
    worst = max(errs.values())
    record("anderson_mix", [h, n], worst, 1e-12,
           lambda: ops.anderson_mix(X, G, a, beta=1.0),
           lambda: ref.anderson_mix(X, G, a, beta=1.0),
           (h * n + h + n) * 8, 2 * h * n, lfn=lambda: a @ G,
           source="src/repro_torch/csrc/anderson_mix.cu",
           replaces="src/repro/kernels/anderson_mix.py:46",
           extra=dict(rel_err_by_n_beta=errs))
    del X, G, idx, probs, R
    torch.cuda.empty_cache()

    flash_row(torch, dev, record, bound, err_of, (fp32, bf16))
    return rows_out


#: flash-attention checks at small shapes (TestFlashAttention's sweep, a
#: q_offset case, ragged ones): B, Sq, Skv, nq, nkv, hd, causal, window,
#: softcap, q_offset
FLASH_SWEEP = [
    (1, 128, 128, 4, 4, 64, True, None, None, 0),
    (2, 256, 256, 8, 2, 64, True, None, None, 0),
    (2, 128, 128, 4, 1, 128, True, None, None, 0),
    (1, 256, 256, 4, 2, 64, True, 64, None, 0),
    (1, 128, 128, 2, 2, 64, True, None, 30.0, 0),
    (2, 128, 128, 4, 4, 64, False, None, None, 0),
    (1, 256, 256, 8, 2, 64, True, 32, 50.0, 0),
    (2, 64, 256, 4, 4, 64, True, None, None, 192),
    (2, 1000, 1000, 8, 4, 256, True, 300, 50.0, 0),
    (1, 131, 299, 4, 2, 16, True, 70, 50.0, 168),
]


def flash_row(torch, dev, record, bound, err_of, peaks_fp):
    """flash_attention at the Gemma-2-2B serve shape (a local layer of the
    LM main path) in float32 and bfloat16, plus the small sweep; timed
    against its plain version and, with the softcap off (SDPA has none),
    against ``scaled_dot_product_attention`` with an explicit mask.  The
    global layer's shape (no window) is checked and timed beside it."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.kernel_bench import (attention_pairs, flash_work,
                                                 time_ms)

    fp32, bf16 = peaks_fp
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    # At the serve shape a row of 4096 keys gives outputs of ~0.03, so 2e-2
    # would hide a bfloat16 fault; there both sides round the same float32
    # result to bfloat16, so hold each element to the float32 tolerance
    # plus two bfloat16 ulps of the plain value.
    bf16_rtol = 2.0 ** -6
    gen = torch.Generator(device=dev).manual_seed(1)
    sweep_err = {}
    for case in FLASH_SWEEP:
        B, Sq, Skv, nq, nkv, hd, causal, window, cap, off = case
        for dt, tol in tols.items():
            q = torch.randn(B, Sq, nq, hd, generator=gen, device=dev).to(dt)
            k = torch.randn(B, Skv, nkv, hd, generator=gen, device=dev).to(dt)
            v = torch.randn(B, Skv, nkv, hd, generator=gen, device=dev).to(dt)
            kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
            err = err_of(ops.flash_attention(q, k, v, **kw).float(),
                         ref.flash_attention(q, k, v, **kw).float())
            check(err <= tol, f"flash_attention {case} {dt}: err {err:.3e}")
            key = f"{dt}".replace("torch.", "")
            sweep_err[key] = max(sweep_err.get(key, 0.0), err)
    print(f"[kernels] flash_attention sweep ({len(FLASH_SWEEP)} shapes): "
          f"max err {sweep_err}")

    B, S, nq, nkv, hd, window, cap = LM_BATCH, LM_PROMPT, 8, 4, 256, 4096, 50.0
    pairs = attention_pairs(S, S, True, window)
    nbytes, flops = flash_work(B, S, nq, nkv, hd, window, 4)
    kw = dict(causal=True, window=window, softcap=cap)
    qf = torch.randn(B, S, nq, hd, generator=gen, device=dev)
    kf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    vf = torch.randn(B, S, nkv, hd, generator=gen, device=dev)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = qf.to(dt), kf.to(dt), vf.to(dt)
        got = ops.flash_attention(q, k, v, **kw).float()
        want = ref.flash_attention(q, k, v, **kw).float()
        err = err_of(got, want)
        rtol = bf16_rtol if dt == torch.bfloat16 else 0.0
        excess = float(((got - want).abs() - rtol * want.abs()).max())
        del got, want
        check(excess <= tols[torch.float32],
              f"flash_attention serve shape {dt}: |err| - {rtol:g}|ref| "
              f"reaches {excess:.3e} > {tols[torch.float32]:.0e}")
        if dt == torch.bfloat16:
            b_ms, b_by = bound(nbytes // 2, flops, bf16)
            out.update(bf16_max_abs_err=err,
                       bf16_tol=f"{tols[torch.float32]:g} + {rtol:g}|ref|",
                       bf16_ms=time_ms(torch, lambda: ops.flash_attention(
                           q, k, v, **kw)),
                       bf16_plain_ms=time_ms(torch, lambda: ref.flash_attention(
                           q, k, v, **kw), reps=5, warmup=1),
                       bf16_bound_ms=b_ms, bf16_bound_by=b_by)
            del q, k, v
            torch.cuda.empty_cache()
    # SDPA: the same masks (boolean, True = attend), GQA, no softcap.
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    nocap = dict(causal=True, window=window)
    lib_err = err_of(sdpa().transpose(1, 2),
                     ops.flash_attention(qf, kf, vf, **nocap))
    out.update(ms_softcap_off=time_ms(torch, lambda: ops.flash_attention(
                   qf, kf, vf, **nocap)),
               library_softcap="off", library_max_abs_err=lib_err,
               pairs=pairs, flops=flops, dtype="float32",
               sweep_max_abs_err=sweep_err)
    print(f"[kernels] flash_attention bf16 {[B, S, nq, nkv, hd]}: err "
          f"{out['bf16_max_abs_err']:.2e}, kernel {out['bf16_ms']:.3f} ms, "
          f"plain {out['bf16_plain_ms']:.3f} ms, bound "
          f"{out['bf16_bound_ms']:.4f} ms ({out['bf16_bound_by']}); f32 with "
          f"softcap off {out['ms_softcap_off']:.3f} ms (SDPA agrees to "
          f"{lib_err:.2e})")
    # The global layers (no window) of the same prefill.
    gkw = dict(causal=True, softcap=cap)
    _, gflops = flash_work(B, S, nq, nkv, hd, None, 4)
    got = ops.flash_attention(qf, kf, vf, **gkw)
    want = ref.flash_attention(qf, kf, vf, **gkw)
    g_err = err_of(got, want)
    del got, want
    torch.cuda.empty_cache()
    check(g_err <= tols[torch.float32],
          f"flash_attention global layer: err {g_err:.3e}")
    g_bound, g_by = bound(nbytes, gflops, fp32)
    out.update(global_max_abs_err=g_err, global_flops=gflops,
               global_ms=time_ms(torch, lambda: ops.flash_attention(
                   qf, kf, vf, **gkw)),
               global_plain_ms=time_ms(torch, lambda: ref.flash_attention(
                   qf, kf, vf, **gkw), reps=5, warmup=1),
               global_library_ms=time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True)),
               global_bound_ms=g_bound, global_bound_by=g_by)
    print(f"[kernels] flash_attention global layer {[B, S, nq, nkv, hd]}: "
          f"err {g_err:.2e}, kernel {out['global_ms']:.3f} ms, plain "
          f"{out['global_plain_ms']:.3f} ms, SDPA (causal, softcap off) "
          f"{out['global_library_ms']:.3f} ms, bound {g_bound:.4f} ms "
          f"({g_by})")
    q, k, v = qf, kf, vf
    record("flash_attention", [B, S, S, nq, nkv, hd, "causal", window, cap],
           err_of(ops.flash_attention(q, k, v, **kw),
                  ref.flash_attention(q, k, v, **kw)), tols[torch.float32],
           lambda: ops.flash_attention(q, k, v, **kw),
           lambda: ref.flash_attention(q, k, v, **kw), nbytes, flops,
           lfn=sdpa, source="src/repro_torch/csrc/flash_attention.cu",
           replaces="src/repro/kernels/flash_attention.py:132", extra=out,
           peak=fp32)
    del q, k, v, qf, kf, vf, qt, kt, vt, mask
    torch.cuda.empty_cache()


def run_path(label, problem, cfg):
    """One main-path run with the launch counters reset around it."""
    import numpy as np

    from repro_torch import run_fixed_point
    from repro_torch.kernels import ops

    r0 = problem.residual_norm(problem.initial())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_fixed_point(problem, cfg)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(res.x.shape == (problem.n,), f"{label}: iterate shape {res.x.shape}")
    check(bool(np.isfinite(res.x).all()), f"{label}: non-finite iterate")
    check(res.residual_norm < r0,
          f"{label}: residual {res.residual_norm:.3e} did not fall below "
          f"{r0:.3e}")
    print(f"[{label}] worker_updates {res.worker_updates}, fires "
          f"{res.accel_fires}, accepts {res.accel_accepts}, residual "
          f"{r0:.6e} -> {res.residual_norm:.6e}, run wall {res.wall_time:.3f}"
          f" s (call {wall:.3f} s), inline fires {res.fire_window_s:.3f} s,"
          f" coordinator busy share {res.coordinator_busy_frac:.3f}, "
          f"device_dispatches {res.device_dispatches}, device_refreshes "
          f"{res.device_refreshes}, launches {json.dumps(launches)}")
    return res, launches, r0


def main_cfg(**kw):
    from repro_torch import AndersonConfig, FaultProfile, RunConfig

    base = dict(mode="async", executor="thread", n_workers=4,
                device_plane="on", accel=AndersonConfig(m=5), fire_every=4,
                tol=1e-6, max_updates=200,
                faults={0: FaultProfile(delay_mean=0.1)})
    base.update(kw)
    return RunConfig(**base)


def jacobi_problem(dev):
    from repro_torch import JacobiProblem

    return JacobiProblem(grid=JACOBI_GRID, sweeps=10, seed=0, device=dev)


def vi_problem(dev):
    from repro_torch import GarnetMDP, ValueIterationProblem

    t0 = time.perf_counter()
    mdp = GarnetMDP(S=VI_STATES, A=4, b=5, gamma=0.95, seed=0,
                    sample="fast", device=dev)
    print(f"[vi] Garnet S={VI_STATES} built in "
          f"{time.perf_counter() - t0:.2f} s")
    return ValueIterationProblem(mdp)


def phase_jacobi(dev):
    import numpy as np

    prob = jacobi_problem(dev)
    res, launches, _ = run_path("jacobi", prob, main_cfg())
    for k in ("jacobi_halo_sweeps", "jacobi_sweep", "anderson_mix"):
        check(launches[k] > 0, f"jacobi: {k} was never launched")
    check(res.device_dispatches > 0, "jacobi: the device plane never ran")
    # One worker through the kernels against one through the numpy oracle.
    one = dict(n_workers=1, faults=None, max_updates=20)
    rk = run_path("jacobi-1w-kernel", prob, main_cfg(**one))[0]
    rr = run_path("jacobi-1w-ref", prob, main_cfg(device_plane="ref",
                                                  **one))[0]
    rel = float(np.max(np.abs(rk.x - rr.x)) / np.max(np.abs(rr.x)))
    print(f"[jacobi-1w] kernel vs numpy-oracle iterate rel diff {rel:.3e} "
          f"(tol 1e-12)")
    check(rk.worker_updates == rr.worker_updates == 20,
          "jacobi-1w: update counts differ")
    check(rel <= 1e-12, f"jacobi-1w: iterates differ by {rel:.3e}")
    return launches


def phase_vi(dev):
    res, launches, _ = run_path("vi", vi_problem(dev), main_cfg())
    for k in ("bellman_block", "bellman", "anderson_mix"):
        check(launches[k] > 0, f"vi: {k} was never launched")
    check(res.device_dispatches > 0, "vi: the device plane never ran")
    return launches


def phase_small_parity(dev):
    """Small inputs with a known answer: the committed Jacobi golden, and
    the card against the CPU's plain versions for accelerated VI."""
    import hashlib

    import numpy as np

    from repro_torch import (AndersonConfig, FaultProfile, GarnetMDP,
                             JacobiProblem, RunConfig, ValueIterationProblem,
                             run_fixed_point)

    faults = FaultProfile(delay_mean=0.002, delay_std=0.001)
    r = run_fixed_point(
        JacobiProblem(grid=16, sweeps=5, seed=0, device=dev),
        RunConfig(mode="async", tol=1e-10, max_updates=600, compute_time=1e-3,
                  faults=faults, seed=7))
    sha = hashlib.sha256(np.ascontiguousarray(r.x).tobytes()).hexdigest()
    got = (r.worker_updates, r.wall_time, sha)
    print(f"[parity] jacobi_async_plain on the card: {got}")
    check(got == _JACOBI_GOLDEN, "jacobi_async_plain golden not reproduced")
    cfg = RunConfig(mode="async", tol=1e-12, max_updates=800,
                    compute_time=1e-3, faults=faults, seed=11,
                    accel=AndersonConfig(m=5, mix_kernel_n=1), fire_every=4)
    runs = {}
    for d in (dev, "cpu"):
        runs[str(d)] = run_fixed_point(ValueIterationProblem(GarnetMDP(
            S=60, A=4, b=5, gamma=0.9, seed=0, device=d)), cfg)
    rc, rh = runs[str(dev)], runs["cpu"]
    rel = float(np.max(np.abs(rc.x - rh.x)) / np.max(np.abs(rh.x)))
    print(f"[parity] vi_async_accel card vs CPU: updates {rc.worker_updates}"
          f"/{rh.worker_updates}, fires {rc.accel_fires}/{rh.accel_fires}, "
          f"accepts {rc.accel_accepts}/{rh.accel_accepts}, rel diff "
          f"{rel:.3e} (tol 1e-12)")
    check((rc.worker_updates, rc.accel_fires, rc.accel_accepts)
          == (rh.worker_updates, rh.accel_fires, rh.accel_accepts),
          "vi parity: counts differ")
    check(rel <= 1e-12, f"vi parity: iterates differ by {rel:.3e}")


def phase_lm(torch, dev):
    """Gemma-2-2B at its published widths through lm_serve's functions."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve

    cfg = lm_serve.make_config(LM_ARCH)
    t0 = time.perf_counter()
    params = lm_serve.make_params(cfg, dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B float32 parameters drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    lm_serve.serve(cfg, params, lm_serve.make_prompt(cfg, LM_BATCH, 64, dev),
                   2)  # warm-up: cuBLAS handles and plans, not measured
    prompt = lm_serve.make_prompt(cfg, LM_BATCH, LM_PROMPT, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, params, prompt, LM_GEN)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check(tuple(res.tokens.shape) == (LM_BATCH, LM_GEN),
          f"lm: tokens shape {tuple(res.tokens.shape)}")
    check(bool(torch.isfinite(res.prefill_logits).all()),
          "lm: non-finite prefill logits")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "lm: token out of the vocabulary")
    check(launches["flash_attention"] == cfg.n_layers,
          f"lm: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {cfg.n_layers}")
    decode_s = res.decode_ms_per_step * (LM_GEN - 1) / 1e3
    print(f"[lm] prefill {LM_BATCH} x {LM_PROMPT} tokens: {res.prefill_s:.3f}"
          f" s ({LM_BATCH * LM_PROMPT / res.prefill_s:.0f} tokens/s); decode "
          f"{res.decode_ms_per_step:.2f} ms/step ({LM_BATCH * 1e3 / res.decode_ms_per_step:.1f}"
          f" tokens/s); {LM_BATCH * LM_GEN} tokens generated in "
          f"{res.prefill_s + decode_s:.3f} s "
          f"({LM_BATCH * LM_GEN / (res.prefill_s + decode_s):.1f} tokens/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; flash_attention "
          f"launches {launches['flash_attention']}")
    print(f"[lm] row0: {res.tokens[0].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return launches


def phase_lm_parity(torch, dev):
    """Gemma-2-2B widths at depth 2, window 128, prompt 512: the card (flash
    kernel) against the CPU (plain version) on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, window=128)
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         dtype=torch.float32, device=cpu)
    prompt = lm_serve.make_prompt(cfg, 2, 512, cpu, seed=1)
    t0 = time.perf_counter()
    want = lm_serve.serve(cfg, params, prompt, 9, keep_logits=True)
    cpu_s = time.perf_counter() - t0
    got = lm_serve.serve(cfg, params.to(dev), prompt.to(dev), 9,
                         keep_logits=True)
    rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in zip([got.prefill_logits] + got.step_logits,
                              [want.prefill_logits] + want.step_logits))
    same = torch.equal(got.tokens.cpu(), want.tokens)
    print(f"[lm-parity] depth 2, window 128, prompt 2 x 512, 8 decode steps:"
          f" logits rel diff {rel:.3e} (tol 1e-4), tokens identical {same} "
          f"(CPU run {cpu_s:.1f} s)")
    check(rel <= 1e-4, f"lm parity: logits differ by {rel:.3e}")
    check(same, "lm parity: greedy tokens differ")
    del params
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the full results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no repro_torch sources under {src}")
    sys.path.insert(0, str(src))
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # The LM stack's float32 products run in full float32, as the
    # reference's einsums do (PyTorch's default; stated, not assumed).
    torch.backends.cuda.matmul.allow_tf32 = False
    name = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch, dev, name)
    launches = {k: 0 for k in kernels}
    for path in (phase_jacobi, phase_vi, lambda d: phase_lm(torch, d)):
        for k, c in path(dev).items():
            launches[k] += c
    phase_small_parity(dev)
    phase_lm_parity(torch, dev)
    for k, row in kernels.items():
        row["launches"] = launches[k]
    line = {"kernels": list(kernels.values())}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(line, indent=1))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
