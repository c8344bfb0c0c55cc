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
   PyTorch call computes the same function) library times; the Jacobi
   halo kernel also at the paper's four-worker block (25 x 100) and the
   one-worker block (the whole grid), with its device time and CUDA
   launches per call as ``torch.profiler`` records them (at most 2 at 10
   sweeps: one pass and the norm's combine); ``anderson_mix`` at every
   beta at the Jacobi, VI, SCF and async-DP/DiLoCo windows (where the
   launcher must take 16-byte loads) and at an odd N through a misaligned
   window view (8-byte loads), the two giving the same bits at SCF's
   window, timed at the four windows by events and CUPTI beside
   ``a @ G``, VI's with the L2 flushed before every call;
   ``flash_attention`` at the Gemma-2-2B serve shape: float32 (the FFMA
   kernel) at the local and global layers, every element within 2e-5 of
   the plain version, and bfloat16 (the wgmma + TMA kernel) at both
   layers, held to the JAX package's own bfloat16 attention math (the max
   and the RMS of |kernel - plain| no larger than those of
   ``train_attention`` on the same inputs), each timed by events and
   CUPTI, with the softcap and without it beside
   ``scaled_dot_product_attention`` (the local layer's mask;
   ``is_causal`` at the global one); and bfloat16 at the MoE configs'
   prefill shape, q/k/v (2, 8192, 16, 128), causal, no window, no softcap,
   held to the reference's bfloat16 math for Qwen1.5-MoE's heads and timed
   beside SDPA ``is_causal``; and bfloat16 at the [lm-whisper] prefill's
   three layers (the encoder's (8, 1500, 20, 64) non-causal, the
   cross-attention's q (8, 224) against 1500 keys non-causal, the
   decoder's self-attention (8, 224) causal) and the [lm-vl] prefill's
   (q (2, 8192, 64, 128) against 8 KV heads, causal), each held to the
   reference's bfloat16 math and timed by events and CUPTI beside SDPA;
   the float32 local layer also beside SDPA with the window mask by
   events and CUPTI; ``selective_scan`` (the port's own kernel: Mamba's
   scan, which has no Pallas kernel) on a small sweep (d_state 8 and 16,
   float32 and bfloat16, with and without h0, lengths off the kernel's
   tiles) within 1e-5 of the plain scan, then at the [lm-jamba] prefill's
   shape, dt and xc (2, 8192, 16384) bfloat16, d_state 16, held to a
   float64 run of the plain scan (its max and RMS error at most
   ``SCAN_ERR_FACTOR`` times the plain float32 scan's), timed by events
   and CUPTI beside the plain scan at ``ssm_chunk`` 1024, with its byte
   bound and the exponentials' floor; ``moe_expert_ffn`` (the port's own
   kernel: a MoE layer's dropless decode) at the jamba.decode cell's
   shape (32 tokens, 16 experts, d 8192, f 24576, bfloat16), held to the
   plain version in float32, timed by events and CUPTI beside the plain
   version and the weight copy plus two ``torch.bmm`` it replaced, with
   its byte bound, launches, registers and spills;
4. Jacobi main path — g = 2048 (n = 4,194,304), 4 thread workers, the
   device plane on, Anderson(m=5), worker 0 a 100 ms straggler; then one
   worker through the kernels against one through the numpy oracle;
5. value-iteration main path — Garnet S = 10^6, A = 4, b = 5, same config;
6. SCF main path — the PPP chain of 1024 sites at U/|t| = 2 (the state is
   the 1024 x 1024 float64 density, n = 2^20), same config but DIIS(8) on
   every arrival; each worker update is one 1024 x 1024 ``eigh`` on the
   card, each fire combines a (9, 2^20) window through ``anderson_mix``;
   prints ms per ``full_map``, the energy and the final HOMO–LUMO gap;
7. small-input parity — the ``jacobi_async_plain`` golden trajectory
   reproduced byte for byte on the card, an accelerated VI run, the
   ``scf_async_plain``/``scf_async_diis`` golden configurations and a UHF
   reference energy on the card against the same runs on the CPU;
8. LM serving main path — Gemma-2-2B at its published widths (26 layers,
   float32, weights from a seeded generator) through
   ``repro_torch.launch.lm_serve``: batched prefill of 2 x 8192 tokens
   (past the 4096 window, so the local layers' window mask and ring caches
   bind) and 32 greedy tokens; prefill attention must launch the flash
   kernel once per layer;
8b. LM serving in bfloat16 — ``[lm-bf16]``: the same model and prompt in
   the config's own bfloat16 (weights, and the prefill's caches after
   them): 26 flash launches a prefill, all bfloat16 (the tensor-core
   kernel), finite logits, tokens in the vocabulary; prefill seconds and
   tokens/s, decode ms/step, peak memory, and one traced prefill's device
   time by kernel group (``lm_profile.breakdown``) with the flash share;
9. LM parity — Gemma-2-2B widths at depth 2 with window 128, prompt 512:
   prefill logits and 8 greedy decode steps on the card (kernel) against
   the same weights on the CPU (plain version); then ``[lm-bf16-parity]``:
   the same in bfloat16 with the vocabulary cut to 32768, the decode
   teacher-forced on the CPU's tokens (two bfloat16 runs may split at a
   near-tie), logits within ``LM_BF16_PARITY_TOL`` of the CPU's;
9b. MoE and xLSTM serving — ``[lm-moe]`` (Qwen1.5-MoE-A2.7B: 24 layers,
   60 experts padded to 64, top-4, 4 shared) and ``[lm-olmoe]``
   (OLMoE-1B-7B: 16 layers, 64 experts, top-8, QK-norm) at their published
   widths in bfloat16, the same prompt and generation as phase 8: one
   bfloat16 flash launch a layer a prefill, finite logits, tokens in the
   vocabulary; prefill seconds and tokens/s, decode ms/step, peak memory,
   the assignments the prefill dropped by capacity (factor 1.25), one
   ``moe_expert_ffn`` launch a layer and decode step, and one traced
   prefill's device time by kernel group (``moe_dispatch`` among them); ``[lm-xlstm]`` (xLSTM-125M, 12 layers [m, m, m, s], bfloat16):
   no flash launch, finite logits, prefill and decode times, peak memory
   and the sLSTM loops' share of the prefill.  Then ``[lm-moe-parity]``
   (Qwen1.5-MoE widths at depth 1, vocab 32768, prompt 4 x 256, 8 decode
   steps teacher-forced on the CPU's tokens; float32 to 1e-4, bfloat16 to
   ``LM_BF16_PARITY_TOL``; the card takes the CPU's experts where its
   top-k set differs, each such flip a near-tie on the CPU, ``MOE_TIE``)
   and ``[lm-xlstm-parity]`` (xLSTM-125M widths at depth 4, float32, prompt
   2 x 1024; the whole model amplifies rounding, so each piece runs on
   the card from the CPU's inputs: each sLSTM step and each decode step
   against the CPU's, each mLSTM layer, parallel and ``ssm_chunk=256``,
   against the float64 answer, all to 1e-4); each model is freed before
   the next;
9c. Encoder-decoder and vision-language serving — ``[lm-whisper]``
   (Whisper-large-v3 whole: 32 encoder + 32 decoder layers, bfloat16, 8
   clips of 1500 seeded frame embeddings, a 224-token prompt, 32 greedy
   tokens, after a warm-up at the same shapes): 96 bfloat16 flash
   launches a prefill, 32 each for the encoder, self- and
   cross-attention (counted by role, with their host time, in one more
   prefill); prefill and encoder seconds, decode ms/step, peak memory and
   one traced prefill's split by kernel group; ``[lm-vl]`` (Qwen2-VL-72B's widths at depth 8
   of 80, bfloat16, 2 x 8192 tokens whose first 2048 are a seeded vision
   block on a 1 x 32 x 64 grid with M-RoPE ids, decode ids continuing
   the text's apart from the cache index): 8 flash launches, the same
   figures.  After ``[lm-xlstm-parity]``, ``[lm-whisper-parity]``
   (Whisper's widths, 2 + 2 layers, 2 x 64 frames, prompt 2 x 32) and
   ``[lm-vl-parity]`` (Qwen2-VL's widths at depth 2, vocab 32768, prompt
   2 x 256 with a 64-position vision block) hold the card to the CPU on
   the same weights (drawn on the card), float32 to 1e-4 and bfloat16 to
   ``LM_BF16_PARITY_TOL``, 8 decode steps teacher-forced on the CPU's
   tokens, and print each dtype's seconds by step (draw, copy to the
   CPU, CPU run, card run);
9d. Hybrid serving — ``[lm-jamba]`` (Jamba-1.5-Large's widths at depth 5
   of 72: layers (mamba, mlp), (mamba, moe), (mamba, mlp), (mamba, moe),
   (attn, mlp); d 8192, 64/8 heads of 128, d_ff 24576, 16 experts top-2,
   Mamba d_state 16 and d_inner 16384, vocab 65536 untied; ~24.05 B
   bfloat16 parameters; ``ssm_chunk`` 1024), the serve cell's prompt and
   generation after a warm-up at the same shapes: 1 bfloat16 flash
   launch and 4 ``selective_scan`` launches a prefill, neither in decode,
   one ``moe_expert_ffn`` launch a MoE layer and decode step; parameter
   count, prefill and decode times, peak memory and a traced
   prefill's split by kernel group (``selective_scan`` among them).
   After ``[lm-vl-parity]``, ``[lm-jamba-parity]``: (a) Jamba's widths at
   depth 1 (its (mamba, mlp) layer), vocab 32768, prompt 2 x 256,
   ``ssm_chunk`` 64, float32 to 1e-4 and bfloat16 to
   ``LM_BF16_PARITY_TOL``; (b) the reduced full period (every sublayer
   kind) in float32 to 1e-4, 7 ``selective_scan`` launches a prefill;
10. process backend — the Jacobi g = 2048 and SCF main paths on
   ``executor="process"`` (4 spawned workers, each with its own CUDA
   context on the card; without MPS their kernels time-slice): the Jacobi
   halo kernel must launch in the workers; then one worker's Jacobi run
   equal byte for byte to one thread worker's, on a cold pool and again
   on the warm pool, which must spawn no interpreter; the pools' cold
   start is printed;
11. chaos — ``[chaos]``: the Jacobi main path (thread backend,
   ``main_cfg()``) under ``get_scenario("spot_wave", 4)`` and the VI one
   under ``rolling_restart``, at the library's defaults, beside the same
   runs without the scenario (device plane on, and on the host path a
   scenario forces); prints walls, preemptions, joins, reassigned blocks,
   partial commits, discards and the residual, and checks the kernels of
   those host paths launched;
12. recover — ``[recover]``: the Jacobi main path at ``SIDE_UPDATES``
   updates with ``checkpoint_every=RECOVER_EVERY`` into a temporary
   directory (removed after),
   once through, then with a scripted ``coordinator_crash`` half-way
   through that run's wall, and ``resume_fixed_point`` to the end; prints
   bytes and seconds per checkpoint write, load and restore seconds and
   the resumed wall, and checks ``wu`` continuity and that no fire
   replays; on the thread backend and then on the process backend, whose
   runs reuse phase 10's warm pool (0 spawns), after which every pool is
   shut down;
13. recover parity — ``[recover-parity]``: a scripted virtual Jacobi run
   with Anderson (through ``anderson_mix``) on the card against the CPU,
   and on each its resume at a mid ``wu`` against the uninterrupted run;
14. telemetry — ``[telemetry]``: the Jacobi main path with
   ``telemetry=True`` beside the same run without it (both walls, span
   counts, staleness p50/p95, the fire ledger against ``accel_fires`` and
   ``accel_accepts``, the busy-share tail, a lane per worker, each
   worker's fused block-local norm, ``run_report --validate`` on the
   saved capture, and a fire's split from the spans: mean, p95 and share
   of the wall); then VI S = 10^6 on the process backend with telemetry,
   whose worker lanes arrive as ``"tel"`` batches and whose fused norms
   cover the four workers;
15. autoscale — ``[autoscale]``: VI S = 10^6 on threads under
   ``get_policy("target_staleness")`` with the straggler: the decision
   log, ``controller_actions``, ``worker_seconds``, ``run_cost``; no
   device plane under a controller;
16. serve — ``[serve]``: a ``SolverService`` (``max_active=2``, tenants
   a:2 b:1, telemetry) multiplexing 4 VI and 2 Jacobi main-path requests
   on the thread backend (two families on the card at once): each
   ticket's wait and service ms, throughput, p50/p95 latency, served
   counts and the Prometheus round trip; then 3 VI requests through one
   process pool, which spawns nothing after the first;
17. train — ``[train]`` (after phase 9, before any process pool holds a
   context): Gemma-2-2B at its published widths (26 layers, ~2.61 B
   float32 parameters from a seeded generator, TF32 off) takes one
   warm-up and 4 timed AdamW steps of ``SyntheticLM`` batches of 2 x 2048
   tokens through ``make_train_step`` with ``accum=2`` (microbatches of
   1 x 2048, each period recomputed in the backward pass); prints loss,
   grad norm and seconds per step, tokens/s, peak memory and the step's
   share of the float32 non-tensor peak (8 N tokens FLOP a step), and
   checks finite losses, every parameter changed and no
   ``flash_attention`` launch under grad; writes no checkpoint;
18. train parity — ``[train-parity]``: Gemma-2-2B widths at depth 2,
   window 128, vocab cut to 32768 (so the CPU side stays short), batch
   2 x 256: two train steps on the card against the CPU on the same
   weights: loss and every gradient leaf within 1e-4 relative; after
   AdamW each parameter within lr / 10, but for at most 1e-4 of them,
   each with a gradient within 100x of the card's difference from the
   CPU's (a sign Adam may flip), within 2 lr a step;
19. async data-parallel training — ``[async-dp]``: the experiment of
   ``benchmarks/async_dp_lm.py`` (``repro_torch.launch.async_dp_lm``,
   fast budget, virtual backend, worker 0 a 0.05 s straggler) at a
   config grown so θ (n = 2,950,400) reaches ``anderson_mix``:
   full-gradient and block-gradient workers, plain and with Anderson(5)
   every 8 arrivals; checks ``anderson_mix`` launched and both plain runs
   reduced the loss, prints the paper's prediction beside the outcome;
20. DiLoCo — ``[diloco]``: the same config, 4 pods x 4 inner steps x 6
   outer steps with Anderson(5), sync and then async with pod 0 a 3 s
   straggler; checks the loss fell and ``anderson_mix`` launched;
21. query-chunked training — ``[train-chunk]``: Gemma-2-2B at its
   published widths, one sequence of 8192 tokens, ``adjusted_config``'s
   ``attn_chunk`` 1024, AdamW at learning rate 0: a warm-up and one
   timed step (s/step, peak), then one step with ``attn_chunk=None`` from
   the same weights and batch (loss 1e-5, gradient leaves 1e-4, chunked peak no higher;
   if the unchunked step runs out of memory, the finding and the same
   checks at 4096 tokens); with the allocator's expandable segments;
22. dry run — ``[dryrun]``: the meta-device dry run
   (``repro_torch.launch.dryrun``) at the shapes of ``[train]``,
   ``[train-chunk]``, ``[lm-bf16]``, ``[lm-jamba]`` and ``[lm-vl]``,
   beside each phase's measured peak and time: the resident estimate at
   most the peak (the ratio printed), the compute term beside the
   measured step (``[train]``: its share of the float32 peak), the
   traced product FLOPs beside ``model_flops``; ``[dryrun --all]``, the
   last phase, prints ``dryrun --all`` over the reference's cell list at
   one card (a line a cell), traced in two processes that see no card
   beside the phases from ``[process]`` on;
23. examples — ``[examples]``: ``repro_torch.examples`` serve_batched
   (decode equals teacher forcing), train_lm (crash, resume, the loss
   keeps falling), diloco_async (every run's loss falls) and quickstart
   (Jacobi at ``QUICKSTART_GRID``, VI at the example's size; every run
   converges) on the card, with their seconds and kernel launches;
24. sharding — ``[shard]``: the band-sharded Jacobi sweep with 2 and 4
   bands on the one card at the Jacobi worker block (512 x 2048) and the
   whole grid (2048 x 2048), 10 sweeps, equal byte for byte to the
   one-band kernel (norms within 1e-12), its launches (bands x 10 a call)
   and ms a call beside the one-band call's; on a one-rank ``nccl``
   group, ``moe_ffn_a2a`` at Qwen1.5-MoE-A2.7B's layer widths on 2 x 8192
   bfloat16 tokens (capacity factor ``SHARD_MOE_CF``: nothing dropped)
   and ``moe_ffn(dropless=True)`` (the expert kernel), each against the
   layer in float32 on the same bfloat16 inputs within ``SHARD_MOE_TOL``,
   which two planted faults exceed (an expert's ``wo`` zeroed, the gate's
   activation swapped), and a
   (1, 1)-mesh train step against the one-rank step at
   ``[train-parity]``'s size and tolerances; then two processes on the
   card over ``gloo`` (which takes CUDA tensors) run the (1, 2) mesh's
   all-to-all at the same widths (float32, ``SHARD_GLOO_TOKENS``), its
   output and token and router gradients against the one-rank dropless
   layer on the CPU within 1e-4, and the (2, 1) mesh's ZeRO train step (the
   reduce-scatter, chunked AdamW and all-gather) against the one-rank
   step on the whole batch within 1e-5;
25. tensor parallelism — ``[tp]``: two processes on the card over
   ``gloo`` at mesh (1, 2) run Gemma-2-2B's serve path through
   ``build_prefill``/``build_decode`` on each rank's slices (26 layers,
   bfloat16, weights drawn on the card, a 2 x 8192 prefill and
   ``TP_DECODE`` teacher-forced decode steps), against the one-rank run
   of the same weights: 26 flash launches a prefill at a rank's heads,
   seconds a prefill and peak memory a process (the card's name and
   power limit beside them), the bytes the collectives moved in one
   prefill equal to the dry run's count for the same cell, and the
   logits no further from the float32 run of the same weights than
   ``TP_EXACT_FACTOR`` times the one-rank bfloat16 run's; the same at
   depth 2 in bfloat16 (3e-2 of the one-rank run) and float32 (1e-4);
   and a (1, 2) train step at ``[train-parity]``'s size against the
   one-rank step (loss and every gradient leaf, put together from the two
   slices, within 1e-4; the loss falls over ``TP_TRAIN_STEPS`` steps).
   NCCL with two ranks is not run: it refuses two ranks on one card;
26. multi-rank dry run — ``[dryrun-mesh]``: ``DRYRUN_MESH_CELLS`` at
   16x16 and 2x16x16 (and Jamba ``decode_32k``, xLSTM ``long_500k`` at
   16x16), traced in a process that sees no card beside ``[tp]`` and
   ``[tp-inner]``: both byte counts, the collectives and the three terms;
27. the ``"inner"`` split and sequence-split caches — ``[tp-inner]``:
   two processes on the card over ``gloo`` at mesh (1, 2), each
   building only its slices from the seed (``init_params(mesh=)``):
   Jamba-1.5-Large at its published widths, depth 5 (every sublayer
   kind), bfloat16, a 2 x 8192 prefill and ``TPI_DECODE`` decode steps:
   4 ``selective_scan`` launches a rank at (2, 8192, 8192) and one flash
   launch at q (2, 8192, 32, 128), the collectives of one prefill equal
   to the dry run's count, seconds a prefill, ms a decode step and peak
   memory a process; the same widths at depth 2 with every sublayer kind
   (``TPI_PARITY_LAYERS``) against the one-rank run in float32 (1e-4)
   and, in bfloat16, no further from that float32 answer than
   ``TPI_BF16_FACTOR`` times the one-rank bfloat16 run's; xLSTM-125M
   whole, float32, 2 x 1024 + ``TPI_DECODE`` steps, no further from the
   float64 run of the same weights than ``TPI_XLSTM_FACTOR`` times the
   one-rank float32 run's; and Gemma-3-4B's batch-1 decode against
   524,288-position caches filled from a seed (no prefill), each rank
   holding half the positions of every layer under
   ``long_decode_rules``, ``TPI_LONG_STEPS`` steps, no further from the
   float32 run's logits than ``TP_EXACT_FACTOR`` times one rank's.
28. Ray backend — ``[ray]`` (after ``[process]``, in a child process, so
   nothing of it stays in this one; the child starts with ``[process]``
   and waits to be told to go, so that its torch import overlaps that
   phase): the real ``ray`` where it imports,
   else ``tests/torch_ray_standin.py`` (the first line names which); the
   Jacobi main path on 4 CUDA actors that share the card at
   ``SIDE_UPDATES`` updates with telemetry,
   a ``RAY_SYNC_UPDATES``-update sync run of the same solve on the warm
   pool, VI S = 10^6 async on 4 actors, and one actor's Jacobi run
   (``RAY_1W_UPDATES`` updates) against one thread worker's bytes, cold
   and then warm with no actor created; prints wall, updates, fires,
   accepts, staleness p50/p95, each pool's cold start, and the actors'
   launches (``jacobi_halo_sweeps``, ``bellman``) apart from the
   coordinator's (``jacobi_sweep``, ``anderson_mix``), each of which
   must be > 0; its launches join the kernels line.

To fit a 900 s time limit on one H100, the runs that repeat a main path under
another feature take ``SIDE_UPDATES`` updates (200 before ``[tp]`` was
added) and ``[jacobi]``'s one-worker comparison ``JACOBI_1W_UPDATES``
(20 before).

After each phase a ``[time]`` line gives its seconds and the total so
far.  The ``{"kernels": [...]}`` line carries, per kernel, the launches counted
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
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: main-path sizes: the Jacobi grid side, the Garnet state count and the
#: PPP chain's sites (its state is the SCF_ATOMS^2 density matrix), with
#: the SCF path's DIIS window
JACOBI_GRID = 2048
VI_STATES = 10 ** 6
SCF_ATOMS, SCF_DIIS_M = 1024, 8

#: LM serving main path: Gemma-2-2B, batch x prompt tokens, tokens generated
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "gemma2_2b", 2, 8192, 32

#: the MoE and xLSTM serving cells (phase label, arch), served at the same
#: batch, prompt and generation in each config's bfloat16
LM_MOE = (("lm-moe", "qwen2_moe_a2p7b"), ("lm-olmoe", "olmoe_1b_7b"))
LM_XLSTM = "xlstm_125m"

#: the encoder-decoder serving cell: whisper-large-v3 at its published
#: widths, batch 8 of 30-s clips (``inputs.WHISPER_FRAMES`` post-conv
#: frames each), a 224-token decoder prompt (half Whisper's 448-token text
#: context) and LM_GEN greedy tokens
LM_WHISPER, WHISPER_BATCH, WHISPER_PROMPT = "whisper_large_v3", 8, 224
#: the vision-language serving cell: qwen2-vl-72b's widths, depth cut from
#: 80 to 8 layers (80 hold ~145 GB of bfloat16 weights), LM_BATCH x
#: LM_PROMPT tokens whose first quarter is a vision block
LM_VL, VL_LAYERS = "qwen2_vl_72b", 8
#: the hybrid serving cell: jamba-1.5-large's widths, depth cut from 72 to
#: 5 layers (layers 0-4 hold every sublayer kind of its period: (mamba,
#: mlp), (mamba, moe), (attn, mlp)), with the reference's ssm_chunk for a
#: prefill over 1024 tokens (``adjusted_config``: read by the plain scan
#: only; the card's kernel walks time in order)
LM_JAMBA, JAMBA_LAYERS, JAMBA_SSM_CHUNK = "jamba_1p5_large_398b", 5, 1024

#: [kernels] selective_scan: the kernel's max and RMS error against a
#: float64 run of the plain scan may be at most this many times the plain
#: float32 scan's own (time in order against a doubling scan; a CPU
#: emulation of the sequential order measured 1.3x the doubling scan's max
#: error and 1.03x its RMS at (1, 8192, 128, 16))
SCAN_ERR_FACTOR = 4
#: the small selective_scan cases, (B, S, d_inner), each at d_state 8 and
#: 16, float32 and bfloat16, with and without h0: S = 1, and lengths that
#: are no multiple of the kernel's 16- and 32-step tiles
SCAN_SWEEP = [(1, 1, 32), (2, 33, 130), (2, 515, 384)]

#: LM training main path (its shape is ``launch/train_profile.py``'s): timed
#: steps, after one warm-up step
TRAIN_STEPS = 4

#: [train-chunk]: one sequence of this many tokens, Gemma-2-2B at its
#: published widths with ``inputs.adjusted_config``'s ``attn_chunk``
#: (1024 above 4096 tokens); the tokens the chunked and unchunked steps
#: are compared at if the unchunked one runs out of memory (4 chunks)
TRAIN_CHUNK_SEQ, TRAIN_CHUNK_FALLBACK = 8192, 4096

#: [examples]: quickstart's Jacobi grid side (the example's is 50, whose
#: whole run took 42.9 s on the card: over this phase's budget) and
#: Garnet states (the example's)
QUICKSTART_GRID, QUICKSTART_VI_STATES = 24, 200

#: [dryrun --all]: its worker processes (two of the host's cores, beside
#: the last phases) and its time limit (s) once those phases are done
DRYRUN_JOBS, DRYRUN_TIMEOUT = 2, 400

#: what the phases measured, by label, for [dryrun] to hold its estimates
#: against: peak bytes and seconds
MEASURED = {}

#: the card's name and power limit as ``nvidia-smi`` gives them (phase 1)
CARD = "card not read"

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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
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
    from repro_torch.kernels.jacobi_stencil import halo_plan
    from repro_torch.launch.kernel_bench import (anderson_work,
                                                 bellman_work, bound_ms,
                                                 device_profile,
                                                 jacobi_halo_work, peaks,
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
               source="", replaces="", extra=None, peak=fp64, note=""):
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
              f"bound {b_ms:.4f} ms ({b_by}){note}")

    def err_of(a, b):
        return float((a - b).abs().max())

    # jacobi_halo_sweeps: one device-plane block of the g=2048 grid (timed),
    # then the paper's 100 x 100 grid's block with four workers and the
    # whole grid (the one-worker block); all exact.  Launches per call are
    # what CUPTI records.
    g, sweeps = JACOBI_GRID, 10
    rows = g // 4
    main = (rows, g, sweeps)
    xb, bb, top, bot = randn(rows, g), randn(rows, g), randn(g), randn(g)
    extra_gen = torch.Generator(device=dev).manual_seed(3)
    halo_err = {}
    for shape in (main, (25, 100, sweeps), (g, g, sweeps)):
        r, gg, sw = shape
        args = ((xb, top, bot, bb) if shape == main else
                tuple(torch.randn(*dims, generator=extra_gen, **f64)
                      for dims in ((r, gg), (gg,), (gg,), (r, gg))))
        out, norm = ops.jacobi_halo_sweeps(*args, sweeps=sw)
        want, wnorm = ref.jacobi_halo_sweeps(*args, sweeps=sw)
        err, rel = err_of(out, want), float((norm - wnorm).abs() / wnorm.abs())
        if shape == main:
            norm_rel = rel
        halo_err[str(list(shape))] = err
        check(err == 0.0 and rel <= 1e-12, f"jacobi_halo_sweeps {shape}: "
              f"err {err:.3e}, norm rel err {rel:.3e}")
    del args, out, want

    def halo():
        return ops.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps)

    passes = halo_plan(rows, g, sweeps)[0]
    dev_ms, per_call = device_profile(torch, halo)
    check(per_call == passes + 1 <= 2,
          f"jacobi_halo_sweeps: {per_call} CUDA launches per call at "
          f"{sweeps} sweeps, expected {passes} pass(es) + 1 combine <= 2")
    record("jacobi_halo_sweeps", list(main), halo_err[str(list(main))], 0.0,
           halo,
           lambda: ref.jacobi_halo_sweeps(xb, top, bot, bb, sweeps=sweeps),
           *jacobi_halo_work(rows, g, sweeps),
           source="src/repro_torch/csrc/jacobi_stencil.cu",
           replaces="src/repro/kernels/jacobi_stencil.py:78",
           extra=dict(norm_rel_err=norm_rel, device_ms=dev_ms,
                      launches_per_call=per_call,
                      exact_at_shapes=halo_err),
           note=f", device {dev_ms:.4f} ms, {per_call:g} CUDA launches per "
                f"call; exact at {sorted(halo_err)}")

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

    # anderson_mix: every beta path at the Jacobi fire's (6, n), VI's (6, S),
    # SCF's (9, 2^20) and the async-DP/DiLoCo fire's (6, θ size) windows,
    # where the launcher must take 16-byte loads, and at an odd N through a
    # window view one row into a ring buffer, whose rows alternate between
    # aligned and 8 bytes off, where it takes 8-byte loads.  Then beta = 1
    # (the main paths') timed at the four windows beside `a @ G`, VI's with
    # the L2 flushed before every call (its 56 MB nearly fit the 50 MB L2;
    # a fire finds its window cold).
    from repro_torch.kernels.anderson_mix import plan_of
    from repro_torch.launch.kernel_bench import l2_flush

    h = 6
    hs, Ns = SCF_DIIS_M + 1, SCF_ATOMS ** 2
    n_dp = async_dp_theta_size()
    odd_buf = [randn(12, 1_000_001) for _ in range(2)]
    windows = {"jacobi": (randn(h, n), randn(h, n), "vector"),
               "vi": (randn(h, S), randn(h, S), "vector"),
               "scf": (randn(hs, Ns), randn(hs, Ns), "vector"),
               "async_dp": (randn(h, n_dp), randn(h, n_dp), "vector"),
               "odd_view": (odd_buf[0][1:7], odd_buf[1][1:7], "scalar")}
    errs, mixes = {}, {}
    for label, (X, G, kernel) in windows.items():
        a = randn(X.shape[0])
        a = a / a.sum()
        for beta in (1.0, 0.5, 0.0):
            taken = plan_of(X, G, beta).kernel
            check(taken == kernel, f"anderson_mix {label} {list(X.shape)} "
                  f"beta {beta}: the launcher took the {taken} kernel, "
                  f"expected {kernel}")
            got = ops.anderson_mix(X, G, a, beta=beta)
            want = ref.anderson_mix(X, G, a, beta=beta)
            errs[f"{label}/{beta}"] = (err_of(got, want)
                                       / float(want.abs().max()))
        mixes[label] = (X, G, a)
    del odd_buf, got, want
    # 8-byte loads from a copy of SCF's window one element off a 16-byte
    # boundary give the 16-byte loads' bits.
    X, G, a = mixes["scf"]
    Go = torch.empty(G.numel() + 1, dtype=G.dtype, device=dev)[1:]
    Go = Go.view(G.shape).copy_(G)
    check(plan_of(X, Go, 1.0).kernel == "scalar", "anderson_mix: a window "
          "one element off a 16-byte boundary took 16-byte loads")
    check(torch.equal(ops.anderson_mix(X, Go, a, beta=1.0),
                      ops.anderson_mix(X, G, a, beta=1.0)),
          "anderson_mix: 8-byte and 16-byte loads disagree in bits")
    del Go
    flush = l2_flush(torch, dev)
    timed = {}
    for label, cold in (("jacobi", False), ("vi", True), ("scf", False),
                        ("async_dp", False)):
        X, G, a = mixes[label]
        between = flush if cold else None

        def kernel():
            return ops.anderson_mix(X, G, a, beta=1.0)

        def library():
            return a @ G

        b_ms, b_by = bound(*anderson_work(*X.shape))
        t = dict(shape=list(X.shape), kernel=plan_of(X, G, 1.0).kernel,
                 l2_flush=cold, ms=time_ms(torch, kernel, between=between),
                 device_ms=device_profile(torch, kernel, between=between)[0],
                 plain_ms=time_ms(torch, lambda: ref.anderson_mix(
                     X, G, a, beta=1.0), between=between),
                 library_ms=time_ms(torch, library, between=between),
                 library_device_ms=device_profile(torch, library,
                                                  between=between)[0],
                 bound_ms=b_ms, bound_by=b_by)
        t.update(bound_share=b_ms / t["ms"],
                 device_bound_share=b_ms / t["device_ms"])
        timed[label] = t
        print(f"[kernels] anderson_mix {label} {t['shape']} ({t['kernel']} "
              f"loads{', L2 flushed' if cold else ''}): kernel "
              f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, a @ G "
              f"{t['library_ms']:.4f} ms, device "
              f"{t['library_device_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{100 * t['bound_share']:.1f}% by events, "
              f"{100 * t['device_bound_share']:.1f}% by device time)")
    del flush
    X, G, a = mixes["jacobi"]
    record("anderson_mix", [h, n], max(errs.values()), 1e-12,
           lambda: ops.anderson_mix(X, G, a, beta=1.0),
           lambda: ref.anderson_mix(X, G, a, beta=1.0),
           *anderson_work(h, n), lfn=lambda: a @ G,
           source="src/repro_torch/csrc/anderson_mix.cu",
           replaces="src/repro/kernels/anderson_mix.py:46",
           extra=dict(rel_err_by_window_beta=errs, windows=timed),
           note=f", max rel err {max(errs.values()):.2e} over "
                f"{sorted(windows)} x beta {{1, 0.5, 0}}")
    del X, G, mixes, idx, probs, R
    torch.cuda.empty_cache()

    flash_row(torch, dev, record, bound, err_of, (fp32, bf16))
    rows_out["selective_scan"] = scan_row(torch, dev, bound, fp32)
    rows_out["moe_expert_ffn"] = moe_row(torch, dev, bound, bf16)
    return rows_out


def scan_row(torch, dev, bound, fp32):
    """selective_scan (the port's own kernel: Mamba's scan has no Pallas
    kernel) on the small sweep (``SCAN_SWEEP``, within 1e-5 relative of
    the plain version), then at the [lm-jamba] prefill's shape: dt and xc
    (2, 8192, 16384) bfloat16, d_state 16, A = -(1..16) (Mamba's S4D-real
    init).  Held to a float64 run of the plain scan on the same inputs:
    the kernel's max and RMS error no larger than ``SCAN_ERR_FACTOR``
    times the plain float32 scan's (both at ``ssm_chunk`` 1024, by slabs
    of 1024 channels: the scan is independent per channel).  Timed by
    events and CUPTI beside the plain scan at ``ssm_chunk`` 1024 (one
    call), and again with B and C as the model's views (the last columns
    of a (2, 8192, 544) ``x_proj`` output); bound by bytes, and the
    exponentials' floor at 16 a clock an SM at the card's maximum SM
    clock; with the registers ``ptxas`` gave that instantiation.  No
    single PyTorch call computes it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.kernel_bench import (SCAN_PROJ, device_profile,
                                                 exp_floor_ms,
                                                 max_sm_clock_hz,
                                                 ptxas_report, scan_inputs,
                                                 selective_scan_work,
                                                 time_ms)

    gen = torch.Generator(device=dev).manual_seed(4)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    sweep_err = 0.0
    for ds in (8, 16):
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                for B_, S_, di_ in SCAN_SWEEP:
                    args = scan_inputs(torch, dev, gen, B_, S_, di_, ds,
                                       dtype)
                    h0 = (torch.randn(B_, di_, ds, generator=gen, device=dev)
                          if with_h0 else None)
                    y, h = ops.selective_scan(*args, h0)
                    wy, wh = ref.selective_scan(*args, h0)
                    err = max(rel(y, wy), rel(h, wh))
                    check(err <= 1e-5, f"selective_scan {(B_, S_, di_, ds)} "
                          f"{dtype} h0 {with_h0}: rel err {err:.3e}")
                    sweep_err = max(sweep_err, err)
    cfg = get_config(LM_JAMBA)
    B, S = LM_BATCH, LM_PROMPT
    di, ds = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
    dt, xc, Bm, Cm, _ = scan_inputs(torch, dev, gen, B, S, di, ds,
                                    torch.bfloat16)
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device=dev).expand(
        di, ds).contiguous()
    y, h = ops.selective_scan(dt, xc, Bm, Cm, A)
    errs = {k: [0.0, 0.0] for k in ("kernel_y", "plain_y", "kernel_h",
                                    "plain_h")}  # max, sum of squares
    slab = 1024
    for c0 in range(0, di, slab):
        sl = slice(c0, c0 + slab)
        args = (dt[..., sl], xc[..., sl], Bm, Cm, A[sl])
        y64, h64 = ref.selective_scan(*args, chunk=JAMBA_SSM_CHUNK,
                                      acc=torch.float64)
        y32, h32 = ref.selective_scan(*args, chunk=JAMBA_SSM_CHUNK)
        for key, got, want in (("kernel_y", y[..., sl], y64),
                               ("plain_y", y32, y64),
                               ("kernel_h", h[:, sl], h64),
                               ("plain_h", h32, h64)):
            d = got.double() - want
            errs[key][0] = max(errs[key][0], float(d.abs().max()))
            errs[key][1] += float(d.pow(2).sum())
        del y64, h64, y32, h32, d
    counts = {"y": y.numel(), "h": h.numel()}
    err = {k: (m, math.sqrt(ss / counts[k[-1]])) for k, (m, ss) in
           errs.items()}
    for part in ("y", "h"):
        (km, kr), (pm, pr) = err[f"kernel_{part}"], err[f"plain_{part}"]
        check(km <= SCAN_ERR_FACTOR * pm and kr <= SCAN_ERR_FACTOR * pr,
              f"selective_scan {part}: kernel max/RMS {km:.3e}/{kr:.3e} vs "
              f"float64 beyond {SCAN_ERR_FACTOR} x the plain float32 scan's "
              f"{pm:.3e}/{pr:.3e}")
    # a (1, 2) rank's channels ([tp-inner]'s prefill): the first half
    rdi = di // TPI_MESH[1]
    rargs = (dt[..., :rdi].contiguous(), xc[..., :rdi].contiguous(), Bm, Cm,
             A[:rdi].contiguous())
    y_rank = y[..., :rdi].clone()
    del y, h
    torch.cuda.empty_cache()

    def kernel():
        return ops.selective_scan(dt, xc, Bm, Cm, A)

    def kernel_rank():
        return ops.selective_scan(*rargs)

    rank_err = float((kernel_rank()[0] - y_rank).abs().max())
    check(rank_err == 0.0, f"selective_scan at a rank's channels: "
          f"{rank_err:.3e} from the whole call's")
    r_bytes, r_flops, r_exp = selective_scan_work(B, S, rdi, ds, 2)
    rb_ms, rb_by = bound(r_bytes, r_flops, fp32)

    Bv, Cv = scan_inputs(torch, dev, gen, B, S, di, ds, torch.bfloat16,
                         proj=SCAN_PROJ)[2:4]

    def kernel_views():
        return ops.selective_scan(dt, xc, Bv, Cv, A)

    nbytes, flops, n_exp = selective_scan_work(B, S, di, ds, 2)
    b_ms, b_by = bound(nbytes, flops, fp32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    exp_ms = exp_floor_ms(n_exp, sms, clock)
    inst = f"selective_scan_kernel<__nv_bfloat16, {ds}, true>"
    regs = [(r, st, ld) for name, r, st, ld in ptxas_report(
        _build.build_info().log, "selective_scan.cu") if inst in name]
    row = dict(name="selective_scan", route="cuda",
               source="src/repro_torch/csrc/selective_scan.cu",
               replaces="src/repro/models/mamba.py:107",
               pallas_kernel=None, shape=[B, S, di, ds, "bfloat16"],
               max_abs_err=err["kernel_y"][0], rms_err=err["kernel_y"][1],
               plain_max_abs_err=err["plain_y"][0],
               plain_rms_err=err["plain_y"][1],
               h_max_abs_err=err["kernel_h"][0], h_rms_err=err["kernel_h"][1],
               plain_h_max_abs_err=err["plain_h"][0],
               plain_h_rms_err=err["plain_h"][1],
               err_factor=SCAN_ERR_FACTOR, tol=SCAN_ERR_FACTOR
               * err["plain_y"][0], sweep_max_rel_err=sweep_err,
               ms=time_ms(torch, kernel),
               device_ms=device_profile(torch, kernel)[0],
               views_ms=time_ms(torch, kernel_views),
               views_device_ms=device_profile(torch, kernel_views)[0],
               registers=regs[0][0] if regs else None,
               spill_bytes=sum(regs[0][1:]) if regs else None,
               plain_ms=time_ms(torch, lambda: ref.selective_scan(
                   dt, xc, Bm, Cm, A, chunk=JAMBA_SSM_CHUNK), reps=2,
                   warmup=1),
               plain_chunk=JAMBA_SSM_CHUNK, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
               exponentials=n_exp, sm_clock_max_mhz=clock / 1e6,
               exp_floor_ms=exp_ms)
    row["kernel_ms"] = row["ms"]
    row.update(bound_share=b_ms / row["ms"],
               device_bound_share=b_ms / row["device_ms"],
               exp_floor_share=exp_ms / row["device_ms"])
    rank = dict(shape=[B, S, rdi, ds, "bfloat16"],
                ms=time_ms(torch, kernel_rank),
                device_ms=device_profile(torch, kernel_rank)[0],
                plain_ms=time_ms(torch, lambda: ref.selective_scan(
                    *rargs, chunk=JAMBA_SSM_CHUNK), reps=1, warmup=1),
                bound_ms=rb_ms, bound_by=rb_by, bytes=r_bytes,
                exp_floor_ms=exp_floor_ms(r_exp, sms, clock),
                max_abs_err_vs_whole=rank_err)
    rank.update(bound_share=rb_ms / rank["ms"],
                device_bound_share=rb_ms / rank["device_ms"])
    row["rank"] = rank
    print(f"[kernels] selective_scan sweep ({len(SCAN_SWEEP)} shapes x d_state"
          f" 8/16 x float32/bfloat16 x h0): max rel err {sweep_err:.2e} "
          f"(tol 1e-05)")
    print(f"[kernels] selective_scan {row['shape']}: vs float64 |err| y max "
          f"{err['kernel_y'][0]:.3e} RMS {err['kernel_y'][1]:.3e} (the plain "
          f"float32 scan's {err['plain_y'][0]:.3e} / {err['plain_y'][1]:.3e}"
          f"), h max {err['kernel_h'][0]:.3e} RMS {err['kernel_h'][1]:.3e} "
          f"({err['plain_h'][0]:.3e} / {err['plain_h'][1]:.3e}; factor "
          f"{SCAN_ERR_FACTOR}); kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f}), B and C as x_proj views "
          f"{row['views_ms']:.4f} ms (device {row['views_device_ms']:.4f}); "
          f"{row['registers']} registers, spills "
          f"{row['spill_bytes']} B; plain at chunk {JAMBA_SSM_CHUNK} "
          f"{row['plain_ms']:.3f} ms; bound {b_ms:.4f} ms ({b_by}, "
          f"{100 * row['bound_share']:.1f}% by events, "
          f"{100 * row['device_bound_share']:.1f}% by device time); "
          f"{n_exp:.3e} exponentials at 16 a clock an SM, {sms} SMs, "
          f"{clock / 1e6:.0f} MHz: {exp_ms:.4f} ms "
          f"({100 * row['exp_floor_share']:.1f}% of the device time)")
    print(f"[kernels] selective_scan at a {TPI_MESH} rank's channels "
          f"{rank['shape']}: equal to the whole call's channels; kernel "
          f"{rank['ms']:.4f} ms (device {rank['device_ms']:.4f}), plain at "
          f"chunk {JAMBA_SSM_CHUNK} {rank['plain_ms']:.3f} ms; bound "
          f"{rb_ms:.4f} ms ({rb_by}, {100 * rank['bound_share']:.1f}% by "
          f"events, {100 * rank['device_bound_share']:.1f}% by device "
          f"time); exponentials' floor {rank['exp_floor_ms']:.4f} ms at "
          f"{sms} SMs")
    del dt, xc, Bm, Cm, A, Bv, Cv, rargs, y_rank
    torch.cuda.empty_cache()
    return row


#: the [kernels] moe_expert_ffn row's tokens: jamba.decode's batch of 32
MOE_DECODE_TOKENS = 32


def moe_row(torch, dev, bound, bf16):
    """moe_expert_ffn (the port's own kernel: MoE decode has no Pallas
    kernel) at Jamba's decode shape: 32 tokens, its 16 experts, d 8192, f
    24576, bfloat16, swiglu, the experts picked by each token's top 2 of a
    seeded draw.  Held, expert by expert, to the plain version computed in
    float32 on the same bfloat16 inputs: max error within 1e-2 of the
    largest output and RMS error no larger than the plain bfloat16
    version's (``ref.moe_expert_ffn``: the copy of the picked experts and
    ``torch.bmm``).  Timed by events and CUPTI beside that plain version
    and the library yardstick the port's decode ran before this kernel
    (the copy of min(E, 2T) experts' weights, ``params["wi"][sel]``, and
    two ``torch.bmm``), which the port never calls; bound by the picked
    experts' bytes; with the launches a call and the registers and spills
    ``ptxas`` gave the instantiations."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch.kernel_bench import (device_profile,
                                                 moe_expert_ffn_work,
                                                 ptxas_report, time_ms)

    cfg = get_config(LM_JAMBA)
    T, E, d, f = (MOE_DECODE_TOKENS, cfg.moe.padded_experts, cfg.d_model,
                  cfg.d_ff)
    k = cfg.moe.top_k
    check(cfg.ffn_act == "swiglu", f"moe_expert_ffn: {cfg.ffn_act}")
    gen = torch.Generator(device=dev).manual_seed(6)
    bfl = dict(dtype=torch.bfloat16, device=dev)
    x = torch.randn(T, d, generator=gen, **bfl)
    wi = torch.randn(E, d, 2, f, generator=gen, **bfl).mul_(d ** -0.5)
    wo = torch.randn(E, f, d, generator=gen, **bfl).mul_(f ** -0.5)
    top_e = torch.rand(T, E, generator=gen, device=dev).topk(k).indices
    used = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    used.index_fill_(0, top_e.reshape(-1), 1)
    picked = used[:E].nonzero().flatten().tolist()

    def kernel():
        return ops.moe_expert_ffn(x, wi, wo, used, act="swiglu")

    def plain():
        return ref.moe_expert_ffn(x, wi, wo, used, act="swiglu",
                                  picks=T * k)

    def library():  # the port's decode before this kernel, all on device
        sel = torch.argsort(used[:E], descending=True,
                            stable=True)[:min(E, T * k)]
        n = sel.numel()
        h = torch.bmm(x.expand(n, T, d), wi[sel].reshape(n, d, 2 * f))
        h = h.unflatten(-1, (2, f))
        return torch.bmm(F.silu(h[..., 0, :]) * h[..., 1, :], wo[sel])

    ops.reset_launch_counts()
    got = kernel()
    torch.cuda.synchronize()
    check(ops.launch_counts()["moe_expert_ffn"] == 1,
          "moe_expert_ffn: not one counted launch a call")
    plain_out = plain()
    errs = {"kernel": [0.0, 0.0], "plain": [0.0, 0.0]}  # max, sum sq
    top = 0.0
    for e in picked:
        xf = x.float()
        hh = xf @ wi[e].float().reshape(d, 2 * f)
        want = (F.silu(hh[:, :f]) * hh[:, f:]) @ wo[e].float()
        del hh
        top = max(top, float(want.abs().max()))
        for key, o in (("kernel", got[e]), ("plain", plain_out[e])):
            diff = o.float() - want
            errs[key][0] = max(errs[key][0], float(diff.abs().max()))
            errs[key][1] += float(diff.pow(2).sum())
        del want, diff
    count = len(picked) * T * d
    err = {key: (m / top, math.sqrt(ss / count))
           for key, (m, ss) in errs.items()}
    check(err["kernel"][0] <= 1e-2 and err["kernel"][1] <= err["plain"][1],
          f"moe_expert_ffn: rel max {err['kernel'][0]:.3e} (tol 1e-2), RMS "
          f"{err['kernel'][1]:.3e} against the plain bfloat16 version's "
          f"{err['plain'][1]:.3e}")
    del got, plain_out
    torch.cuda.empty_cache()
    nbytes, flops = moe_expert_ffn_work(len(picked), T, d, f, 2)
    b_ms, b_by = bound(nbytes, flops, bf16)
    dev_ms, per_call = device_profile(torch, kernel)
    regs = {name: (r, st + ld) for name, r, st, ld in ptxas_report(
        _build.build_info().log, "moe_expert_ffn.cu")
        if "moe_expert_gemm_bf16<32" in name}
    row = dict(name="moe_expert_ffn", route="cuda",
               source="src/repro_torch/csrc/moe_expert_ffn.cu",
               replaces=None, pallas_kernel=None,
               shape=[T, E, d, f, "bfloat16", "swiglu"],
               picked=len(picked), max_rel_err=err["kernel"][0],
               rms_err=err["kernel"][1], plain_max_rel_err=err["plain"][0],
               plain_rms_err=err["plain"][1], tol=1e-2,
               ms=time_ms(torch, kernel), device_ms=dev_ms,
               cuda_launches_per_call=per_call,
               plain_ms=time_ms(torch, plain, reps=3, warmup=1),
               library_ms=time_ms(torch, library, reps=5, warmup=1),
               library_device_ms=device_profile(torch, library, reps=5,
                                                warmup=1)[0],
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
               registers={n: r for n, (r, _) in regs.items()},
               spill_bytes={n: sp for n, (_, sp) in regs.items()})
    row["kernel_ms"] = row["ms"]
    row.update(bound_share=b_ms / row["ms"],
               device_bound_share=b_ms / row["device_ms"])
    print(f"[kernels] moe_expert_ffn {row['shape']}, {len(picked)} of {E} "
          f"experts picked: vs float32 max {err['kernel'][0]:.3e} of the "
          f"largest output, RMS {err['kernel'][1]:.3e} (the plain bfloat16 "
          f"version's {err['plain'][0]:.3e} / {err['plain'][1]:.3e}); "
          f"kernel {row['ms']:.4f} ms (device {dev_ms:.4f}, "
          f"{per_call:g} CUDA launches a call); plain {row['plain_ms']:.3f} "
          f"ms; library (weight copy + 2 bmm) {row['library_ms']:.3f} ms "
          f"(device {row['library_device_ms']:.3f}); bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes / 1e9:.3f} GB; {100 * row['bound_share']:.1f}% "
          f"by events, {100 * row['device_bound_share']:.1f}% by device "
          f"time); registers, spill bytes {regs}")
    del x, wi, wo, used
    torch.cuda.empty_cache()
    return row


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
    # the no-grad held-out loss of [async-dp] and [diloco]
    (4, 16, 16, 4, 1, 64, True, None, None, 0),
    # Whisper: cross-attention (non-causal, 1500 keys: not a multiple of
    # any key tile) and the encoder's self-attention; Qwen2-VL's 8:1 GQA
    (1, 224, 1500, 20, 20, 64, False, None, None, 0),
    (1, 1500, 1500, 20, 20, 64, False, None, None, 0),
    (1, 320, 320, 64, 8, 128, True, None, None, 0),
]


def flash_row(torch, dev, record, bound, err_of, peaks_fp):
    """flash_attention at the Gemma-2-2B serve shape (a local layer of the
    LM main path) in float32 and, through the tensor-core kernel, bfloat16
    at both layers (local and global), plus the small sweep; timed against
    its plain version and, with the softcap off (SDPA has none), against
    ``scaled_dot_product_attention``: with an explicit mask at the local
    layer, ``is_causal`` (the flash backend) at the global one.  The
    float32 global layer is checked and timed beside them."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.kernel_bench import (attention_pairs,
                                                 device_profile, flash_work,
                                                 time_ms)

    fp32, bf16 = peaks_fp
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
    # SDPA: the same masks (boolean, True = attend), GQA, no softcap.
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    nocap = dict(causal=True, window=window)
    out = {}
    q, k, v = (t.to(torch.bfloat16) for t in (qf, kf, vf))
    for label, win in (("local", window), ("global", None)):
        out[f"bf16_{label}"] = flash_bf16_layer(
            torch, label, q, k, v, bound, bf16, window=win, mask=mask)
    del q, k, v
    torch.cuda.empty_cache()
    # [tp]'s per-rank shape: the heads of one of TP_MESH's "model" ranks
    from repro_torch.configs import get_config
    from repro_torch.models.attention import local_heads

    heads = local_heads(get_config(LM_ARCH), TP_MESH[1])
    q = torch.randn(B, S, heads[0], hd, generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn(B, S, heads[1], hd, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    for label, win in (("local", window), ("global", None)):
        out[f"bf16_tp_{label}"] = flash_bf16_layer(
            torch, f"tp rank {label}", q, k, v, bound, bf16, window=win,
            mask=mask, heads=heads)
    del q, k, v
    torch.cuda.empty_cache()
    # The MoE configs' prefill attention (both have 16 heads of 128, no GQA,
    # no window, no softcap): q/k/v (2, 8192, 16, 128), causal.
    moe_arch = LM_MOE[0][1]
    mcfg = get_config(moe_arch)
    mshape = (B, S, mcfg.n_heads, mcfg.hd)
    q, k, v = (torch.randn(*mshape, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    out["bf16_moe_hd128"] = flash_bf16_layer(
        torch, "moe hd128", q, k, v, bound, bf16, arch=moe_arch)
    del q, k, v
    torch.cuda.empty_cache()
    # The encoder-decoder and vision-language serve cells' layers.
    for key, label, arch, (B_, Sq, Skv), causal in FLASH_CELL_LAYERS:
        ccfg = get_config(arch)
        q = torch.randn(B_, Sq, ccfg.n_heads, ccfg.hd, generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B_, Skv, ccfg.n_kv_heads, ccfg.hd, generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        out[key] = flash_bf16_layer(torch, label, q, k, v, bound, bf16,
                                    arch=arch, causal=causal)
        del q, k, v
        torch.cuda.empty_cache()
    # float32 (both sides compute in float32): every element within 2e-5,
    # held by ``record`` below.
    qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)

    lib_err = err_of(sdpa().transpose(1, 2),
                     ops.flash_attention(qf, kf, vf, **nocap))
    out.update(ms_softcap_off=time_ms(torch, lambda: ops.flash_attention(
                   qf, kf, vf, **nocap)),
               device_ms_softcap_off=device_profile(
                   torch, lambda: ops.flash_attention(qf, kf, vf, **nocap))[0],
               local_library_ms=time_ms(torch, sdpa),
               local_library_device_ms=device_profile(torch, sdpa)[0],
               library_softcap="off", library_max_abs_err=lib_err,
               pairs=pairs, flops=flops, dtype="float32",
               sweep_max_abs_err=sweep_err)
    print(f"[kernels] flash_attention f32 {[B, S, nq, nkv, hd]} local: "
          f"softcap off {out['ms_softcap_off']:.3f} ms (device "
          f"{out['device_ms_softcap_off']:.3f}); SDPA with the window mask, "
          f"softcap off, {out['local_library_ms']:.3f} ms (device "
          f"{out['local_library_device_ms']:.3f}; agrees to {lib_err:.2e})")
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


#: the bfloat16 flash layers of the [lm-whisper] and [lm-vl] prefills:
#: (key, label, arch, (B, Sq, Skv), causal); heads from the config
FLASH_CELL_LAYERS = [
    ("bf16_whisper_encoder", "whisper encoder", "whisper_large_v3",
     (8, 1500, 1500), False),
    ("bf16_whisper_cross", "whisper cross", "whisper_large_v3",
     (8, 224, 1500), False),
    ("bf16_whisper_self", "whisper self", "whisper_large_v3",
     (8, 224, 224), True),
    ("bf16_vl_gqa", "qwen2-vl hd128 gqa 8:1", "qwen2_vl_72b",
     (2, 8192, 8192), True),
]


def _by_kv_group(fn, q, k, v):
    """``fn(q, k, v)`` one batch row and one KV head's query group at a
    time (bounds the plain versions' (Sq, Skv) float32 scores at the
    Qwen2-VL layer to ~2 GB), concatenated back."""
    import torch

    B, nkv = q.shape[0], k.shape[2]
    g = q.shape[2] // nkv
    return torch.cat([torch.cat([
        fn(q[b:b + 1, :, j * g:(j + 1) * g], k[b:b + 1, :, j:j + 1],
           v[b:b + 1, :, j:j + 1]) for j in range(nkv)], dim=2)
        for b in range(B)], dim=0)


def flash_bf16_layer(torch, label, q, k, v, bound, peak, arch=LM_ARCH,
                     causal=True, window=None, mask=None, heads=None):
    """The bfloat16 tensor-core kernel at one prefill attention layer of
    ``arch`` (its heads, or ``heads``, a tensor-parallel rank's (q, KV)
    heads, and its softcap): q (B, Sq), k/v (B, Skv), ``causal``,
    ``window`` and, for SDPA, the window's boolean ``mask``.  The kernel
    rounds P to bfloat16 before P V (as FlashAttention-2/3 do), so its
    elements are not held to the float32 answer's 2e-5: the max and the
    RMS of |kernel - plain| must not exceed those of the JAX package's own
    bfloat16 attention math (``train_attention``, scores and weights
    rounded to bfloat16, the config's softcap) on the same inputs against
    the same plain version; both run by KV group (:func:`_by_kv_group`).
    Timed by events and CUPTI beside the plain version and SDPA
    (``is_causal``, the mask, or none; ``enable_gqa`` under GQA) and,
    where the config has a softcap (SDPA has none), with it off too."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.kernel_bench import (attention_pairs,
                                                 device_profile, time_ms)
    from repro_torch.models.attention import train_attention

    cfg = get_config(arch)
    B, Sq, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    check((*(heads or (cfg.n_heads, cfg.n_kv_heads)), cfg.hd)
          == (nq, nkv, hd),
          f"flash_attention bf16 {label}: q/k/v are not {cfg.name}'s heads")
    cap = cfg.attn_softcap
    kw = dict(causal=causal, window=window, softcap=cap)
    nocap = dict(causal=causal, window=window)
    gcfg = dataclasses.replace(cfg, n_heads=nq // nkv, n_kv_heads=1,
                               head_dim=hd)

    def dev_of(diff):
        return float(diff.abs().max()), float(diff.pow(2).mean().sqrt())

    def plain(**kw_):
        return lambda q_, k_, v_: ref.flash_attention(q_, k_, v_, **kw_)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    def kernel_nocap():
        return ops.flash_attention(q, k, v, **nocap)

    want = _by_kv_group(plain(**kw), q, k, v).float()
    k_max, k_rms = dev_of(kernel().float() - want)
    r_max, r_rms = dev_of(_by_kv_group(
        lambda q_, k_, v_: train_attention(gcfg, q_, k_, v_, causal=causal,
                                           window=window),
        q, k, v).float() - want)
    del want
    torch.cuda.empty_cache()
    check(k_max <= r_max and k_rms <= r_rms,
          f"flash_attention bf16 {label}: kernel max/RMS {k_max:.3e}/"
          f"{k_rms:.3e} beyond the bfloat16 reference math's "
          f"{r_max:.3e}/{r_rms:.3e}")
    nbytes = 2 * B * (2 * Sq * nq + 2 * Skv * nkv) * hd
    flops = 4 * B * nq * hd * attention_pairs(Sq, Skv, causal, window)
    b_ms, b_by = bound(nbytes, flops, peak)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = nq != nkv
    if window is None:
        library = "SDPA " + ("is_causal" if causal else "no mask")

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=gqa)
    else:
        library = "SDPA with the boolean mask"

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)
    lib_err = float((sdpa().transpose(1, 2).float()
                     - kernel_nocap().float()).abs().max())
    row = dict(
        source="src/repro_torch/csrc/flash_attention_bf16.cu", arch=arch,
        shape=[B, Sq, Skv, nq, nkv, hd], causal=causal, window=window,
        max_abs_err=k_max, rms_err=k_rms, ref_math_max_abs_err=r_max,
        ref_math_rms_err=r_rms, ms=time_ms(torch, kernel),
        device_ms=device_profile(torch, kernel)[0],
        plain_ms=time_ms(torch, lambda: _by_kv_group(plain(**kw), q, k, v),
                         reps=2, warmup=1),
        library=library, library_ms=time_ms(torch, sdpa),
        library_device_ms=device_profile(torch, sdpa)[0],
        library_max_abs_err=lib_err, bound_ms=b_ms, bound_by=b_by,
        flops=flops, bytes=nbytes)
    off = ""
    if cap is not None:
        want = _by_kv_group(plain(**nocap), q, k, v).float()
        off_max, off_rms = dev_of(kernel_nocap().float() - want)
        del want
        torch.cuda.empty_cache()
        row.update(softcap_off_max_abs_err=off_max,
                   softcap_off_rms_err=off_rms,
                   ms_softcap_off=time_ms(torch, kernel_nocap),
                   device_ms_softcap_off=device_profile(torch,
                                                        kernel_nocap)[0])
        off = (f"; softcap off |err| {off_max:.3e} / {off_rms:.3e}, "
               f"{row['ms_softcap_off']:.4f} ms (device "
               f"{row['device_ms_softcap_off']:.4f})")
    # the bound's share of the call that computes SDPA's function
    row["bound_share"] = b_ms / row.get("ms_softcap_off", row["ms"])
    row["device_bound_share"] = b_ms / row.get("device_ms_softcap_off",
                                               row["device_ms"])
    print(f"[kernels] flash_attention bf16 {label} q {[B, Sq, nq, hd]} k/v "
          f"{[B, Skv, nkv, hd]} {'causal' if causal else 'non-causal'} "
          f"window {window} softcap {cap}: |err| max {k_max:.3e} RMS "
          f"{k_rms:.3e} (the reference's bf16 math {r_max:.3e} / "
          f"{r_rms:.3e}); kernel {row['ms']:.4f} ms (device "
          f"{row['device_ms']:.4f}){off}; {library} {row['library_ms']:.4f} "
          f"ms (device {row['library_device_ms']:.4f}; agrees to "
          f"{lib_err:.2e}); plain by KV group {row['plain_ms']:.3f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}, {100 * row['bound_share']:.1f}% by "
          f"events, {100 * row['device_bound_share']:.1f}% by device time"
          f"{' with the softcap off' if cap is not None else ''})")
    del qt, kt, vt
    return row


def run_path(label, problem, cfg, run=None):
    """One main-path run (``run(problem, cfg)``, default
    ``run_fixed_point``) with the launch counters reset around it."""
    import numpy as np

    from repro_torch import run_fixed_point
    from repro_torch.kernels import ops

    r0 = problem.residual_norm(problem.initial())
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = (run or run_fixed_point)(problem, cfg)
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


#: max_updates of the Jacobi and SCF runs that repeat the main path under
#: another feature ([process]'s Jacobi and SCF, [chaos]'s, [telemetry]'s
#: and [serve]'s Jacobi; VI keeps 200: its residual need not fall in 100)
#: and of [recover]'s runs (checkpoints every RECOVER_EVERY): half the
#: main path's 200, so that the whole smoke with [tp] fits a 900 s time
#: limit (they ran 200 before [tp] was added, [recover] with checkpoints
#: every 50)
SIDE_UPDATES, RECOVER_EVERY = 100, 25
#: [ray]'s sync Jacobi run (rounds of 4 updates) and its one-actor runs
#: (the [process] phase's one-worker count), and the child process's time
#: limit (s)
RAY_SYNC_UPDATES, RAY_1W_UPDATES, RAY_TIMEOUT = 20, 20, 300
#: [jacobi]'s one-worker runs, through the kernels and through the numpy
#: oracle (20 before [tp] was added: the oracle run took 32 s on an H100
#: host)
JACOBI_1W_UPDATES = 8


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
    one = dict(n_workers=1, faults=None, max_updates=JACOBI_1W_UPDATES)
    rk = run_path("jacobi-1w-kernel", prob, main_cfg(**one))[0]
    rr = run_path("jacobi-1w-ref", prob, main_cfg(device_plane="ref",
                                                  **one))[0]
    rel = float(np.max(np.abs(rk.x - rr.x)) / np.max(np.abs(rr.x)))
    print(f"[jacobi-1w] kernel vs numpy-oracle iterate rel diff {rel:.3e} "
          f"(tol 1e-12)")
    check(rk.worker_updates == rr.worker_updates == JACOBI_1W_UPDATES,
          "jacobi-1w: update counts differ")
    check(rel <= 1e-12, f"jacobi-1w: iterates differ by {rel:.3e}")
    return launches


def phase_vi(dev):
    res, launches, _ = run_path("vi", vi_problem(dev), main_cfg())
    for k in ("bellman_block", "bellman", "anderson_mix"):
        check(launches[k] > 0, f"vi: {k} was never launched")
    check(res.device_dispatches > 0, "vi: the device plane never ran")
    return launches


def scf_problem(dev):
    from repro_torch import PPPChain, SCFProblem

    return SCFProblem(PPPChain(n_atoms=SCF_ATOMS, U=2.0, t=1.0, device=dev))


def scf_cfg(**kw):
    """``main_cfg`` with DIIS(8) on every arrival.  At 1024 sites the
    chain's HOMO–LUMO gap is small and the plain map sloshes: with a fire
    every 4 arrivals the residual does not fall in 200 updates, and with a
    window of 5 a run can stall in the sloshing mode; 8 is the window of
    the reference's SCF solver (``SCFProblem.reference_solution``)."""
    from repro_torch import AndersonConfig

    kw.setdefault("fire_every", 1)
    kw.setdefault("accel", AndersonConfig(m=SCF_DIIS_M))
    return main_cfg(**kw)


def phase_scf(torch, dev):
    from repro_torch.launch.kernel_bench import time_ms

    prob = scf_problem(dev)
    x0 = prob.initial()
    map_ms = time_ms(torch, lambda: prob.full_map(x0))
    res, launches, _ = run_path("scf", prob, scf_cfg())
    check(launches["anderson_mix"] > 0, "scf: anderson_mix was never launched")
    gap = prob.chain.homo_lumo_gap(res.x)
    print(f"[scf] n_atoms {SCF_ATOMS}: full_map {map_ms:.3f} ms (20 calls "
          f"between CUDA events, host copies included), energy "
          f"{prob.energy(res.x):.10f} (core guess {prob.energy(x0):.10f}), "
          f"HOMO-LUMO gap of the final Fock matrix {gap:.6e} (core guess "
          f"{prob.chain.homo_lumo_gap(x0):.6e})")
    check(gap > 1e-6, f"scf: HOMO-LUMO gap {gap:.3e} near rounding: the "
                      f"density is not well defined")
    return launches


def phase_scf_parity(dev):
    """The SCF golden configurations of tests/test_hotpath_goldens.py
    (n = 8) and a multistable UHF chain's reference energy on the card
    against the CPU."""
    import numpy as np

    from repro_torch import (AndersonConfig, FaultProfile, PPPChain,
                             RunConfig, SCFProblem, UHFSCFProblem,
                             run_fixed_point)

    base = dict(mode="async", tol=1e-12, max_updates=400, compute_time=1e-3,
                faults=FaultProfile(delay_mean=0.002, delay_std=0.001),
                seed=5)
    for name, kw in (("scf_async_plain", dict(block_damping=0.7)),
                     ("scf_async_diis", dict(accel=AndersonConfig(m=5,
                                                                  beta=1.0),
                                             fire_every=4))):
        rc, rh = (run_fixed_point(SCFProblem(PPPChain(8, 2.0, 1.0, device=d)),
                                  RunConfig(**base, **kw))
                  for d in (dev, "cpu"))
        rel = float(np.max(np.abs(rc.x - rh.x)) / np.max(np.abs(rh.x)))
        got = (rc.worker_updates, rc.accel_fires, rc.accel_accepts)
        want = (rh.worker_updates, rh.accel_fires, rh.accel_accepts)
        print(f"[scf-parity] {name} card vs CPU: (updates, fires, accepts) "
              f"{got} / {want}, wall {rc.wall_time} / {rh.wall_time}, "
              f"iterate rel diff {rel:.3e} (tol 1e-10)")
        check(got == want and rc.wall_time == rh.wall_time,
              f"scf parity {name}: counts differ")
        check(rel <= 1e-10, f"scf parity {name}: iterates differ by {rel:.3e}")
    ec, eh = (UHFSCFProblem(PPPChain(32, 3.0, device=d)).reference_energy()
              for d in (dev, "cpu"))
    rel = abs(ec - eh) / abs(eh)
    print(f"[scf-parity] UHF n=32 U=3 reference_energy card {ec!r}, CPU "
          f"{eh!r}: abs diff {abs(ec - eh):.3e}, rel {rel:.3e} (tol 1e-10)")
    check(rel <= 1e-10, f"scf parity UHF: energies differ by {rel:.3e}")


def phase_process(dev):
    """The Jacobi and SCF main paths on the process backend, then one
    worker's Jacobi run against one thread worker's, cold and warm."""
    import numpy as np

    from repro_torch import run_fixed_point
    from repro_torch.core import pool_stats

    launches = {}
    for label, make, cfg in (
            ("jacobi", jacobi_problem,
             lambda **kw: main_cfg(max_updates=SIDE_UPDATES, **kw)),
            ("scf", scf_problem,
             lambda **kw: scf_cfg(max_updates=SIDE_UPDATES, **kw))):
        res, got, _ = run_path(f"process-{label}", make(dev),
                               cfg(executor="process"))
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        boot = [s["boot_s"] for s in pool_stats().values()]
        print(f"[process-{label}] cold pool starts so far (4 workers: "
              f"spawn, torch import, CUDA context, problem on the card, "
              f"kernel library): {[round(b, 3) for b in boot]} s")
    check(launches["jacobi_halo_sweeps"] > 0,
          "process: jacobi_halo_sweeps never launched in the workers")
    check(launches["anderson_mix"] > 0,
          "process: anderson_mix never launched")
    prob = jacobi_problem(dev)
    one = dict(n_workers=1, faults=None, max_updates=20)
    rt = run_path("jacobi-1w-thread", prob, main_cfg(**one))[0]
    for turn in ("cold", "warm"):
        before = pool_pids()
        rp = run_path(f"jacobi-1w-process-{turn}", prob,
                      main_cfg(executor="process", **one))[0]
        spawned = len(pool_pids() - before)
        same = rp.x.tobytes() == rt.x.tobytes()
        print(f"[process] one-worker Jacobi, {turn} pool: {spawned} "
              f"interpreters spawned, device_dispatches "
              f"{rp.device_dispatches}, iterate equal to the thread "
              f"run's bytes: {same}")
        check(same and rp.worker_updates == rt.worker_updates,
              f"process: one-worker {turn} run differs from the thread run")
        check(rp.device_dispatches > 0,
              "process: the one-worker run missed the device plane")
        if turn == "warm":
            check(spawned == 0, f"process: a warm run spawned {spawned}")
    return launches


@contextlib.contextmanager
def ray_child_proc():
    """[ray]'s child process (:func:`ray_child`), started on entering the
    block so that its interpreter start (a torch import, and the
    stand-in's fork server importing torch again) overlaps the phases
    before [ray]; it touches the card only once :func:`phase_ray` says
    go.  Stopped on leaving the block if it still runs."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ray.json"
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.ray_child(sys.argv[1]))", str(out)],
            cwd=str(ROOT), stdin=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        proc.out = out
        try:
            yield proc
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_ray(proc):
    """[ray]: the Ray backend's cells in the child process of
    :func:`ray_child_proc`; returns the launches of its main-path runs."""
    sys.stdout.flush()
    proc.stdin.write("go\n")
    proc.stdin.close()
    rc = proc.wait(timeout=RAY_TIMEOUT)
    check(rc == 0, f"ray: the child process exited {rc}")
    return json.loads(proc.out.read_text())


def ray_runtime():
    """``ray`` where it imports, else ``tests/torch_ray_standin.py``
    installed as ``ray`` (whose actors are processes of their own); with a
    line that says which."""
    try:
        import ray

        return ray, f"ray {ray.__version__}"
    except ImportError:
        sys.path.insert(0, str(ROOT / "tests"))
        import torch_ray_standin

        torch_ray_standin.install()
        return torch_ray_standin, ("the stand-in tests/torch_ray_standin.py "
                                   "(ray does not import here): each actor "
                                   "a process of its own")


def ray_child(out_path: str) -> int:
    """Body of [ray]'s child: the Jacobi and VI main paths on 4 CUDA actors,
    a sync Jacobi run, one actor against one thread worker cold and warm;
    writes the runs' launches as JSON to ``out_path``."""
    import torch

    ray, runtime = ray_runtime()
    # Started before the wait: the stand-in's fork server imports torch
    # then, off the phase's clock.
    ray.init(include_dashboard=False, log_to_driver=False)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ray_pool_stats, shutdown_ray_pools
    from repro_torch.kernels import ops

    if sys.stdin.readline().strip() != "go":
        return 1  # the smoke stopped before [ray]
    print(f"[ray] runtime: {runtime}")
    dev = torch.device("cuda", 0)
    actor_side = {}
    merge = ops.add_launch_counts

    def tally(counts):
        # The backend merges each actor's counts through here.
        for k, c in counts.items():
            actor_side[k] = actor_side.get(k, 0) + c
        merge(counts)

    ops.add_launch_counts = tally
    launches = {}

    def cell(label, prob, cfg):
        actor_side.clear()
        keys = set(ray_pool_stats())
        res, got, _ = run_path(label, prob, cfg)
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        coord = {k: c - actor_side.get(k, 0) for k, c in got.items()}
        summ = res.telemetry_summary or {}
        stale = (f"staleness p50 {summ['staleness_p50']:g} p95 "
                 f"{summ['staleness_p95']:g}" if "staleness_p50" in summ
                 else f"mean staleness {res.mean_staleness:.3f}")
        boot = [f"{st['boot_s']:.3f} s" for k, st in ray_pool_stats().items()
                if k not in keys]
        print(f"[{label}] wall {res.wall_time:.3f} s, updates "
              f"{res.worker_updates}, fires {res.accel_fires}, accepts "
              f"{res.accel_accepts}, {stale}; pool cold start "
              f"{', '.join(boot) or 'none (warm pool)'}; actor launches "
              f"{json.dumps({k: c for k, c in actor_side.items() if c})}; "
              f"coordinator launches "
              f"{json.dumps({k: c for k, c in coord.items() if c})}")
        return res, dict(actor_side), coord

    try:
        jac = jacobi_problem(dev)
        _, act, coord = cell("ray-jacobi", jac, main_cfg(
            executor="ray", max_updates=SIDE_UPDATES, telemetry=True))
        check(act.get("jacobi_halo_sweeps", 0) > 0,
              "ray: jacobi_halo_sweeps never launched in the actors")
        for k in ("jacobi_sweep", "anderson_mix"):
            check(coord[k] > 0, f"ray: the coordinator never launched {k}")
        cell("ray-jacobi-sync", jac, main_cfg(
            executor="ray", mode="sync", max_updates=RAY_SYNC_UPDATES))
        _, act, coord = cell("ray-vi", vi_problem(dev), main_cfg(
            executor="ray", telemetry=True))
        check(act.get("bellman", 0) > 0,
              "ray: bellman never launched in the actors")
        check(coord["anderson_mix"] > 0,
              "ray: the coordinator never launched anderson_mix on VI")
        one = dict(n_workers=1, faults=None, max_updates=RAY_1W_UPDATES,
                   device_plane="off")
        rt = run_path("ray-1w-thread", jac, main_cfg(**one))[0]
        for turn in ("cold", "warm"):
            before = {p for st in ray_pool_stats().values()
                      for p in st["pids"]}
            rr = run_path(f"ray-1w-{turn}", jac,
                          main_cfg(executor="ray", **one))[0]
            created = len({p for st in ray_pool_stats().values()
                           for p in st["pids"]} - before)
            same = rr.x.tobytes() == rt.x.tobytes()
            print(f"[ray] one-actor Jacobi, {turn} pool: {created} actors "
                  f"created, iterate equal to the thread run's bytes: {same}")
            check(same and rr.worker_updates == rt.worker_updates,
                  f"ray: the one-actor {turn} run differs from the thread "
                  f"run")
            if turn == "warm":
                check(created == 0, f"ray: a warm run created {created} "
                                    f"actors")
    finally:
        shutdown_ray_pools()
    check(ray_pool_stats() == {}, "ray: pools left after shutdown")
    Path(out_path).write_text(json.dumps(launches))
    return 0


def pool_pids():
    from repro_torch.core import pool_stats

    return {p for s in pool_stats().values() for p in s["pids"]}


def phase_chaos(dev):
    """[chaos]: the Jacobi main path under the library's ``spot_wave`` and
    the VI one under ``rolling_restart`` (thread backend, ``main_cfg()``,
    the scripts at their defaults), beside the same runs without them.  A
    scenario keeps the workers on the host path (a resident block cannot
    follow a reassigned block), so the scenario-free run is timed both
    with the device plane and on the host path."""
    from repro_torch.chaos import get_scenario

    launches = {}
    for label, make, name, kernels, upd in (
            ("jacobi", jacobi_problem, "spot_wave",
             ("jacobi_halo_sweeps", "jacobi_sweep", "anderson_mix"),
             SIDE_UPDATES),
            ("vi", vi_problem, "rolling_restart", ("bellman",
                                                  "anderson_mix"), 200)):
        prob = make(dev)
        plane = run_path(f"chaos-{label}-none", prob,
                         main_cfg(max_updates=upd))[0]
        host = run_path(f"chaos-{label}-none-host", prob,
                        main_cfg(device_plane="off", max_updates=upd))[0]
        scn = get_scenario(name, 4)
        res, got, r0 = run_path(f"chaos-{label}", prob,
                                main_cfg(scenario=scn, max_updates=upd))
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        print(f"[chaos] {label} under {name} (last event at "
              f"{max(ev.t for ev in scn.events):.2f} s): run wall "
              f"{res.wall_time:.3f} s; without the scenario "
              f"{plane.wall_time:.3f} s (device plane) and "
              f"{host.wall_time:.3f} s (host path); preemptions "
              f"{res.preemptions}, joins {res.joins}, reassigned_blocks "
              f"{res.reassigned_blocks}, accel_partial_commits "
              f"{res.accel_partial_commits}, preempt_discards "
              f"{res.preempt_discards}, accel_discards {res.accel_discards}, "
              f"residual {r0:.6e} -> {res.residual_norm:.6e}, "
              f"service_fractions {json.dumps(res.service_fractions)}")
        check(res.preemptions >= 1 and res.reassigned_blocks >= 1,
              f"chaos {label}: the scenario moved no block")
        check(res.device_dispatches == 0,
              f"chaos {label}: a scenario run took the device plane")
        for k in kernels:
            check(got[k] > 0, f"chaos {label}: {k} was never launched")
        if label == "vi":
            # The host path's VI block update is the full Bellman map
            # restricted to the block, as in the reference
            # (repro/problems/value_iteration.py:238-242).
            print(f"[chaos] vi host path: bellman_block launches "
                  f"{got['bellman_block']} (the block update is the "
                  f"restricted full map), bellman {got['bellman']}")
        else:
            check(res.preemptions == 2 and res.joins == 2,
                  "chaos jacobi: spot_wave did not preempt and rejoin "
                  "workers 1 and 2")
    return launches


def phase_recover(dev, executor):
    """[recover]: the Jacobi main path at ``SIDE_UPDATES`` updates with
    checkpoints every ``RECOVER_EVERY``, once through, then killed by a scripted ``coordinator_crash`` half-way
    through that run's wall and resumed from the latest checkpoint.  The
    checkpoint writes and the restore are timed by wrapping
    ``repro_torch.recover.checkpoint``'s two functions for the phase."""
    import os
    import shutil
    import tempfile

    from repro_torch import CoordinatorCrash, run_fixed_point
    from repro_torch.chaos import FaultScenario
    from repro_torch.kernels import ops
    from repro_torch.recover import (SolveCheckpoint, checkpoint,
                                     list_checkpoints, resume_fixed_point)

    prob = jacobi_problem(dev)
    tag = f"recover-{executor}"
    writes, restores = [], []
    write0 = checkpoint.write_checkpoint
    restore0 = checkpoint.restore_coordinator

    def timed_write(coord, t, loop_state=None):
        t0 = time.perf_counter()
        path = write0(coord, t, loop_state)
        writes.append(time.perf_counter() - t0)
        return path

    def timed_restore(coord, ckpt):
        t0 = time.perf_counter()
        restore0(coord, ckpt)
        restores.append(time.perf_counter() - t0)

    def ckpt_bytes(path):
        return sum(os.path.getsize(path[:-5] + e) for e in (".json", ".npz"))

    launches = {}
    dirs = [tempfile.mkdtemp(prefix="chip_smoke_ckpt_") for _ in range(2)]
    checkpoint.write_checkpoint = timed_write
    checkpoint.restore_coordinator = timed_restore
    try:
        pids0 = pool_pids()
        cfg = main_cfg(executor=executor, checkpoint_every=RECOVER_EVERY,
                       checkpoint_dir=dirs[0], max_updates=SIDE_UPDATES)
        full, got, r0 = run_path(f"{tag}-through", prob, cfg)
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        sizes = [ckpt_bytes(p) for p in list_checkpoints(dirs[0])]
        print(f"[recover] {executor}: uninterrupted run with checkpoints "
              f"every {RECOVER_EVERY} updates: wall {full.wall_time:.3f} s, "
              f"{full.checkpoints_written} checkpoints of {sizes} bytes, "
              f"write seconds {[round(w, 4) for w in writes]}")
        check(full.checkpoints_written == 4 and len(sizes) == 4,
              f"recover {executor}: {full.checkpoints_written} checkpoints")
        n_writes = len(writes)
        shutil.rmtree(dirs[0])
        crash_at = full.wall_time / 2
        cfg = main_cfg(executor=executor, checkpoint_every=RECOVER_EVERY,
                       checkpoint_dir=dirs[1], max_updates=SIDE_UPDATES,
                       scenario=FaultScenario("crash").coordinator_crash(
                           crash_at))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            run_fixed_point(prob, cfg)
        except CoordinatorCrash as e:
            print(f"[recover] {executor}: {e} after "
                  f"{time.perf_counter() - t0:.3f} s of call")
        else:
            raise RuntimeError(f"chip_smoke: recover {executor}: the "
                               f"scripted crash at {crash_at:.3f} s never "
                               f"fired")
        for k, c in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + c
        paths = list_checkpoints(dirs[1])
        check(bool(paths),
              f"recover {executor}: no checkpoint before the crash")
        t0 = time.perf_counter()
        ck = SolveCheckpoint.load(paths[-1])
        load_s = time.perf_counter() - t0
        pids1 = pool_pids()
        res, got, _ = run_path(f"{tag}-resumed", prob, cfg,
                               run=lambda p, c: resume_fixed_point(p, c, ck))
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        spawned = len(pool_pids() - pids1)
        since_fire = ck.loop["since_fire"]
        want_fires = (ck.meta["accel"]["n_fire"]
                      + (since_fire + SIDE_UPDATES - ck.wu) // 4)
        hist = [tuple(h) for h in ck.meta["history"]]
        print(f"[recover] {executor}: crash at {crash_at:.3f} s, resumed "
              f"from {ck.tag} (wu {ck.wu}, t {ck.t:.3f} s, "
              f"{ckpt_bytes(paths[-1])} bytes): load {load_s:.3f} s, "
              f"restore {restores[-1]:.3f} s, resumed wall "
              f"{res.wall_time:.3f} s cumulative "
              f"({res.wall_time - ck.t:.3f} s after the checkpoint's time), "
              f"write seconds after the first run "
              f"{[round(w, 4) for w in writes[n_writes:]]}, fires "
              f"{res.accel_fires} (expected {want_fires}), updates "
              f"{res.worker_updates}, interpreters spawned on resume "
              f"{spawned}")
        check(res.resumed_from == ck.tag
              and res.worker_updates == SIDE_UPDATES,
              f"recover {executor}: resumed run ended at wu "
              f"{res.worker_updates}")
        check(res.history[:len(hist)] == hist,
              f"recover {executor}: the resumed history does not continue "
              f"the checkpoint's")
        check(all(a[1] <= b[1] for a, b in zip(res.history,
                                                res.history[1:])),
              f"recover {executor}: wu went backwards")
        check(res.accel_fires == want_fires,
              f"recover {executor}: {res.accel_fires} fires, expected "
              f"{want_fires}: a fire replayed or went missing")
        if executor == "process":
            check(spawned == 0 and bool(pids0) and pool_pids() == pids0,
                  "recover process: the crash or resume spawned "
                  "interpreters (phase 10's pool not reused)")
    finally:
        checkpoint.write_checkpoint = write0
        checkpoint.restore_coordinator = restore0
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return launches


def phase_recover_parity(dev):
    """[recover-parity]: a scripted virtual Jacobi run with Anderson (the
    combine through ``anderson_mix``) on the card against the CPU, and on
    each device its resume from a checkpoint taken after the script is
    over against the uninterrupted run.

    The card's Anderson Gram is a cuBLAS product and the CPU's numpy's, so
    the two differ in the last place at every fire, and accelerated async
    Jacobi (the paper's iterate-corruption case) amplifies that over the
    run's 150 fires: the card is held to the CPU's decisions (updates,
    fires, accepts, membership, virtual wall) with iterates within 1e-4
    relative (measured on the H100: 5.0e-7 scripted, 7.0e-6 for the same
    run without the script, which is checked beside it as the baseline of
    that amplification).  A resume on one device is held to that device's
    uninterrupted run byte for byte."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import (AndersonConfig, FaultProfile, JacobiProblem,
                             RunConfig, run_fixed_point)
    from repro_torch.chaos import get_scenario
    from repro_torch.kernels import ops
    from repro_torch.recover import SolveCheckpoint, list_checkpoints

    scn = get_scenario("rolling_restart", 4).scaled(0.05)
    last = max(ev.t for ev in scn.events)
    runs = {}
    for d in (dev, "cpu"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
        try:
            cfg = RunConfig(mode="async", tol=1e-300, max_updates=600,
                            compute_time=1e-3, seed=7, fire_every=4,
                            faults=FaultProfile(delay_mean=0.002,
                                                delay_std=0.001),
                            accel=AndersonConfig(m=5, mix_kernel_n=1),
                            scenario=scn, checkpoint_every=150,
                            checkpoint_dir=tmp)
            prob = JacobiProblem(grid=32, sweeps=5, seed=0, device=d)
            ops.reset_launch_counts()
            full = run_fixed_point(prob, cfg)
            ck = next(c for c in map(SolveCheckpoint.load,
                                     list_checkpoints(tmp))
                      if c.t > last and c.wu < 600)
            res = run_fixed_point(prob, dataclasses.replace(
                cfg, scenario=None, resume_from=ck))
            launches = ops.launch_counts()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        same = res.x.tobytes() == full.x.tobytes()
        rel = float(np.max(np.abs(res.x - full.x)) / np.max(np.abs(full.x)))
        counts = (full.worker_updates, full.accel_fires, full.accel_accepts,
                  full.preemptions, full.joins)
        print(f"[recover-parity] {d}: scripted run (updates, fires, "
              f"accepts, preemptions, joins) {counts}, resumed from "
              f"{ck.tag}: bytes equal to the uninterrupted run {same} (rel "
              f"diff {rel:.3e}), launches {json.dumps(launches)}")
        check(res.worker_updates == full.worker_updates
              and res.accel_fires == full.accel_fires,
              f"recover parity {d}: the resume's counts differ")
        check(same, f"recover parity {d}: the resume is not bit-identical "
                    f"to the uninterrupted run (rel {rel:.3e})")
        if d != "cpu":
            check(launches["anderson_mix"] > 0,
                  "recover parity: anderson_mix never launched")
        runs[str(d)] = full
    for d in (dev, "cpu"):  # the same run without the script
        runs[f"{d}/plain"] = run_fixed_point(
            JacobiProblem(grid=32, sweeps=5, seed=0, device=d),
            dataclasses.replace(cfg, scenario=None, checkpoint_every=None,
                                checkpoint_dir=None))
    for label, rc, rh in (
            ("scripted", runs[str(dev)], runs["cpu"]),
            ("without the script", runs[f"{dev}/plain"], runs["cpu/plain"])):
        rel = float(np.max(np.abs(rc.x - rh.x)) / np.max(np.abs(rh.x)))
        counts = [(r.worker_updates, r.accel_fires, r.accel_accepts,
                   r.preemptions, r.joins, r.wall_time) for r in (rc, rh)]
        print(f"[recover-parity] {label}, card vs CPU: {counts[0]} / "
              f"{counts[1]}, iterate bytes equal "
              f"{rc.x.tobytes() == rh.x.tobytes()}, rel diff {rel:.3e} "
              f"(tol 1e-4)")
        check(counts[0] == counts[1],
              f"recover parity {label}: card and CPU counts differ")
        check(rel <= 1e-4,
              f"recover parity {label}: card and CPU differ by {rel:.3e}")


@contextlib.contextmanager
def local_norms():
    """Capture each run's ``device_local_norms`` (the device plane's fused
    block-local norm per worker) as the coordinator assembles its result;
    ``RunResult`` does not carry them, as in the reference."""
    from repro_torch.core.engine import coordinator

    seen = []
    result0 = coordinator.Coordinator.result

    def result(self, *a, **k):
        seen.append(dict(self.device_local_norms))
        return result0(self, *a, **k)

    coordinator.Coordinator.result = result
    try:
        yield seen
    finally:
        coordinator.Coordinator.result = result0


def fire_split(res):
    """(count, mean ms, p95 ms, share of the run wall) of the fire spans
    of a telemetry capture: accel begin -> commit on the backend clock."""
    import numpy as np

    d = np.array([ev["t1"] - ev["t0"] for ev in res.telemetry.events
                  if ev["k"] == "fire"])
    if not len(d):
        return 0, 0.0, 0.0, 0.0
    return (len(d), float(d.mean() * 1e3), float(np.percentile(d, 95) * 1e3),
            float(d.sum() / res.wall_time))


def add_counts(total, got):
    for k, c in got.items():
        total[k] = total.get(k, 0) + c


def phase_telemetry(dev, jac, vi):
    """[telemetry]: the Jacobi main path with ``telemetry=True`` beside the
    same run without it (thread backend, device plane on); the capture's
    ledger, lanes, fire split and ``run_report --validate``; then VI
    S = 10^6 on the process backend with telemetry, whose worker lanes
    arrive as ``"tel"`` batches and whose fused block-local norms come
    back as ``"okd"`` messages."""
    import os
    import shutil
    import tempfile

    from repro_torch.core import shutdown_pools
    from repro_torch.launch.run_report import main as run_report_main
    from repro_torch.telemetry import TelemetryConfig
    from repro_torch.telemetry.export import trace_lanes

    launches = {}
    off, got, _ = run_path("telemetry-jacobi-off", jac,
                           main_cfg(max_updates=SIDE_UPDATES))
    add_counts(launches, got)
    with local_norms() as norms:
        on, got, _ = run_path("telemetry-jacobi-on", jac,
                              main_cfg(telemetry=True,
                                       max_updates=SIDE_UPDATES))
    add_counts(launches, got)
    summ, cap = on.telemetry_summary, on.telemetry
    fires = summ["fires"]
    lanes = trace_lanes(cap)
    n, mean_ms, p95_ms, share = fire_split(on)
    print(f"[telemetry] jacobi run wall: telemetry on {on.wall_time:.3f} s, "
          f"off {off.wall_time:.3f} s (ratio "
          f"{on.wall_time / off.wall_time:.3f}); span counts "
          f"{json.dumps(summ['span_counts'], sort_keys=True)}; staleness "
          f"p50 {summ['staleness_p50']:g} p95 {summ['staleness_p95']:g} "
          f"(n {summ['staleness_n']}); fire ledger {json.dumps(fires)} "
          f"(accel_fires {on.accel_fires}, accepts {on.accel_accepts}, "
          f"rejects {on.accel_rejects}, discards {on.accel_discards}); "
          f"busy share tail {summ['busy_frac_tail']}; device_dispatches "
          f"{on.device_dispatches}; lanes {lanes}; device_local_norms "
          f"{json.dumps({w: f'{v:.6e}' for w, v in sorted(norms[-1].items())})}")
    print(f"[telemetry] jacobi fire split from the spans: {n} fires, mean "
          f"{mean_ms:.3f} ms, p95 {p95_ms:.3f} ms, fire share of the wall "
          f"{share:.4f}")
    check(sum(fires.values()) == on.accel_fires > 0,
          f"telemetry: fire ledger {fires} != {on.accel_fires} fires")
    check(fires.get("accept", 0) == on.accel_accepts,
          f"telemetry: ledger accepts {fires.get('accept', 0)} != "
          f"{on.accel_accepts}")
    check(fires.get("fallback", 0) + fires.get("discard", 0)
          == on.accel_rejects, "telemetry: ledger rejects disagree")
    check(summ["span_counts"]["fire"] == on.accel_fires,
          "telemetry: fire span count != accel_fires")
    check({f"w{w}" for w in range(4)} <= set(lanes),
          f"telemetry: a worker has no lane ({lanes})")
    check(on.device_dispatches > 0, "telemetry: the device plane never ran")
    check(set(norms[-1]) == set(range(4)),
          f"telemetry: device_local_norms cover {sorted(norms[-1])}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tel_")
    try:
        path = cap.save(os.path.join(tmp, "capture.json"))
        chrome = os.path.join(tmp, "capture.trace.json")
        rc = run_report_main([path, "--chrome", chrome, "--validate"])
        check(rc == 0 and os.path.getsize(chrome) > 0,
              f"telemetry: run_report --validate exited {rc}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Batches of 8 spans, so the straggler's lane arrives too (a worker
    # ships a batch once it holds worker_batch spans; the tail is dropped).
    with local_norms() as norms:
        res, got, _ = run_path("telemetry-vi-process", vi, main_cfg(
            executor="process", telemetry=TelemetryConfig(worker_batch=8)))
    add_counts(launches, got)
    shutdown_pools()  # [serve] counts the runs of a fresh VI pool
    worker = [ev for ev in res.telemetry.events if ev.get("src") == "worker"]
    wl = sorted({ev["lane"] for ev in worker})
    n, mean_ms, p95_ms, share = fire_split(res)
    print(f"[telemetry] vi process: {len(worker)} worker spans in \"tel\" "
          f"batches on lanes {wl} (compute mean "
          f"{sum(e['t1'] - e['t0'] for e in worker) / max(len(worker), 1) * 1e3:.3f}"
          f" ms), span counts "
          f"{json.dumps(res.telemetry_summary['span_counts'], sort_keys=True)}"
          f", pool series {json.dumps({k: v for k, v in res.telemetry.series.items() if k.startswith('pool')})}"
          f", device_local_norms "
          f"{json.dumps({w: f'{v:.6e}' for w, v in sorted(norms[-1].items())})}"
          f"; fire split: {n} fires, mean {mean_ms:.3f} ms, p95 "
          f"{p95_ms:.3f} ms, share {share:.4f}")
    check(wl == [f"w{w}" for w in range(4)],
          f"telemetry vi process: worker lanes {wl}")
    check(res.device_dispatches > 0 and set(norms[-1]) == set(range(4)),
          f"telemetry vi process: device_local_norms cover "
          f"{sorted(norms[-1])}")
    check(launches["bellman_block"] > 0,
          "telemetry: bellman_block never launched in the workers")
    return launches


def phase_autoscale(dev, vi):
    """[autoscale]: VI S = 10^6 on threads under the ``target_staleness``
    policy with the 100 ms straggler.  A controller keeps the run on the
    host path (the resolver refuses the device plane)."""
    from repro_torch.autoscale import get_policy, run_cost

    ctl = get_policy("target_staleness")
    res, launches, r0 = run_path("autoscale-vi", vi,
                                 main_cfg(controller=ctl))
    print(f"[autoscale] target_staleness: controller_actions "
          f"{res.controller_actions}, decision log "
          f"{json.dumps(ctl.decision_log)} ({len(ctl.decision_log)} "
          f"entries), worker_seconds {res.worker_seconds:.3f}, run_cost "
          f"{run_cost(res):.3f} worker-s x s, preemptions "
          f"{res.preemptions}, joins {res.joins}, residual {r0:.6e} -> "
          f"{res.residual_norm:.6e}, service_fractions "
          f"{json.dumps(res.service_fractions)}")
    check(res.controller_actions == len(ctl.decision_log),
          "autoscale: controller_actions != len(decision_log)")
    check(res.device_dispatches == 0,
          "autoscale: a controller run took the device plane")
    check(res.worker_seconds > 0.0, "autoscale: worker-seconds not metered")
    for k in ("bellman", "anderson_mix"):
        check(launches[k] > 0, f"autoscale: {k} was never launched")
    return launches


def phase_serve(dev, jac, vi):
    """[serve]: a ``SolverService`` (two dispatchers, tenants a:2 b:1,
    telemetry) multiplexing 4 VI and 2 Jacobi main-path requests on the
    thread backend, so two families run on the card at once; then 3 VI
    requests of one family through one warm process pool."""
    import numpy as np

    from repro_torch.core import pool_stats, shutdown_pools
    from repro_torch.kernels import ops
    from repro_torch.serve import ServiceConfig, SolverService
    from repro_torch.telemetry.export import parse_prometheus, to_prometheus

    probs = {"vi": vi, "jacobi": jac}
    r0 = {k: p.residual_norm(p.initial()) for k, p in probs.items()}
    kinds = ["vi", "jacobi", "vi", "jacobi", "vi", "vi"]

    def checked(label, kind, tk):
        r = tk.result()
        check(tk._exception is None, f"serve {label}: ticket raised")
        check(bool(np.isfinite(r.x).all()) and r.residual_norm < r0[kind],
              f"serve {label}: residual {r.residual_norm:.3e} did not fall "
              f"below {r0[kind]:.3e}")
        return r

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with SolverService(ServiceConfig(max_active=2, weights={"a": 2, "b": 1},
                                     telemetry=True)) as svc:
        tickets = [svc.submit(probs[k], main_cfg(**(
                       {"max_updates": SIDE_UPDATES} if k == "jacobi" else {})),
                              tenant="ab"[i % 2])
                   for i, k in enumerate(kinds)]
        results = [checked(f"#{i}", k, tk)
                   for i, (k, tk) in enumerate(zip(kinds, tickets))]
        stats = svc.stats()
        prom = parse_prometheus(to_prometheus(svc))
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for i, (k, tk, r) in enumerate(zip(kinds, tickets, results)):
        print(f"[serve] #{i} {k} tenant {tk.tenant}: wait "
              f"{tk.wait_s * 1e3:.1f} ms, service "
              f"{(tk.total_s - tk.wait_s) * 1e3:.1f} ms, updates "
              f"{r.worker_updates}, fires {r.accel_fires}, device_dispatches "
              f"{r.device_dispatches}, residual {r0[k]:.6e} -> "
              f"{r.residual_norm:.6e}")
    totals = sorted(tk.total_s for tk in tickets)
    print(f"[serve] {len(tickets)} requests in {wall:.3f} s "
          f"({len(tickets) / wall:.3f} req/s); total latency p50 "
          f"{np.percentile(totals, 50) * 1e3:.1f} ms, p95 "
          f"{np.percentile(totals, 95) * 1e3:.1f} ms; served "
          f"{json.dumps(stats['served'], sort_keys=True)}; prometheus "
          f"round trip {json.dumps(prom, sort_keys=True)}; launches "
          f"{json.dumps(launches)}")
    check(stats["served"] == {"a": 3, "b": 3} and stats["failed"] == 0,
          f"serve: served {stats['served']}, failed {stats['failed']}")
    check(prom['repro_serve_served_total{tenant="a"}'] == 3.0
          and 'repro_serve_request_seconds{quantile="0.95"}' in prom,
          "serve: the Prometheus round trip lost a sample")
    for k in ("jacobi_halo_sweeps", "jacobi_sweep", "bellman_block",
              "bellman", "anderson_mix"):
        check(launches[k] > 0, f"serve: {k} was never launched")

    shutdown_pools()
    cfg = main_cfg(executor="process")
    ops.reset_launch_counts()
    with SolverService(ServiceConfig(max_active=1)) as svc:
        first = checked("process #0", "vi", svc.submit(vi, cfg))
        pids = pool_pids()
        rest = [svc.submit(vi, cfg) for _ in range(2)]
        rest = [checked(f"process #{i + 1}", "vi", tk)
                for i, tk in enumerate(rest)]
        spawned = len(pool_pids() - pids)
    add_counts(launches, ops.launch_counts())
    served = [s["runs_served"] for s in pool_stats().values()]
    print(f"[serve] process: 3 VI requests on one pool: walls "
          f"{[round(r.wall_time, 3) for r in [first] + rest]} s, "
          f"interpreters spawned after the first {spawned}, runs served "
          f"{served}")
    check(spawned == 0 and served == [3],
          f"serve process: {spawned} spawns, runs served {served}")
    shutdown_pools()
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


def phase_lm_bf16(torch, dev):
    """Gemma-2-2B at its published widths in the config's own bfloat16
    (weights and, following them, the prefill's caches) through
    lm_serve's ``serve``: every prefill attention launches the bfloat16
    tensor-core kernel.  Then one traced prefill splits its device time by
    kernel group (``lm_profile.breakdown``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params

    cfg = lm_serve.make_config(LM_ARCH)
    check(cfg.param_dtype == "bfloat16", f"lm-bf16: {cfg.name} has "
          f"param_dtype {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    dtypes = {p.dtype for p in params.parameters()}
    check(dtypes == {torch.bfloat16}, f"lm-bf16: parameter types {dtypes}")
    print(f"[lm-bf16] {cfg.name}: {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"bfloat16 parameters drawn in {time.perf_counter() - t0:.2f} s")
    lm_serve.serve(cfg, params, lm_serve.make_prompt(cfg, LM_BATCH, 64, dev),
                   2)  # warm-up, not measured
    prompt = lm_serve.make_prompt(cfg, LM_BATCH, LM_PROMPT, dev)
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):  # records the types; launches and counts as is
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.flash_attention = spy
    try:
        ops.reset_launch_counts()
        res = lm_serve.serve(cfg, params, prompt, LM_GEN)
        launches = ops.launch_counts()
    finally:
        ops.flash_attention = real
    peak = torch.cuda.max_memory_allocated(dev)
    check(tuple(res.tokens.shape) == (LM_BATCH, LM_GEN),
          f"lm-bf16: tokens shape {tuple(res.tokens.shape)}")
    check(res.prefill_logits.dtype == torch.bfloat16,
          f"lm-bf16: prefill logits are {res.prefill_logits.dtype}")
    check(bool(torch.isfinite(res.prefill_logits).all()),
          "lm-bf16: non-finite prefill logits")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          "lm-bf16: token out of the vocabulary")
    check(launches["flash_attention"] == cfg.n_layers == len(seen),
          f"lm-bf16: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {cfg.n_layers}")
    check(all(d == (torch.bfloat16,) * 3 for d in seen),
          f"lm-bf16: flash_attention inputs {set(seen)}, expected bfloat16")
    MEASURED["lm-bf16"] = dict(peak=peak, s=res.prefill_s,
                               decode_ms=res.decode_ms_per_step)
    split = _cell_prefill_split(torch, "lm-bf16", cfg, params, prompt, None)
    flash_ms = split["groups"]["flash_attention"]
    print(f"[lm-bf16] prefill {LM_BATCH} x {LM_PROMPT} tokens: "
          f"{res.prefill_s:.3f} s ({LM_BATCH * LM_PROMPT / res.prefill_s:.0f}"
          f" tokens/s); decode {res.decode_ms_per_step:.2f} ms/step "
          f"({LM_BATCH * 1e3 / res.decode_ms_per_step:.1f} tokens/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; flash_attention "
          f"launches {launches['flash_attention']}, all bfloat16; traced "
          f"prefill: flash_attention {flash_ms:.3f} ms of "
          f"{split['device_ms']:.3f} ms device time "
          f"({flash_ms / split['device_ms']:.3f})")
    print(f"[lm-bf16] row0: {res.tokens[0].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return launches


#: the card against the CPU in bfloat16, max|delta| / max|ref| of the
#: prefill logits and of 8 teacher-forced decode steps
LM_BF16_PARITY_TOL = 3e-2


def phase_lm_bf16_parity(torch, dev):
    """Gemma-2-2B widths at depth 2, window 128, vocab cut to 32768,
    bfloat16 weights, prompt 2 x 512: the card (the tensor-core kernel,
    cuBLAS bfloat16 products) against the CPU (the plain version) on the
    same weights.  The decode steps are teacher-forced on the CPU's
    greedy tokens: two bfloat16 runs may split at a near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import decode_step, init_params, prefill

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, window=128,
                              vocab_size=32768)
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(1), device=cpu)
    check(all(p.dtype == torch.bfloat16 for p in params.parameters()),
          "lm-bf16-parity: parameters are not bfloat16")
    prompt = lm_serve.make_prompt(cfg, 2, 512, cpu, seed=1)
    steps = 8

    def run(p, toks, forced=None):
        logits, caches = prefill(cfg, p, {"tokens": toks},
                                 max_len=toks.shape[1] + steps)
        out, tok = [logits], logits[:, -1].argmax(-1)[:, None]
        fed = []
        for t in range(steps):
            tok = forced[t].to(toks.device) if forced is not None else tok
            fed.append(tok.cpu())
            step, caches = decode_step(cfg, p, caches, tok,
                                       toks.shape[1] + t)
            out.append(step)
            tok = step[:, 0].argmax(-1)[:, None]
        return [o.float().cpu() for o in out], fed

    t0 = time.perf_counter()
    want, fed = run(params, prompt)
    cpu_s = time.perf_counter() - t0
    got, _ = run(params.to(dev), prompt.to(dev), forced=fed)
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(got, want)]
    print(f"[lm-bf16-parity] depth 2, window 128, vocab 32768, prompt "
          f"2 x 512, {steps} teacher-forced decode steps, bfloat16: logits "
          f"max|delta|/max|ref| prefill {rels[0]:.3e}, decode max "
          f"{max(rels[1:]):.3e} (tol {LM_BF16_PARITY_TOL:g}; CPU run "
          f"{cpu_s:.1f} s)")
    check(max(rels) <= LM_BF16_PARITY_TOL,
          f"lm-bf16 parity: logits differ by {max(rels):.3e}")
    del params
    torch.cuda.empty_cache()


def _bf16_cell(torch, dev, label, arch):
    """Draw ``arch``'s weights at its published widths in its bfloat16 on
    the card and warm ``lm_serve.serve`` up; returns (cfg, params,
    prompt)."""
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params

    cfg = lm_serve.make_config(arch)
    check(cfg.param_dtype == "bfloat16", f"{label}: {cfg.name} has "
          f"param_dtype {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    dtypes = {p.dtype for p in params.parameters()}
    check(dtypes == {torch.bfloat16}, f"{label}: parameter types {dtypes}")
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers {cfg.period}, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, vocab "
          f"{cfg.vocab_size}; "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"bfloat16 parameters drawn in {time.perf_counter() - t0:.2f} s")
    lm_serve.serve(cfg, params, lm_serve.make_prompt(cfg, LM_BATCH, 64, dev),
                   2)  # warm-up, not measured
    prompt = lm_serve.make_prompt(cfg, LM_BATCH, LM_PROMPT, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    return cfg, params, prompt


def _check_served(torch, label, cfg, res, batch=LM_BATCH):
    check(tuple(res.tokens.shape) == (batch, LM_GEN),
          f"{label}: tokens shape {tuple(res.tokens.shape)}")
    check(res.prefill_logits.dtype == torch.bfloat16,
          f"{label}: prefill logits are {res.prefill_logits.dtype}")
    check(bool(torch.isfinite(res.prefill_logits).all()),
          f"{label}: non-finite prefill logits")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()),
          f"{label}: token out of the vocabulary")


def _rates(res) -> str:
    return (f"prefill {LM_BATCH} x {LM_PROMPT} tokens: {res.prefill_s:.3f} s "
            f"({LM_BATCH * LM_PROMPT / res.prefill_s:.0f} tokens/s); decode "
            f"{res.decode_ms_per_step:.2f} ms/step "
            f"({LM_BATCH * 1e3 / res.decode_ms_per_step:.1f} tokens/s)")


def _check_decode_experts(label, cfg, launches):
    """One ``moe_expert_ffn`` launch a MoE layer and decode step of a
    served ``LM_GEN`` tokens (none in the prefill, whose experts take the
    capacity path); returns the launches."""
    from repro_torch.models.transformer import layer_kinds

    n_moe = sum(ffn == "moe" for _, ffn in layer_kinds(cfg))
    n = launches["moe_expert_ffn"]
    check(n == n_moe * (LM_GEN - 1),
          f"{label}: moe_expert_ffn launched {n} times in a serve, expected "
          f"{n_moe} MoE layers x {LM_GEN - 1} decode steps")
    return n


def phase_lm_moe(torch, dev, label, arch):
    """An MoE config at its published widths in bfloat16 through lm_serve's
    ``serve``: prefill attention through the bfloat16 flash kernel once per
    layer, the experts through ``models.moe`` (capacity in the prefill,
    dropless on the picked experts in decode).  Counts the assignments
    the prefill dropped by capacity; then one traced prefill's device time
    by kernel group (``lm_profile.breakdown``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.models import moe

    cfg, params, prompt = _bf16_cell(torch, dev, label, arch)
    m = cfg.moe
    T = LM_BATCH * LM_PROMPT
    C = moe.capacity(cfg, T)
    print(f"[{label}] {m.n_experts} experts padded to {m.padded_experts}, "
          f"top-{m.top_k}, {m.n_shared} shared, d_ff {cfg.d_ff}; prefill "
          f"capacity {C} a expert (factor {m.capacity_factor:g})")
    seen, dropped = [], []
    real_flash, real_moe = ops.flash_attention, moe.moe_ffn

    def flash_spy(q, k, v, **kw):  # records the types; launches as is
        seen.append((q.dtype, k.dtype, v.dtype))
        return real_flash(q, k, v, **kw)

    def moe_spy(cfg_, p, x, dropless=False, **kw):
        out, aux = real_moe(cfg_, p, x, dropless=dropless, **kw)
        if not dropless:
            dropped.append(aux["moe_dropped"])
        return out, aux

    ops.flash_attention, moe.moe_ffn = flash_spy, moe_spy
    try:
        ops.reset_launch_counts()
        res = lm_serve.serve(cfg, params, prompt, LM_GEN)
        launches = ops.launch_counts()
    finally:
        ops.flash_attention, moe.moe_ffn = real_flash, real_moe
    peak = torch.cuda.max_memory_allocated(dev)
    _check_served(torch, label, cfg, res)
    check(launches["flash_attention"] == cfg.n_layers == len(seen),
          f"{label}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {cfg.n_layers}")
    n_expert = _check_decode_experts(label, cfg, launches)
    check(all(d == (torch.bfloat16,) * 3 for d in seen),
          f"{label}: flash_attention inputs {set(seen)}, expected bfloat16")
    check(len(dropped) == cfg.n_layers,
          f"{label}: {len(dropped)} capacity-dispatched MoE layers in the "
          f"prefill, expected {cfg.n_layers}")
    n_drop = int(torch.stack(dropped).sum())
    n_assign = T * m.top_k * cfg.n_layers
    split = _cell_prefill_split(torch, label, cfg, params, prompt, None)
    print(f"[{label}] {_rates(res)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; flash_attention launches "
          f"{launches['flash_attention']}, all bfloat16; moe_expert_ffn "
          f"launches {n_expert} in decode; assignments dropped "
          f"by capacity in the prefill {n_drop} of {n_assign} "
          f"({n_drop / n_assign:.4f}); traced prefill device time "
          f"{split['device_ms']:.3f} ms: {_shares(split)}")
    print(f"[{label}] row0: {res.tokens[0].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return launches


def phase_lm_xlstm(torch, dev):
    """xLSTM-125M at its published widths in bfloat16 through lm_serve's
    ``serve``: the parallel mLSTM and the sLSTM's Python loop over time in
    the prefill, recurrent states in decode; no attention, so no flash
    launch.  The sLSTM layers' prefill seconds are read by synchronising
    around each."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.models import xlstm

    label = "lm-xlstm"
    cfg, params, prompt = _bf16_cell(torch, dev, label, LM_XLSTM)
    slstm_s = []
    real = xlstm.slstm_block_with_state

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t0)
        return out

    xlstm.slstm_block_with_state = timed
    try:
        ops.reset_launch_counts()
        res = lm_serve.serve(cfg, params, prompt, LM_GEN)
        launches = ops.launch_counts()
    finally:
        xlstm.slstm_block_with_state = real
    peak = torch.cuda.max_memory_allocated(dev)
    _check_served(torch, label, cfg, res)
    check(launches["flash_attention"] == 0,
          f"{label}: flash_attention launched {launches['flash_attention']} "
          f"times, expected none")
    n_s = sum(1 for mixer, _ in cfg.period if mixer == "slstm") * cfg.n_periods
    check(len(slstm_s) == n_s, f"{label}: {len(slstm_s)} sLSTM prefills, "
          f"expected {n_s}")
    print(f"[{label}] {_rates(res)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; flash_attention launches 0; the {n_s} "
          f"sLSTM layers' loops over {LM_PROMPT} steps {sum(slstm_s):.3f} s "
          f"({sum(slstm_s) / res.prefill_s:.3f} of the prefill)")
    print(f"[{label}] row0: {res.tokens[0].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return launches


def _cell_prefill_split(torch, label, cfg, params, prompt, inputs):
    """One traced prefill (gen 1: no decode) split by kernel group
    (``lm_profile.breakdown``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import lm_profile, lm_serve
    from repro_torch.telemetry.serving import SERVE_SPANS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm_serve.serve(cfg, params, prompt, 1, inputs=inputs)
    events = prof.events()
    wall = [e.time_range for e in events if e.name == lm_serve.PREFILL
            and e.device_type == DeviceType.CPU]
    split = lm_profile.breakdown(
        f"{label} traced prefill", wall[0].elapsed_us() / 1e3,
        [e for e in events if e.device_type == DeviceType.CUDA
         and e.name not in SERVE_SPANS])
    check(split["groups"].get("flash_attention", 0.0) > 0,
          f"{label}: the trace holds no flash-attention kernel")
    return split


def _prefill_roles(torch, label, cfg, params, prompt, inputs, want):
    """The flash launches of one more prefill (untimed), by role
    (``lm_profile.flash_roles``), with their host time; checks them
    against ``want`` ({role: launches}), all bfloat16."""
    from repro_torch.launch import lm_profile, lm_serve

    with lm_profile.flash_roles() as calls:
        lm_serve.serve(cfg, params, prompt, 1, inputs=inputs)
    roles = lm_profile.role_summary(calls)
    got = {role: r["launches"] for role, r in roles.items()}
    check(got == want, f"{label}: flash launches by role {got}, expected "
          f"{want}")
    for role, r in roles.items():
        check(r["dtypes"] == ["bfloat16"],
              f"{label}: {role} flash inputs {r['dtypes']}")
    return roles


def _roles_line(roles) -> str:
    return ", ".join(f"{role} {r['launches']} ({'/'.join(r['dtypes'])}, "
                     f"host {r['host_us']:.1f} us a launch)"
                     for role, r in roles.items())


def _shares(split) -> str:
    return ", ".join(f"{g} {ms:.3f} ms ({ms / split['device_ms']:.3f})"
                     for g, ms in sorted(split["groups"].items(),
                                         key=lambda kv: -kv[1]))


def phase_lm_whisper(torch, dev):
    """Whisper-large-v3 at its published widths (32 encoder + 32 decoder
    layers) in its bfloat16 through lm_serve's ``serve``: 8 clips of 1500
    seeded frame embeddings, a 224-token prompt, LM_GEN greedy tokens.
    Each prefill launches the bfloat16 flash kernel 96 times: per layer
    once in the encoder (non-causal), and once for self-attention
    (causal) and once for cross-attention (non-causal, 1500 keys) in the
    decoder.  A warm-up serves the same inputs with one decode step.
    Prints the prefill, the encoder's share, decode, peak memory and a
    traced prefill's split by kernel group."""
    from repro_torch.kernels import ops
    from repro_torch.launch import inputs as stub, lm_serve
    from repro_torch.models import init_params, transformer

    label = "lm-whisper"
    cfg = lm_serve.make_config(LM_WHISPER)
    check(WHISPER_PROMPT == stub.WHISPER_DEC_LEN // 2,
          f"{label}: the prompt is not half Whisper's text context")
    check(cfg.param_dtype == "bfloat16" and cfg.kind == "encdec",
          f"{label}: {cfg.name} is {cfg.kind}, {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    dtypes = {p.dtype for p in params.parameters()}
    check(dtypes == {torch.bfloat16}, f"{label}: parameter types {dtypes}")
    print(f"[{label}] {cfg.name}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"bfloat16 parameters drawn in {time.perf_counter() - t0:.2f} s")
    B, bf16, frames = WHISPER_BATCH, torch.bfloat16, stub.WHISPER_FRAMES
    inputs = lm_serve.audio_inputs(cfg, B, frames, dev, bf16)
    prompt = lm_serve.make_prompt(cfg, B, WHISPER_PROMPT, dev)
    lm_serve.serve(cfg, params, prompt, 2, inputs=inputs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, params, prompt, LM_GEN, inputs=inputs)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_served(torch, label, cfg, res, batch=B)
    n = cfg.n_enc_layers + 2 * cfg.n_layers
    check(launches["flash_attention"] == n,
          f"{label}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {n}")
    roles = _prefill_roles(torch, label, cfg, params, prompt, inputs, {
        "encoder": cfg.n_enc_layers, "self": cfg.n_layers,
        "cross": cfg.n_layers})
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = transformer._encode(cfg, params, inputs)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    check(bool(torch.isfinite(enc).all()), f"{label}: non-finite encoder "
          f"output")
    del enc
    split = _cell_prefill_split(torch, label, cfg, params, prompt, inputs)
    print(f"[{label}] prefill {B} clips x {frames} frames + {B} x "
          f"{WHISPER_PROMPT} tokens: {res.prefill_s:.3f} s ({B / res.prefill_s:.1f}"
          f" clips/s), of which the encoder alone {enc_s:.3f} s; decode "
          f"{res.decode_ms_per_step:.2f} ms/step "
          f"({B * 1e3 / res.decode_ms_per_step:.1f} tokens/s); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; flash_attention "
          f"launches {launches['flash_attention']}: {_roles_line(roles)}; "
          f"traced prefill device time {split['device_ms']:.3f} ms: "
          f"{_shares(split)}")
    print(f"[{label}] row0: {res.tokens[0].tolist()}")
    del params, res, inputs
    torch.cuda.empty_cache()
    return launches


def phase_lm_vl(torch, dev):
    """Qwen2-VL-72B's widths at depth VL_LAYERS in its bfloat16 through
    lm_serve's ``serve``: LM_BATCH x LM_PROMPT tokens whose first quarter
    is a seeded vision block on a 1 x 32 x 64 patch grid, M-RoPE ids
    (t, h, w differ there; text at t = h = w from 64), and decode ids
    that continue the text's apart from the cache index.  One bfloat16
    flash launch a layer a prefill (hd 128, 8:1 GQA).  A warm-up serves
    the same inputs with one decode step."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params

    label = "lm-vl"
    cfg = dataclasses.replace(lm_serve.make_config(LM_VL),
                              n_layers=VL_LAYERS)
    check(cfg.param_dtype == "bfloat16" and cfg.mrope_sections is not None,
          f"{label}: {cfg.name} has no M-RoPE or is {cfg.param_dtype}")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    print(f"[{label}] {cfg.name}: depth cut to {cfg.n_layers} of 80 layers,"
          f" d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
          f"KV of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE "
          f"{cfg.mrope_sections}; "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"bfloat16 parameters drawn in {time.perf_counter() - t0:.2f} s")
    bf16 = torch.bfloat16
    inputs, dec = lm_serve.vision_inputs(cfg, LM_BATCH, LM_PROMPT, LM_GEN,
                                         dev, bf16)
    pos = inputs["positions"]
    nv = inputs["vision_embeds"].shape[1]
    check(bool((pos[:, 0, :nv] != pos[:, 1, :nv]).any()
               and (pos[:, 1, :nv] != pos[:, 2, :nv]).any()),
          f"{label}: the M-RoPE streams do not differ")
    check(int(dec[0, 0, 0]) != LM_PROMPT,
          f"{label}: the decode ids are the cache index")
    prompt = lm_serve.make_prompt(cfg, LM_BATCH, LM_PROMPT, dev)
    lm_serve.serve(cfg, params, prompt, 2, inputs=inputs,
                   decode_positions=dec)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, params, prompt, LM_GEN, inputs=inputs,
                         decode_positions=dec)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_served(torch, label, cfg, res)
    MEASURED[label] = dict(peak=peak, s=res.prefill_s,
                           decode_ms=res.decode_ms_per_step)
    check(launches["flash_attention"] == cfg.n_layers,
          f"{label}: flash_attention launched {launches['flash_attention']} "
          f"times in one prefill, expected {cfg.n_layers}")
    roles = _prefill_roles(torch, label, cfg, params, prompt, inputs,
                           {"self": cfg.n_layers})
    split = _cell_prefill_split(torch, label, cfg, params, prompt, inputs)
    print(f"[{label}] {_rates(res)}; vision block {nv} positions on grid "
          f"{lm_serve.vision_grid(nv)}, text M-RoPE ids from "
          f"{int(pos[0, 0, nv])}, decode ids from {int(dec[0, 0, 0])} (cache "
          f"index {LM_PROMPT}); max_memory_allocated {peak / 2**30:.2f} GiB;"
          f" flash_attention launches {launches['flash_attention']}: "
          f"{_roles_line(roles)}; traced prefill device time "
          f"{split['device_ms']:.3f} ms: {_shares(split)}")
    print(f"[{label}] row0: {res.tokens[0].tolist()}")
    del params, res, inputs
    torch.cuda.empty_cache()
    return launches


def phase_lm_jamba(torch, dev):
    """Jamba-1.5-Large's widths at depth JAMBA_LAYERS in its bfloat16
    through lm_serve's ``serve``: LM_BATCH x LM_PROMPT tokens, LM_GEN
    greedy tokens, after a warm-up at the same shapes with one decode
    step.  Each prefill launches the bfloat16 flash kernel once (the
    attention layer: hd 128, 8:1 GQA, causal) and ``selective_scan`` once
    a Mamba layer (4); decode launches neither (the Mamba step is plain
    PyTorch) and ``moe_expert_ffn`` once a MoE layer and step.  Prints the parameter count, prefill and decode times,
    peak memory and a traced prefill's split by kernel group."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params
    from repro_torch.models.transformer import layer_kinds

    label = "lm-jamba"
    cfg = dataclasses.replace(lm_serve.make_config(LM_JAMBA),
                              n_layers=JAMBA_LAYERS,
                              ssm_chunk=JAMBA_SSM_CHUNK)
    kinds = layer_kinds(cfg)
    check(set(kinds) == {("mamba", "mlp"), ("mamba", "moe"),
                         ("attn", "mlp")} and cfg.param_dtype == "bfloat16",
          f"{label}: layers {kinds}, {cfg.param_dtype}")
    n_mamba = sum(mixer == "mamba" for mixer, _ in kinds)
    n_attn = sum(mixer == "attn" for mixer, _ in kinds)
    vl = lm_serve.make_config(LM_VL)  # its flash row in the kernel table
    check((cfg.n_heads, cfg.n_kv_heads, cfg.hd)
          == (vl.n_heads, vl.n_kv_heads, vl.hd),
          f"{label}: attention heads are not the Qwen2-VL row's")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    m = cfg.mamba
    print(f"[{label}] {cfg.name}: depth cut to {cfg.n_layers} of 72 layers "
          f"{kinds}, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, Mamba d_state "
          f"{m.d_state} d_conv {m.d_conv} expand {m.expand}, vocab "
          f"{cfg.vocab_size}, ssm_chunk {cfg.ssm_chunk}; {n_params / 1e9:.3f}"
          f" B bfloat16 parameters ({n_params * 2 / 2**30:.2f} GiB) drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = lm_serve.make_prompt(cfg, LM_BATCH, LM_PROMPT, dev)
    lm_serve.serve(cfg, params, prompt, 2)  # warm-up at the cell's shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, params, prompt, LM_GEN)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    _check_served(torch, label, cfg, res)
    MEASURED[label] = dict(peak=peak, s=res.prefill_s,
                           decode_ms=res.decode_ms_per_step)
    ops.reset_launch_counts()
    roles = _prefill_roles(torch, label, cfg, params, prompt, None,
                           {"self": n_attn})
    in_prefill = ops.launch_counts()
    want = {"flash_attention": n_attn, "selective_scan": n_mamba,
            "moe_expert_ffn": 0}
    for k, n in want.items():
        check(in_prefill[k] == n,
              f"{label}: {k} launched {in_prefill[k]} times in a prefill, "
              f"expected {n}")
    for k in ("flash_attention", "selective_scan"):
        check(launches[k] == want[k],
              f"{label}: {k} launched {launches[k]} times in a serve, "
              f"expected {want[k]} (none in decode)")
    n_expert = _check_decode_experts(label, cfg, launches)
    split = _cell_prefill_split(torch, label, cfg, params, prompt, None)
    scan_ms = split["groups"].get("selective_scan", 0.0)
    check(scan_ms > 0, f"{label}: the trace holds no selective_scan kernel")
    print(f"[{label}] {_rates(res)}; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; launches a prefill: flash_attention "
          f"{in_prefill['flash_attention']} ({_roles_line(roles)}), "
          f"selective_scan {in_prefill['selective_scan']}, neither in "
          f"decode; moe_expert_ffn {n_expert} in decode; "
          f"traced prefill device time {split['device_ms']:.3f} ms: "
          f"{_shares(split)}; selective_scan {scan_ms / n_mamba:.3f} ms a "
          f"layer")
    print(f"[{label}] row0: {res.tokens[0].tolist()}")
    del params, res
    torch.cuda.empty_cache()
    return launches


def phase_lm_cell_parity(torch, dev, label, cfg, B, S, steps, make_inputs):
    """``cfg`` on the card against the CPU on the same weights, float32 to
    1e-4 and bfloat16 to ``LM_BF16_PARITY_TOL``: prefill logits and
    ``steps`` decode steps teacher-forced on the CPU's tokens.  The
    weights are drawn on the card (one generator's draws on the CPU take
    ~20 s at Qwen2-VL's 2.3 B) and copied to the CPU.
    ``make_inputs(cfg, dtype)`` gives the prefill's other inputs and the
    decode's M-RoPE ids, made on the CPU.  Prints each dtype's seconds
    by step: the draw, the copy to the CPU, the CPU run and the card
    run."""
    import copy

    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params

    cpu = torch.device("cpu")
    prompt = lm_serve.make_prompt(cfg, B, S, cpu, seed=1)
    for dtype, tol in ((torch.float32, 1e-4),
                       (torch.bfloat16, LM_BF16_PARITY_TOL)):
        name = str(dtype).replace("torch.", "")
        secs = {}

        def lap(step, t0):
            torch.cuda.synchronize()
            secs[step] = time.perf_counter() - t0
            return time.perf_counter()

        t0 = time.perf_counter()
        on_card = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                              dtype=dtype, device=dev)
        t0 = lap("draw", t0)
        params = copy.deepcopy(on_card).to(cpu)
        inputs, dec = make_inputs(cfg, dtype)
        t0 = lap("copy", t0)
        want, fed = _forced_run(torch, cfg, params, prompt, steps,
                                inputs=inputs, dec_pos=dec)
        t0 = lap("cpu run", t0)
        to_dev = {k: t.to(dev) for k, t in inputs.items()}
        got, _ = _forced_run(torch, cfg, on_card, prompt.to(dev),
                             steps, forced=fed, inputs=to_dev,
                             dec_pos=None if dec is None else dec.to(dev))
        lap("card run", t0)
        rel = _rel_max(got, want)
        same = all(torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
                   for g, w in zip(got, want))
        print(f"[{label}] {name}: logits max|delta|/max|ref| {rel:.3e} "
              f"(tol {tol:g}) over the prefill and {steps} teacher-forced "
              f"decode steps; greedy picks identical {same}; seconds: "
              + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
        check(rel <= tol, f"{label} {name}: logits differ by {rel:.3e}")
        del params, on_card, inputs, to_dev
        torch.cuda.empty_cache()


def phase_lm_whisper_parity(torch, dev):
    """Whisper-large-v3 at its published widths, 2 encoder + 2 decoder
    layers, 2 clips of 64 frames, prompt 2 x 32, 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve

    cfg = dataclasses.replace(get_config(LM_WHISPER), n_layers=2,
                              n_enc_layers=2)
    print(f"[lm-whisper-parity] {cfg.name} widths, {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, 2 x 64 frames, prompt 2 x 32")
    phase_lm_cell_parity(
        torch, dev, "lm-whisper-parity", cfg, 2, 32, 8,
        lambda c, dt: (lm_serve.audio_inputs(c, 2, 64, torch.device("cpu"),
                                             dt, seed=1), None))


def phase_lm_vl_parity(torch, dev):
    """Qwen2-VL-72B widths at depth 2, vocab cut to 32768, prompt 2 x 256
    with a 64-position vision block (1 x 8 x 8) and M-RoPE ids, 8 decode
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve

    cfg = dataclasses.replace(get_config(LM_VL), n_layers=2,
                              vocab_size=32768)
    print(f"[lm-vl-parity] {cfg.name} widths, depth 2, vocab 32768, prompt "
          f"2 x 256 with a 64-position vision block")
    phase_lm_cell_parity(
        torch, dev, "lm-vl-parity", cfg, 2, 256, 8,
        lambda c, dt: lm_serve.vision_inputs(c, 2, 256, 9,
                                             torch.device("cpu"), dt,
                                             seed=1))


def phase_lm_jamba_parity(torch, dev):
    """(a) Jamba-1.5-Large's widths at depth 1 (its (mamba, mlp) layer),
    vocab cut to 32768, prompt 2 x 256, ``ssm_chunk`` 64 (the CPU's scan
    in 4 chunks), 8 decode steps: float32 to 1e-4, bfloat16 to
    ``LM_BF16_PARITY_TOL`` (``phase_lm_cell_parity``); one
    ``selective_scan`` launch a card prefill.  (b) The reduced full period
    (``reduced()``: 8 layers, every sublayer kind at once) in float32,
    prompt 2 x 100, 8 decode steps teacher-forced on the CPU's tokens,
    logits within 1e-4; 7 ``selective_scan`` launches and 1 flash launch a
    card prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve

    label = "lm-jamba-parity"
    cfg = dataclasses.replace(get_config(LM_JAMBA), n_layers=1,
                              vocab_size=32768, ssm_chunk=64)
    print(f"[{label}] (a) {cfg.name} widths, depth 1 {cfg.remainder}, vocab "
          f"32768, prompt 2 x 256, ssm_chunk 64")
    ops.reset_launch_counts()
    phase_lm_cell_parity(torch, dev, label, cfg, 2, 256, 8,
                         lambda c, dt: ({}, None))
    got = ops.launch_counts()["selective_scan"]
    check(got == 2, f"{label} (a): selective_scan launched {got} times in "
          f"two card runs, expected 1 a prefill")
    cfg = get_config(LM_JAMBA).reduced()
    cpu = torch.device("cpu")
    params = lm_serve.make_params(cfg, cpu, seed=1)
    prompt = lm_serve.make_prompt(cfg, 2, 100, cpu, seed=1)
    steps = 8
    want, fed = _forced_run(torch, cfg, params, prompt, steps)
    ops.reset_launch_counts()
    got, _ = _forced_run(torch, cfg, params.to(dev), prompt.to(dev), steps,
                         forced=fed)
    counts = ops.launch_counts()
    rel = _rel_max(got, want)
    print(f"[{label}] (b) reduced period {cfg.period}, d_model {cfg.d_model},"
          f" d_state {cfg.mamba.d_state}, float32, prompt 2 x 100, {steps} "
          f"teacher-forced decode steps: logits max|delta|/max|ref| "
          f"{rel:.3e} (tol 1e-4); card prefill launches flash_attention "
          f"{counts['flash_attention']}, selective_scan "
          f"{counts['selective_scan']}")
    check(rel <= 1e-4, f"{label} (b): logits differ by {rel:.3e}")
    check(counts["flash_attention"] == 1 and counts["selective_scan"] == 7,
          f"{label} (b): launches {counts}")
    del params
    torch.cuda.empty_cache()


def _forced_run(torch, cfg, params, toks, steps, forced=None, inputs=None,
                dec_pos=None):
    """Prefill ``toks`` (with the prefill's other ``inputs``) and ``steps``
    decode steps (with M-RoPE ids ``dec_pos`` (B, 3, steps)), each fed the
    previous greedy token or, with ``forced``, that list's; returns the
    logits (float32, on the CPU) and the tokens fed."""
    from repro_torch.models import decode_step, prefill

    logits, caches = prefill(cfg, params, {"tokens": toks, **(inputs or {})},
                             max_len=toks.shape[1] + steps)
    out, tok, fed = [logits], logits[:, -1].argmax(-1)[:, None], []
    for t in range(steps):
        tok = forced[t].to(toks.device) if forced is not None else tok
        fed.append(tok.cpu())
        mrope = None if dec_pos is None else dec_pos[:, :, t:t + 1]
        step, caches = decode_step(cfg, params, caches, tok,
                                   toks.shape[1] + t, mrope)
        out.append(step)
        tok = step[:, 0].argmax(-1)[:, None]
    return [o.float().cpu() for o in out], fed


def _rel_max(got, want) -> float:
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


#: [lm-moe-parity]: the CPU's gap between the k-th and (k+1)-th router
#: probability below which a routing decision may differ on the card
MOE_TIE = {"float32": 1e-5, "bfloat16": 1e-2}


def phase_lm_moe_parity(torch, dev):
    """Qwen1.5-MoE widths at depth 1 (all 64 experts; capacity factor
    1.25, so experts overflow), vocab cut to 32768, prompt 4 x 256, 8
    decode steps: the card against the CPU on the same weights (drawn on
    the card and copied: the CPU's draw took most of the phase), in
    float32 (tol 1e-4) and bfloat16 (``LM_BF16_PARITY_TOL``), the decode
    teacher-forced on the CPU's tokens.  Routing near-ties may flip
    between the devices, and a flip at one token moves its row and, by
    the shared capacity, other rows' drops: so each router call on the
    card takes the CPU's experts where its top-k set differs, each such
    flip must be a near-tie on the CPU (its gap between the k-th and
    (k+1)-th probability below ``MOE_TIE``), and the logits of every row
    are then held.  Prints the flips, their largest gap and the rows
    without one."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params, moe

    cfg = dataclasses.replace(get_config(LM_MOE[0][1]), n_layers=1,
                              vocab_size=32768)
    k, cpu = cfg.moe.top_k, torch.device("cpu")
    B, S, steps = 4, 256, 8
    prompt = lm_serve.make_prompt(cfg, B, S, cpu, seed=1)
    real = moe.route
    for dtype, tol in ((torch.float32, 1e-4),
                       (torch.bfloat16, LM_BF16_PARITY_TOL)):
        name = str(dtype).replace("torch.", "")
        on_card = init_params(cfg,
                              torch.Generator(device=dev).manual_seed(1),
                              dtype=dtype, device=dev)
        params = copy.deepcopy(on_card).to(cpu)
        rec = []

        def record(cfg_, p, xt):
            r = real(cfg_, p, xt)
            top = r.probs.topk(k + 1, dim=-1).values
            rec.append((r.top_e, top[:, k - 1] - top[:, k]))
            return r

        moe.route = record
        try:
            t0 = time.perf_counter()
            want, fed = _forced_run(torch, cfg, params, prompt, steps)
            cpu_s = time.perf_counter() - t0
        finally:
            moe.route = real
        calls = iter(rec)
        flips, gaps, rows = 0, [], set()

        def force(cfg_, p, xt):
            nonlocal flips
            r = real(cfg_, p, xt)
            want_e, gap = next(calls)
            diff = (r.top_e.sort(-1).values.cpu()
                    != want_e.sort(-1).values).any(-1)
            idx = diff.nonzero()[:, 0]
            if idx.numel() == 0:
                return r
            flips += idx.numel()
            gaps.extend(gap[idx].tolist())
            per_row = xt.shape[0] // B
            rows.update(int(t) // per_row for t in idx)
            check(float(gap[idx].max()) < MOE_TIE[name],
                  f"lm-moe-parity {name}: routing differs at tokens "
                  f"{idx.tolist()[:8]} whose CPU gap "
                  f"{float(gap[idx].max()):.3e} is no near-tie")
            top_e = torch.where(diff.to(xt.device)[:, None],
                                want_e.to(xt.device), r.top_e)
            top_p = r.probs.gather(-1, top_e)
            return moe.Routing(r.logits, r.probs,
                               top_p / top_p.sum(-1, keepdim=True), top_e)

        moe.route = force
        try:
            got, _ = _forced_run(torch, cfg, on_card, prompt.to(dev),
                                 steps, forced=fed)
        finally:
            moe.route = real
        check(next(calls, None) is None, "lm-moe-parity: the card made "
              "fewer router calls than the CPU")
        rel = _rel_max(got, want)
        same = all(torch.equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
                   for g, w in zip(got, want))
        print(f"[lm-moe-parity] {name}: depth 1, 64 experts, vocab 32768, "
              f"prompt {B} x {S}, {steps} teacher-forced decode steps: "
              f"logits max|delta|/max|ref| {rel:.3e} (tol {tol:g}); "
              f"routing flips {flips} (largest CPU gap "
              f"{max(gaps) if gaps else 0.0:.3e}, tie bound "
              f"{MOE_TIE[name]:g}), rows without a flip "
              f"{B - len(rows)} of {B}; greedy picks identical {same} "
              f"(CPU run {cpu_s:.1f} s)")
        check(rel <= tol, f"lm-moe-parity {name}: logits differ by "
              f"{rel:.3e}")
        del params, on_card
        torch.cuda.empty_cache()


#: [lm-xlstm-parity]: a layer's (or a step's) output on the card from the
#: CPU's input, against the CPU's (the sLSTM and decode steps) or against
#: the float64 answer (the mLSTM layers), float32
XLSTM_TOL = 1e-4


def phase_lm_xlstm_parity(torch, dev):
    """xLSTM-125M widths at depth 4 (one [m, m, m, s] period), float32,
    prompt 2 x 1024, 8 decode steps: the card against the CPU on the same
    weights.  At these widths the model is ill-conditioned in float32:
    on the CPU alone, 1e-7 relative noise on the weights moves the
    logits by ~1e-1 (the JAX package's own model by ~1e-2), through the
    mLSTM's normaliser and the sLSTM's recurrence over 1024 steps.  So
    each piece gets the CPU's inputs and is held to ``XLSTM_TOL``: every
    sLSTM step of the prefill from the CPU's state and input at that step
    (all 1024 in one batched step) and every decode step from the CPU's
    states and token, against the CPU's; every mLSTM layer's prefill
    output and final state from the CPU's input to that layer, in the
    parallel form and with ``ssm_chunk=256`` (the chunk-recurrent form),
    against the float64 answer (the parallel form with the module's
    float32 points in float64, on the CPU; the chunked form's float64
    answer is the same to ~1e-13).  A single mLSTM layer at these widths
    has a float32 error near 7e-5 against that answer on either device,
    so card and CPU are held to it rather than to each other.  The whole
    model's logits, card against CPU, are printed beside the CPU's own
    1e-7 weight-noise spread."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import lm_serve
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm

    cfg = dataclasses.replace(get_config(LM_XLSTM), n_layers=4)
    cpu, steps, B, S = torch.device("cpu"), 8, 2, 1024
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         dtype=torch.float32, device=cpu)
    prompt = lm_serve.make_prompt(cfg, B, S, cpu, seed=1)
    ins, outs, slstm_steps = [], [], []
    real_full, real_step = tf.apply_sublayer_full, xlstm._slstm_step

    def record_full(cfg_, p, sub, x, *a, **kw):
        r = real_full(cfg_, p, sub, x, *a, **kw)
        ins.append(x)
        outs.append(r)
        return r

    def record_step(wr32, bias, xt, st):
        nxt = real_step(wr32, bias, xt, st)
        slstm_steps.append((xt, st, nxt))
        return nxt

    t0 = time.perf_counter()
    tf.apply_sublayer_full, xlstm._slstm_step = record_full, record_step
    try:
        want, fed = _forced_run(torch, cfg, params, prompt, steps)
    finally:
        tf.apply_sublayer_full, xlstm._slstm_step = real_full, real_step
    cpu_s = time.perf_counter() - t0
    check(len(ins) == cfg.n_layers and len(slstm_steps) == S + steps,
          f"lm-xlstm-parity: recorded {len(ins)} layers and "
          f"{len(slstm_steps)} sLSTM steps")
    # the CPU's own spread under 1e-7 relative weight noise
    noisy = copy.deepcopy(params)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for q in noisy.parameters():
            q.mul_(1 + 1e-7 * torch.randn(q.shape, generator=gen))
    spread = _rel_max(_forced_run(torch, cfg, noisy, prompt, steps,
                                  forced=fed)[0], want)
    del noisy
    # decode from the CPU's states: its prefill caches, then each step's
    caches, states = [], None
    with torch.no_grad():
        from repro_torch.models import decode_step, prefill

        _, states = prefill(cfg, params, {"tokens": prompt},
                            max_len=S + steps)
        for t in range(steps):
            caches.append(states)
            _, states = decode_step(cfg, params, states, fed[t], S + t)

    def on(tree):
        return type(tree)(*(a.to(dev) for a in tree))

    params = params.to(dev)
    got, _ = _forced_run(torch, cfg, params, prompt.to(dev), steps,
                         forced=fed)
    whole = _rel_max(got, want)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    ccfg = dataclasses.replace(cfg, ssm_chunk=256)

    def err(res, want):  # output and final state, largest
        return max(_rel_max([g.cpu().double()], [w.cpu().double()])
                   for g, w in zip([res[0], *res[2]], [want[0], *want[2]]))

    errs = {"card": [], "card ssm_chunk=256": [], "CPU": [],
            "card vs CPU": [], "ssm_chunk=256 vs parallel": []}
    with torch.no_grad():
        for i, layer in enumerate(params.layers):
            if layer.kind[0] != "mlstm":
                continue
            lay64 = copy.deepcopy(layer).to(cpu).double()
            xlstm.f32 = torch.float64
            try:
                want64 = real_full(cfg, lay64, lay64.kind, ins[i].double(),
                                   pos.cpu(), collect_cache=True,
                                   max_len=S + steps)
            finally:
                xlstm.f32 = torch.float32
            x = ins[i].to(dev)
            res = real_full(cfg, layer, layer.kind, x, pos,
                            collect_cache=True, max_len=S + steps)
            cres = real_full(ccfg, layer, layer.kind, x, pos,
                             collect_cache=True, max_len=S + steps)
            errs["card"].append(err(res, want64))
            errs["card ssm_chunk=256"].append(err(cres, want64))
            errs["CPU"].append(err(outs[i], want64))
            errs["card vs CPU"].append(err(res, outs[i]))
            errs["ssm_chunk=256 vs parallel"].append(err(cres, res))
        layer = [lyr for lyr in params.layers if lyr.kind[0] == "slstm"][0]
        xt = torch.cat([x for x, _, _ in slstm_steps]).to(dev)
        st = xlstm.SLSTMState(*(torch.cat(f).to(dev) for f in zip(
            *(s for _, s, _ in slstm_steps))))
        nxt = real_step(layer["mixer"]["wr"].float(), layer["mixer"]["bias"],
                        xt, st)
        step_err = max(_rel_max([g.cpu()], [torch.cat(f)]) for g, f in zip(
            nxt, zip(*(n for _, _, n in slstm_steps))))
        dec = [decode_step(cfg, params, [on(c) for c in caches[t]],
                           fed[t].to(dev), S + t)[0].float().cpu()
               for t in range(steps)]
    dec_err = _rel_max(dec, want[1:])
    mlstm = "; ".join(f"{k} {', '.join(f'{e:.3e}' for e in v)}"
                      for k, v in errs.items())
    print(f"[lm-xlstm-parity] depth 4, float32, prompt {B} x {S}, {steps} "
          f"decode steps, each piece from the CPU's inputs, max|delta|/"
          f"max|ref|: the {len(slstm_steps)} sLSTM steps card vs CPU "
          f"{step_err:.3e}; decode steps card vs CPU {dec_err:.3e}; mLSTM "
          f"layers' output and state against the float64 answer: {mlstm} "
          f"(tol {XLSTM_TOL:g} for the card, both forms, and the steps); "
          f"whole model card vs CPU {whole:.3e}, the CPU against itself "
          f"under 1e-7 weight noise {spread:.3e} (CPU run {cpu_s:.1f} s)")
    check(max([step_err, dec_err] + errs["card"]) <= XLSTM_TOL,
          "lm-xlstm-parity: the card differs from the CPU or the float64 "
          "answer")
    check(max(errs["card ssm_chunk=256"]) <= XLSTM_TOL,
          "lm-xlstm-parity: the chunked mLSTM differs from the float64 "
          "answer")
    del params
    torch.cuda.empty_cache()


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


def phase_train(torch, dev, name):
    """Gemma-2-2B at its published widths: AdamW steps through
    ``make_train_step`` with gradient accumulation."""
    from repro_torch.kernels import ops
    from repro_torch.launch import lm_serve
    from repro_torch.launch.kernel_bench import peaks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train_profile import ACCUM, ARCH, BATCH, SEQ
    from repro_torch.models import make_trainable
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    cfg = lm_serve.make_config(ARCH)
    t0 = time.perf_counter()
    params = lm_serve.make_params(cfg, dev, seed=0)
    flat = make_trainable(params)
    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=1,
                          total_steps=TRAIN_STEPS + 1)
    state = adamw_init(flat, opt_cfg)
    torch.cuda.synchronize()
    n, tokens = flat.n, BATCH * SEQ
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n / 1e9:.3f} B float32 "
          f"parameters (flat buffer + gradient + AdamW m/v "
          f"{4 * 4 * n / 2**30:.2f} GiB) ready in "
          f"{time.perf_counter() - t0:.2f} s")
    step_fn = make_train_step(cfg, opt_cfg, ACCUM)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=BATCH, seq=SEQ, seed=7))
    before = [p.detach().reshape(-1)[:1 << 16].clone() for p in flat.params]
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for i in range(TRAIN_STEPS + 1):  # step 0 warms up, not timed
        batch = {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                           device=dev)}
        if i == 1:
            ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(all(map(math.isfinite, (m["loss"], m["grad_norm"]))),
              f"train: step {i} loss {m['loss']} grad norm {m['grad_norm']}")
        print(f"[train] step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{m['loss']:.6f}, grad norm {m['grad_norm']:.6f}, lr "
              f"{m['lr']:.3e}, {dt:.3f} s")
        if i:
            times.append(dt)
            losses.append(m["loss"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    unchanged = [i for i, (p, b) in enumerate(zip(flat.params, before))
                 if torch.equal(p.detach().reshape(-1)[:1 << 16], b)]
    check(not unchanged, f"train: {len(unchanged)} parameters never changed")
    check(launches["flash_attention"] == 0,
          f"train: flash_attention launched {launches['flash_attention']} "
          f"times under grad")
    s_step = sum(times) / len(times)
    MEASURED["train"] = dict(peak=peak, s=s_step)
    flop = 8 * n * tokens  # forward, recompute, backward (2 x forward)
    fp32 = peaks(name)[2]
    print(f"[train] {TRAIN_STEPS} steps of {BATCH} x {SEQ} "
          f"tokens (accum {ACCUM}): {s_step:.3f} s/step "
          f"(min {min(times):.3f}, max {max(times):.3f}), "
          f"{tokens / s_step:.1f} tokens/s, {flop / s_step / 1e12:.2f} "
          f"TFLOP/s = {100 * flop / s_step / fp32:.1f}% of the float32 "
          f"non-tensor peak (bound {flop / fp32:.3f} s/step); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; every parameter "
          f"changed; launches {json.dumps(launches)}")
    del params, flat, state, step_fn, before
    torch.cuda.empty_cache()
    return launches


def phase_train_parity(torch, dev):
    """Gemma-2-2B widths at depth 2 (vocab cut to 32768): two train steps
    on the card against the CPU on the same weights."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, make_trainable
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, window=128,
                              vocab_size=32768)
    cpu = torch.device("cpu")
    base = init_params(cfg, torch.Generator().manual_seed(2),
                       dtype=torch.float32, device=cpu)
    models = {"cpu": copy.deepcopy(base), "card": base.to(dev)}
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    states = {k: adamw_init(make_trainable(m), opt_cfg)
              for k, m in models.items()}
    step_fn = make_train_step(cfg, opt_cfg, 1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                  seq=256, seed=11))
    cpu_s, near, flip_cap = 0.0, None, 0.0
    for i in range(2):
        toks = data.batch(i)["tokens"]
        metrics = {}
        for key, d in (("cpu", cpu), ("card", dev)):
            t0 = time.perf_counter()
            models[key], states[key], metrics[key] = step_fn(
                models[key], states[key],
                {"tokens": torch.as_tensor(toks, device=d)})
            if key == "cpu":
                cpu_s += time.perf_counter() - t0
        fc, fg = models["cpu"].flat, models["card"].flat
        loss_rel = (abs(metrics["card"]["loss"] - metrics["cpu"]["loss"])
                    / abs(metrics["cpu"]["loss"]))
        g_cpu = fc.grad.to(dev)
        grad_rel = max(
            float((fg.grad[lf.start:lf.stop] - g_cpu[lf.start:lf.stop])
                  .abs().max() / g_cpu[lf.start:lf.stop].abs().max())
            for lf in fg.leaves)
        # Adam moves an element by about lr whatever its gradient's size,
        # so an element whose gradient is within 100x of the card's
        # difference from the CPU's may move by up to 2 lr the other way;
        # every other element stays within lr / 10 of the CPU's, and the
        # exceptions are few.
        lr = metrics["cpu"]["lr"]
        close = g_cpu.abs() <= 100 * (fg.grad - g_cpu).abs()
        near = close if near is None else near | close
        flip_cap += 2 * lr
        diff = (fg.theta - fc.theta.to(dev)).abs()
        far = diff > lr / 10
        n_far, n_stray = int(far.sum()), int((far & ~near).sum())
        p_diff = float(diff.max())
        del g_cpu, close, diff, far
        print(f"[train-parity] step {i}: loss card "
              f"{metrics['card']['loss']:.6f} CPU {metrics['cpu']['loss']:.6f}"
              f" (rel {loss_rel:.2e}), max gradient leaf rel diff "
              f"{grad_rel:.2e} (tol 1e-4), max |param diff| after AdamW "
              f"{p_diff:.2e} (lr / 10 = {lr / 10:.2e}; {n_far} of {fg.n} "
              f"beyond it, {n_stray} of them away from a near-zero "
              f"gradient; cap {flip_cap:.2e})")
        check(loss_rel <= 1e-4, f"train parity: loss differs by {loss_rel}")
        check(grad_rel <= 1e-4,
              f"train parity: a gradient differs by {grad_rel:.3e}")
        check(n_stray == 0, f"train parity: {n_stray} parameters with a "
              f"clear gradient differ by more than lr / 10")
        check(n_far <= 1e-4 * fg.n and p_diff <= flip_cap,
              f"train parity: {n_far} parameters beyond lr / 10, max "
              f"{p_diff:.3e} (cap {flip_cap:.3e})")
    print(f"[train-parity] depth 2, window 128, vocab 32768, 2 x 256 "
          f"tokens: CPU steps {cpu_s:.1f} s")
    del models, states, base
    torch.cuda.empty_cache()


def async_dp_theta_size() -> int:
    """θ's size in [async-dp] and [diloco]: the width of their Anderson
    window."""
    from repro_torch.launch import async_dp_lm
    from repro_torch.models import model_spec
    from repro_torch.models.common import leaves

    return sum(math.prod(s.shape) for _, s in
               leaves(model_spec(async_dp_lm.make_config("card"))))


def phase_async_dp(torch, dev):
    """The coupling-density experiment of benchmarks/async_dp_lm.py at a
    size whose θ reaches anderson_mix."""
    from repro_torch.kernels import ops
    from repro_torch.launch import async_dp_lm

    cfg = async_dp_lm.make_config("card")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = async_dp_lm.run(cfg, fast=True, device=dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    n = rows[0]["results"][0].x.size
    check(n == async_dp_theta_size(), f"async-dp: θ holds {n} elements, "
          f"the window checked in [kernels] {async_dp_theta_size()}")
    for r in rows:
        print(f"[async-dp] {r['name']}: loss0 {r['loss0']:.4f}, plain "
              f"{r['plain']:.4f}, anderson {r['anderson']:.4f}, "
              f"anderson_helps {'yes' if r['anderson_helps'] else 'no'}; "
              f"fires {r['fires']}, accepts {r['accepts']}, worker_updates "
              f"{r['worker_updates']}, virtual walls "
              f"{[round(w, 4) for w in r['virtual_wall_s']]} s, host "
              f"{[round(w, 2) for w in r['host_s']]} s")
        check(r["plain"] < r["loss0"],
              f"async-dp {r['name']}: plain run did not reduce the loss")
    helps = {r["name"].split("/")[1]: r["anderson_helps"] for r in rows}
    print(f"[async-dp] n = {n}; paper's prediction: Anderson survives "
          f"full_grad (evaluation-level staleness) and degrades block_grad "
          f"(iterate-level corruption); here anderson_helps = {helps}; "
          f"{wall:.1f} s; launches {json.dumps(launches)}")
    check(launches["anderson_mix"] > 0, "async-dp: anderson_mix never ran")
    return launches


def phase_diloco(torch, dev):
    """DiLoCo sync and async (pod 0 a straggler) with Anderson(5)."""
    from repro_torch import AndersonConfig, FaultProfile
    from repro_torch.kernels import ops
    from repro_torch.launch import async_dp_lm
    from repro_torch.training.diloco import DiLoCoConfig, DiLoCoTrainer

    cfg = async_dp_lm.make_config("card")
    base = DiLoCoConfig(n_pods=4, inner_steps=4, outer_steps=6,
                        accel=AndersonConfig(m=5))
    total = {}
    for dcfg in (base, dataclasses.replace(
            base, mode="async", faults={0: FaultProfile(delay_mean=3.0)})):
        trainer = DiLoCoTrainer(cfg, dcfg, batch=4, seq=16, device=dev)
        l0 = trainer.eval_loss(trainer.theta)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = trainer.run()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        print(f"[diloco] {dcfg.mode}: loss {l0:.4f} -> "
              f"{[round(x, 4) for x in res.losses]}, outer_updates "
              f"{res.outer_updates}, accepts {res.accel_accepts}, rejects "
              f"{res.accel_rejects}, virtual wall {res.wall_times[-1]:.2f} s,"
              f" host {wall:.2f} s, launches {json.dumps(launches)}")
        check(res.losses[-1] < l0, f"diloco {dcfg.mode}: the loss did not "
              f"fall ({l0:.4f} -> {res.losses[-1]:.4f})")
        check(launches["anderson_mix"] > 0,
              f"diloco {dcfg.mode}: anderson_mix never ran")
        add_counts(total, launches)
        del trainer
    torch.cuda.empty_cache()
    return total


def phase_train_chunk(torch, dev):
    """Gemma-2-2B at its published widths, one sequence of
    TRAIN_CHUNK_SEQ tokens, ``adjusted_config`` (``attn_chunk`` 1024)
    through ``make_train_step``: one warm-up step, one timed step, then,
    from the timed step's weights and batch, one step with
    ``attn_chunk=None``: the loss within 1e-5 and every gradient leaf
    within 1e-4 relative (``[train-parity]``'s), at no higher peak.  The
    steps run AdamW at learning rate 0 (its arithmetic all the same), so
    every step starts from the same weights.  If
    the unchunked step runs out of memory, that is printed as the finding
    (with the dry run's bytes for it) and the same comparison, with the
    same checks, is made at TRAIN_CHUNK_FALLBACK tokens.  The phase runs
    with the allocator's expandable segments: the head's float32
    logit-sized tensors (7.8 GiB each at 8192 x 256000) fragment the
    default segments, and the chunked step ran out of memory with 63.6
    GiB allocated and 7.4 GiB reserved but free."""
    with expandable_segments(torch):
        _train_chunk(torch, dev)


@contextlib.contextmanager
def expandable_segments(torch):
    """The caching allocator with expandable segments inside the block
    (its cache emptied on entry and exit)."""
    settings = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


def _timed_step(torch, dev, step, params, state, batch):
    """One train step timed between synchronisations, from a reset peak:
    ``(seconds, peak bytes, metrics)``."""
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step(params, state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev),
            m)


def _train_chunk(torch, dev):
    from repro_torch.launch import dryrun, inputs, lm_serve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train_profile import ARCH
    from repro_torch.models import make_trainable
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    label, gib = "train-chunk", 2 ** 30
    shape = inputs.ShapeSpec(label, TRAIN_CHUNK_SEQ, 1, "train")
    cfg = inputs.adjusted_config(lm_serve.make_config(ARCH), shape)
    check(cfg.attn_chunk == 1024, f"{label}: attn_chunk {cfg.attn_chunk}")
    plain = dataclasses.replace(cfg, attn_chunk=None)
    params = lm_serve.make_params(cfg, dev, seed=0)
    flat = make_trainable(params)
    opt_cfg = AdamWConfig(lr=0.0, warmup_steps=1, total_steps=4)
    state = adamw_init(flat, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=1,
                                  seq=TRAIN_CHUNK_SEQ, seed=7))
    warm, batch = ({"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                              device=dev)} for i in (0, 1))
    step = make_train_step(cfg, opt_cfg, 1)
    _, state, m = step(params, state, warm)
    check(math.isfinite(m["loss"]), f"{label}: warm-up loss {m['loss']}")

    def compare(tokens):
        """The chunked and the unchunked step on ``tokens``: ``(chunked,
        unchunked)``, each (s, peak, metrics), and the largest relative
        distance of a gradient leaf."""
        b = {"tokens": tokens}
        chunked = _timed_step(torch, dev, step, params, state, b)
        ran.append(chunked)
        grad_c = flat.grad.to("cpu", copy=True)
        unchunked = _timed_step(torch, dev, make_train_step(plain, opt_cfg, 1),
                                params, state, b)
        grad_rel = 0.0
        for lf in flat.leaves:
            want = grad_c[lf.start:lf.stop].to(dev)
            got = flat.grad[lf.start:lf.stop]
            grad_rel = max(grad_rel, float((got - want).abs().max()
                                           / want.abs().max()))
        return chunked, unchunked, grad_rel

    n, oom, ran = TRAIN_CHUNK_SEQ, None, []
    try:
        chunked, unchunked, grad_rel = compare(batch["tokens"])
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]  # the traceback (and its tensors) go
    if oom is not None:
        check(ran, f"{label}: the chunked step at {n} tokens ran out of "
              f"memory ({oom})")
        torch.cuda.empty_cache()
        est = dryrun.resident_bytes(plain, "train", 1, TRAIN_CHUNK_SEQ,
                                    inputs.rules_for(plain, shape))
        print(f"[{label}] FINDING: the unchunked step at {n} tokens ran out "
              f"of memory ({oom}); the dry run's resident bytes for it "
              f"{est['total'] / gib:.2f} GiB before activations; the "
              f"chunked step took {ran[0][0]:.3f} s, max_memory_allocated "
              f"{ran[0][1] / gib:.2f} GiB; the comparison is made at "
              f"{TRAIN_CHUNK_FALLBACK} tokens")
        n = TRAIN_CHUNK_FALLBACK
        chunked, unchunked, grad_rel = compare(batch["tokens"][:, :n])
    # [dryrun] reads the chunked step at TRAIN_CHUNK_SEQ tokens
    MEASURED[label] = dict(peak=ran[0][1], s=ran[0][0])
    (s_c, peak, m_c), (s_u, plain_peak, m_u) = chunked, unchunked
    loss_rel = abs(m_u["loss"] - m_c["loss"]) / abs(m_c["loss"])
    print(f"[{label}] {cfg.name}: 1 x {n} tokens, attn_chunk "
          f"{cfg.attn_chunk}: {s_c:.3f} s/step, max_memory_allocated "
          f"{peak / gib:.2f} GiB; attn_chunk None from the same weights and "
          f"batch: {s_u:.3f} s/step, max_memory_allocated "
          f"{plain_peak / gib:.2f} GiB; loss chunked {m_c['loss']:.6f}, "
          f"unchunked {m_u['loss']:.6f} (rel {loss_rel:.2e}, tol 1e-5); max "
          f"gradient leaf rel diff {grad_rel:.2e} (tol 1e-4)")
    check(math.isfinite(m_c["loss"]), f"{label}: loss {m_c['loss']}")
    check(loss_rel <= 1e-5, f"{label}: loss differs by {loss_rel:.3e}")
    check(grad_rel <= 1e-4, f"{label}: a gradient differs by {grad_rel:.3e}")
    check(peak <= plain_peak, f"{label}: chunked peak {peak} above the "
          f"unchunked {plain_peak}")
    del params, flat, state


@contextlib.contextmanager
def dryrun_all():
    """``dryrun --all`` over the reference's cell list at one card, started
    in the background in DRYRUN_JOBS processes (they see no card and
    trace on the meta device) while the last phases run, none of whose
    times a ``[dryrun]`` line reads; the process is stopped on leaving the
    block if it still runs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(DRYRUN_JOBS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    proc.started = time.perf_counter()
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def phase_dryrun(torch):
    """The meta-device dry run at the shapes the smoke's phases ran, beside
    what they measured: the estimated resident bytes at most the measured
    peak (their ratio printed), the roofline's compute term beside the
    measured time ([train]: its share of the float32 peak), the traced
    product FLOPs beside ``model_flops``."""
    from repro_torch.launch import dryrun, inputs, lm_serve
    from repro_torch.launch.train_profile import ACCUM, ARCH, BATCH, SEQ

    gib = 2 ** 30
    cells = [
        ("train", lm_serve.make_config(ARCH),
         inputs.ShapeSpec("train", SEQ, BATCH, "train"), ACCUM, None),
        ("train-chunk", inputs.adjusted_config(
            lm_serve.make_config(ARCH),
            inputs.ShapeSpec("t", TRAIN_CHUNK_SEQ, 1, "train")),
         inputs.ShapeSpec("train-chunk", TRAIN_CHUNK_SEQ, 1, "train"), 1,
         None),
        ("lm-bf16", lm_serve.make_config(LM_ARCH),
         inputs.ShapeSpec("lm-bf16", LM_PROMPT, LM_BATCH, "prefill"), None,
         LM_PROMPT + LM_GEN),
        ("lm-jamba", dataclasses.replace(
            lm_serve.make_config(LM_JAMBA), n_layers=JAMBA_LAYERS,
            ssm_chunk=JAMBA_SSM_CHUNK),
         inputs.ShapeSpec("lm-jamba", LM_PROMPT, LM_BATCH, "prefill"), None,
         LM_PROMPT + LM_GEN),
        ("lm-vl", dataclasses.replace(lm_serve.make_config(LM_VL),
                                      n_layers=VL_LAYERS),
         inputs.ShapeSpec("lm-vl", LM_PROMPT, LM_BATCH, "prefill"), None,
         LM_PROMPT + LM_GEN),
    ]
    for label, cfg, shape, accum, max_len in cells:
        got = MEASURED.get(label)
        check(got is not None, f"dryrun: [{label}] measured nothing")
        t0 = time.perf_counter()
        rec = dryrun.dry_run(cfg, shape, accum=accum, max_len=max_len)
        res = rec["resident_bytes"]
        ratio = res["total"] / got["peak"]
        parts = ", ".join(f"{k} {v / gib:.2f}" for k, v in res.items()
                          if k != "total")
        line = (f"[dryrun] {label}: {cfg.name} {shape.batch} x {shape.seq} "
                f"{shape.kind}{f', accum {accum}' if accum else ''}: "
                f"resident estimate {res['total'] / gib:.2f} GiB ({parts}) "
                f"vs measured peak {got['peak'] / gib:.2f} GiB (ratio "
                f"{ratio:.3f}); compute term {rec['compute_s']:.4f} s, "
                f"memory term {rec['memory_s']:.4f} s ({rec['bottleneck']}) "
                f"vs measured {got['s']:.4f} s")
        if shape.kind == "train":
            line += (f" = {100 * rec['compute_s'] / got['s']:.1f}% of the "
                     f"float32 peak")
        else:
            dec = dryrun.dry_run(cfg, inputs.ShapeSpec(
                label, max_len, shape.batch, "decode"), max_len=max_len)
            line += (f"; a decode step: compute {dec['compute_s'] * 1e3:.3f}"
                     f" ms, memory {dec['memory_s'] * 1e3:.3f} ms vs "
                     f"measured {got['decode_ms']:.2f} ms")
        line += (f"; traced product FLOPs {rec['dot_flops']:.4e} "
                 f"({json.dumps(rec['dot_flops_by_dtype'])}) vs model_flops "
                 f"{rec['model_flops']:.4e} (useful "
                 f"{rec['useful_fraction']:.3f}); kernel leaves "
                 f"{json.dumps({k: v['calls'] for k, v in rec['leaves'].items()})}"
                 f"; traced in {time.perf_counter() - t0:.1f} s")
        print(line)
        check(res["total"] <= got["peak"], f"dryrun {label}: estimate "
              f"{res['total']} above the measured peak {got['peak']}")


def phase_dryrun_all(name, all_proc):
    """The lines of ``dryrun --all`` (``all_proc``, from
    :func:`dryrun_all`), one a cell, and how many fit the card."""
    stdout, stderr = all_proc.communicate(timeout=DRYRUN_TIMEOUT)
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[")]
    for ln in lines:
        print(f"[dryrun --all] {ln}")
    n_ok = sum(" OK " in ln for ln in lines)
    n_skip = sum(" SKIP " in ln for ln in lines)
    print(f"[dryrun --all] {n_ok} cells traced, {n_skip} skipped, fitting "
          f"one {name}: {sum('fits=True' in ln for ln in lines)}; "
          f"read {time.perf_counter() - all_proc.started:.1f} s after its "
          f"start in {DRYRUN_JOBS} processes")
    check(all_proc.returncode == 0, f"dryrun --all exited "
          f"{all_proc.returncode}: {stderr[-2000:]}")


def phase_examples(torch, dev):
    """The four examples whole on the card, each checking what its
    reference checks (serve_batched: decode equals teacher forcing;
    train_lm: the resumed run's loss keeps falling; diloco_async: every
    run's loss falls; quickstart: every solve converges)."""
    import tempfile

    from repro_torch.examples import (diloco_async, quickstart,
                                      serve_batched, train_lm)
    from repro_torch.kernels import ops

    def log(name):
        return lambda text: print(f"[examples] {name}: {text}")

    launches = {}
    for name, fn in (
            ("serve_batched", lambda: serve_batched.run(device=dev,
                                                        log=log("serve"))),
            ("train_lm", None),
            ("diloco_async", lambda: diloco_async.run(device=dev,
                                                      log=log("diloco"))),
            ("quickstart", lambda: quickstart.run(
                grid=QUICKSTART_GRID, vi_states=QUICKSTART_VI_STATES,
                device=dev, log=log("quickstart")))):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "train_lm":
            with tempfile.TemporaryDirectory() as d:
                out = train_lm.run(ckpt=d, device=dev, log=log("train_lm"))
        else:
            out = fn()
        wall = time.perf_counter() - t0
        counts = {k: c for k, c in ops.launch_counts().items() if c}
        extra = ""
        if name == "serve_batched":
            extra = f"teacher-forcing agreement {out['match']:.3f}, "
        elif name == "train_lm":
            extra = (f"resumed loss {out['losses'][0]:.3f} -> "
                     f"{out['losses'][-1]:.3f} (falling), ")
        elif name == "diloco_async":
            extra = "losses " + ", ".join(
                f"{k} {out['start'][k]:.3f} -> {r.losses[-1]:.3f}"
                for k, r in out["runs"].items()) + ", "
        else:
            bad = [k for k, r in out.items() if not r.converged]
            check(not bad, f"examples quickstart: {bad} did not converge")
            extra = (f"grid {QUICKSTART_GRID}, {QUICKSTART_VI_STATES} "
                     f"states, all {len(out)} runs converged, ")
        print(f"[examples] {name}: {extra}{wall:.1f} s on the card; kernel "
              f"launches {json.dumps(counts)}")
        add_counts(launches, ops.launch_counts())
    torch.cuda.empty_cache()
    return launches


#: [shard]: the band counts, and the blocks (rows, grid side) of the
#: band-sharded sweep: a four-worker block of the Jacobi main path and
#: the whole grid
SHARD_BANDS = (2, 4)
SHARD_BLOCKS = ((JACOBI_GRID // 4, JACOBI_GRID), (JACOBI_GRID, JACOBI_GRID))
#: the all-to-all's capacity factor at Qwen1.5-MoE's widths: on one rank
#: cap = T * k * cf slots and C2 = cap * cf / E per expert (4096 at
#: 2 x 8192 tokens, 3.75x the mean load), so nothing is dropped and the
#: layer is the dropless one's
SHARD_MOE_CF = 2.0
#: the two-process gloo run's tokens (batch, sequence) for the all-to-all
SHARD_GLOO_TOKENS = (2, 64)
#: its ZeRO train step: the widths, the global batch and the steps
SHARD_GLOO_STEP_WIDTHS = dict(n_layers=2, d_model=64, d_ff=128,
                              vocab_size=256, n_heads=4, n_kv_heads=4,
                              head_dim=16)
SHARD_GLOO_STEP_TOKENS = (8, 32)
SHARD_GLOO_STEPS = 5


def _shard_moe_cfg():
    from repro_torch.configs import get_config

    cfg = get_config(LM_MOE[0][1])
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=SHARD_MOE_CF))


def _shard_moe_inputs(torch, dev, dtype, tokens):
    """The MoE layer's weights and input, drawn on ``dev`` from a seed."""
    from repro_torch.models import moe
    from repro_torch.models.common import materialize

    cfg = _shard_moe_cfg()
    gen = torch.Generator(device=dev).manual_seed(3)
    params = materialize(moe.moe_spec(cfg), gen, device=dev, dtype=dtype)
    x = torch.randn(*tokens, cfg.d_model, generator=gen, device=dev,
                    dtype=dtype)
    return cfg, params, x


def _shard_bands(torch, dev):
    """The band-sharded sweep against the one-band kernel; the launches of
    one banded call a case."""
    from repro_torch.distributed.sharding import band_sharded_jacobi_sweeps
    from repro_torch.kernels import ops
    from repro_torch.launch.kernel_bench import time_ms

    total = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    kw = dict(dtype=torch.float64, device=dev)
    for rows, g in SHARD_BLOCKS:
        blk, bg = (torch.randn(rows, g, generator=gen, **kw)
                   for _ in range(2))
        # the whole grid's halos are its zero Dirichlet rows
        top, bot = ((torch.zeros(g, **kw) for _ in range(2)) if rows == g
                    else (torch.randn(g, generator=gen, **kw)
                          for _ in range(2)))
        want, wnorm = ops.jacobi_halo_sweeps(blk, top, bot, bg, sweeps=10)
        wnorm = float(wnorm)
        one_ms = time_ms(torch, lambda: ops.jacobi_halo_sweeps(
            blk, top, bot, bg, sweeps=10))
        for n in SHARD_BANDS:
            devices = [dev] * n
            ops.reset_launch_counts()
            got, norm = band_sharded_jacobi_sweeps(blk, top, bot, bg,
                                                   sweeps=10, devices=devices)
            counts = ops.launch_counts()
            add_counts(total, counts)
            rel = abs(norm - wnorm) / wnorm
            ms = time_ms(torch, lambda: band_sharded_jacobi_sweeps(
                blk, top, bot, bg, sweeps=10, devices=devices))
            same = torch.equal(got, want)
            print(f"[shard] band jacobi ({rows}, {g}) float64, 10 sweeps, "
                  f"{n} bands on {dev}: bytes equal to the one-band kernel "
                  f"{same}; norm rel diff {rel:.1e} (tol 1e-12); "
                  f"jacobi_halo_sweeps launches {counts['jacobi_halo_sweeps']}"
                  f" (bands x 10); {ms:.4f} ms a call against the one-band "
                  f"call's {one_ms:.4f} ms ({ms / one_ms:.2f}x)")
            check(same, f"shard: {n} bands at ({rows}, {g}) differ from the "
                  f"one-band kernel")
            check(rel <= 1e-12, f"shard: band norm differs by {rel:.1e}")
            check(counts["jacobi_halo_sweeps"] == 10 * n
                  and sum(counts.values()) == 10 * n,
                  f"shard: launches {counts}, expected {10 * n} halo sweeps")
        del blk, bg, want, got
    return total


@contextlib.contextmanager
def _one_rank_group(backend):
    """A one-rank default process group (a file store in a temporary
    directory), destroyed on exit."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed import ranks

    with tempfile.TemporaryDirectory() as tmp:
        ranks.init(0, 1, os.path.join(tmp, "store"), backend)
        try:
            yield
        finally:
            dist.destroy_process_group()


#: the one-rank all-to-all and the dropless layer in bfloat16, each
#: against the layer in float32 on the same bfloat16 inputs,
#: max|delta|/max|ref|: on an H100 the sound runs read 7.67e-3 (a2a) and
#: 7.34e-3 (dropless), the planted faults 2.48e-2 (geglu for swiglu) and
#: 0.81 (an expert's wo zeroed); the limit is their geometric middle,
#: 1.8x from each
SHARD_MOE_TOL = 1.4e-2


def _moe_layer_f32(torch, cfg, params, x):
    """The dropless MoE layer in float32 from bfloat16 ``params`` and ``x``
    (B, S, d): the layer's own routing, each expert through
    ``moe._expert_ffn`` on the tokens that picked it, weighted by their
    probabilities, plus the shared experts' MLP."""
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp

    m = cfg.moe
    xt = x.reshape(-1, cfg.d_model)
    r = moe.route(cfg, params, xt)
    xf = xt.float()
    out = torch.zeros_like(xf)
    for e in range(m.padded_experts):
        t, j = (r.top_e == e).nonzero(as_tuple=True)
        if t.numel():
            one = {k: params[k][e:e + 1].float() for k in ("wi", "wo")}
            y = moe._expert_ffn(cfg.ffn_act, one, xf[t][None])[0]
            out.index_add_(0, t, y * r.top_p[t, j, None])
    if m.n_shared:
        shared = {k: v.float() for k, v in params["shared"].items()}
        out += mlp(shared, xf, cfg.ffn_act, d_ff=m.n_shared * cfg.d_ff)
    return out.reshape(x.shape), r


def _shard_moe(torch, dev):
    """moe_ffn_a2a on a one-rank nccl mesh at Qwen1.5-MoE's widths and
    moe_ffn(dropless=True), each against the layer in float32; then two
    planted faults in the dropless layer against the same limit."""
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.launch.kernel_bench import time_ms
    from repro_torch.models import moe
    from repro_torch.models.moe_shard_map import moe_ffn_a2a

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg, params, x = _shard_moe_inputs(torch, dev, torch.bfloat16,
                                       (LM_BATCH, LM_PROMPT))

    def rel(got):
        return float((got.float() - want).abs().max() / want.abs().max())

    with torch.no_grad():
        want, r = _moe_layer_f32(torch, cfg, params, x)
        out, aux = moe_ffn_a2a(cfg, params, x, mesh)
        drop, _ = moe.moe_ffn(cfg, params, x, dropless=True)
        sound = {"a2a": rel(out), "dropless": rel(drop)}
        del out, drop
        busiest = int(torch.bincount(r.top_e.reshape(-1)).argmax())
        cut = dict(params, wo=params["wo"].clone())
        cut["wo"][busiest] = 0
        swapped = dataclasses.replace(cfg, ffn_act="geglu")
        faults = {f"expert {busiest} zeroed": rel(moe.moe_ffn(
                      cfg, cut, x, dropless=True)[0]),
                  "geglu for swiglu": rel(moe.moe_ffn(
                      swapped, params, x, dropless=True)[0])}
        del cut
        a2a_ms = time_ms(torch, lambda: moe_ffn_a2a(cfg, params, x, mesh),
                         reps=5, warmup=1)
        plain_ms = time_ms(torch, lambda: moe.moe_ffn(cfg, params, x,
                                                      dropless=True),
                           reps=5, warmup=1)
    dropped = int(aux["moe_dropped"])
    m = cfg.moe
    print(f"[shard] moe_ffn_a2a on a one-rank nccl mesh (1, 1): "
          f"{m.n_experts} experts padded to {m.padded_experts}, top-"
          f"{m.top_k}, {m.n_shared} shared, d {cfg.d_model}, "
          f"{LM_BATCH} x {LM_PROMPT} bfloat16 tokens, capacity factor "
          f"{SHARD_MOE_CF:g}: dropped {dropped}; max|delta|/max|ref| against"
          f" the layer in float32: a2a {sound['a2a']:.3e}, dropless "
          f"{sound['dropless']:.3e}; planted faults in the dropless layer: "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {SHARD_MOE_TOL:g}); {a2a_ms:.2f} ms a call against the "
          f"dropless layer's {plain_ms:.2f} ms")
    check(dropped == 0, f"shard: the all-to-all dropped {dropped}")
    for k, v in sound.items():
        check(v <= SHARD_MOE_TOL, f"shard: {k} differs by {v:.3e}")
    for k, v in faults.items():
        check(v > SHARD_MOE_TOL, f"shard: the fault '{k}' reads {v:.3e}")
    del params, x, want
    torch.cuda.empty_cache()


def _shard_step(torch, dev):
    """A (1, 1)-mesh train step against the one-rank step, at
    [train-parity]'s size, from the same weights and batches."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, make_trainable
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, window=128,
                              vocab_size=32768)
    base = init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                       dtype=torch.float32, device=dev)
    models = {"one": base, "mesh": copy.deepcopy(base)}
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    states = {k: adamw_init(make_trainable(v), opt_cfg)
              for k, v in models.items()}
    step_fns = {"one": make_train_step(cfg, opt_cfg, 1),
                "mesh": make_train_step(cfg, opt_cfg, 1, mesh=mesh)}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                  seq=256, seed=11))
    for i in range(2):
        batch = {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                           device=dev)}
        metrics, secs = {}, {}
        for k in ("one", "mesh"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models[k], states[k], metrics[k] = step_fns[k](
                models[k], states[k], batch)
            torch.cuda.synchronize()
            secs[k] = time.perf_counter() - t0
        fo, fm = models["one"].flat, models["mesh"].flat
        loss_rel = (abs(metrics["mesh"]["loss"] - metrics["one"]["loss"])
                    / abs(metrics["one"]["loss"]))
        grad_rel = max(
            float((fm.grad[lf.start:lf.stop] - fo.grad[lf.start:lf.stop])
                  .abs().max() / fo.grad[lf.start:lf.stop].abs().max())
            for lf in fm.leaves)
        lr = metrics["one"]["lr"]
        p_diff = float((fm.theta - fo.theta).abs().max())
        print(f"[shard] (1, 1)-mesh nccl train step {i} ({cfg.name} widths, "
              f"depth 2, vocab 32768, 2 x 256 tokens): loss {metrics['mesh']['loss']:.6f}"
              f" against the one-rank step's {metrics['one']['loss']:.6f} "
              f"(rel {loss_rel:.2e}, tol 1e-4); max gradient leaf rel diff "
              f"{grad_rel:.2e} (tol 1e-4); max |param diff| {p_diff:.2e} "
              f"(lr / 10 = {lr / 10:.2e}); seconds mesh {secs['mesh']:.3f},"
              f" one rank {secs['one']:.3f}")
        check(loss_rel <= 1e-4, f"shard: step loss differs by {loss_rel}")
        check(grad_rel <= 1e-4, f"shard: a gradient differs by {grad_rel}")
        check(p_diff <= lr / 10, f"shard: θ differs by {p_diff:.3e}")
    del models, states, base
    torch.cuda.empty_cache()


def _shard_gloo_step(torch, dev, mesh):
    """[shard]'s ZeRO step on the (world, 1) mesh against the one-rank
    step on the whole batch, in this process: per step the loss's
    relative difference, and after the first the largest |difference| of
    this rank's gradient chunk and of θ."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (Sharding, local_slice,
                                                  local_tree)
    from repro_torch.launch.steps import (make_train_step, opt_shardings,
                                          shard_range)
    from repro_torch.models import init_params, make_trainable
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    cfg = get_config(LM_ARCH).reduced(**SHARD_GLOO_STEP_WIDTHS)
    opt_cfg = AdamWConfig()
    one = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                      dtype=torch.float32, device=dev)
    mine = copy.deepcopy(one)
    fo, fm = make_trainable(one), make_trainable(mine)
    st_one = adamw_init(fo, opt_cfg)
    st_mine = local_tree(adamw_init(fm, opt_cfg), opt_shardings(mesh))
    tokens = torch.randint(0, cfg.vocab_size, SHARD_GLOO_STEP_TOKENS,
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    piece = local_slice(tokens, Sharding(mesh, ("data",)))
    step_one = make_train_step(cfg, opt_cfg, 1)
    step_mine = make_train_step(cfg, opt_cfg, 1, mesh=mesh)
    lo, hi = shard_range(fm.n, mesh.shape["data"], mesh.coord("data"))
    res = {"loss_rel": [], "losses": []}
    for i in range(SHARD_GLOO_STEPS):
        one, st_one, m_one = step_one(one, st_one, {"tokens": tokens})
        mine, st_mine, m_mine = step_mine(mine, st_mine, {"tokens": piece})
        res["losses"].append(m_mine["loss"])
        res["loss_rel"].append(abs(m_mine["loss"] - m_one["loss"])
                               / abs(m_one["loss"]))
        if i == 0:
            res["grad_diff"] = float((fm.grad[lo:hi] - fo.grad[lo:hi])
                                     .abs().max())
            res["theta_diff"] = float((fm.theta - fo.theta).abs().max())
    return res


def _shard_gloo_rank(rank, world, out_dir, device):
    """One of the processes of [shard]'s gloo run on ``device``: the
    (1, world) mesh's all-to-all, its output and router and token
    gradients, and the (world, 1) mesh's ZeRO train step against the
    one-rank step, saved for the parent."""
    import torch
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models.moe_shard_map import moe_ffn_a2a

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh((1, world), ("data", "model"))
    cfg, params, x = _shard_moe_inputs(torch, dev, torch.float32,
                                       SHARD_GLOO_TOKENS)
    params["router"].requires_grad_(True)
    x.requires_grad_(True)
    out, aux = moe_ffn_a2a(cfg, params, x, mesh)
    (out ** 2).sum().backward()
    step = _shard_gloo_step(torch, dev, make_mesh((world, 1),
                                                  ("data", "model")))
    torch.save({"out": out.detach().cpu(), "x": x.grad.cpu(),
                "router": params["router"].grad.cpu(),
                "dropped": int(aux["moe_dropped"]), "step": step},
               os.path.join(out_dir, f"rank{rank}.pt"))


def _shard_gloo(torch, dev):
    """Two processes on the card over gloo run the (1, 2) mesh; their
    output and gradients against the one-rank dropless layer on the CPU
    (the card's takes the expert kernel, which has no backward), on the
    weights and tokens the ranks drew."""
    import tempfile

    from repro_torch.distributed import ranks
    from repro_torch.models import moe

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks.run("chip_smoke:_shard_gloo_rank", 2, args=[tmp, str(dev)],
                  path=[str(ROOT)], timeout=180)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(2)]
    run_s = time.perf_counter() - t0
    cfg, params, x = _shard_moe_inputs(torch, dev, torch.float32,
                                       SHARD_GLOO_TOKENS)
    params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.cpu())
              for k, v in params.items()}
    x = x.cpu()
    params["router"].requires_grad_(True)
    x.requires_grad_(True)
    want, _ = moe.moe_ffn(cfg, params, x, dropless=True)
    (want ** 2).sum().backward()
    rels = {}
    for name, ref in (("out", want), ("x", x.grad),
                      ("router", params["router"].grad)):
        ref = ref.detach().cpu()
        rels[name] = max(float((g[name] - ref).abs().max()
                               / ref.abs().max()) for g in got)
    print(f"[shard] gloo, 2 processes on {dev}, mesh (1, 2): "
          f"moe_ffn_a2a at {cfg.name}'s widths, "
          f"{SHARD_GLOO_TOKENS[0]} x {SHARD_GLOO_TOKENS[1]} float32 tokens: "
          f"dropped {got[0]['dropped']}; max|delta|/max|ref| against the "
          f"one-rank moe_ffn(dropless=True) on the CPU: output "
          f"{rels['out']:.2e}, "
          f"token gradient {rels['x']:.2e}, router gradient "
          f"{rels['router']:.2e} (tol 1e-4), the collectives on CUDA "
          f"tensors; {run_s:.1f} s for the two processes")
    check(all(g["dropped"] == 0 for g in got), "shard: gloo run dropped")
    check(max(rels.values()) <= 1e-4, f"shard: gloo run differs {rels}")
    steps = [g["step"] for g in got]
    loss_rel = max(max(st["loss_rel"]) for st in steps)
    grad_diff = max(st["grad_diff"] for st in steps)
    theta_diff = max(st["theta_diff"] for st in steps)
    losses = steps[0]["losses"]
    print(f"[shard] gloo, 2 processes on {dev}, mesh (2, 1): ZeRO train "
          f"step ({LM_ARCH} reduced to {SHARD_GLOO_STEP_WIDTHS}, "
          f"{SHARD_GLOO_STEP_TOKENS[0]} x {SHARD_GLOO_STEP_TOKENS[1]} "
          f"tokens, float32; reduce-scatter, chunked AdamW, all-gather on "
          f"CUDA tensors) against the one-rank step on the whole batch: "
          f"max loss rel diff over {SHARD_GLOO_STEPS} steps {loss_rel:.2e}, "
          f"first step's max |gradient chunk diff| {grad_diff:.2e} and "
          f"max |θ diff| {theta_diff:.2e} (tol 1e-5 each); losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    check(loss_rel <= 1e-5, f"shard: ZeRO step loss differs by {loss_rel}")
    check(grad_diff <= 1e-5, f"shard: ZeRO gradient differs by {grad_diff}")
    check(theta_diff <= 1e-5, f"shard: ZeRO θ differs by {theta_diff}")
    check(losses[-1] < losses[0], f"shard: ZeRO loss did not fall {losses}")
    del params, x, want
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# [tp]: tensor parallelism along "model"; [dryrun-mesh]
# --------------------------------------------------------------------- #
#: [tp]: the (data, model) mesh of its gloo processes on the one card,
#: the decode steps after the prefill (8 before [ray] was added: the
#: split runs' steps are gloo-bound), the train steps and the run's time
#: limit (s)
TP_MESH, TP_DECODE, TP_TRAIN_STEPS = (1, 2), 4, 5
TP_TIMEOUT = 300
#: [tp]'s serve runs: (label, weights' dtype, depth (None: the config's),
#: limit of the logits' max|delta|/max|ref| against the one-rank run of
#: the same weights).  At depth 2 bfloat16 is held to
#: [lm-bf16-parity]'s 3e-2.  At the full depth no such limit holds
#: between two bfloat16 runs that sum in another order: the one-rank run
#: itself lies 9.2e-2 from the float32 answer there (NVIDIA H100 80GB
#: HBM3, 700 W; the (1, 2) run 4.1e-2 from it), so the (1, 2) run is held
#: to that answer instead (``TP_EXACT_FACTOR``).
TP_SERVE = (("bf16", "bfloat16", None, None),
            ("bf16 depth 2", "bfloat16", 2, 3e-2),
            ("f32 depth 2", "float32", 2, 1e-4))
#: the full-depth bfloat16 run's limit: its max|delta|/max|ref| from the
#: float32 run of the same weights (upcast, one rank) at most this many
#: times the one-rank bfloat16 run's
TP_EXACT_FACTOR = 1.25
#: the train step's limit: loss (relative) and gradient leaves
#: (max|delta|/max|ref| per leaf)
TP_TRAIN_TOL = 1e-4

#: [dryrun-mesh]: (arch, shape, mesh) cells of the multi-rank dry run
DRYRUN_MESH_CELLS = [(arch, shape, mesh) for mesh in ("16x16", "2x16x16")
                     for arch, shape in (("gemma2_2b", "train_4k"),
                                         ("qwen2_moe_a2p7b", "prefill_32k"),
                                         ("gemma3_4b", "long_500k"))] + [
    ("jamba_1p5_large_398b", "decode_32k", "16x16"),
    ("xlstm_125m", "long_500k", "16x16")]


def _tp_logits(torch, cfg, params, tokens, nxt, max_len):
    """One rank's prefill and teacher-forced decode logits (float32)."""
    from repro_torch.models import transformer as tf

    S = tokens.shape[1]
    with torch.no_grad():
        logits, caches = tf.prefill(cfg, params, {"tokens": tokens},
                                    max_len=max_len,
                                    cache_dtype=torch.bfloat16)
        out = [logits.float()]
        for t in range(TP_DECODE):
            logits, caches = tf.decode_step(cfg, params, caches, nxt[t], S + t)
            out.append(logits.float())
    return out


def _tp_serve(torch, dev, mesh, cfg, dtype, exact=False):
    """One rank of [tp]'s serve run: the one-rank prefill and
    teacher-forced decode of the whole weights (drawn on the card), then
    the same through ``build_prefill``/``build_decode`` on this rank's
    slices; the flash launches, their shapes and the collectives of one
    prefill, its seconds and the process's peak memory.  With ``exact``
    "model" rank 0 also runs the weights upcast to float32: how far each
    run lies from the float32 answer."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import BASE_RULES
    from repro_torch.kernels import ops
    from repro_torch.launch import inputs, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh

    B, S = LM_BATCH, LM_PROMPT
    max_len = S + TP_DECODE
    whole = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    nxt = torch.randint(0, cfg.vocab_size, (TP_DECODE, B, 1), generator=gen,
                        device=dev)
    want = _tp_logits(torch, cfg, whole, tokens, nxt, max_len)
    f32_run = None
    if exact and mesh.coord("model") == 0:
        import copy

        upcast = copy.deepcopy(whole).float()
        f32_run = _tp_logits(torch, cfg, upcast, tokens, nxt, max_len)
        del upcast
    params = tf.shard_params(whole, mesh)
    del whole
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shape = inputs.ShapeSpec("tp", max_len, B, "prefill")
    prefill = steps.build_prefill(cfg, shape, mesh, BASE_RULES)[0]
    decode = steps.build_decode(cfg, dataclasses.replace(shape, kind="decode"),
                                mesh, BASE_RULES)[0]
    shapes, real = set(), ops.flash_attention

    def spy(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    # one prefill (the one-rank run warmed the kernels up): its flash
    # shapes, launches, collectives and seconds, both ranks starting
    # together (rank 0 may still be running the float32 answer)
    coll.all_reduce_sum(torch.zeros(1, device=dev), mesh.group("model"))
    ops.flash_attention = spy
    ops.reset_launch_counts()
    try:
        with coll.tally() as moved:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        ops.flash_attention = real
    launches = ops.launch_counts()["flash_attention"]
    with use_mesh(mesh):
        got = [tf.gather_logits(cfg, logits).float()]
        for t in range(TP_DECODE):
            logits, caches = decode(params, caches, nxt[t], S + t)
            got.append(tf.gather_logits(cfg, logits).float())
    if f32_run is not None:  # each run against the float32 answer
        f32_run = (_rel_max(want, f32_run), _rel_max(got, f32_run))
    return dict(rel=_rel_max(got, want),
                exact=f32_run,
                finite=all(bool(torch.isfinite(g).all()) for g in got),
                prefill_s=secs, peak=torch.cuda.max_memory_allocated(),
                launches=launches, shapes=sorted(shapes), moved=moved,
                local_vocab=int(logits.shape[-1]))


def _tp_train(torch, dev, mesh):
    """One rank of [tp]'s train steps: the (1, 2) step
    (``build_train``) on this rank's slices beside the one-rank step on
    the whole weights, [train-parity]'s size; per step the loss's
    relative difference, and after the first each gradient leaf's
    max|delta| over this rank's slice against the whole leaf's max."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (BASE_RULES, local_tree,
                                                  model_slice)
    from repro_torch.launch import inputs, steps
    from repro_torch.models import transformer as tf
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2, window=128,
                              vocab_size=32768)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    one = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                         dtype=torch.float32, device=dev)
    fn, in_sh, _, _, meta = steps.build_train(
        cfg, inputs.ShapeSpec("tp-train", 256, 2, "train"), mesh,
        BASE_RULES, opt_cfg=opt_cfg, accum_override=1)
    mine = tf.shard_params(one, mesh)
    f_one, f_mine = tf.make_trainable(one), tf.make_trainable(mine)
    st_one = adamw_init(f_one, opt_cfg)
    st_mine = local_tree(adamw_init(f_mine, opt_cfg), in_sh[1])
    step_one = steps.make_train_step(cfg, opt_cfg, 1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                  seq=256, seed=11))
    res = {"loss_rel": [], "losses": [], "tp": meta["tp"]}
    for i in range(TP_TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                           device=dev)}
        one, st_one, m_one = step_one(one, st_one, batch)
        mine, st_mine, m_mine = fn(mine, st_mine, local_tree(batch, in_sh[2]))
        res["losses"].append(m_mine["loss"])
        res["loss_rel"].append(abs(m_mine["loss"] - m_one["loss"])
                               / abs(m_one["loss"]))
        if i == 0:
            whole = _leaves(f_one.tree(f_one.grad))
            want = _leaves(model_slice(f_one.tree(f_one.grad), in_sh[0]))
            got = _leaves(f_mine.tree(f_mine.grad))
            res["grad"] = {k: (float((got[k] - want[k]).abs().max()),
                               float(whole[k].abs().max())) for k in want}
    return res


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _tp_rank(rank, world, out_dir, device):
    """One of [tp]'s processes on ``device``: its mesh, the bfloat16
    serve run at full depth, the float32 one at ``TP_F32_LAYERS`` and
    the train steps, saved for the parent."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_mesh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(TP_MESH, ("data", "model"))
    cfg = get_config(LM_ARCH)
    res = {}
    for key, dtype, depth, tol in TP_SERVE:
        res[key] = _tp_serve(
            torch, dev, mesh, dataclasses.replace(
                cfg, n_layers=depth or cfg.n_layers), getattr(torch, dtype),
            exact=tol is None)
        torch.cuda.empty_cache()
    res["train"] = _tp_train(torch, dev, mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_tp(torch, dev):
    """[tp]: two gloo processes on the card run the (1, 2) mesh's
    tensor-parallel serve path (Gemma-2-2B, 26 layers, bfloat16; and at
    depth 2 in float32) and train step, each against the one-rank run of
    the same weights; the collectives' bytes of a prefill against the dry
    run's count for the same cell."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks.run("chip_smoke:_tp_rank", TP_MESH[1], args=[tmp, str(dev)],
                  path=[str(ROOT)], timeout=TP_TIMEOUT)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(TP_MESH[1])]
    run_s = time.perf_counter() - t0
    cfg = get_config(LM_ARCH)
    B, S = LM_BATCH, LM_PROMPT
    gib = 2 ** 30
    for key, dtype, depth, tol in TP_SERVE:
        depth = depth or cfg.n_layers
        runs = [g[key] for g in got]
        rel = max(r["rel"] for r in runs)
        for r, run in enumerate(runs):
            moved = ", ".join(f"{op} x{d['count']}: {d['operand_bytes']:.0f} "
                              f"B" for op, d in sorted(run["moved"].items()))
            print(f"[tp] {key} rank {r} of mesh {TP_MESH} ({cfg.name}, "
                  f"{depth} layers, {B} x {S} tokens, gloo on {dev}; "
                  f"{CARD}): prefill {run['prefill_s']:.3f} s, peak memory "
                  f"{run['peak'] / gib:.2f} GiB, flash launches "
                  f"{run['launches']} at q/k {run['shapes']}, logits' "
                  f"local vocabulary {run['local_vocab']}; the collectives "
                  f"of one prefill: {moved}")
            check(run["finite"], f"tp {key}: non-finite logits")
            check(run["launches"] == depth,
                  f"tp {key}: {run['launches']} flash launches, not {depth}")
        print(f"[tp] {key}: prefill and {TP_DECODE} teacher-forced decode "
              f"steps, logits (gathered over the vocabulary) against the "
              f"one-rank run of the same weights on the card: "
              f"max|delta|/max|ref| {rel:.3e}" + (
                  f" (tol {tol:g})" if tol is not None else ""))
        if tol is not None:
            check(rel <= tol, f"tp {key}: logits differ by {rel:.3e}")
        else:
            one, mine = runs[0]["exact"]
            print(f"[tp] {key}: against the float32 run of the same weights "
                  f"(upcast, one rank): the one-rank {dtype} run "
                  f"{one:.3e}, the {TP_MESH} run {mine:.3e} (limit "
                  f"{TP_EXACT_FACTOR:g} x the one-rank run's)")
            check(mine <= TP_EXACT_FACTOR * one,
                  f"tp {key}: {mine:.3e} from the float32 answer, against "
                  f"the one-rank run's {one:.3e}")
        check(all(r["moved"] == runs[0]["moved"] for r in runs),
              f"tp {key}: the ranks' collectives differ")
        # the dry run's trace of the same cell (its weights' dtype) on
        # rank 0 of the mesh
        st = dryrun.trace_step(
            dataclasses.replace(cfg, n_layers=depth, param_dtype=dtype),
            "prefill", B, S,
            max_len=S + TP_DECODE, mesh=MeshShape(("data", "model"),
                                                  TP_MESH))
        counted = {op: (st.coll_counts[op], st.coll_operand_bytes[op])
                   for op in st.coll_counts}
        seen = {op: (d["count"], d["operand_bytes"])
                for op, d in runs[0]["moved"].items()}
        print(f"[tp] {key}: the dry run's collectives (count, operand "
              f"bytes) for the same cell at {TP_MESH}: {counted}; the gloo "
              f"run's: {seen}")
        check(counted == seen, f"tp {key}: the bytes moved are not the dry "
              f"run's count")
    tr = [g["train"] for g in got]
    loss_rel = max(max(t["loss_rel"]) for t in tr)
    grad_rel = max(max(d / w for d, w in t["grad"].values()) for t in tr)
    losses = tr[0]["losses"]
    print(f"[tp] train step on mesh {TP_MESH} ({cfg.name} widths, depth 2, "
          f"vocab 32768, 2 x 256 tokens, float32; {CARD}) against the "
          f"one-rank step: max loss rel diff over {TP_TRAIN_STEPS} steps "
          f"{loss_rel:.2e} (tol {TP_TRAIN_TOL:g}), first step's gradient "
          f"leaves, put together from the {TP_MESH[1]} slices, max "
          f"|delta|/max|ref| {grad_rel:.2e} (tol {TP_TRAIN_TOL:g}); losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; {run_s:.1f} s for the "
          f"{TP_MESH[1]} processes")
    check(all(t["tp"] == TP_MESH[1] for t in tr), "tp: the step is not "
          "tensor-parallel")
    check(loss_rel <= TP_TRAIN_TOL, f"tp: step loss differs by {loss_rel}")
    check(grad_rel <= TP_TRAIN_TOL, f"tp: a gradient differs by {grad_rel}")
    check(losses[-1] < losses[0], f"tp: the loss did not fall {losses}")


# --------------------------------------------------------------------- #
# [tp-inner]: the "inner" split of Mamba and xLSTM, sequence-split caches
# --------------------------------------------------------------------- #
#: [tp-inner]: its mesh, decode steps (8 before [ray] was added: gloo-
#: bound), time limit (s), Jamba's depth
TPI_MESH, TPI_DECODE, TPI_TIMEOUT, TPI_JAMBA_DEPTH = (1, 2), 4, 420, 5
#: the parity runs: Jamba's widths at depth 2 with every sublayer kind
#: (one (mamba, moe) and one (attn, mlp) layer), 4 experts (16 at depth
#: 2 hold 39 GB in float32 alone), 2 x 2048 tokens; float32 within
#: ``TPI_F32_TOL`` of one rank's run
TPI_PARITY_LAYERS = (("mamba", "moe"), ("attn", "mlp"))
TPI_PARITY_EXPERTS, TPI_PARITY_PROMPT, TPI_F32_TOL = 4, 2048, 1e-4
#: the parity run in bfloat16: its distance from the float32 answer (the
#: same weights upcast, one rank) at most this many times one rank's.
#: Each partial sum a rank all-reduces (``x_proj``'s, ``out_proj``'s,
#: the FFN's, ``wo``'s) is rounded to bfloat16 once before the sum, one
#: rounding more than one rank's product takes; ``x_proj``'s feeds dt's
#: exponentials.  Measured (NVIDIA H100 80GB HBM3, 700.00 W): 1.32x
#: (1.514e-2 against 1.145e-2), where [tp]'s Gemma-2 gives 1.00-1.10x
TPI_BF16_FACTOR = 2.0
#: xLSTM-125M (float32, 2 x 1024): the (1, 2) run's distance from the
#: float64 run of the same weights at most this many times the one-rank
#: float32 run's (the model amplifies float32 rounding: [lm-xlstm-parity])
TPI_XLSTM_PROMPT, TPI_XLSTM_FACTOR = 1024, 2.0
#: batch-1 long decode: Gemma-3-4B against caches of this many positions
#: filled from a seed, this many steps (4 before [ray] was added; each
#: split step takes ~0.48 s of gloo collectives)
TPI_LONG_ARCH, TPI_LONG_LEN, TPI_LONG_STEPS = "gemma3_4b", 524288, 2


def _barrier(torch, mesh, dev):
    from repro_torch.distributed import collectives as coll

    coll.all_reduce_sum(torch.zeros(1, device=dev), mesh.group("model"))


def _tpi_run(torch, cfg, params, tokens, nxt, mesh=None, rules=None):
    """Prefill and teacher-forced decode logits (float32, gathered over the
    vocabulary), one rank's or under ``mesh``."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh

    B, S = tokens.shape
    with use_mesh(mesh, rules, B), torch.no_grad():
        logits, caches = tf.prefill(cfg, params, {"tokens": tokens},
                                    max_len=S + nxt.shape[0])
        out = [tf.gather_logits(cfg, logits).float()]
        for t in range(nxt.shape[0]):
            logits, caches = tf.decode_step(cfg, params, caches, nxt[t],
                                            S + t)
            out.append(tf.gather_logits(cfg, logits).float())
    return out


def _tpi_tokens(torch, dev, cfg, B, S, steps):
    gen = torch.Generator(device=dev).manual_seed(1)
    return (torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                          device=dev),
            torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen,
                          device=dev))


def _tpi_parity(torch, dev, mesh):
    """Jamba's widths at depth 2 (``TPI_PARITY_LAYERS``), bfloat16 weights:
    model rank 0 runs the whole model, and its float32 answer (the same
    weights upcast), then both ranks their slices of the same draws, in
    bfloat16 and upcast; rank 0 returns each run's distances."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    base = get_config(LM_JAMBA)
    cfg = dataclasses.replace(
        base, n_layers=len(TPI_PARITY_LAYERS), period=TPI_PARITY_LAYERS,
        moe=dataclasses.replace(base.moe, n_experts=TPI_PARITY_EXPERTS,
                                pad_to=TPI_PARITY_EXPERTS))
    tokens, nxt = _tpi_tokens(torch, dev, cfg, LM_BATCH, TPI_PARITY_PROMPT,
                              TPI_DECODE)
    one = mesh.coord("model") == 0
    want, got = {}, {}
    if one:
        whole = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
        want[torch.bfloat16] = _tpi_run(torch, cfg, whole, tokens, nxt)
        want[torch.float32] = _tpi_run(torch, cfg, whole.float(), tokens,
                                       nxt)
        del whole
        torch.cuda.empty_cache()
    _barrier(torch, mesh, dev)
    mine = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.bfloat16, device=dev, mesh=mesh)
    got[torch.bfloat16] = _tpi_run(torch, cfg, mine, tokens, nxt, mesh)
    got[torch.float32] = _tpi_run(torch, cfg, mine.float(), tokens, nxt, mesh)
    del mine
    torch.cuda.empty_cache()
    out = dict(logits=[g.cpu() for g in got[torch.bfloat16]])
    if one:
        f32 = want[torch.float32]
        out.update(f32=_rel_max(got[torch.float32], f32),
                   one_bf16=_rel_max(want[torch.bfloat16], f32),
                   mine_bf16=_rel_max(got[torch.bfloat16], f32))
    return out


def _tpi_jamba(torch, dev, mesh):
    """Jamba at its published widths, depth ``TPI_JAMBA_DEPTH``, bfloat16,
    the rank's slices drawn leaf by leaf: one timed prefill (launches and
    their shapes, collectives, seconds) and ``TPI_DECODE`` timed decode
    steps; the process's peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import BASE_RULES
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh

    cfg = dataclasses.replace(get_config(LM_JAMBA), n_layers=TPI_JAMBA_DEPTH)
    B, S = LM_BATCH, LM_PROMPT
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mesh=mesh)
    tokens, nxt = _tpi_tokens(torch, dev, cfg, B, S, TPI_DECODE)
    shapes = {"selective_scan": set(), "flash_attention": set()}
    real = {k: getattr(ops, k) for k in shapes}

    def spy(name):
        def fn(*a, **kw):
            shapes[name].add(tuple(a[0].shape) if name == "selective_scan"
                             else (tuple(a[0].shape), tuple(a[1].shape)))
            return real[name](*a, **kw)
        return fn

    for k in shapes:
        setattr(ops, k, spy(k))
    try:
        with use_mesh(mesh, BASE_RULES, B), torch.no_grad():
            # a short warm-up (kernels loaded, the collectives' first
            # use), then the timed prefill
            tf.prefill(cfg, params, {"tokens": tokens[:, :256]},
                       max_len=256 + TPI_DECODE)
            _barrier(torch, mesh, dev)
            for v in shapes.values():
                v.clear()
            ops.reset_launch_counts()
            with coll.tally() as moved:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = tf.prefill(cfg, params, {"tokens": tokens},
                                            max_len=S + TPI_DECODE)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            launches = {k: v for k, v in ops.launch_counts().items()
                        if k in shapes}
            out = [tf.gather_logits(cfg, logits).float()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(TPI_DECODE):
                logits, caches = tf.decode_step(cfg, params, caches, nxt[t],
                                                S + t)
                out.append(tf.gather_logits(cfg, logits).float())
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / TPI_DECODE
    finally:
        for k, fn in real.items():
            setattr(ops, k, fn)
    return dict(prefill_s=secs, decode_ms=step_ms,
                peak=torch.cuda.max_memory_allocated(), launches=launches,
                shapes={k: sorted(v) for k, v in shapes.items()},
                moved=moved, finite=all(bool(torch.isfinite(o).all())
                                        for o in out),
                n_params=sum(p.numel() for p in params.parameters()),
                logits=[o.cpu() for o in out])


@contextlib.contextmanager
def _float64_points(torch):
    """The layers' float32 points in float64 (``xlstm.f32`` as
    [lm-xlstm-parity] sets it, and its neighbours'), so that a float64
    model computes in float64 throughout."""
    from repro_torch.models import attention, layers, mamba, moe, xlstm
    from repro_torch.models import transformer as tf

    mods = (layers, attention, mamba, xlstm, moe)
    tf.clear_host_tables()
    for m in mods:
        m.f32 = torch.float64
    try:
        yield
    finally:
        for m in mods:
            m.f32 = torch.float32
        tf.clear_host_tables()


def _tpi_xlstm(torch, dev, mesh):
    """xLSTM-125M whole in float32: model rank 0 runs the whole model and
    its float64 answer, then both ranks their slices (heads split)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config(LM_XLSTM)
    tokens, nxt = _tpi_tokens(torch, dev, cfg, LM_BATCH, TPI_XLSTM_PROMPT,
                              TPI_DECODE)
    one = mesh.coord("model") == 0
    out = {}
    if one:
        whole = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
        want = _tpi_run(torch, cfg, whole, tokens, nxt)
        with _float64_points(torch):
            want64 = _tpi_run(torch, cfg, whole.double(), tokens, nxt)
        del whole
        torch.cuda.empty_cache()
    _barrier(torch, mesh, dev)
    mine = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          dtype=torch.float32, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _tpi_run(torch, cfg, mine, tokens, nxt, mesh)
    torch.cuda.synchronize()
    out.update(secs=time.perf_counter() - t0, logits=[g.cpu() for g in got],
               finite=all(bool(torch.isfinite(g).all()) for g in got))
    if one:
        out.update(one=_rel_max(want, want64), mine=_rel_max(got, want64),
                   vs_one=_rel_max(got, want))
    return out


def _tpi_caches(torch, dev, cfg, gen, dtype):
    """Gemma-3's whole decode caches at ``TPI_LONG_LEN`` positions, filled
    layer by layer from ``gen`` (standard normal, K and V)."""
    from repro_torch.models import transformer as tf

    caches = tf.init_caches(cfg, 1, TPI_LONG_LEN, dtype, device=dev)
    for c in caches:
        for t in c:
            t.normal_(generator=gen)
    return caches


def _tpi_long(torch, dev, mesh):
    """Batch-1 decode against 524,288-position caches under
    ``long_decode_rules``: model rank 0 runs one rank's decode in
    bfloat16 and with the same weights upcast to float32 on the same
    caches, then both ranks their halves in bfloat16."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import long_decode_rules
    from repro_torch.launch import inputs, steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import use_mesh

    cfg = get_config(TPI_LONG_ARCH)
    rules = long_decode_rules()
    L, n = TPI_LONG_LEN, TPI_LONG_STEPS
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (n, 1, 1), generator=gen,
                         device=dev)
    one = mesh.coord("model") == 0
    out = {}

    def fresh():  # every run starts from the same seeded caches (a ring
        # slot a run writes would look valid to the next one)
        return _tpi_caches(torch, dev, cfg,
                           torch.Generator(device=dev).manual_seed(5),
                           torch.bfloat16)

    if one:
        runs = {}
        params = tf.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            params, cs, logits = params.to(dtype), fresh(), []
            with torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(n):
                    lg, cs = tf.decode_step(cfg, params, cs, toks[t],
                                            L - n + t)
                    logits.append(lg.float())
                torch.cuda.synchronize()
            runs[dtype] = (logits, (time.perf_counter() - t0) * 1e3 / n)
            del cs
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    mine = tf.shard_caches(cfg, fresh(), mesh, rules, batch=1)
    torch.cuda.empty_cache()
    _barrier(torch, mesh, dev)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, mesh=mesh)
    decode = steps.build_decode(cfg, inputs.ShapeSpec("long", L, 1, "decode"),
                                mesh, rules)[0]
    got = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = mine
    for t in range(n):
        lg, cs = decode(params, cs, toks[t], L - n + t)
        with use_mesh(mesh):
            got.append(tf.gather_logits(cfg, lg).float())
    torch.cuda.synchronize()
    out.update(step_ms=(time.perf_counter() - t0) * 1e3 / n,
               cache_bytes=sum(t.numel() * t.element_size()
                               for c in mine for t in c),
               split=[type(c).__name__ for c in mine],
               logits=[g.cpu() for g in got])
    if one:
        f32, ms32 = runs[torch.float32]
        bf16, ms16 = runs[torch.bfloat16]
        out.update(one=_rel_max(bf16, f32), mine=_rel_max(got, f32),
                   vs_one=_rel_max(got, bf16), one_ms=ms16, f32_ms=ms32)
    return out


def _tpi_rank(rank, world, out_dir, device):
    """One of [tp-inner]'s processes on ``device``."""
    import torch
    from repro_torch.distributed.sharding import make_mesh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(TPI_MESH, ("data", "model"))
    res = {}
    for key, fn in (("parity", _tpi_parity), ("jamba", _tpi_jamba),
                    ("xlstm", _tpi_xlstm), ("long", _tpi_long)):
        t0 = time.perf_counter()
        res[key] = fn(torch, dev, mesh)
        res[key]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def phase_tp_inner(torch, dev):
    """[tp-inner]: two gloo processes on the card run the (1, 2) mesh's
    split Mamba, MoE router, xLSTM and sequence-split caches (see the
    module docstring); returns the Jamba prefill's kernel launches (both
    ranks')."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.distributed import ranks
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks.run("chip_smoke:_tpi_rank", TPI_MESH[1], args=[tmp, str(dev)],
                  path=[str(ROOT)], timeout=TPI_TIMEOUT)
        got = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(TPI_MESH[1])]
    run_s = time.perf_counter() - t0
    gib = 2 ** 30
    walls = ", ".join(f"{k} {got[0][k]['wall_s']:.1f} s" for k in got[0])
    print(f"[tp-inner] {TPI_MESH[1]} gloo processes on {dev} ({CARD}): "
          f"{run_s:.1f} s ({walls} on rank 0)")

    def same(key):  # the gathered logits are the same on every rank
        return all(all(torch.equal(a, b) for a, b in zip(
            g[key]["logits"], got[0][key]["logits"])) for g in got[1:])

    # Jamba at depth 5
    cfg = dataclasses.replace(get_config(LM_JAMBA), n_layers=TPI_JAMBA_DEPTH)
    B, S = LM_BATCH, LM_PROMPT
    n_mamba = sum(m == "mamba" for m, _ in cfg.period[:TPI_JAMBA_DEPTH])
    n_attn = TPI_JAMBA_DEPTH - n_mamba
    di = cfg.mamba.expand * cfg.d_model // TPI_MESH[1]
    for r, g in enumerate(got):
        j = g["jamba"]
        moved = ", ".join(f"{op} x{d['count']}: {d['operand_bytes']:.0f} B"
                          for op, d in sorted(j["moved"].items()))
        print(f"[tp-inner] jamba rank {r} of mesh {TPI_MESH} ({cfg.name}, "
              f"{TPI_JAMBA_DEPTH} layers, bfloat16, {j['n_params']:,} "
              f"parameters a rank, {B} x {S} tokens; {CARD}): prefill "
              f"{j['prefill_s']:.3f} s, decode {j['decode_ms']:.2f} ms a "
              f"step, peak memory {j['peak'] / gib:.2f} GiB; launches "
              f"{j['launches']} at {j['shapes']}; the collectives of one "
              f"prefill: {moved}")
        check(j["finite"], "tp-inner jamba: non-finite logits")
        check(j["launches"].get("selective_scan") == n_mamba
              and j["launches"].get("flash_attention") == n_attn,
              f"tp-inner jamba: launches {j['launches']}, not {n_mamba} "
              f"scans and {n_attn} flash")
        check(j["shapes"]["selective_scan"] == [(B, S, di)]
              and j["shapes"]["flash_attention"] == [(
                  (B, S, cfg.n_heads // TPI_MESH[1], cfg.hd),
                  (B, S, cfg.n_kv_heads // TPI_MESH[1], cfg.hd))],
              f"tp-inner jamba: shapes {j['shapes']}")
    check(same("jamba"), "tp-inner jamba: the ranks' logits differ")
    check(all(g["jamba"]["moved"] == got[0]["jamba"]["moved"] for g in got),
          "tp-inner jamba: the ranks' collectives differ")
    st = dryrun.trace_step(cfg, "prefill", B, S, max_len=S + TPI_DECODE,
                           mesh=MeshShape(("data", "model"), TPI_MESH))
    counted = {op: (st.coll_counts[op], st.coll_operand_bytes[op])
               for op in st.coll_counts}
    seen = {op: (d["count"], d["operand_bytes"])
            for op, d in got[0]["jamba"]["moved"].items()}
    print(f"[tp-inner] jamba: the dry run's collectives (count, operand "
          f"bytes) for the same cell at {TPI_MESH}: {counted}; the gloo "
          f"run's: {seen}")
    check(counted == seen, "tp-inner jamba: the bytes moved are not the dry "
          "run's count")
    # parity at depth 2
    p = got[0]["parity"]
    print(f"[tp-inner] parity ({cfg.name} widths, layers "
          f"{list(TPI_PARITY_LAYERS)}, {TPI_PARITY_EXPERTS} experts, "
          f"{LM_BATCH} x {TPI_PARITY_PROMPT} tokens + {TPI_DECODE} decode "
          f"steps; {CARD}): float32 (1, 2) against one rank "
          f"{p['f32']:.3e} (tol {TPI_F32_TOL:g}); against the float32 "
          f"answer: one-rank bfloat16 {p['one_bf16']:.3e}, the {TPI_MESH} "
          f"bfloat16 run {p['mine_bf16']:.3e} (limit {TPI_BF16_FACTOR:g} x "
          f"the one-rank run's)")
    check(same("parity"), "tp-inner parity: the ranks' logits differ")
    check(p["f32"] <= TPI_F32_TOL, f"tp-inner parity: float32 {p['f32']}")
    check(p["mine_bf16"] <= TPI_BF16_FACTOR * p["one_bf16"],
          f"tp-inner parity: bfloat16 {p['mine_bf16']:.3e} from the answer")
    # xLSTM
    x = got[0]["xlstm"]
    print(f"[tp-inner] xlstm ({LM_XLSTM}, whole, float32, {LM_BATCH} x "
          f"{TPI_XLSTM_PROMPT} tokens + {TPI_DECODE} decode steps; {CARD}): "
          f"prefill and decode {x['secs']:.2f} s on the mesh; against the "
          f"float64 run of the same weights: one rank {x['one']:.3e}, the "
          f"{TPI_MESH} run {x['mine']:.3e} (limit {TPI_XLSTM_FACTOR:g} x "
          f"one rank's); the {TPI_MESH} run against one rank "
          f"{x['vs_one']:.3e}")
    check(x["finite"] and same("xlstm"), "tp-inner xlstm: logits")
    check(x["mine"] <= TPI_XLSTM_FACTOR * x["one"],
          f"tp-inner xlstm: {x['mine']:.3e} from the float64 answer")
    # batch-1 long decode
    lg = got[0]["long"]
    print(f"[tp-inner] long decode ({TPI_LONG_ARCH}, batch 1, "
          f"{TPI_LONG_LEN} positions, long_decode_rules, {TPI_LONG_STEPS} "
          f"steps, bfloat16; {CARD}): caches a rank "
          f"{lg['cache_bytes'] / gib:.2f} GiB "
          f"({sum(k == 'SeqKVCache' for k in lg['split'])} of "
          f"{len(lg['split'])} split along the sequence), "
          f"{lg['step_ms']:.2f} ms a step on the mesh, one rank "
          f"{lg['one_ms']:.2f} ms (float32 {lg['f32_ms']:.2f}); against the "
          f"float32 run: one rank {lg['one']:.3e}, the {TPI_MESH} run "
          f"{lg['mine']:.3e} (limit {TP_EXACT_FACTOR:g} x); against one "
          f"rank {lg['vs_one']:.3e}")
    check(same("long"), "tp-inner long: the ranks' logits differ")
    check(all(k == "SeqKVCache" for k in lg["split"]),
          "tp-inner long: a cache is not split along the sequence")
    check(lg["mine"] <= TP_EXACT_FACTOR * lg["one"],
          f"tp-inner long: {lg['mine']:.3e} from the float32 answer")
    launches = {}
    for g in got:
        for k, v in g["jamba"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


@contextlib.contextmanager
def dryrun_mesh():
    """[dryrun-mesh]'s cells traced in one background process that sees
    no card (the meta device), while [tp] runs."""
    code = ("import sys\nfrom repro_torch.launch import dryrun\nrc = 0\n"
            + "".join(f"rc |= dryrun.main(['--arch', {a!r}, '--shape', "
                      f"{s!r}, '--mesh', {m!r}])\n"
                      for a, s, m in DRYRUN_MESH_CELLS)
            + "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    proc.started = time.perf_counter()
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def phase_dryrun_mesh(proc):
    """[dryrun-mesh]: the multi-rank dry run's lines (both byte counts,
    the collectives and the three terms)."""
    stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith("[") and not ln.startswith("[dryrun]")]
    for ln in lines:
        print(f"[dryrun-mesh] {ln}")
    print(f"[dryrun-mesh] {len(lines)} cells, read "
          f"{time.perf_counter() - proc.started:.1f} s after their start")
    check(proc.returncode == 0 and len(lines) == len(DRYRUN_MESH_CELLS),
          f"dryrun-mesh exited {proc.returncode}: {stderr[-2000:]}")
    check(all(" OK " in ln and "collectives=(none)" not in ln
              for ln in lines), "dryrun-mesh: a cell without collectives")


def phase_shard(torch, dev):
    """[shard]: band-sharded Jacobi, the expert-parallel all-to-all and a
    sharded train step on one card; returns the band path's launches."""
    counts = _shard_bands(torch, dev)
    with _one_rank_group("nccl"):
        _shard_moe(torch, dev)
        _shard_step(torch, dev)
    _shard_gloo(torch, dev)
    return counts


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

    def run(label, fn):
        """``fn()``, its main-path launches (where it returns counts) added
        in, and its seconds printed beside the total so far."""
        t0 = time.perf_counter()
        for k, c in (fn() or {}).items():
            launches[k] += c
        now = time.perf_counter()
        print(f"[time] {label} {now - t0:.1f} s (total {now - t_start:.1f} "
              f"s)")

    print(f"[time] device, build and kernels "
          f"{time.perf_counter() - t_start:.1f} s")
    for label, fn in (
            ("jacobi", lambda: phase_jacobi(dev)),
            ("vi", lambda: phase_vi(dev)),
            ("scf", lambda: phase_scf(torch, dev)),
            ("lm", lambda: phase_lm(torch, dev)),
            ("lm-bf16", lambda: phase_lm_bf16(torch, dev)),
            ("chaos", lambda: phase_chaos(dev)),
            ("recover thread", lambda: phase_recover(dev, "thread")),
            ("small-parity", lambda: phase_small_parity(dev)),
            ("scf-parity", lambda: phase_scf_parity(dev)),
            ("recover-parity", lambda: phase_recover_parity(dev)),
            ("lm-parity", lambda: phase_lm_parity(torch, dev)),
            ("lm-bf16-parity", lambda: phase_lm_bf16_parity(torch, dev)),
            *((moe, lambda arch=arch, moe=moe: phase_lm_moe(
                torch, dev, moe, arch)) for moe, arch in LM_MOE),
            ("lm-xlstm", lambda: phase_lm_xlstm(torch, dev)),
            ("lm-whisper", lambda: phase_lm_whisper(torch, dev)),
            ("lm-vl", lambda: phase_lm_vl(torch, dev)),
            ("lm-jamba", lambda: phase_lm_jamba(torch, dev)),
            ("lm-moe-parity", lambda: phase_lm_moe_parity(torch, dev)),
            ("lm-xlstm-parity", lambda: phase_lm_xlstm_parity(torch, dev)),
            ("lm-whisper-parity",
             lambda: phase_lm_whisper_parity(torch, dev)),
            ("lm-vl-parity", lambda: phase_lm_vl_parity(torch, dev)),
            ("lm-jamba-parity", lambda: phase_lm_jamba_parity(torch, dev)),
            ("train", lambda: phase_train(torch, dev, name)),
            ("train-parity", lambda: phase_train_parity(torch, dev)),
            ("async-dp", lambda: phase_async_dp(torch, dev)),
            ("diloco", lambda: phase_diloco(torch, dev))):
        run(label, fn)
    run("train-chunk", lambda: phase_train_chunk(torch, dev))
    run("dryrun", lambda: phase_dryrun(torch))
    run("examples", lambda: phase_examples(torch, dev))
    run("shard", lambda: phase_shard(torch, dev))
    with dryrun_mesh() as mesh_proc:
        run("tp", lambda: phase_tp(torch, dev))
        run("tp-inner", lambda: phase_tp_inner(torch, dev))
        run("dryrun-mesh", lambda: phase_dryrun_mesh(mesh_proc))
    from repro_torch.core import pool_stats, shutdown_pools

    try:
        with dryrun_all() as all_proc, ray_child_proc() as ray_proc:
            run("process", lambda: phase_process(dev))
            run("ray", lambda: phase_ray(ray_proc))
            run("recover process", lambda: phase_recover(dev, "process"))
            jac, vi = jacobi_problem(dev), vi_problem(dev)
            run("telemetry", lambda: phase_telemetry(dev, jac, vi))
            run("autoscale", lambda: phase_autoscale(dev, vi))
            run("serve", lambda: phase_serve(dev, jac, vi))
            run("dryrun --all", lambda: phase_dryrun_all(name, all_proc))
    finally:
        shutdown_pools()
    check(pool_stats() == {}, "process: pools left after shutdown_pools()")
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
