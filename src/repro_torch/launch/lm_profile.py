"""Where the LM serving path's time goes on the card.

Warms up, runs :func:`repro_torch.launch.lm_serve.serve` once untraced
(its prefill seconds and decode ms/step), then once more under
``torch.profiler``, and splits that trace at the serve's own phase
ranges (``lm_serve.PREFILL``, ``lm_serve.DECODE``):

  PYTHONPATH=src python -m repro_torch.launch.lm_profile --arch gemma2_2b \\
      [--batch 2] [--prompt-len 8192] [--gen 9] [--dtype bfloat16]

``--arch`` takes any config the port carries (``configs.PORTED``), the
MoE (``qwen2_moe_a2p7b``, ``olmoe_1b_7b``), xLSTM (``xlstm_125m``),
encoder-decoder, vision-language and Mamba-hybrid (Jamba) ones too:

  PYTHONPATH=src python -m repro_torch.launch.lm_profile \
      --arch whisper_large_v3 --dtype bfloat16   # 8 x 1500 frames, 224 tokens
  PYTHONPATH=src python -m repro_torch.launch.lm_profile \
      --arch qwen2_vl_72b --layers 8 --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.lm_profile \
      --arch jamba_1p5_large_398b --layers 5 --dtype bfloat16

Whisper gets seeded frame embeddings of a padded 30-s clip
(``inputs.WHISPER_FRAMES``) and, by default, batch 8 and a 224-token
prompt (half its 448-token text context); Qwen2-VL a seeded vision block
of the prompt's first quarter with its M-RoPE ids
(``lm_serve.vision_inputs``).  ``--layers`` cuts the depth (Qwen2-VL-72B's
80 layers and Jamba-1.5-Large's 72 do not fit one card; Jamba's first 5
hold every sublayer kind of its period).  The warm-up serves the same
inputs with one decode step, so the timed run is not the first at its
shapes.
Before the traced run one prefill counts the flash launches by role
(encoder, self, cross) and their host time (:func:`flash_roles`).

For each phase it prints the host wall time, the device time summed over
the kernels and copies the profiler recorded (one stream, so they do not
overlap; the serve synchronises between the phases, so a kernel belongs
to the phase it starts in), the device's busy share (that sum over the
traced wall time; tracing slows the host, so for a host-bound phase the
share is a lower bound), and the device time by group (the
flash-attention kernel, cuBLAS products, MoE routing and dispatch,
copies, Mamba's ``selective_scan`` kernel, other PyTorch kernels) and by
kernel, largest first.  The ``moe_dispatch`` group is every top-k, sort,
``searchsorted``, gather, scatter, index and histogram kernel: an MoE
layer's routing and token movement (in the other configs only the
embedding lookup and the ring caches' writes land there).  ``--dtype``
picks the parameters' type: float32 (the default, ``lm_serve``'s) or
bfloat16 (the config's own ``param_dtype``, as the JAX package's
launchers serve it; the caches follow).  The parameters come from
``models.init_params`` and a seeded generator, so the script also runs
unchanged against an earlier tree's package.  ``--reduced --device cpu``
runs it without device times, for tests.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .._device import resolve_device
from ..kernels import ops
from ..models import init_params
from ..telemetry.serving import SERVE_SPANS
from . import lm_serve
from .inputs import WHISPER_DEC_LEN, WHISPER_FRAMES

__all__ = ["kernel_group", "breakdown", "FlashCall", "flash_role",
           "flash_roles", "role_summary", "main"]

#: (group, substrings of a kernel's name in lower case), first match wins
_GROUPS = (("flash_attention", ("flash_fwd_kernel", "flash_bf16_kernel")),
           ("selective_scan", ("selective_scan_kernel",)),
           ("matmul", ("gemm", "gemv", "sm90_", "cutlass", "xmma", "nvjet")),
           ("copies", ("memcpy", "memset")),
           ("moe_dispatch", ("topk", "sort", "index", "scatter", "gather",
                             "histogram")))
#: kernels listed per phase
_TOP = 12


def kernel_group(name: str) -> str:
    name = name.lower()
    for group, keys in _GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def breakdown(label: str, wall_ms: float, device_events) -> Dict:
    """Print and return one phase's device time by group and by kernel."""
    by_kernel: Dict[str, float] = collections.Counter()
    counts: Dict[str, int] = collections.Counter()
    for e in device_events:
        by_kernel[e.name] += e.time_range.elapsed_us() / 1e3
        counts[e.name] += 1
    groups: Dict[str, float] = collections.Counter()
    for name, ms in by_kernel.items():
        groups[kernel_group(name)] += ms
    device_ms = sum(by_kernel.values())
    busy = device_ms / wall_ms if by_kernel else None
    print(f"[{label}] traced wall {wall_ms:.3f} ms, device {device_ms:.3f} ms"
          f" in {sum(counts.values())} kernels/copies, busy share "
          + (f"{busy:.3f}" if busy is not None else "not measured"))
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {g:16s} {ms:10.3f} ms ({ms / device_ms:.3f})")
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:_TOP]
    for name, ms in kernels:
        print(f"[{label}]     {ms:10.3f} ms x{counts[name]:5d}  {name[:100]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=busy,
                groups=dict(groups),
                kernels=[dict(name=n, ms=ms, calls=counts[n])
                         for n, ms in kernels])


class FlashCall(NamedTuple):
    role: str  # "encoder", "self" or "cross"
    dtype: torch.dtype  # q's (k and v are checked to match by the wrapper)
    host_s: float  # the wrapper's host seconds, launch included


def flash_role(q, k, causal: bool) -> str:
    """A prefill attention's role from the kernel's own arguments:
    ``self`` if causal; else ``encoder`` where the queries are the keys'
    positions (an encoder's self-attention), ``cross`` where they are not
    (a decoder's queries against the encoder's frames; a Whisper prompt,
    at most ``WHISPER_DEC_LEN`` tokens, is never as long as its
    ``WHISPER_FRAMES`` frames)."""
    if causal:
        return "self"
    return "encoder" if q.shape[1] == k.shape[1] else "cross"


@contextlib.contextmanager
def flash_roles():
    """Record every ``ops.flash_attention`` call made inside: its
    :func:`flash_role`, q's dtype and the call's host seconds (no
    synchronise: the time to build the launch and enqueue it).  Yields
    the list the calls are appended to."""
    calls: List[FlashCall] = []
    real = ops.flash_attention

    def flash(q, k, v, **kw):
        t0 = time.perf_counter()
        out = real(q, k, v, **kw)
        calls.append(FlashCall(flash_role(q, k, kw.get("causal", True)),
                               q.dtype, time.perf_counter() - t0))
        return out

    ops.flash_attention = flash
    try:
        yield calls
    finally:
        ops.flash_attention = real


def role_summary(calls: List[FlashCall]) -> Dict[str, Dict]:
    """Launches, dtypes and mean host microseconds by role."""
    out: Dict[str, Dict] = {}
    for c in calls:
        r = out.setdefault(c.role, dict(launches=0, dtypes=set(),
                                        host_us=0.0))
        r["launches"] += 1
        r["dtypes"].add(str(c.dtype).replace("torch.", ""))
        r["host_us"] += c.host_s * 1e6
    for r in out.values():
        r["host_us"] /= r["launches"]
        r["dtypes"] = sorted(r["dtypes"])
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 2 (8 for an encoder-decoder)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help=f"default 8192 ({WHISPER_DEC_LEN // 2} for an "
                         f"encoder-decoder)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--gen", type=int, default=9,
                    help="tokens generated: the prefill's and gen - 1 "
                         "decode steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (no device times; tests)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the parameters' type")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = lm_serve.make_config(args.arch, args.reduced)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    encdec = cfg.kind == "encdec"
    if args.batch is None:
        args.batch = 8 if encdec else 2
    if args.prompt_len is None:
        args.prompt_len = WHISPER_DEC_LEN // 2 if encdec else 8192
    dtype = getattr(torch, args.dtype)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         dtype=dtype, device=device)
    prompt = lm_serve.make_prompt(cfg, args.batch, args.prompt_len, device)
    inputs, dec_pos = None, None
    if encdec:
        inputs = lm_serve.audio_inputs(cfg, args.batch, WHISPER_FRAMES,
                                       device, dtype)
    elif cfg.vision_stub:
        inputs, dec_pos = lm_serve.vision_inputs(
            cfg, args.batch, args.prompt_len, args.gen, device, dtype)
    kw = dict(inputs=inputs, decode_positions=dec_pos)
    # warm-up at the same shapes: the kernel build on first use, cuBLAS
    # handles and plans, the allocator's blocks
    lm_serve.serve(cfg, params, prompt, 2, **kw)
    res = lm_serve.serve(cfg, params, prompt, args.gen, **kw)
    print(f"[serve] {cfg.name} {args.dtype} {cfg.n_layers} layers, batch "
          f"{args.batch} x {args.prompt_len}"
          + (f" after {WHISPER_FRAMES} frames" if encdec else "")
          + f": prefill {res.prefill_s:.3f} s, decode "
          f"{res.decode_ms_per_step:.2f} ms/step (untraced)")
    with flash_roles() as calls:
        lm_serve.serve(cfg, params, prompt, 1, **kw)
    roles = role_summary(calls)
    for role, r in roles.items():
        print(f"[flash] {role:8s} {r['launches']:4d} launches a prefill "
              f"({', '.join(r['dtypes'])}), host {r['host_us']:.1f} us "
              f"a launch")

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        lm_serve.serve(cfg, params, prompt, args.gen, **kw)
    events = prof.events()
    names = (lm_serve.PREFILL, lm_serve.DECODE)
    phases = {e.name: e.time_range for e in events
              if e.name in names and e.device_type == DeviceType.CPU}
    if len(phases) != 2:
        raise RuntimeError(f"the trace holds the serve ranges {sorted(phases)}"
                           f", expected {lm_serve.PREFILL} and "
                           f"{lm_serve.DECODE}")
    split = phases[lm_serve.DECODE].start
    # (the profiler may mirror the serving spans on the device: not
    # kernels)
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and e.name not in SERVE_SPANS]
    out = dict(arch=cfg.name, dtype=args.dtype, n_layers=cfg.n_layers,
               batch=args.batch, prompt_len=args.prompt_len,
               frames=WHISPER_FRAMES if encdec else None,
               decode_steps=args.gen - 1, prefill_s=res.prefill_s,
               decode_ms_per_step=res.decode_ms_per_step, flash_roles=roles)
    out["prefill"] = breakdown(
        "prefill", phases[lm_serve.PREFILL].elapsed_us() / 1e3,
        [e for e in device_events if e.time_range.start < split])
    out["decode"] = breakdown(
        f"decode x{args.gen - 1}", phases[lm_serve.DECODE].elapsed_us() / 1e3,
        [e for e in device_events if e.time_range.start >= split])
    return out


if __name__ == "__main__":
    main()
