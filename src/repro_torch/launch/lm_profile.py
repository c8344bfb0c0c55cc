"""Where the LM serving path's time goes on the card.

Warms up, runs :func:`repro_torch.launch.lm_serve.serve` once untraced
(its prefill seconds and decode ms/step), then once more under
``torch.profiler``, and splits that trace at the serve's own phase
ranges (``lm_serve.PREFILL``, ``lm_serve.DECODE``):

  PYTHONPATH=src python -m repro_torch.launch.lm_profile --arch gemma2_2b \\
      [--batch 2] [--prompt-len 8192] [--gen 9]

For each phase it prints the host wall time, the device time summed over
the kernels and copies the profiler recorded (one stream, so they do not
overlap; the serve synchronises between the phases, so a kernel belongs
to the phase it starts in), the device's busy share (that sum over the
traced wall time; tracing slows the host, so for a host-bound phase the
share is a lower bound), and the device time by group (the
flash-attention kernel, cuBLAS products, copies, other PyTorch kernels)
and by kernel, largest first.  ``--reduced --device cpu`` runs it without
device times, for tests.
"""

from __future__ import annotations

import argparse
import collections
from typing import Dict, List, Optional

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .._device import resolve_device
from . import lm_serve

__all__ = ["kernel_group", "breakdown", "main"]

#: (group, substrings of a kernel's name), first match wins
_GROUPS = (("flash_attention", ("flash_fwd_kernel",)),
           ("matmul", ("gemm", "gemv", "sm90_", "cutlass", "xmma")),
           ("copies", ("Memcpy", "Memset")))
#: kernels listed per phase
_TOP = 12


def kernel_group(name: str) -> str:
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


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8192)
    ap.add_argument("--gen", type=int, default=9,
                    help="tokens generated: the prefill's and gen - 1 "
                         "decode steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (no device times; tests)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = lm_serve.make_config(args.arch, args.reduced)
    params = lm_serve.make_params(cfg, device)
    prompt = lm_serve.make_prompt(cfg, args.batch, args.prompt_len, device)
    # warm-up: the kernel build on first use, cuBLAS handles and plans
    lm_serve.serve(cfg, params, prompt[:, :64], 2)
    res = lm_serve.serve(cfg, params, prompt, args.gen)
    print(f"[serve] {cfg.name} batch {args.batch} x {args.prompt_len}: "
          f"prefill {res.prefill_s:.3f} s, decode "
          f"{res.decode_ms_per_step:.2f} ms/step (untraced)")

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        lm_serve.serve(cfg, params, prompt, args.gen)
    events = prof.events()
    names = (lm_serve.PREFILL, lm_serve.DECODE)
    phases = {e.name: e.time_range for e in events
              if e.name in names and e.device_type == DeviceType.CPU}
    if len(phases) != 2:
        raise RuntimeError(f"the trace holds the serve ranges {sorted(phases)}"
                           f", expected {lm_serve.PREFILL} and "
                           f"{lm_serve.DECODE}")
    split = phases[lm_serve.DECODE].start
    # (the profiler may mirror the two ranges on the device: not kernels)
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and e.name not in names]
    out = dict(arch=cfg.name, batch=args.batch, prompt_len=args.prompt_len,
               decode_steps=args.gen - 1, prefill_s=res.prefill_s,
               decode_ms_per_step=res.decode_ms_per_step)
    out["prefill"] = breakdown(
        "prefill", phases[lm_serve.PREFILL].elapsed_us() / 1e3,
        [e for e in device_events if e.time_range.start < split])
    out["decode"] = breakdown(
        f"decode x{args.gen - 1}", phases[lm_serve.DECODE].elapsed_us() / 1e3,
        [e for e in device_events if e.time_range.start >= split])
    return out


if __name__ == "__main__":
    main()
