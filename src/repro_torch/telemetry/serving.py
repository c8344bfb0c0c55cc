"""Spans and counters of the LM serving path, on the profiler's clock.

The serving path (``launch.lm_serve``, ``models.transformer``'s
``prefill`` and ``decode_step``, the Mamba and MoE sublayers) names its
parts with :func:`span`.  While ``torch.profiler`` records, a span is a
``record_function`` range, so the host ranges and the device's kernels
land in one Kineto trace on one clock: each kernel can be put down to
the range its launch ran in, and each idle stretch of the device to the
host range open at that time.  With no profiler recording, :func:`span`
returns one shared null context: no range, no kernel, no synchronise.
The profiler is the only switch.

Every span name is in :data:`SERVE_SPANS` (name -> what it covers);
nesting in time is the parent link.

Counters (:data:`SERVE_COUNTERS`) also count only while a profiler
records.  Integers the host knows are summed on the host; device scalars
are summed on the device without a synchronise, and
:func:`serve_counters` reads them once, after the caller's window has
synchronised.  :func:`reset_serve_counters` zeroes them and takes the
CUDA allocator's statistics, whose deltas :func:`serve_counters` adds.
Counters are per process; a rank that holds a slice of a MoE layer's
experts does not count that layer.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SERVE_SPANS", "SERVE_COUNTERS", "MIXER_SPANS", "recording",
           "span", "count", "count_on_device", "reset_serve_counters",
           "serve_counters"]

#: span name -> what it covers
SERVE_SPANS: Dict[str, str] = {
    "lm_serve.prefill": "lm_serve.serve's prefill: models.prefill, the "
                        "first token's argmax and the wait on it",
    "lm_serve.decode": "lm_serve.serve's decode steps and the wait on "
                       "the last",
    "lm_serve.sync": "a host wait on the device in lm_serve.serve (three "
                     "a call)",
    "lm.embed": "token embedding, with the positions' table where the "
                "config adds one",
    "lm.layer": "one (mixer, ffn) layer; its self time is the norms and "
                "the residual adds (and an encoder-decoder's "
                "cross-attention)",
    "lm.mixer.attention": "global or sliding-window attention, its "
                          "projections and its KV cache's fill or update",
    "lm.mixer.mamba": "a Mamba block and its state",
    "lm.mixer.mlstm": "an mLSTM block and its state",
    "lm.mixer.slstm": "an sLSTM block and its state",
    "lm.mamba.proj": "Mamba's in_proj and out_proj",
    "lm.mamba.conv": "Mamba's causal depthwise conv, its silu and the "
                     "conv state",
    "lm.mamba.ssm": "Mamba's x_proj, dt_proj and softplus: dt, A, B, C",
    "lm.mamba.scan": "Mamba's selective scan with its D skip and the "
                     "silu(z) gate",
    "lm.ffn.mlp": "a dense MLP",
    "lm.moe": "a whole MoE sublayer (also the expert-parallel all-to-all)",
    "lm.moe.route": "the float32 router product, softmax, top-k and "
                    "renormalisation",
    "lm.moe.dispatch": "capacity slots, the gather table and the (E, C, d) "
                       "gather; in decode the mask of the picked experts "
                       "(off the card also the copy of their weights)",
    "lm.moe.experts": "the experts' batched products and activation (in "
                      "decode on the card the expert-indexed kernel)",
    "lm.moe.combine": "the inverse gather and the weighted sum of each "
                      "token's assignments",
    "lm.moe.shared": "the shared experts' MLP",
    "lm.head": "the final norm and the logits",
}

#: a layer's mixer kind -> its span
MIXER_SPANS: Dict[str, str] = {
    "attn": "lm.mixer.attention", "local": "lm.mixer.attention",
    "mamba": "lm.mixer.mamba", "mlstm": "lm.mixer.mlstm",
    "slstm": "lm.mixer.slstm"}

#: counter name -> what it counts
SERVE_COUNTERS: Dict[str, str] = {
    "moe.assignments": "token-to-expert assignments of capacity-dispatched "
                       "MoE layers, T x k a layer",
    "moe.slots": "expert rows the capacity-dispatched experts compute, "
                 "E x C a layer",
    "moe.dropped": "assignments dropped by capacity",
    "moe.experts_gathered": "experts whose weights a dropless (decode) MoE "
                            "layer copies off the card, min(E, T x k) a "
                            "layer",
    "moe.experts_picked": "of those, the experts the tokens picked",
    "moe.experts_streamed": "experts whose weights a dropless (decode) MoE "
                            "layer's kernel reads in place on the card: "
                            "the picked ones, summed on the card",
    "alloc.retries": "the CUDA allocator's retries (cached blocks freed, "
                     "the device synchronised), num_alloc_retries' delta",
    "alloc.device_allocs": "cudaMalloc calls, num_device_alloc's delta",
    "alloc.device_frees": "cudaFree calls, num_device_free's delta",
}

_ALLOC_STATS = {"alloc.retries": "num_alloc_retries",
                "alloc.device_allocs": "num_device_alloc",
                "alloc.device_frees": "num_device_free"}

_NULL = contextlib.nullcontext()
_host: Dict[str, int] = collections.Counter()
_on_device: Dict[Tuple[str, torch.device], torch.Tensor] = {}
_alloc0: Optional[Dict[str, int]] = None


def recording() -> bool:
    """Whether a profiler records on this process."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler
    records, else the shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` while a
    profiler records."""
    if _profiler._is_profiler_enabled:
        _host[name] += int(n)


def count_on_device(name: str, value: torch.Tensor) -> None:
    """Add the integer scalar ``value`` to the counter ``name`` on its
    device, while a profiler records; nothing is read back."""
    if not _profiler._is_profiler_enabled:
        return
    key = (name, value.device)
    acc = _on_device.get(key)
    if acc is None:
        _on_device[key] = value.detach().reshape(()).to(torch.int64,
                                                        copy=True)
    else:
        acc.add_(value.detach().reshape(()))


def _alloc_stats() -> Optional[Dict[str, int]]:
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(v, 0)) for k, v in _ALLOC_STATS.items()}


def reset_serve_counters() -> None:
    """Zero every counter and take the allocator's statistics."""
    global _alloc0
    _host.clear()
    _on_device.clear()
    _alloc0 = _alloc_stats()


def serve_counters() -> Dict[str, int]:
    """The counters since :func:`reset_serve_counters` (the device ones
    read here, one synchronise each), with the allocator's deltas on a
    CUDA process."""
    out = dict(_host)
    for (name, _), acc in _on_device.items():
        out[name] = out.get(name, 0) + int(acc.item())
    now = _alloc_stats()
    if now is not None and _alloc0 is not None:
        out.update({k: now[k] - _alloc0[k] for k in now})
    return out
