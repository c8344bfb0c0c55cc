"""flash_roofline.prefill: the causal attention FLOPs of the traced
window's calls (2 B S^2 H hd an attention layer) over the bfloat16 peak,
over the device time of the flash attention kernel, in percent."""

from harness import counts


def read(view):
    if view.trace is None or view.loop != "prefill" or not view.calls:
        return None
    s = view.trace.seconds_by_group().get("flash_attention")
    if not s:
        return None
    flops = sum(counts.attention_flops(view.spec, B, S)
                for B, S in view.calls)
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / s
