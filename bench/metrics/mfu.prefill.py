"""mfu.prefill: the model FLOPs of the calls in the traced window
(``harness.counts.prefill_flops``: the products' active weights, causal
attention, the head at the last position) over the window's host
seconds x the bfloat16 peak, in percent."""

from harness import counts


def read(view):
    if view.loop != "prefill" or not view.calls:
        return None
    flops = sum(counts.prefill_flops(view.spec, B, S) for B, S in view.calls)
    return 100.0 * flops / (view.window_s * counts.PEAK_BF16_FLOPS)
