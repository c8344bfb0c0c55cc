"""moe_dispatch_ms.prefill: device milliseconds a call in the
``moe_dispatch`` kernel group (top-k, sorts, index, gathers, scatters,
histograms; ``harness.trace.GROUPS``) over the traced window."""


def read(view):
    if view.trace is None or view.loop != "prefill" or not view.calls:
        return None
    s = view.trace.seconds_by_group().get("moe_dispatch")
    return None if s is None else 1e3 * s / len(view.calls)
