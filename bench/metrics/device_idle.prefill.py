"""device_idle.prefill: the share of the traced window, in percent, in
which no kernel, copy or set ran on the card."""


def read(view):
    if view.trace is None or view.loop != "prefill":
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
