"""moe_dispatch_ms.decode: device milliseconds a decode step in the
``moe_dispatch`` kernel group (it holds the dropless decode's gather of
the picked experts' weights) over the traced window."""


def read(view):
    if view.trace is None or view.loop != "decode" or not view.steps:
        return None
    s = view.trace.seconds_by_group().get("moe_dispatch")
    return None if s is None else 1e3 * s / len(view.steps)
