"""prefill_tok_s: the prompt tokens of every call that completed in the
window, over the window's host seconds (the last call ends it)."""


def read(view):
    if view.loop != "prefill" or not view.calls:
        return None
    return sum(B * S for B, S in view.calls) / view.window_s
