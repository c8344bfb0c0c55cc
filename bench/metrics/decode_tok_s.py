"""decode_tok_s: the tokens generated in the window (batch x the steps
completed) over the window's host seconds."""


def read(view):
    if view.loop != "decode" or not view.steps:
        return None
    return view.batch * len(view.steps) / view.window_s
