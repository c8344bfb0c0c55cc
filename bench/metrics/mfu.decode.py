"""mfu.decode: the whole decode step's share of its roofline: the sum
over the window's steps of the larger of the step's model FLOPs over the
bfloat16 peak and its bytes over the HBM bandwidth
(``harness.counts.step_floor_s``; every expert counted once, about 2%
high at batch 32 and top-2 of 16), over the window's host seconds, in
percent."""

from harness import counts


def read(view):
    if view.loop != "decode" or not view.steps:
        return None
    floor = sum(counts.step_floor_s(view.spec, view.batch, p)
                for p in view.steps)
    return 100.0 * floor / view.window_s
