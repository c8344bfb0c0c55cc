"""itl_p95_ms: the 95th percentile (numpy's linear interpolation) of the
gaps between consecutive decode steps over every step of the window,
from CUDA events recorded on the stream after each step: a gap counts
the step's kernels and any time the card waited for the host."""

import numpy as np


def read(view):
    if view.loop != "decode" or not view.itl_ms:
        return None
    return float(np.percentile(np.asarray(view.itl_ms), 95))
