"""frame_ms_p95: the 95th percentile (linear interpolation) of the wall
times of every frame in the window, call to synchronise; host clock."""

import numpy as np


def read(ctx):
    t = ctx["window"]["frame_s"]
    return float(np.percentile(np.asarray(t) * 1e3, 95)) if t else None
