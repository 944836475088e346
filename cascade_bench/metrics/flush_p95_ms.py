"""flush_p95_ms: the 95th percentile (linear interpolation) of every
flush of the window, host clock from the call to the rects on the host."""

import numpy as np


def read(run):
    if not run.flush_s:
        return None
    return float(np.percentile(np.asarray(run.flush_s), 95)) * 1e3
