"""head_roofline: the least time the head needs (cascade_bench/counts.py,
from the reference's work on these images) over the device time of the
operations launched inside the head spans, summed over traced flushes."""

from cascade_bench import counts


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    least = busy = 0.0
    for f, w in zip(run.trace.flushes, run.work):
        least += counts.least_s(w["head_ops"], w["head_bytes"], run.peaks)
        busy += f["head_busy_s"]
    return 100.0 * least / busy if busy > 0 and least > 0 else None
