"""tail_roofline: the least time the tail stages need (cascade_bench/
counts.py, over the windows that enter each stage) over the device time of
the operations launched inside the tail spans, summed over traced flushes.
Nothing to read where the cascade has no tail stage."""

from cascade_bench import counts


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    least = busy = 0.0
    for f, w in zip(run.trace.flushes, run.work):
        if w["tail_ops"] > 0:
            least += counts.least_s(w["tail_ops"], w["tail_bytes"],
                                    run.peaks)
        busy += f["tail_busy_s"]
    return 100.0 * least / busy if busy > 0 and least > 0 else None
