"""tail_ms: per flush, the time between the CUDA events that bracket the
tail halves (Detector.batch_parts' tail_fn: shared compactions, counts,
packed tail) on the stream, summed over buckets, averaged over flushes."""


def read(run):
    s = run.halves_s.get("tail")
    if not s or not run.flush_s:
        return None
    return sum(s) / len(run.flush_s) * 1e3
