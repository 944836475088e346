"""head_ms: per flush, the time between the CUDA events that bracket the
head halves (Detector.batch_parts' head_fn: pyramid, SATs, dense stages)
on the stream, summed over the flush's buckets and averaged over flushes."""


def read(run):
    s = run.halves_s.get("head")
    if not s or not run.flush_s:
        return None
    return sum(s) / len(run.flush_s) * 1e3
