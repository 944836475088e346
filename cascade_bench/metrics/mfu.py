"""mfu: the operations the flushes need (head and tail, cascade_bench/
counts.py) over their wall time (host clock) times the card's float32
peak outside the tensor cores: the whole flush's share of it.  Read from
the flushes after the profiler stopped, which run as an untraced run's
do; ``None`` where a traced run has none."""


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    n = run.traced_flushes
    if len(run.flush_s) <= n:
        return None
    ops = sum(w["head_ops"] + w["tail_ops"] for w in run.work[n:])
    wall = sum(run.flush_s[n:])
    return 100.0 * ops / (wall * run.peaks["fp32_flops_per_s"])
