"""idle_share: 1 - device busy / traced wall time, over the traced
window; busy is the union of the device operations' intervals (one
stream: they do not overlap)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
