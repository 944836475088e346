"""host_ms: per flush, its wall time less the time the device was busy
inside it (torch.profiler), averaged over the traced flushes: the host's
packing, upload, launches, waits and decode that the device does not
hide."""


def read(run):
    fl = run.trace.flushes if run.trace else []
    if not fl:
        return None
    return sum(f["wall_s"] - f["busy_s"] for f in fl) / len(fl) * 1e3
