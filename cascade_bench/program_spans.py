"""The program's own spans and copy counters, read from a traced window.

``repro_torch`` opens a profiler span ``repro_torch.<name>`` around each
part of ``detect_batch``'s work (``detect_batch`` around ``pack``,
``upload``, ``head``, ``tail``, ``sync``, ``copy_back`` and ``decode``)
and counts on its ``Detector``, beside ``program_builds``, the bytes it
copies each way (``h2d_bytes``, ``d2h_bytes``).  The spans are profiler
events on the device operations' clock, so each idle gap of the device
falls inside the innermost program span open on the host.

:func:`events` takes the program's spans out of a profiler,
:func:`per_flush` reduces them per flush of the benchmark, :func:`counters`
reads a detector's counters (``None`` for one the program lacks) and
:func:`layer_values` gives a window's per-layer numbers from both.  A
program without the spans or counters gives no value for them.
"""

from __future__ import annotations

import bisect

from cascade_bench.tracing import _union

PREFIX = "repro_torch."
COUNTERS = ("program_builds", "h2d_bytes", "d2h_bytes")
# per-layer metric -> (program span, field of per_flush), read in ms a flush
SPAN_METRICS = {
    "pack_ms": ("pack", "self_s"),
    "upload_ms": ("upload", "self_s"),
    "head_idle_ms": ("head", "idle_s"),
    "sync_wait_ms": ("sync", "self_s"),
    "copy_back_ms": ("copy_back", "self_s"),
    "decode_ms": ("decode", "self_s"),
}
# per-layer metric -> counter, read in MB a flush
COUNTER_METRICS = {"h2d_mb": "h2d_bytes", "d2h_mb": "d2h_bytes"}


def events(prof, device_cpu) -> list:
    """The program's spans ``(name without the prefix, start, end)`` of a
    ``torch.profiler`` trace, in seconds."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == device_cpu and name.startswith(PREFIX):
            out.append((name[len(PREFIX):], e.start_ns() / 1e9,
                        e.end_ns() / 1e9))
    return out


def _busy(merged: list, ends: list, a: float, b: float) -> float:
    """Device-busy time of the disjoint sorted ``merged`` inside [a, b)."""
    total = 0.0
    for s, e in merged[bisect.bisect_right(ends, a):]:
        if s >= b:
            break
        total += min(e, b) - max(s, a)
    return total


def per_flush(flushes: list, spans: list, ops: list) -> list:
    """For each flush ``(start, end)``, the program spans inside it by
    name (summed over the flush's buckets): ``self_s`` (duration less what
    child spans cover), ``idle_s`` (duration less the device-busy time
    inside it) and ``idle_self_s`` (the idle charged to the span as the
    innermost one open).  ``ops`` are the device operations ``(name,
    start, end, correlation id)``; the spans of one call nest, on one
    thread."""
    merged = _union([[a, b] for _n, a, b, _c in ops])
    ends = [e for _s, e in merged]
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    starts = [s[1] for s in spans]
    out = []
    for f0, f1 in sorted(flushes):
        rec: dict = {}
        stack: list = []     # open spans: [name, end, self_s, idle_self_s]

        def close(top):
            name, _end, self_s, idle_self = top
            r = rec.setdefault(name, dict(self_s=0.0, idle_s=0.0,
                                          idle_self_s=0.0))
            r["self_s"] += self_s
            r["idle_self_s"] += idle_self

        for name, a, b in spans[bisect.bisect_left(starts, f0):]:
            if a >= f1:
                break
            if b > f1:
                continue
            while stack and stack[-1][1] <= a:
                close(stack.pop())
            dur, idle = b - a, b - a - _busy(merged, ends, a, b)
            rec.setdefault(name, dict(self_s=0.0, idle_s=0.0,
                                      idle_self_s=0.0))["idle_s"] += idle
            if stack:        # a child: its time leaves its parent's self
                stack[-1][2] -= dur
                stack[-1][3] -= idle
            stack.append([name, b, dur, idle])
        while stack:
            close(stack.pop())
        out.append(rec)
    return out


def counters(det) -> dict:
    """The detector's plan builds and copied bytes so far; ``None`` for a
    counter the program does not keep."""
    return {k: getattr(det, k, None) for k in COUNTERS}


def deltas(before: dict, after: dict) -> dict:
    """What each counter moved between two :func:`counters` readings."""
    return {k: None if before.get(k) is None or after.get(k) is None
            else after[k] - before[k] for k in COUNTERS}


def layer_values(program: list, moved: dict, n_flushes: int) -> dict:
    """The per-layer metrics of a window: the span metrics as the mean ms
    a flush over ``program`` (:func:`per_flush`, traced flushes), the
    counter metrics as MB a flush from the counters' ``moved`` over
    ``n_flushes``; a metric with nothing to read is left out."""
    out = {}
    for metric, (name, field) in SPAN_METRICS.items():
        got = [f[name][field] for f in program if name in f]
        if got:
            out[metric] = sum(got) / len(program) * 1e3
    for metric, key in COUNTER_METRICS.items():
        if moved.get(key) is not None and n_flushes:
            out[metric] = moved[key] / n_flushes / 1e6
    return out
