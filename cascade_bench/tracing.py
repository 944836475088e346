"""Spans around the program's layers and the reading of a profiler trace.

The benchmark records its own spans (``torch.profiler.record_function``)
around the calls into each layer; the program carries none yet:

- ``cascade_bench.window``: the traced part of the window (its first
  :data:`TRACE_S` seconds);
- ``cascade_bench.flush``: one ``detect_batch`` call, to its rects;
- ``cascade_bench.head`` / ``cascade_bench.tail``: the two halves of each
  bucket's packed program (``Detector.batch_parts``), which
  ``detect_batch`` calls; CUDA events on the stream bracket each too.

The time in a flush before its first head is the host's packing and
upload, the time between a tail and the next head the decode of one
bucket and the packing of the next, and the time after the last tail the
decode.  :func:`summarize` turns the trace into plain numbers that the
metric readers take.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

SPAN = "cascade_bench."
TOP = 10
# seconds of a traced run's window that run under the profiler: a trace of
# the whole window holds millions of events (11 GB and two minutes to read
# for 51 s of vj25.vga_b16), and some hundred flushes are enough
TRACE_S = 10.0


@dataclass
class Trace:
    window_s: float                 # the traced window's wall time
    busy_s: float                   # device busy (union of its operations)
    flushes: list = field(default_factory=list)   # per flush, see summarize
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Profile:
    """``torch.profiler`` (host and device) over part of a window, with the
    window's span; ``span(name)`` is a benchmark span while it is open."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.open = False
        self._window = None

    def start(self) -> None:
        self.prof.__enter__()
        self._window = self._torch.profiler.record_function(SPAN + "window")
        self._window.__enter__()
        self.open = True

    def stop(self) -> None:
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.open = False

    def span(self, name: str):
        if not self.open:
            return contextlib.nullcontext()
        return self._torch.profiler.record_function(SPAN + name)


class Halves:
    """Wraps a detector's ``batch_parts`` so each half runs inside its own
    span, bracketed by CUDA events on a card; ``events`` keeps, per call,
    the half's name and its two events."""

    def __init__(self, det, torch):
        self.events: list = []
        self._torch = torch
        self._cuda = det.device.type == "cuda"
        inner = det.batch_parts

        def batch_parts(hp, wp, batch):
            head_fn, tail_fn = inner(hp, wp, batch)
            return self._wrap("head", head_fn), self._wrap("tail", tail_fn)
        det.batch_parts = batch_parts

    def _wrap(self, name: str, fn):
        torch = self._torch

        def half(*args):
            with torch.profiler.record_function(SPAN + name):
                if not self._cuda:
                    return fn(*args)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
            self.events.append((name, start, end))
            return out
        return half

    def elapsed_s(self) -> dict:
        """Seconds between each half's two events, by half, in call order."""
        out = defaultdict(list)
        for name, start, end in self.events:
            out[name].append(start.elapsed_time(end) / 1e3)
        return dict(out)


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged: list, a: float, b: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in merged)


def _host_segments(flushes: list, halves: list) -> list:
    """``(start, end, label)`` of what the host was doing, in order."""
    segs = []
    j = 0
    for f0, f1 in flushes:
        inside = []
        while j < len(halves) and halves[j][1] < f1:
            if halves[j][1] >= f0:
                inside.append(halves[j])
            j += 1
        t, prev = f0, None
        for name, a, b in inside:
            label = ("pack_upload" if prev is None else
                     "decode_pack" if prev == "tail" else "head_to_tail")
            segs.append((t, a, label))
            segs.append((a, b, name))
            t, prev = b, name
        segs.append((t, f1, "decode" if prev else "flush"))
    return segs


def events(prof, device_cpu) -> tuple:
    """The trace as plain tuples, from the profiler's raw events (cheaper
    to walk than its function events): the benchmark's spans ``(name,
    start, end)``, the host operations' start by correlation id, and the
    device operations ``(name, start, end, linked correlation id)``;
    times in seconds."""
    spans, op_start, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() / 1e9, e.end_ns() / 1e9
        if e.device_type() == device_cpu:
            if name.startswith(SPAN):
                spans.append((name[len(SPAN):], a, b))
            op_start[e.correlation_id()] = a
        elif not name.startswith(SPAN):
            ops.append((name, a, b, e.linked_correlation_id()))
    return spans, op_start, ops


def summarize(spans: list, op_start: dict, ops: list) -> Trace:
    """Plain numbers of a trace (see :func:`events`).

    Per flush: ``wall_s``, ``busy_s`` (device operations inside the
    flush), ``head_busy_s`` and ``tail_busy_s`` (device time of the
    operations launched from inside its head and tail spans: the host
    operation each links to started inside the span)."""
    by = defaultdict(list)
    for name, a, b in spans:
        by[name].append((a, b))
    if not by["window"]:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = by["window"][0]
    merged = _union([[a, b] for _n, a, b, _c in ops if b > w0 and a < w1])
    halves = sorted((a, b, name) for name in ("head", "tail")
                    for a, b in by[name])
    starts = [h[0] for h in halves]
    half_busy = [0.0] * len(halves)
    for _n, a, b, corr in ops:
        t = op_start.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < halves[i][1]:
            half_busy[i] += b - a
    flushes = []
    j = 0
    for f0, f1 in sorted(by["flush"]):
        rec = dict(wall_s=f1 - f0, busy_s=_covered(merged, f0, f1),
                   head_busy_s=0.0, tail_busy_s=0.0)
        while j < len(halves) and halves[j][0] < f1:
            if halves[j][0] >= f0:
                rec[f"{halves[j][2]}_busy_s"] += half_busy[j]
            j += 1
        flushes.append(rec)
    per_op = defaultdict(float)
    for name, a, b, _c in ops:
        per_op[name] += max(0.0, min(b, w1) - max(a, w0))
    device_ops = sorted(([n[:160], v] for n, v in per_op.items() if v > 0),
                        key=lambda x: -x[1])[:TOP]
    segs = _host_segments(sorted(by["flush"]),
                          [(name, a, b) for a, b, name in halves])
    seg_ends = [g[1] for g in segs]
    gaps = defaultdict(float)
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        # split the idle time by what the host was doing meanwhile
        covered = 0.0
        for s0, s1, label in segs[bisect.bisect_right(seg_ends, a):]:
            if s0 >= b:
                break
            part = min(s1, b) - max(s0, a)
            if part > 0:
                gaps[label] += part
                covered += part
        if b - a - covered > 0:
            gaps["loop"] += b - a - covered
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])
    return Trace(window_s=w1 - w0, busy_s=_covered(merged, w0, w1),
                 flushes=flushes, device_ops=device_ops, idle_gaps=idle[:TOP])
