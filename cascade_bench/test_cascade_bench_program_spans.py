"""The program's own spans and counters as the benchmark reads them
(``program_spans.py``): on a made-up trace, beside the benchmark's own
reduction, and from a CPU flush of the tiny cell under the profiler."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from cascade_bench import bench as benchlib
from cascade_bench import program_spans, tracing

REPO = Path(__file__).resolve().parents[1]
CPU, CUDA = "cpu", "cuda"
NAMES = ("detect_batch", "pack", "upload", "head", "tail", "sync",
         "copy_back", "decode")
# one flush [0, 1): the program's spans, nested under detect_batch, and the
# device operations they launched
FLUSH = (0.0, 1.0)
SPANS = [("detect_batch", 0.02, 0.98), ("pack", 0.02, 0.06),
         ("upload", 0.06, 0.10), ("head", 0.10, 0.30), ("tail", 0.30, 0.50),
         ("sync", 0.50, 0.80), ("copy_back", 0.80, 0.86),
         ("decode", 0.86, 0.96)]
OPS = [("h2d", 0.07, 0.10, 1), ("A", 0.15, 0.20, 2), ("S", 0.25, 0.35, 3),
       ("C", 0.40, 0.78, 4), ("d2h", 0.81, 0.85, 5)]
# name: (self_s, idle_s) by hand
WANT = {"detect_batch": (0.02, 0.36), "pack": (0.04, 0.04),
        "upload": (0.04, 0.01), "head": (0.20, 0.10), "tail": (0.20, 0.05),
        "sync": (0.30, 0.02), "copy_back": (0.06, 0.02),
        "decode": (0.10, 0.10)}


def reduce():
    return program_spans.per_flush([FLUSH], SPANS, OPS)[0]


@pytest.mark.parametrize("name", NAMES)
def test_self_and_idle_time_of_each_span(name):
    got = reduce()[name]
    assert (got["self_s"], got["idle_s"]) == pytest.approx(WANT[name])


def test_spans_outside_a_flush_stay_out_and_buckets_sum():
    two = SPANS + [("pack", 0.97, 0.98), ("pack", 1.2, 1.3)]
    got = program_spans.per_flush([FLUSH], two, OPS)[0]
    assert got["pack"]["self_s"] == pytest.approx(0.05)
    assert got["detect_batch"]["self_s"] == pytest.approx(0.01)
    assert program_spans.per_flush([(2.0, 3.0)], two, OPS) == [{}]


def _kineto(spans, ops, bench_spans):
    """A profiler whose raw events are these spans and device operations."""
    def ev(name, a, b, dev, corr=0):
        return SimpleNamespace(
            name=lambda: name, start_ns=lambda: int(round(a * 1e9)),
            end_ns=lambda: int(round(b * 1e9)), device_type=lambda: dev,
            correlation_id=lambda: corr, linked_correlation_id=lambda: corr)
    evs = [ev(tracing.SPAN + n, a, b, CPU) for n, a, b in bench_spans]
    evs += [ev(program_spans.PREFIX + n, a, b, CPU) for n, a, b in spans]
    # each device operation's launch, on the host, inside its span
    evs += [ev("cudaLaunchKernel", a - 0.004, a - 0.003, CPU, c)
            for _n, a, _b, c in ops]
    evs += [ev(n, a, b, CUDA, c) for n, a, b, c in ops]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


BENCH_SPANS = [("window", 0.0, 1.5), ("flush", *FLUSH),
               ("head", 0.10, 0.30), ("tail", 0.30, 0.50)]


def _bench_run(prof):
    t = tracing.summarize(*tracing.events(prof, CPU))
    work = [dict(head_ops=2e9, head_bytes=1e9, tail_ops=1e9, tail_bytes=0.0)
            ] * 2
    return SimpleNamespace(trace=t, work=work, flush_s=[1.0, 0.5],
                           images=[4, 4], traced_flushes=1, window_s=1.5,
                           energy_j=None, setup_s=1.0,
                           peaks={"fp32_flops_per_s": 1e12,
                                  "bytes_per_s": 1e11},
                           halves_s={"head": [0.2], "tail": [0.2]})


def test_the_benchmarks_own_readers_ignore_the_program_spans():
    names = [m["name"] for m in benchlib.load(REPO)["per_layer"]]
    assert len(names) >= 7
    plain = _bench_run(_kineto([], OPS, BENCH_SPANS))
    spanned = _bench_run(_kineto(SPANS, OPS, BENCH_SPANS))
    assert spanned.trace.device_ops == plain.trace.device_ops
    for name in names:
        read = benchlib.metric_reader(REPO, name)
        assert read(spanned) == read(plain), name


def test_the_spans_come_out_of_the_profiler_and_charge_all_idle():
    prof = _kineto(SPANS, OPS, BENCH_SPANS)
    got = program_spans.events(prof, CPU)
    assert sorted(got) == pytest.approx(sorted(SPANS))
    spans, op_start, ops = tracing.events(prof, CPU)
    flush = tracing.summarize(spans, op_start, ops).flushes[0]
    rec = program_spans.per_flush([FLUSH], got, ops)[0]
    outside = 0.02 + 0.02          # before and after detect_batch, idle
    charged = sum(r["idle_self_s"] for r in rec.values())
    assert charged + outside == pytest.approx(flush["wall_s"]
                                              - flush["busy_s"])
    assert rec["detect_batch"]["idle_s"] == pytest.approx(charged)


def test_the_eight_values_of_a_window():
    rec = reduce()
    moved = {"program_builds": 0, "h2d_bytes": 2 * 19_661_056,
             "d2h_bytes": 2 * 36_437_479}
    vals = program_spans.layer_values([rec, {}], moved, 2)
    assert vals == pytest.approx({
        "pack_ms": 20.0, "upload_ms": 20.0, "head_idle_ms": 50.0,
        "sync_wait_ms": 150.0, "copy_back_ms": 30.0, "decode_ms": 50.0,
        "h2d_mb": 19.661056, "d2h_mb": 36.437479})


def test_a_program_without_spans_or_counters_gives_nothing():
    old = SimpleNamespace(program_builds=3)
    c = program_spans.counters(old)
    assert c == {"program_builds": 3, "h2d_bytes": None, "d2h_bytes": None}
    moved = program_spans.deltas(c, c)
    assert moved == {"program_builds": 0, "h2d_bytes": None,
                     "d2h_bytes": None}
    assert program_spans.layer_values([{}, {}], moved, 2) == {}


def test_a_cpu_flush_of_the_tiny_cell_reduces_to_every_span(tiny_root):
    import torch
    from torch.autograd import DeviceType

    from cascade_bench import program
    from cascade_bench import traffic as trafficlib
    root, bench = tiny_root
    cell = benchlib.cell(bench, root, "tiny.t")
    cfg, trf = cell["config"], cell["traffic"]
    scenes = [img for _g, _i, img in trafficlib.pool(trf, 5)]
    sched = trafficlib.schedule(trf, 5)
    det = program.detector(program.cascade_arrays(cfg, cell["config_dir"]),
                           cfg["engine"], torch.device("cpu"))
    imgs = [scenes[i] for i in sched[0]]
    want = program.flush(det, imgs)                   # builds the plans
    before = program_spans.counters(det)
    prof = tracing.Profile(torch)
    prof.start()
    with prof.span("flush"):
        got = program.flush(det, imgs)
    prof.stop()
    moved = program_spans.deltas(before, program_spans.counters(det))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    spans, _op_start, ops = tracing.events(prof.prof, DeviceType.CPU)
    flushes = [(a, b) for n, a, b in spans if n == "flush"]
    rec, = program_spans.per_flush(
        flushes, program_spans.events(prof.prof, DeviceType.CPU), ops)
    assert set(rec) == set(NAMES)
    # nothing runs on a device: each span's own time is all idle
    for name, r in rec.items():
        assert r["idle_self_s"] == pytest.approx(r["self_s"]), name
    assert moved["program_builds"] == 0
    stack = sum(4 * im.shape[0] * im.shape[1] for im in imgs)
    assert moved["h2d_bytes"] >= stack
    vals = program_spans.layer_values([rec], moved, 1)
    assert set(vals) == set(program_spans.SPAN_METRICS) | set(
        program_spans.COUNTER_METRICS)
