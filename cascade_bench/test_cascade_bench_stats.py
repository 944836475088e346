"""The window's statistics and the trace's reduction to per-layer numbers,
on made-up runs and traces."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from cascade_bench import bench as benchlib
from cascade_bench import tracing

REPO = Path(__file__).resolve().parents[1]
PEAKS = {"fp32_flops_per_s": 1e12, "bytes_per_s": 1e11}


def read(name, run):
    return benchlib.metric_reader(REPO, name)(run)


def window(flush_s, window_s=None, images=4, energy_j=None):
    return SimpleNamespace(flush_s=list(flush_s), images=[images] * len(flush_s),
                           window_s=window_s or sum(flush_s), energy_j=energy_j,
                           setup_s=3.5, trace=None, halves_s={}, work=[],
                           peaks=None)


def test_rate_is_all_images_over_the_whole_window():
    run = window([0.1] * 10, window_s=2.0)     # the host idled 1 s as well
    assert read("images_per_s", run) == pytest.approx(40 / 2.0)
    run.images[3] = 0                           # a flush that failed
    assert read("images_per_s", run) == pytest.approx(36 / 2.0)


def test_p95_is_over_every_flush_and_moves_when_one_stalls():
    steady = window([0.1] * 20)
    assert read("flush_p95_ms", steady) == pytest.approx(100.0)
    stalled = window([0.1] * 19 + [1.1])
    assert read("flush_p95_ms", stalled) > 140.0
    assert read("flush_p95_ms", window([0.1, 0.2])) == pytest.approx(195.0)


def test_energy_per_image_and_setup():
    run = window([0.1] * 10, energy_j=120.0)
    assert read("j_per_image", run) == pytest.approx(3.0)
    assert read("j_per_image", window([0.1])) is None    # no counter
    assert read("setup_s", run) == 3.5


def trace_fixture():
    """Two flushes of 1 s: [0, 1) and [1.5, 2.5) inside a window [0, 3)."""
    spans = [("window", 0.0, 3.0), ("flush", 0.0, 1.0), ("flush", 1.5, 2.5),
             ("head", 0.1, 0.3), ("tail", 0.3, 0.6),
             ("head", 1.6, 1.8), ("tail", 1.8, 2.1)]
    # host operations that launched device work (correlation id: start)
    op_start = {1: 0.15, 2: 0.35, 3: 0.05, 4: 1.65, 5: 1.85, 6: 2.2}
    ops = [("upload", 0.05, 0.1, 3), ("A", 0.2, 0.4, 1), ("C", 0.4, 0.8, 2),
           ("A", 1.7, 1.9, 4), ("C", 1.9, 2.2, 5), ("copy", 2.2, 2.3, 6)]
    return tracing.summarize(spans, op_start, ops)


def test_trace_reduction():
    t = trace_fixture()
    assert t.window_s == pytest.approx(3.0)
    assert t.busy_s == pytest.approx(0.05 + 0.6 + 0.6)
    assert [f["wall_s"] for f in t.flushes] == pytest.approx([1.0, 1.0])
    assert [f["busy_s"] for f in t.flushes] == pytest.approx([0.65, 0.6])
    # device time of what each half launched, wherever it ran
    assert [f["head_busy_s"] for f in t.flushes] == pytest.approx([0.2, 0.2])
    assert [f["tail_busy_s"] for f in t.flushes] == pytest.approx([0.4, 0.3])
    assert t.device_ops[0] == ["C", pytest.approx(0.7)]
    gaps = dict(t.idle_gaps)
    # idle time split by what the host was doing meanwhile
    assert gaps["decode"] == pytest.approx(0.2 + 0.2)   # [0.8,1.0) [2.3,2.5)
    assert gaps["loop"] == pytest.approx(0.5 + 0.5)     # between flushes
    assert gaps["pack_upload"] == pytest.approx(0.05 + 0.1)
    assert gaps["head"] == pytest.approx(0.1 + 0.1)
    assert sum(gaps.values()) == pytest.approx(3.0 - t.busy_s)


def test_per_layer_readers_on_a_trace():
    t = trace_fixture()
    work = [dict(head_ops=2e9, head_bytes=1e9, tail_ops=1e9, tail_bytes=0.0)
            ] * 3
    # two flushes under the profiler, a third after it stopped
    run = SimpleNamespace(trace=t, work=work, peaks=PEAKS,
                          flush_s=[1.0, 1.0, 0.5], images=[4, 4, 4],
                          traced_flushes=2,
                          halves_s={"head": [0.2, 0.25, 0.1],
                                    "tail": [0.5, 0.3, 0.2]})
    assert read("idle_share", run) == pytest.approx(1 - 1.25 / 3.0)
    assert read("host_ms", run) == pytest.approx((0.35 + 0.4) / 2 * 1e3)
    assert read("head_ms", run) == pytest.approx(550.0 / 3)
    assert read("tail_ms", run) == pytest.approx(1000.0 / 3)
    # least time: max(2e9 / 1e12, 1e9 / 1e11) = 10 ms a flush, over 0.2 s
    assert read("head_roofline", run) == pytest.approx(5.0)
    assert read("tail_roofline", run) == pytest.approx(100 * 2e-3 / 0.7)
    # mfu: the untraced flush alone, 3e9 operations in 0.5 s
    assert read("mfu", run) == pytest.approx(100 * 3e9 / (0.5 * 1e12))
    run.traced_flushes = 3
    assert read("mfu", run) is None
    run.traced_flushes = 2
    no_tail = [dict(w, tail_ops=0.0) for w in work]
    run.work = no_tail
    assert read("tail_roofline", run) is None
    run.trace = None
    assert read("idle_share", run) is None and read("mfu", run) is None


def test_a_traced_run_reads_the_profilers_trace(tiny_root):
    from cascade_bench import run as runmod
    root, bench = tiny_root
    res = runmod.run_cell(root, bench, "tiny.t", 8, 0.05, True, device="cpu")
    assert res["correct"]
    assert res["device"]["window_s"] >= 0.05
    labels = {k for k, _v in res["breakdown"]["idle_gaps"]}
    assert labels <= {"pack_upload", "head", "head_to_tail", "tail",
                      "decode_pack", "decode", "flush", "loop"}
    assert {"head", "tail"} <= labels     # the halves' spans are in it
    assert list(res)[-2:] == ["breakdown", "checks"]


def test_only_the_windows_first_part_is_traced(tiny_root, monkeypatch):
    from cascade_bench import program
    from cascade_bench import run as runmod
    root, bench = tiny_root
    flushes, stopped_after = [], []
    real_flush, real_stop = program.flush, tracing.Profile.stop

    def flush(det, images):
        flushes.append(len(images))
        return real_flush(det, images)

    def stop(self):
        stopped_after.append(len(flushes))
        real_stop(self)
    monkeypatch.setattr(program, "flush", flush)
    monkeypatch.setattr(tracing.Profile, "stop", stop)
    monkeypatch.setattr(tracing, "TRACE_S", 0.0)
    res = runmod.run_cell(root, bench, "tiny.t", 8, 0.3, True, device="cpu")
    assert res["correct"]
    # two warm-up flushes, then the profiler closes after the window's first
    assert stopped_after == [runmod.WARM_FLUSHES + 1]
