"""The port's profiler spans and copy counters, on the CPU: ``span()`` is
free while no profiler records, a traced ``detect_batch`` nests one span
of each part of its work inside its own and returns the untraced rects,
and ``h2d_bytes`` / ``d2h_bytes`` count exactly the bytes the shapes
give."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from repro_torch import spans  # noqa: E402
from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.core.training.data import render_scene  # noqa: E402

CASC = tcascade.paper_shaped_cascade(0, stage_sizes=[3, 4, 5, 6, 8])
KW = dict(mode="wave", step=1, min_neighbors=2, use_pallas=True,
          tail_backend="pallas")
PARTS = ("pack", "upload", "head", "tail", "sync", "copy_back", "decode")


def _det():
    return Detector(CASC, EngineConfig(**KW), device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(2)]


def _traced(fn):
    """``fn()``'s result and its ``repro_torch.*`` spans ``(name, start,
    end)`` in start order, under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = sorted((e.time_range.start, -e.time_range.end,
                  e.name[len(spans.PREFIX):]) for e in prof.events()
                 if e.name.startswith(spans.PREFIX))
    return out, [(n, a, -b) for a, b, n in got]


def _nested_counts(recorded):
    """Names of the spans inside the one ``detect_batch`` span, counted."""
    tops = [(a, b) for n, a, b in recorded if n == "detect_batch"]
    assert len(tops) == 1
    (a0, b0), = tops
    inner: dict = {}
    for n, a, b in recorded:
        if n != "detect_batch":
            assert a0 <= a and b <= b0, n
            inner[n] = inner.get(n, 0) + 1
    return inner


def test_span_without_a_profiler_is_one_shared_null(monkeypatch):
    built = []
    monkeypatch.setattr(spans, "_RecordFunctionFast",
                        lambda name: built.append(name))
    assert not torch.autograd._profiler_enabled()
    first = spans.span("a")
    assert spans.span("b") is first
    with first:
        with spans.span("c"):
            pass
    assert built == []


def test_span_under_a_profiler_is_a_prefixed_host_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("part"):
            torch.ones(4).sum()
        assert spans.span("x") is not spans.span("x")
    names = [e.name for e in prof.events()]
    assert names.count("repro_torch.part") == 1


def test_traced_detect_batch_nests_one_span_of_each_part(images):
    det = _det()
    det.detect_batch(images, group=False)            # builds the plan
    _out, recorded = _traced(lambda: det.detect_batch(images, group=False))
    assert _nested_counts(recorded) == dict.fromkeys(PARTS, 1)


def test_traced_rects_equal_untraced(images):
    det = _det()
    plain = det.detect_batch(images, group=False)
    traced, _ = _traced(lambda: det.detect_batch(images, group=False))
    assert len(plain) == len(traced) == 2
    assert sum(len(r) for r in plain) > 0
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)


def test_vmap_path_carries_the_shared_helpers_spans(images):
    det = _det()
    det.detect_batch(images, strategy="vmap", group=False)
    _out, recorded = _traced(
        lambda: det.detect_batch(images, strategy="vmap", group=False))
    assert _nested_counts(recorded) == {"pack": 1, "upload": 1}


def test_flush_counts_the_bytes_its_shapes_give(images):
    det = _det()
    assert det.h2d_bytes == det.d2h_bytes == 0
    det.detect_batch(images, group=False)            # builds the plan
    plan = det.batch_plan(64, 64, 2)
    h2d, d2h = det.h2d_bytes, det.d2h_bytes
    assert h2d > 0 and d2h > 0                        # the build's tables
    det.detect_batch(images, group=False)
    stack = 2 * 64 * 64 * 4                           # float32 (B, hp, wp)
    valid_hw = 2 * 2 * 8                              # int64 (B, 2)
    assert det.h2d_bytes - h2d == stack + valid_hw
    # bool valid + int64 img, lvl, ys, xs over the final lanes; the
    # overflow flag
    assert det.d2h_bytes - d2h == 33 * plan.capacities[-1] + 1


def test_repeated_flush_builds_no_program(images):
    det = _det()
    det.detect_batch(images, group=False)
    builds, h2d = det.program_builds, det.h2d_bytes
    assert builds > 0
    det.detect_batch(images, group=False)
    assert det.program_builds == builds
    # the build's tables go up once: the repeat moves only the flush's input
    assert det.h2d_bytes - h2d == 2 * 64 * 64 * 4 + 2 * 2 * 8


def test_detect_counts_its_copies(images):
    det = _det()
    det.detect(images[0], group=False)
    h2d, d2h = det.h2d_bytes, det.d2h_bytes
    det.detect(images[0], group=False)
    levels = det.batch_plan(64, 64).levels_all
    # the stack, each level's window limits and its two index tables
    want = 64 * 64 * 4 + len(levels) * 2 * 8 + sum(
        (lp.height + lp.width) * 8 for lp in levels)
    assert det.h2d_bytes - h2d == want
    raw = det.detect_raw(images[0])
    lanes = sum(r.valid.numel() for r, _ in raw)
    assert det.d2h_bytes - d2h == 1 + 17 * lanes       # flag, valid + ys, xs
