"""The plan's ``head_tile`` reaches the port's dense kernels, on the CPU:
the engine hands it to ``ops.fused_head_batch`` and
``ops.dense_stage_sums_batch`` on ``detect`` and ``detect_batch``
(recorded by wrappers around the plain versions), it maps onto one launch
shape of kernels A and B per candidate, ``measure_head`` times the fused
head once per candidate in that candidate's tile, the plain versions give
the same bits in every tile, and the port's plans carry the reference's
tuned tile."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.plan as rplan  # noqa: E402
from repro.core import Detector as RDetector, EngineConfig as RConfig  # noqa: E402
from repro.core import cascade as rcascade  # noqa: E402
from repro.core.training.data import render_scene  # noqa: E402

import repro_torch.plan as tplan  # noqa: E402
from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.kernels import autotune, integral_image, ops  # noqa: E402
from repro_torch.kernels.autotune import DEFAULT_TILE, HEAD_TILE_CANDIDATES  # noqa: E402
from repro_torch.kernels.haar_stage import HEAD_ROWS, head_block_shape  # noqa: E402

SMALL = [3, 4, 5, 6, 8]
RCASC = rcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
TCASC = tcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
KW = dict(mode="wave", step=1, min_neighbors=2)
TILES = [(), (16, 128), (8, 256)]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(2)]


@pytest.fixture(scope="module")
def reference(corpus):
    det = RDetector(RCASC, RConfig(**KW))
    return [det.detect(im, group=False) for im in corpus]


def _record_tiles(monkeypatch):
    """Wrap the engine's two dense entry points; returns the list of
    ``(entry, tile)`` of every call."""
    calls = []
    fused, dense = ops.fused_head_batch, ops.dense_stage_sums_batch

    def fused_spy(*args, tile=None, **kw):
        calls.append(("fused", tile))
        return fused(*args, tile=tile, **kw)

    def dense_spy(*args, tile=None, **kw):
        calls.append(("split", tile))
        return dense(*args, tile=tile, **kw)

    monkeypatch.setattr(ops, "fused_head_batch", fused_spy)
    monkeypatch.setattr(ops, "dense_stage_sums_batch", dense_spy)
    return calls


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("head", ["fused", "split"])
@pytest.mark.parametrize("entry", ["detect", "detect_batch"])
def test_engine_hands_plan_head_tile_to_dense_kernels(
        corpus, reference, monkeypatch, entry, head, tile):
    calls = _record_tiles(monkeypatch)
    d = Detector(TCASC, EngineConfig(**KW, use_pallas=True, head_mode=head,
                                     head_tile=tile), device="cpu")
    want = d.batch_plan(64, 64, len(corpus)).head_tile
    assert want == (tile or DEFAULT_TILE)
    assert all(d.level_plan(lp.height, lp.width).head_tile == want
               for lp in d.batch_plan(64, 64, len(corpus)).levels)
    if entry == "detect":
        got = [d.detect(im, group=False) for im in corpus]
    else:
        got = d.detect_batch(corpus, group=False)
    for a, r in zip(got, reference):
        assert np.array_equal(a, r)
    assert calls and {e for e, _ in calls} == {head}
    assert all(t == want for _, t in calls)


def test_head_block_shape_maps_candidates_to_distinct_launches():
    shapes = [head_block_shape(t) for t in HEAD_TILE_CANDIDATES]
    assert len(set(shapes)) == len(HEAD_TILE_CANDIDATES)
    for (ty, tx), (rpt, bx, by) in zip(HEAD_TILE_CANDIDATES, shapes):
        assert (rpt * by, bx) == (ty, tx)      # the block covers the tile
        assert rpt == 4
    assert head_block_shape(()) == head_block_shape(None) \
        == head_block_shape(DEFAULT_TILE)


@pytest.mark.parametrize("tile, shape", [
    ((3, 100), (2, 96, 1)), ((1, 1), (1, 32, 1)), ((40, 4096), (4, 256, 4)),
    ((0, 64), (1, 64, 1)), ((12, 200), (4, 192, 2))])
def test_head_block_shape_rounds_down_to_a_built_shape(tile, shape):
    rpt, bx, by = head_block_shape(tile)
    assert (rpt, bx, by) == shape
    assert rpt * by in HEAD_ROWS and rpt in (1, 2, 4) and bx % 32 == 0
    assert bx * by <= 1024


def test_measure_head_times_each_candidate_in_its_tile(monkeypatch):
    calls = []
    fused, dense = ops.fused_head, ops.dense_stage_sums_batch

    def fused_spy(*args, tile=None, **kw):
        calls.append(("fused", tile))
        return fused(*args, tile=tile, **kw)

    def dense_spy(*args, tile=DEFAULT_TILE, **kw):
        calls.append(("split", tile))
        return dense(*args, tile=tile, **kw)

    monkeypatch.setattr(ops, "fused_head", fused_spy)
    monkeypatch.setattr(ops, "dense_stage_sums_batch", dense_spy)
    rng = np.random.default_rng(3)
    workload = [(rng.integers(0, 255, (40, 48)).astype(np.float32), 1.0),
                (rng.integers(0, 255, (30, 30)).astype(np.float32), 1.0)]
    repeats, inner = 1, 2
    head = autotune.measure_head(TCASC, workload, n_dense=2,
                                 repeats=repeats, inner=inner)
    per_call = 1 + repeats * inner           # warm-up + timed calls
    fused_tiles = [t for e, t in calls if e == "fused"]
    race = [tuple(c) for c in HEAD_TILE_CANDIDATES for _ in workload
            for _ in range(per_call)]
    # the tile race, then the fused head in the winning tile per level
    want = race + [head["head_tiles"]] * (len(workload) * per_call)
    assert fused_tiles == want
    assert {t for e, t in calls if e == "split"} == {DEFAULT_TILE}
    assert set(head["tile_ms"]) == {f"{a}x{b}" for a, b in
                                    HEAD_TILE_CANDIDATES}
    assert all(len(v) == len(workload) for v in head["tile_ms"].values())
    assert head["head_tiles"] in HEAD_TILE_CANDIDATES


@pytest.mark.parametrize("tile", HEAD_TILE_CANDIDATES)
def test_dense_plain_versions_ignore_the_tile(tile):
    rng = np.random.default_rng(9)
    imgs = torch.as_tensor(rng.integers(0, 256, (2, 37, 50)),
                           dtype=torch.float32)
    want = ops.fused_head_batch(TCASC, 0, 3, imgs)
    got = ops.fused_head_batch(TCASC, 0, 3, imgs, tile=tile)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ii = integral_image.sat_tables(imgs)[0]
    for s in range(3):
        assert torch.equal(
            ops.dense_stage_sums_batch(TCASC, s, ii, want[1], tile=tile),
            want[2][:, s])


@pytest.mark.parametrize("head_mode", ["auto", "fused", "split"])
@pytest.mark.parametrize("tile", HEAD_TILE_CANDIDATES)
def test_port_plans_equal_reference_with_a_tuned_head_tile(tile, head_mode):
    kw = dict(use_pallas=True, head_mode=head_mode, head_tile=tile,
              head_rungs=((2000, "split"), (10 ** 6, "fused")))
    rc, tc = RConfig(**kw), EngineConfig(**kw)
    for (hp, wp), batch in (((64, 64), 3), ((480, 640), 8), ((96, 128), 1)):
        r = rplan.compile_plan(rc, 25, hp, wp, batch=batch)
        t = tplan.compile_plan(tc, 25, hp, wp, batch=batch)
        assert t.key == r.key and t.head_tile == r.head_tile == tile
        assert t.head_modes == r.head_modes
        assert [tuple(lp) for lp in t.levels] == [tuple(lp)
                                                   for lp in r.levels]
        lr = rplan.compile_level_plan(rc, 25, hp, wp)
        lt = tplan.compile_level_plan(tc, 25, hp, wp)
        assert lt.key == lr.key and lt.head_tile == lr.head_tile == tile
