"""The port's plan compiler against the reference's, field by field, over a
sweep of bucket, batch and config (tuned ladders and tiles included)."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.plan as rplan  # noqa: E402
from repro.core.engine import EngineConfig as RConfig  # noqa: E402

import repro_torch.plan as tplan  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402

N_STAGES = 25

CONFIGS = [
    {},
    {"use_pallas": True},
    {"use_pallas": True, "tail_backend": "pallas", "pad_multiple": 32},
    {"mode": "dense"},
    {"step": 2, "scale_factor": 1.3},
    {"dense_segments": (2,), "compact_every": 4},
    {"capacity_fracs": (0.5, 0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.1)},
    {"batch_capacity_fracs": (0.4, 0.2, 0.1, 0.05, 0.05, 0.05, 0.05, 0.05)},
    {"tail_rungs": ((128, "bulk"), (2048, "pallas"))},
    {"tail_rungs": ((512, "gather"), (4096, "bulk"))},
    {"use_pallas": True, "head_rungs": ((2000, "split"), (10 ** 6, "fused"))},
    {"use_pallas": True, "head_mode": "split", "head_tile": (16, 128),
     "lane_block": (8, 256)},
    {"use_pallas": True, "head_tile": (8, 256)},
]
BUCKETS = [(64, 64), (96, 128), (480, 640), (24, 24), (23, 30)]


def _cfgs(kw):
    return RConfig(**kw), TConfig(**kw)


def _layout_equal(a, b):
    assert a.active == b.active and a.n_slots == b.n_slots
    for f in ("slot_indices", "lvl_of_slot", "y_of_slot", "x_of_slot",
              "sat_base_of_lvl", "sat_stride_of_lvl"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _plan_equal(r, t):
    assert t.key == r.key and hash(t.key) == hash(r.key)
    for f in ("hp", "wp", "batch", "step", "active", "capacities",
              "head_modes", "head_tile", "lane_block", "n_slots",
              "n_windows_total", "work_units", "dense_prefix"):
        assert getattr(t, f) == getattr(r, f), f
    assert [tuple(lp) for lp in t.levels_all] == [tuple(lp)
                                                   for lp in r.levels_all]
    assert [tuple(lp) for lp in t.levels] == [tuple(lp) for lp in r.levels]
    assert [tuple(s) for s in t.segments] == [tuple(s) for s in r.segments]
    assert [tuple(s) for s in t.tail_segments] == [tuple(s)
                                                   for s in r.tail_segments]
    _layout_equal(r.layout, t.layout)
    assert tplan.segment_work_units(t) == rplan.segment_work_units(r)


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_compile_plan_equal(kw):
    rc, tc = _cfgs(kw)
    for (hp, wp), batch in itertools.product(BUCKETS, (1, 3, 8)):
        _plan_equal(rplan.compile_plan(rc, N_STAGES, hp, wp, batch=batch),
                    tplan.compile_plan(tc, N_STAGES, hp, wp, batch=batch))


@pytest.mark.parametrize("kw", CONFIGS[:4], ids=range(4))
def test_compile_plan_subset_and_rung_equal(kw):
    rc, tc = _cfgs(kw)
    for levels, capacity in (((0, 2), None), ((1,), 512), (None, 2048)):
        _plan_equal(rplan.compile_plan(rc, N_STAGES, 96, 128, 2, levels,
                                       capacity),
                    tplan.compile_plan(tc, N_STAGES, 96, 128, 2, levels,
                                       capacity))


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_compile_level_plan_equal(kw):
    rc, tc = _cfgs(kw)
    for h, w in ((64, 64), (41, 57), (480, 640), (24, 24)):
        r = rplan.compile_level_plan(rc, N_STAGES, h, w)
        t = tplan.compile_level_plan(tc, N_STAGES, h, w)
        assert tuple(t) == tuple(r)
        assert t.key == r.key and t.n_windows == r.n_windows


def test_compile_stream_plan_equal():
    rc, tc = _cfgs({"use_pallas": True})
    for args in ((64, 64, 64, 64, 16, 1, None), (96, 128, 90, 120, 32, 0,
                                                 512)):
        r = rplan.compile_stream_plan(rc, N_STAGES, *args)
        t = tplan.compile_stream_plan(tc, N_STAGES, *args)
        assert t.key == r.key
        for f in ("hp", "wp", "h", "w", "tile", "halo", "ty", "tx",
                  "n_live", "n_slots", "decode_cap"):
            assert getattr(t, f) == getattr(r, f), f
        assert np.array_equal(t.limit_mask, r.limit_mask)
        for lr, lt in zip(r.level_tile_ranges, t.level_tile_ranges):
            assert all(np.array_equal(a, b) for a, b in zip(lr, lt))


def test_plan_keys_split_configs_into_the_same_classes():
    rkeys = [rplan.compile_plan(RConfig(**kw), N_STAGES, 64, 64).key
             for kw in CONFIGS + CONFIGS[:3]]
    tkeys = [tplan.compile_plan(TConfig(**kw), N_STAGES, 64, 64).key
             for kw in CONFIGS + CONFIGS[:3]]
    for i, j in itertools.product(range(len(rkeys)), repeat=2):
        assert (rkeys[i] == rkeys[j]) == (tkeys[i] == tkeys[j])


def test_engine_config_fields_and_defaults_equal():
    assert TConfig._fields == RConfig._fields
    assert tuple(TConfig()) == tuple(RConfig())


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_decision_functions_equal(kw):
    rc, tc = _cfgs(kw)
    assert tplan.segment_spans(N_STAGES, tc) == rplan.segment_spans(
        N_STAGES, rc)
    for n in (1, 128, 129, 2048, 5000, 10 ** 7):
        assert tplan.select_backend(tc, n) == rplan.select_backend(rc, n)
        assert tplan.select_head_mode(tc, n) == rplan.select_head_mode(rc, n)


def test_capacity_ladders_and_limits_equal():
    for n, k in ((10, 1), (1000, 4), (10 ** 6, 8)):
        for fr in ((), (0.5,), (0.3, 0.2, 0.1)):
            assert tplan.level_capacities(n, k, fr) == rplan.level_capacities(
                n, k, fr)
    rc, tc = _cfgs(CONFIGS[7])
    assert tplan.shared_capacities(5000, 8, 8, tc) == \
        rplan.shared_capacities(5000, 8, 8, rc)
    for args in ((100, 2, 7), (100, 2, 700), (10, 1, 0)):
        assert tplan.stream_capacity_rung(*args) == \
            rplan.stream_capacity_rung(*args)
    assert tplan.stream_budget(1000, 3, 0.2) == rplan.stream_budget(
        1000, 3, 0.2)
    hv, wv = np.array([64, 70, 100]), np.array([64, 90, 60])
    for lv in ((96, 96), (80, 80), (41, 41)):
        r = rplan.window_limits(hv, wv, *lv, 96, 96)
        t = tplan.window_limits(hv, wv, *lv, 96, 96)
        assert all(np.array_equal(a, b) for a, b in zip(r, t))


@pytest.mark.parametrize("bad", [
    {"capacity_fracs": (0.5, 0.5)},
    {"batch_capacity_fracs": (1.5,) * 8},
    {"tail_backend": "simd"},
    {"head_mode": "megakernel"},
    {"head_tile": (8,)},
])
def test_validate_config_rejects_what_the_reference_rejects(bad):
    rc, tc = _cfgs(bad)
    with pytest.raises(ValueError) as want:
        rplan.validate_config(N_STAGES, rc)
    with pytest.raises(ValueError) as got:
        tplan.validate_config(N_STAGES, tc)
    assert str(got.value) == str(want.value)
