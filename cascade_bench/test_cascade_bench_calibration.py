"""The calibrated cascade and the reference's rounding band.

The configuration's ``.npz`` is the frozen generator's stumps with the
polarities and thresholds that ``calibrate.py`` sets; its first stages
are derived again here.  The band counts the decisions that a change of
the corner or scale order could flip."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cascade_bench import calibrate
from cascade_bench.frozen.scenes import render_scene
from cascade_bench.frozen.stumps import FIELDS, stump_cascade
from cascade_bench.reference import stump_cascade as REF

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
CONFIG = json.loads((HERE / "configs" / "vj-default-25x2913.json").read_text())
NPZ = HERE / "configs" / CONFIG["cascade"]["npz"]


def stored() -> dict:
    with np.load(NPZ, allow_pickle=False) as z:
        return {f: z[f] for f in FIELDS}


def test_the_npz_is_the_generators_stumps_with_polarities_and_thresholds():
    assert hashlib.sha256(NPZ.read_bytes()).hexdigest() == \
        CONFIG["cascade"]["sha256"]
    mine, gen = stored(), stump_cascade(0, CONFIG["cascade"]["stage_sizes"])
    for f in ("rect_xywh", "rect_w", "wc_threshold", "stage_offsets"):
        assert np.array_equal(mine[f], gen[f]), f
    pair = np.sort(np.stack([gen["left_val"], gen["right_val"]]), axis=0)
    assert np.array_equal(np.sort(np.stack([mine["left_val"],
                                            mine["right_val"]]), axis=0),
                          pair)
    assert not np.array_equal(mine["stage_threshold"],
                              gen["stage_threshold"])


def test_the_first_stages_calibrate_again_to_the_stored_values():
    cal = CONFIG["cascade"]["calibration"]
    assert (cal["min_hit_rate"], cal["max_false_alarm_rate"]) == (
        calibrate.MIN_HIT_RATE, calibrate.MAX_FALSE_ALARM_RATE)
    again = calibrate.from_config(CONFIG, stages=3)
    mine = stored()
    k = int(mine["stage_offsets"][3])
    for f in ("left_val", "right_val"):
        assert np.array_equal(again[f][:k], mine[f][:k]), f
    assert np.array_equal(again["stage_threshold"][:3],
                          mine["stage_threshold"][:3])


def test_the_calibrated_stages_keep_faces_and_reject_backgrounds():
    cal = dict(CONFIG["cascade"]["calibration"], positives=64,
               negatives=2048, images=2, h=120, w=160)
    arrays = stored()
    off = arrays["stage_offsets"]
    for s in range(3):
        ks = np.arange(off[s], off[s + 1])
        theta = arrays["wc_threshold"][ks]

        def sums(win):
            left = calibrate.features(win, arrays, ks) < theta
            return np.where(left, arrays["left_val"][ks],
                            arrays["right_val"][ks]).sum(1)
        hit = (sums(calibrate.positives(cal))
               >= arrays["stage_threshold"][s]).mean()
        fa = (sums(calibrate.negatives(cal))
              >= arrays["stage_threshold"][s]).mean()
        assert hit > 0.85 and fa < 0.65, (s, hit, fa)


def test_ulp_is_float32s():
    x = torch.tensor([1.0, 8e7, 0.75, -3.0])
    assert REF._ulp(x).tolist() == [2.0 ** -23, 8.0, 2.0 ** -24, 2.0 ** -22]


@pytest.mark.parametrize("ulps,expect", [(0, "none"), (None, "some"),
                                         (1 << 30, "all")])
def test_the_band_widens_with_the_rounding_it_allows(monkeypatch, ulps,
                                                     expect):
    arrays = stump_cascade(5, [2, 3, 4])
    img = render_scene(np.random.default_rng(4), 60, 80, n_faces=1,
                       face_sizes=(24, 30))[0]
    engine = dict(CONFIG["engine"], dense_segments=[1, 1])
    if ulps is not None:
        for name in ("RECT_ULPS", "FEAT_ULPS", "SCALE_ULPS", "VOTE_ULPS"):
            monkeypatch.setattr(REF, name, ulps)
    r = REF.detect([img], arrays, engine, torch.device("cpu"))[0]
    evals = int(r["entering"].sum())
    if expect == "none":
        assert r["band_evals"] == 0 and len(r["band_rects"]) == 0
    elif expect == "some":
        assert 0 < r["band_evals"] < evals
    else:
        assert r["band_evals"] == evals
        got = {tuple(x) for x in r["band_rects"].tolist()}
        assert {tuple(x) for x in r["rects"].tolist()} <= got
    plain = REF.detect([img], arrays, engine, torch.device("cpu"),
                       dtype=torch.float64)[0]
    assert plain["band_evals"] == 0 and len(plain["band_rects"]) == 0
