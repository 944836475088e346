"""The port's calibration path against the reference, on the CPU (every
kernel's plain version): ``calibrate_capacities``, ``Detector.calibrated``
(capacity fractions and the profile's densities, exactly), ``work_profile``,
the backend race's lane sampler (the reference's lanes from the same
seed), the tail / head / lane-block races' schemas, and rects that
calibration leaves unchanged.  The reference runs with
``use_pallas=False``: its Pallas dense kernels do not run under the
installed jax.
"""

import numpy as np
import pytest
import torch

from repro.core import Detector as RDetector, EngineConfig as RConfig
from repro.core import calibrate_capacities as r_calibrate
from repro.core import cascade as rcascade
from repro.core.training.data import render_scene
from repro.kernels import packed_tail as rtail

from repro_torch.core import Detector, EngineConfig, calibrate_capacities
from repro_torch.core import cascade as tcascade
from repro_torch.kernels import autotune, packed_tail

SMALL = [3, 4, 5, 6, 8]
RCASC = rcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
TCASC = tcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
KW = dict(mode="wave", step=1, min_neighbors=2)
INV_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(3)]


@pytest.fixture(scope="module")
def ref_det():
    return RDetector(RCASC, RConfig(**KW))


@pytest.fixture(scope="module")
def port_det():
    return Detector(TCASC, EngineConfig(use_pallas=True,
                                        tail_backend="pallas", **KW),
                    device="cpu")


@pytest.fixture(scope="module")
def tuned(port_det, corpus):
    return port_det.calibrated(corpus[0], tune_tail=True,
                               tail_sizes=(64, 256), tune_head=True)


@pytest.mark.parametrize("counts,n,safety", [
    ([500, 120, 30], 1000, 2.0), ([0, 7, 7], 13, 3.0), ([5], 0, 2.0),
    ([0.25, 0.1], 1, 1.5)])
def test_calibrate_capacities_equals_reference(counts, n, safety):
    got = calibrate_capacities(np.asarray(counts), n, safety)
    assert got == r_calibrate(np.asarray(counts), n, safety)
    assert all(isinstance(f, float) for f in got)


def test_calibrated_profile_equals_reference(ref_det, port_det, corpus):
    want = ref_det.calibrated(corpus[0])
    got = port_det.calibrated(corpus[0])
    assert got.device == port_det.device
    assert got.config.capacity_fracs == want.config.capacity_fracs
    assert (got.config.batch_capacity_fracs
            == want.config.batch_capacity_fracs)
    for key in ("densities", "level_densities", "levels", "n_windows"):
        assert got.cal_profile[key] == want.cal_profile[key], key
    assert port_det.cal_profile == {}


def test_work_profile_equals_reference(ref_det, port_det, corpus):
    want = ref_det.work_profile(corpus[1])
    got = port_det.work_profile(corpus[1])
    for key in ("total_windows", "weak_evals_early_exit", "weak_evals_dense"):
        assert got[key] == want[key], key
    assert len(got["per_level"]) == len(want["per_level"])
    for g, w in zip(got["per_level"], want["per_level"]):
        assert g["scale"] == w["scale"] and g["windows"] == w["windows"]
        assert np.array_equal(g["alive_counts"], np.asarray(w["alive_counts"]))
        assert g["weak_evals_early"] == w["weak_evals_early"]


def test_build_workload_sampler_matches_reference(corpus):
    levels = [(corpus[0], 30.0), (corpus[1][:53, :53], 0.0),
              (corpus[2][:44, :40], 12.5)]
    r_flat, r_sample, r_n = rtail._build_workload(
        [(np.asarray(im), wt) for im, wt in levels],
        np.random.default_rng(5))
    t_flat, t_sample, t_n = packed_tail._build_workload(
        levels, np.random.default_rng(5), torch.device("cpu"))
    assert t_n == r_n
    np.testing.assert_allclose(t_flat.numpy(), np.asarray(r_flat), rtol=1e-6)
    for size in (7, 300, 0):
        want, got = r_sample(size), t_sample(size)
        for w, g in zip(want[:5], got[:5]):          # img, base, stride, y, x
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[5].numpy(), np.asarray(want[5]),
                                   **INV_TOL)


def test_tune_tail_ladder(tuned):
    tail = tuned.cal_profile["tail"]
    assert tuned.config.tail_backend == "auto"
    assert tuned.config.tail_rungs == tail["rungs"]
    assert [n for n, _bk in tail["rungs"]] == [64, 256]
    assert all(bk in packed_tail.BACKENDS for _n, bk in tail["rungs"])
    assert tail["crossover"] in (-1, 64, 256)
    assert tail["sizes"] == [64, 256] and tail["levels"] == 6
    assert all(len(v) == 2 and all(t > 0 for t in v)
               for v in tail["ms"].values())


def test_tune_head_ladder_and_tiles(tuned):
    head = tuned.cal_profile["head"]
    wins = [n for n, _mode in head["rungs"]]
    assert wins == sorted(wins) and len(wins) == len(head["levels"])
    assert {mode for _n, mode in head["rungs"]} <= {"fused", "split"}
    assert tuned.config.head_mode == "auto"
    assert tuned.config.head_rungs == head["rungs"]
    assert head["crossover"] == next(
        (n for n, m in head["rungs"] if m == "fused"), -1)
    assert tuned.config.head_tile == head["head_tiles"]
    assert tuned.config.head_tile in autotune.HEAD_TILE_CANDIDATES
    assert set(head["tile_ms"]) == {"8x128", "16x128", "8x256"}
    lane = tuned.cal_profile["lane"]
    assert tuned.config.lane_block == tuned.cal_profile["lane_block"]
    assert tuned.config.lane_block in autotune.LANE_BLOCK_CANDIDATES
    crossover = tuned.cal_profile["tail"]["crossover"]
    assert lane["size"] == (crossover if crossover > 0 else 2048)
    assert len(lane["ms"]) == len(autotune.LANE_BLOCK_CANDIDATES)


def test_calibrated_rects_equal_uncalibrated_and_reference(
        ref_det, port_det, tuned, corpus):
    want = [ref_det.detect(im, group=False) for im in corpus]
    assert sum(len(r) for r in want) > 0
    for det in (port_det, tuned):
        got = det.detect_batch(corpus, group=False)
        for w, g in zip(want, got):
            assert np.array_equal(g, w)
    builds = tuned.program_builds
    tuned.detect_batch(corpus, group=False)
    assert tuned.program_builds == builds > 0       # one plan, built once


def test_racers_refuse_a_headless_plan():
    with pytest.raises(ValueError, match="dense stage"):
        autotune.measure_head(TCASC, [(np.zeros((30, 30), np.float32), 1.0)],
                              n_dense=0)


def test_measure_rungs_default_workload_schema():
    small = tcascade.paper_shaped_cascade(1, stage_sizes=[2, 3])
    prof = packed_tail.measure_rungs(small, sizes=(32,), repeats=1, inner=1)
    assert prof["levels"] == 1 and prof["n_windows"] == 137 * 137
    assert set(prof["ms"]) == set(packed_tail.BACKENDS)
    assert prof["sizes"] == [32] and len(prof["rungs"]) == 1
    assert prof["crossover"] in (-1, 32)
