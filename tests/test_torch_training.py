"""The port's cascade training (``repro_torch.core.training``) and the last
core functions (``save_cascade``, ``build_pyramid``, ``integral_value``)
on the CPU, against the reference (``repro.core``) on the same seeded
inputs.

- npz files round-trip both ways between the packages; pyramid levels are
  index-equal; the integral value agrees to float32 rounding;
- the procedural corpus is bit for bit the reference's, and leaves the
  generator in the same state;
- the feature pool is equal, feature values agree within rtol 1e-4 (the
  reference's own 1/sigma tolerance, ``tests/test_kernels.py``) and atol
  1e-5 (values near zero: the two SAT orders round entries up to 146,880,
  an ulp of 1/64, before the division by 576 sigma);
- the stump search picks the reference's feature, polarity and threshold
  bits on the reference's own feature values;
- a trained cascade has the reference's stages, weak classifiers, features
  and polarities.  Thresholds, votes and stage thresholds agree within
  rtol 1e-4 up to the first round where the two packages split an exact
  tie differently: with equal positive and negative counts the boosting
  weights take few distinct values, so two split points of one feature
  often have the same error in exact arithmetic, and each package's
  float32 cumulative sums (``jnp.cumsum``'s order, the port's float64 sums
  rounded per entry) break the tie.  The test shows that such a round is
  a tie: both choices have the same error in float64 on the round's
  weights.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import cascade as r_cascade  # noqa: E402
from repro.core import integral as r_integral  # noqa: E402
from repro.core import pyramid as r_pyramid  # noqa: E402
from repro.core.training import adaboost as R  # noqa: E402
from repro.core.training import data as r_data  # noqa: E402

from repro_torch.core import (build_pyramid, integral_value,  # noqa: E402
                              load_cascade, paper_shaped_cascade,
                              save_cascade)
from repro_torch.core.training import adaboost as T  # noqa: E402
from repro_torch.core.training import data as t_data  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# tests/test_adaboost.py's tiny config
TINY = dict(n_stages=2, n_pos=120, n_neg=120, max_features=300,
            max_weak_per_stage=8, stage_fpr=0.5, stage_dr=0.98, seed=5,
            verbose=False)
FV_TOL = dict(rtol=1e-4, atol=1e-5)
RTOL = 1e-4


# ------------------------------------------------------------ core functions
def test_npz_round_trips_both_ways(tmp_path):
    meta = {"config": {"n_stages": 5}, "note": "round trip"}
    port = paper_shaped_cascade(0, stage_sizes=[3, 4, 5])
    save_cascade(str(tmp_path / "port.npz"), port, meta)
    ref, ref_meta = r_cascade.load_cascade(str(tmp_path / "port.npz"))
    assert ref_meta == meta
    for f, a in port.numpy().items():
        b = np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f

    ref = r_cascade.paper_shaped_cascade(1, stage_sizes=[2, 6])
    r_cascade.save_cascade(str(tmp_path / "ref.npz"), ref, meta)
    back, back_meta = load_cascade(str(tmp_path / "ref.npz"))
    assert back_meta == meta and back.bounds == (0, 2, 8)
    for f, a in back.numpy().items():
        assert np.array_equal(a, np.asarray(getattr(ref, f))), f
    save_cascade(str(tmp_path / "empty_meta.npz"), back)
    assert load_cascade(str(tmp_path / "empty_meta.npz"))[1] == {}


@pytest.mark.parametrize("hw,scale", [((64, 80), 1.2), ((96, 50), 1.3),
                                      ((23, 40), 1.2)])
def test_build_pyramid_levels_equal(hw, scale):
    img = np.random.default_rng(2).integers(0, 256, hw).astype(np.float32)
    got = build_pyramid(torch.from_numpy(img), scale)
    want = r_pyramid.build_pyramid(jnp.asarray(img), scale)
    assert len(got) == len(want)
    for (g, g_lv), (w, w_lv) in zip(got, want):
        assert tuple(g_lv) == tuple(w_lv)
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["integer", "fractional"])
def test_integral_value_matches_reference(kind):
    rng = np.random.default_rng(4)
    img = rng.random((120, 160)) * 255.0
    if kind == "integer":
        img = np.floor(img)
    img = img.astype(np.float32)
    got = integral_value(torch.from_numpy(img))
    want = np.asarray(r_integral.integral_value(jnp.asarray(img)))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    if kind == "integer":       # exact: the sum stays below 2^24
        assert float(got) == float(img.astype(np.float64).sum())


# ------------------------------------------------------------- the corpus
def _rng_pair(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("fn", ["make_decoy", "sample_negative",
                                "make_face", "make_background"])
def test_window_generators_bit_equal(fn):
    a, b = _rng_pair(17)
    for _ in range(40):
        if fn == "make_background":
            got, want = (getattr(m, fn)(r, 30, 20)
                         for m, r in ((t_data, a), (r_data, b)))
        else:
            got, want = (getattr(m, fn)(r) for m, r in ((t_data, a),
                                                        (r_data, b)))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)
    assert a.bit_generator.state == b.bit_generator.state


def test_window_dataset_bit_equal():
    a, b = _rng_pair(23)
    got = t_data.window_dataset(a, 30, 40, decoy_frac=0.5)
    want = r_data.window_dataset(b, 30, 40, decoy_frac=0.5)
    assert isinstance(got, t_data.FaceCorpus)
    assert got._fields == want._fields
    assert np.array_equal(got.windows, want.windows)
    assert np.array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert a.bit_generator.state == b.bit_generator.state


# ------------------------------------------------------------ features
@pytest.mark.parametrize("kw", [dict(max_features=300, seed=5),
                                dict(feature_stride=2, size_stride=4,
                                     max_features=100000),
                                dict(max_features=3500, seed=7)])
def test_feature_pool_equal(kw):
    got = T.feature_pool(T.TrainConfig(**kw))
    want = R.feature_pool(R.TrainConfig(**kw))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.fixture(scope="module")
def windows_and_values():
    """60 + 60 seeded windows, the tiny config's pool, and the
    reference's feature values of them."""
    rx, rw = R.feature_pool(R.TrainConfig(max_features=300, seed=5))
    corpus = r_data.window_dataset(np.random.default_rng(3), 60, 60)
    return corpus, rx, rw, R.feature_values(corpus.windows, rx, rw)


def test_feature_values_within_tolerance(windows_and_values):
    corpus, rx, rw, want = windows_and_values
    got = T.feature_values(corpus.windows, rx, rw, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **FV_TOL)


def test_feature_values_need_a_card_or_an_explicit_cpu(windows_and_values):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    corpus, rx, rw, _ = windows_and_values
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.feature_values(corpus.windows[:2], rx, rw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.train_cascade(T.TrainConfig(**TINY))


def _stump_of(module, vals, y, w):
    """One round of ``module._best_stump`` on host arrays, as numpy."""
    if module is R:
        jv = jnp.asarray(vals)
        order = jnp.argsort(jv, axis=0)
        out = R._best_stump(jnp.take_along_axis(jv, order, axis=0), order,
                            jnp.asarray(w), jnp.asarray(y))
    else:
        vs, order = torch.sort(torch.from_numpy(vals.copy()), dim=0,
                               stable=True)
        out = T._best_stump(vs, order, torch.from_numpy(w),
                            torch.from_numpy(y))
    return [np.asarray(x) for x in out]


def _eps64(vals, y, w, feat, theta, pol):
    """Weighted error of one stump in float64."""
    v = vals[:, feat]
    pred = (v < theta) if pol == 1 else (v > theta)
    return float(np.asarray(w, np.float64)[pred != (y == 1)].sum())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_best_stump_takes_reference_choice(windows_and_values, seed):
    """On the reference's feature values and seeded weights: the same
    feature, polarity, threshold bits and predictions; eps within float32
    rounding (the two cumulative sums round differently)."""
    corpus, _rx, _rw, vals = windows_and_values
    y = corpus.labels
    w = np.random.default_rng(seed).dirichlet(np.ones(len(y)))
    w = w.astype(np.float32)
    t_eps, t_f, t_theta, t_pol, t_pred = _stump_of(T, vals, y, w)
    r_eps, r_f, r_theta, r_pol, r_pred = _stump_of(R, vals, y, w)
    assert (int(t_f), int(t_pol)) == (int(r_f), int(r_pol))
    assert t_theta.dtype == r_theta.dtype == np.float32
    assert t_theta.tobytes() == r_theta.tobytes()
    assert np.array_equal(t_pred, r_pred)
    np.testing.assert_allclose(t_eps, r_eps, rtol=1e-5)
    assert _eps64(vals, y, w, int(t_f), t_theta, int(t_pol)) == \
        pytest.approx(float(t_eps), rel=1e-5)


def test_best_stump_initial_weights_same_feature_or_tie(windows_and_values):
    """Round 0's weights (equal per class) tie many split points; the
    packages agree on the feature and polarity, and their thresholds are
    equal or have the same float64 error."""
    corpus, _rx, _rw, vals = windows_and_values
    y = corpus.labels
    w = np.full(len(y), 1.0 / len(y), np.float32)
    t_eps, t_f, t_theta, t_pol, _ = _stump_of(T, vals, y, w)
    r_eps, r_f, r_theta, r_pol, _ = _stump_of(R, vals, y, w)
    assert (int(t_f), int(t_pol)) == (int(r_f), int(r_pol))
    if t_theta.tobytes() != r_theta.tobytes():
        assert _eps64(vals, y, w, int(t_f), t_theta, int(t_pol)) == \
            pytest.approx(_eps64(vals, y, w, int(r_f), r_theta, int(r_pol)),
                          abs=1e-6)


# ------------------------------------------------------------- training
@pytest.fixture(scope="module")
def trained():
    """The tiny config trained by both packages; the port's run records
    every round's stump inputs and choice."""
    rounds = []
    real = T._best_stump

    def spy(vals_sorted, order, w, y):
        out = real(vals_sorted, order, w, y)
        vals = torch.empty_like(vals_sorted).scatter_(0, order, vals_sorted)
        rounds.append((vals.numpy(), y.numpy(), w.numpy(),
                       int(out[1]), out[2].numpy(), int(out[3])))
        return out

    T._best_stump = spy
    try:
        port = T.train_cascade(T.TrainConfig(**TINY), device="cpu")
    finally:
        T._best_stump = real
    return port, R.train_cascade(R.TrainConfig(**TINY)), rounds


def _stumps(arrays, pool_rx):
    """[(feature index, polarity, theta, alpha), ...] of a cascade."""
    out = []
    for k in range(len(arrays["wc_threshold"])):
        feat = int(np.flatnonzero((pool_rx == arrays["rect_xywh"][k])
                                  .all(axis=(1, 2)))[0])
        pol = 1 if arrays["left_val"][k] != 0 else -1
        alpha = max(arrays["left_val"][k], arrays["right_val"][k])
        out.append((feat, pol, arrays["wc_threshold"][k], alpha))
    return out


def test_train_cascade_matches_reference(trained):
    (port, info), (ref, r_info), rounds = trained
    t_arr = port.numpy()
    r_arr = {f: np.asarray(getattr(ref, f)) for f in t_arr}
    assert port.rect_xywh.device.type == "cpu"
    assert set(info) == set(r_info)
    assert info["pool_size"] == r_info["pool_size"]
    assert np.array_equal(t_arr["stage_offsets"], r_arr["stage_offsets"])
    assert np.array_equal(t_arr["rect_xywh"], r_arr["rect_xywh"])
    assert np.array_equal(t_arr["rect_w"], r_arr["rect_w"])
    pool_rx, _ = T.feature_pool(T.TrainConfig(**TINY))
    t_st, r_st = _stumps(t_arr, pool_rx), _stumps(r_arr, pool_rx)
    assert [s[:2] for s in t_st] == [s[:2] for s in r_st]
    assert len(rounds) == len(t_st)
    # the first stump whose threshold or vote is off by more than rtol is
    # an exact tie on the port's weights of that round; before it, every
    # value and every stage threshold agrees
    off = [k for k, (t, r) in enumerate(zip(t_st, r_st))
           if not np.allclose(t[2:], r[2:], rtol=RTOL, atol=0)]
    first = off[0] if off else len(t_st)
    if off:
        vals, y, w, feat, theta, pol = rounds[first]
        assert _eps64(vals, y, w, feat, theta, pol) == pytest.approx(
            _eps64(vals, y, w, feat, r_st[first][2], pol), abs=1e-6)
    bounds = t_arr["stage_offsets"]
    done = [s for s in range(len(bounds) - 1) if bounds[s + 1] <= first]
    np.testing.assert_allclose(t_arr["stage_threshold"][done],
                               r_arr["stage_threshold"][done], rtol=RTOL)
    for s in done:
        assert info["stages"][s] == r_info["stages"][s]


def test_training_meets_stage_targets(trained):
    (casc, info), _ref, _rounds = trained
    assert casc.n_stages >= 1
    assert info["overall_dr"] >= 0.9
    assert info["overall_fpr"] <= 0.5 ** casc.n_stages + 0.1


def test_eq4_product_rule(trained):
    """Overall DR/FPR ≈ per-stage products (paper Eq. 4)."""
    (_casc, info), _ref, _rounds = trained
    drs = [s["dr"] for s in info["stages"]]
    fprs = [s["fpr"] for s in info["stages"]]
    assert info["overall_dr"] <= np.prod(drs) + 0.05
    assert info["overall_fpr"] <= np.prod(fprs) + 0.05


def test_training_imports_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.core.training; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
