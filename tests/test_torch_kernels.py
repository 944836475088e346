"""The port's kernel modules against the reference, on the CPU (each
wrapper's plain version; ``tests/test_torch_cuda.py`` holds the kernels
against their plain versions on a card).

Exact where the arithmetic is the reference's (the packed tail, the
oracles, the stage sums given the reference's SAT and 1/sigma); at the
reference's own tolerances (``tests/test_kernels.py``: 1/sigma rtol 1e-4 /
atol 1e-6, stage sums rtol 1e-4 / atol 1e-3) where the port's SAT order or
the dense kernels' corner order differ from the reference oracle's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import cascade as rcascade  # noqa: E402
from repro.core import integral as rintegral  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import packed_tail as rtail  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.core import integral as tintegral  # noqa: E402
from repro_torch.kernels import autotune, native, ops, packed_tail  # noqa: E402
from repro_torch.kernels import fused_head, haar_stage, integral_image  # noqa: E402
from repro_torch.kernels import packed_window, tail_gates, window_variance  # noqa: E402
from torch_gate_cases import (GATE_IMAGES, GATE_LIVE, GATE_ORDERS,  # noqa: E402
                              GATE_STAGES, S0, gate_case, inline_formula,
                              run_gates)

SMALL = [3, 4, 5, 6, 8]
RCASC = rcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
TCASC = tcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
INV_TOL = dict(rtol=1e-4, atol=1e-6)
SUM_TOL = dict(rtol=1e-4, atol=1e-3)
TESTS = Path(__file__).resolve().parent


def _imgs(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w)
                                                ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def packed_inputs():
    """A real multi-image, multi-level packed list over reference SATs."""
    rng = np.random.default_rng(3)
    shapes = [(48, 64), (40, 53), (33, 44)]
    imgs = _imgs(2, 48, 64, seed=5)
    sats, pairs = [[], []], [[], []]
    for b in range(2):
        for h, w in shapes:
            ii, pair = rintegral.integral_images(jnp.asarray(imgs[b][:h, :w]))
            sats[b].append(np.asarray(ii).reshape(-1))
            pairs[b].append(pair)
    ii_flat = np.stack([np.concatenate(s) for s in sats])
    sizes = [(h + 1) * (w + 1) for h, w in shapes]
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n = 700
    img = rng.integers(0, 2, n)
    lvl = rng.integers(0, 3, n)
    hy = np.asarray([h - 23 for h, _ in shapes])[lvl]
    hx = np.asarray([w - 23 for _, w in shapes])[lvl]
    ys, xs = rng.integers(0, hy), rng.integers(0, hx)
    inv = np.asarray([float(rintegral.window_inv_sigma(
        pairs[i][v], jnp.asarray(y), jnp.asarray(x), 24))
        for i, v, y, x in zip(img, lvl, ys, xs)], np.float32)
    base = bases[lvl]
    stride = np.asarray([w + 1 for _, w in shapes])[lvl]
    lanes = [a.astype(np.int32) for a in (img, base, stride, ys, xs)]
    return ii_flat.astype(np.float32), lanes, inv


# -------------------------------------------------------------- S (SAT)
@pytest.mark.parametrize("bhw", [(1, 24, 24), (3, 48, 64), (2, 160, 130)])
def test_sat_tables_plain_vs_reference(bhw):
    imgs = _imgs(*bhw, seed=bhw[1])
    ii, ii2, iic = integral_image.sat_tables(_t(imgs))
    for b in range(bhw[0]):
        r_ii, r_pair = rintegral.integral_images(jnp.asarray(imgs[b]))
        np.testing.assert_allclose(ii[b].numpy(), np.asarray(r_ii),
                                   rtol=1e-6)
        np.testing.assert_allclose(ii2[b].numpy(), np.asarray(r_pair[0]),
                                   rtol=1e-6)
        np.testing.assert_allclose(iic[b].numpy(), np.asarray(r_pair[1]),
                                   rtol=1e-6, atol=1e-2)
    for got, want in zip((ii, ii2, iic), ops.sat_tables_ref(_t(imgs))):
        assert torch.equal(got, want)
    assert (ii[:, 0] == 0).all() and (ii[:, :, 0] == 0).all()
    assert np.allclose(ii[:, -1, -1].numpy(), imgs.sum(axis=(1, 2)),
                       rtol=1e-6)


@pytest.mark.parametrize("bhw", [(1, 1, 1), (2, 37, 70), (1, 33, 641)])
def test_sat_tables_plain_is_the_serial_float64_order(bhw):
    """The pinned order on non-integer input: numpy's sequential float64
    cumsum down the columns, float32 entries, then along the rows."""
    imgs = (np.random.default_rng(sum(bhw)).random(bhw) * 255.0
            ).astype(np.float32)
    got = integral_image.sat_tables_plain(_t(imgs))
    cen = imgs - np.float32(128.0)
    for g, x in zip(got, (imgs, cen * cen, cen)):
        cols = np.cumsum(x.astype(np.float64), axis=1).astype(np.float32)
        rows = np.cumsum(cols.astype(np.float64), axis=2).astype(np.float32)
        want = np.pad(rows, ((0, 0), (1, 0), (1, 0)))
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), want)


@pytest.mark.parametrize("hw", [(24, 24), (64, 128), (96, 96)])
def test_integral_image_wrappers_vs_reference(hw):
    imgs = _imgs(2, *hw, seed=hw[0])
    batch = ops.integral_image_batch(_t(imgs))
    assert torch.equal(batch, ops.integral_image_batch_ref(_t(imgs)))
    for b in range(2):
        want = np.asarray(rops.integral_image(jnp.asarray(imgs[b]),
                                              use_kernel=False))
        one = ops.integral_image(_t(imgs[b]))
        np.testing.assert_allclose(one.numpy(), want, rtol=1e-6)
        assert torch.equal(one, batch[b])
        assert torch.equal(one, ops.integral_image_ref(_t(imgs[b])))
    want = np.asarray(rops.integral_image_batch(jnp.asarray(imgs),
                                                use_kernel=False))
    np.testing.assert_allclose(batch.numpy(), want, rtol=1e-6)


# ----------------------------------------------------------- D (1/sigma)
def _ref_pair(h, w, seed):
    img = _imgs(1, h, w, seed=seed)[0]
    _ii, pair = rintegral.integral_images(jnp.asarray(img))
    return pair


# the sweep's shapes (benchmarks/bench_kernels.py), a single window, and a
# grid reaching past the tables (the reference wrapper's edge padding)
@pytest.mark.parametrize("h,w,ny,nx", [(24, 24, 1, 1), (64, 128, 41, 105),
                                       (96, 96, 73, 73),
                                       (128, 256, 105, 233),
                                       (50, 60, 40, 52)])
def test_window_inv_sigma_grid_plain_vs_reference(h, w, ny, nx):
    pair = _ref_pair(h, w, seed=h + w)
    got = ops.window_inv_sigma_grid(_t(pair), ny, nx)
    assert got.shape == (ny, nx) and got.dtype == torch.float32
    want = np.asarray(rops.window_inv_sigma_grid(pair, ny, nx,
                                                 use_kernel=False))
    np.testing.assert_allclose(got.numpy(), want, **INV_TOL)
    oracle = np.asarray(rref.window_inv_sigma_grid_ref(pair, ny, nx))
    np.testing.assert_allclose(got.numpy(), oracle, **INV_TOL)
    # the twin repeats the (eager) reference oracle's arithmetic exactly
    twin = ops.window_inv_sigma_grid_ref(_t(pair), ny, nx)
    assert np.array_equal(twin.numpy(), oracle)


def test_window_inv_sigma_grid_batch_equals_single():
    pairs = np.stack([np.asarray(_ref_pair(70, 90, seed=s))
                      for s in range(3)])
    batch = ops.window_inv_sigma_grid_batch(_t(pairs), 47, 67)
    for b in range(3):
        assert torch.equal(batch[b],
                           ops.window_inv_sigma_grid(_t(pairs[b]), 47, 67))
    want = np.asarray(rref.window_inv_sigma_grid_batch_ref(
        jnp.asarray(pairs), 47, 67))
    np.testing.assert_allclose(batch.numpy(), want, **INV_TOL)
    twin = ops.window_inv_sigma_grid_batch_ref(_t(pairs), 47, 67)
    assert np.array_equal(twin.numpy(), want)
    # the plain version reads the strided slices of the stacked pairs
    strided = window_variance.inv_sigma_grid_plain(
        _t(pairs)[:, 0], _t(pairs)[:, 1], 47, 67)
    assert torch.equal(strided, batch)


def test_window_inv_sigma_grid_vs_kernel_a_plain():
    """Kernel D's plain version against kernel A's 1/sigma on one SAT: the
    corner orders differ ((d - b) - (c - a) vs d - b - c + a), so they
    agree to tolerance, not bit for bit."""
    ii, ii2, iic = ops.sat_tables(_t(_imgs(2, 60, 80, seed=11)))
    inv_a, _sums = fused_head.tile_pass(TCASC, 0, 1, ii, ii2, iic)
    inv_d = window_variance.inv_sigma_grid(ii2, iic, 37, 57)
    np.testing.assert_allclose(inv_d.numpy(), inv_a.numpy(), **INV_TOL)


# ------------------------------------------------------------ A (fused)
@pytest.mark.parametrize("hw,run", [((40, 56), (0, 3)), ((64, 96), (0, 2)),
                                    ((64, 96), (1, 4))])
def test_fused_head_plain_vs_reference_oracle(hw, run):
    img = _imgs(1, *hw, seed=hw[1])[0]
    r_ii, r_inv, r_sums = rops.fused_head_ref(RCASC, RCASC, *run,
                                              jnp.asarray(img))
    ii, inv, sums = ops.fused_head(TCASC, *run, _t(img))
    np.testing.assert_allclose(ii.numpy(), np.asarray(r_ii), rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(r_inv), **INV_TOL)
    np.testing.assert_allclose(sums.numpy(), np.asarray(r_sums), **SUM_TOL)
    _, t_inv, t_sums = ops.fused_head_ref(TCASC, *run, _t(img))
    assert torch.equal(inv, t_inv)
    np.testing.assert_allclose(sums.numpy(), t_sums.numpy(), **SUM_TOL)


def test_fused_head_batch_equals_single_and_split():
    imgs = _t(_imgs(3, 48, 60, seed=2))
    ii, inv, sums = ops.fused_head_batch(TCASC, 0, 3, imgs)
    for b in range(3):
        one = ops.fused_head(TCASC, 0, 3, imgs[b])
        assert all(torch.equal(x[b], y) for x, y in zip((ii, inv, sums), one))
    # the split head over kernel S's tables gives the same bits
    s_ii, ii2, iic = ops.sat_tables(imgs)
    s_inv = tintegral.window_inv_sigma(
        (ii2, iic), torch.arange(25)[:, None], torch.arange(37)[None, :], 24)
    assert torch.equal(s_ii, ii) and torch.equal(s_inv, inv)
    for s in range(3):
        got = ops.dense_stage_sums_batch(TCASC, s, s_ii, s_inv)
        assert torch.equal(got, sums[:, s])
        np.testing.assert_allclose(
            got.numpy(), ops.dense_stage_sums_batch_ref(TCASC, s, s_ii,
                                                        s_inv).numpy(),
            **SUM_TOL)
    b_ref = ops.fused_head_batch_ref(TCASC, 0, 3, imgs)
    np.testing.assert_allclose(sums.numpy(), b_ref[2].numpy(), **SUM_TOL)


# ------------------------------------------------------------ B (dense)
@pytest.mark.parametrize("stage", range(len(SMALL)))
def test_dense_stage_sums_given_reference_sat(stage):
    img = _imgs(1, 64, 80, seed=stage)[0]
    r_ii, r_pair = rintegral.integral_images(jnp.asarray(img))
    r_inv = rops.window_inv_sigma_grid(r_pair, 41, 57, use_kernel=False)
    want = np.asarray(rops.dense_stage_sums_ref(RCASC, RCASC, stage, r_ii,
                                                r_inv))
    got = ops.dense_stage_sums(TCASC, stage, _t(r_ii), _t(r_inv))
    np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)
    twin = ops.dense_stage_sums_ref(TCASC, stage, _t(r_ii), _t(r_inv))
    assert np.array_equal(twin.numpy(), want)


def test_dense_oracle_twins_exact():
    img = _imgs(1, 50, 50, seed=9)[0]
    r_ii, r_pair = rintegral.integral_images(jnp.asarray(img))
    want = np.asarray(rref.window_inv_sigma_ref(r_pair[0], r_pair[1], 27, 27))
    from repro_torch.kernels import ref as tref
    got = tref.window_inv_sigma_ref(_t(r_pair[0]), _t(r_pair[1]), 27, 27)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(tref.integral_image_ref(_t(img)),
                       tintegral.integral_image(_t(img))[1:, 1:])
    b = ops.dense_stage_sums_batch(TCASC, 1, _t(np.stack([r_ii] * 2)),
                                   _t(np.stack([want] * 2)))
    assert torch.equal(b[0], b[1])


# ----------------------------------------------------------- C (packed)
@pytest.mark.parametrize("run", [(0, 5), (2, 4), (4, 5)])
def test_packed_stage_sums_exact_vs_reference_kernel(packed_inputs, run):
    ii_flat, lanes, inv = packed_inputs
    want = np.asarray(rops.packed_stage_sums(
        RCASC, RCASC, *run, jnp.asarray(ii_flat),
        *[jnp.asarray(a) for a in lanes], jnp.asarray(inv), interpret=True))
    got = ops.packed_stage_sums(TCASC, *run, _t(ii_flat),
                                *[_t(a) for a in lanes], _t(inv))
    assert np.array_equal(got.numpy(), want)
    twin = ops.packed_stage_sums_ref(TCASC, *run, _t(ii_flat),
                                     *[_t(a) for a in lanes], _t(inv))
    assert np.array_equal(twin.numpy(), want)


@pytest.mark.parametrize("backend", ["gather", "bulk", "pallas"])
def test_packed_tail_backends_exact_vs_reference(packed_inputs, backend):
    ii_flat, lanes, inv = packed_inputs
    want = np.asarray(rtail.stage_sums(
        RCASC, RCASC, 1, 4, jnp.asarray(ii_flat),
        *[jnp.asarray(a) for a in lanes], jnp.asarray(inv), backend=backend,
        interpret=True))
    got = packed_tail.stage_sums(TCASC, 1, 4, _t(ii_flat),
                                 *[_t(a).long() for a in lanes], _t(inv),
                                 backend=backend)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_live", [0, 1, 699, 700, 701, 10 ** 9])
@pytest.mark.parametrize("backend", ["gather", "bulk", "pallas"])
def test_packed_tail_backends_zero_past_live(packed_inputs, backend,
                                             n_live):
    """With a live count (cap = 700) every backend gives the no-count
    call's bits on the live prefix and 0 past it."""
    ii_flat, lanes, inv = packed_inputs
    args = (TCASC, 1, 4, _t(ii_flat), *[_t(a).long() for a in lanes],
            _t(inv))
    full = packed_tail.stage_sums(*args, backend=backend)
    got = packed_tail.stage_sums(*args, backend=backend,
                                 n_live=torch.tensor(n_live))
    m = min(n_live, full.shape[1])
    assert got.shape == full.shape
    assert torch.equal(got[:, :m], full[:, :m])
    assert not got[:, m:].any()


def test_kernel_c_block_shapes():
    """lane_block (r, c) -> (lanes per thread, threads per block)."""
    assert packed_window.block_shape(None) == packed_window.block_shape(
        autotune.DEFAULT_TILE)
    want = {(8, 128): (8, 128), (16, 128): (16, 128), (8, 256): (8, 256)}
    assert {c: packed_window.block_shape(c)
            for c in autotune.LANE_BLOCK_CANDIDATES} == want
    assert packed_window.block_shape((3, 100)) == (3, 96)
    assert packed_window.block_shape((64, 4096)) == (64, 1024)
    assert packed_window.block_shape((1, 1)) == (1, 32)


def test_measure_lane_block_launches_each_candidate(monkeypatch):
    seen = []
    real = packed_window.stage_sums

    def spy(*args, lane_block=None, **kw):
        seen.append(lane_block)
        return real(*args, lane_block=lane_block, **kw)

    monkeypatch.setattr(packed_window, "stage_sums", spy)
    out = autotune.measure_lane_block(TCASC, size=32, repeats=1, inner=1)
    cands = [tuple(c) for c in autotune.LANE_BLOCK_CANDIDATES]
    assert out["candidates"] == cands and len(out["ms"]) == len(cands)
    assert out["lane_block"] in cands
    assert set(seen) == set(cands)
    for c in cands:        # a warm-up call and the timed one, per candidate
        assert seen.count(c) == 2


def test_packed_plain_clamps_out_of_range_lanes(packed_inputs):
    ii_flat, lanes, inv = packed_inputs
    far = [a.copy() for a in lanes]
    far[3][:5] = 10 ** 6                  # rows far past the SAT
    out = packed_window.stage_sums_plain(TCASC, 0, 2, _t(ii_flat),
                                         *[_t(a) for a in far], _t(inv))
    assert torch.isfinite(out).all()


def test_unknown_backend_raises():
    lanes = [torch.zeros(1, dtype=torch.long)] * 5
    with pytest.raises(ValueError, match="backend"):
        # repro: ignore[TAIL_BACKEND] deliberately invalid backend: this test pins the rejection
        packed_tail.stage_sums(TCASC, 0, 1, torch.zeros(1, 4), *lanes, torch.zeros(1), backend="simd")  # repro_torch: ignore[TAIL_BACKEND] pins the rejection


# ------------------------------------------------ tail gates (kernel E)
@pytest.mark.parametrize("order", GATE_ORDERS)
@pytest.mark.parametrize("live", GATE_LIVE)
@pytest.mark.parametrize("n_img", GATE_IMAGES)
@pytest.mark.parametrize("k", GATE_STAGES)
def test_tail_gate_counts_equal_twin_and_inline_formula(k, n_img, live,
                                                        order):
    """The wrapper and its twin gate the mask and add each image's
    survivors per stage to the segment's rows exactly as the tail's old
    per-stage ``index_add_`` did, in place, for any order of the image
    indices and any live count; the other rows stay as they were."""
    case = gate_case(k, n_img, live, order)
    want_valid, want_counts = inline_formula(case, k)
    for fn in (ops.tail_gate_counts, ops.tail_gate_counts_ref):
        out, valid, counts = run_gates(fn, case, k)
        assert out is valid
        assert torch.equal(valid, want_valid)
        assert torch.equal(counts, want_counts)
    m = min(int(case["n_live"]), case["ss"].shape[1])
    assert not want_valid[m:].any()
    rest = [s for s in range(counts.shape[0]) if not S0 <= s < S0 + k]
    assert torch.equal(counts[rest], case["counts"][rest])


def test_tail_gate_counts_refuses_other_devices_and_launches_nothing():
    case = gate_case(3, 3, "mid", "sorted")
    ops.reset_launches()
    run_gates(tail_gates.gate_counts, case, 3)
    assert ops.launches()["tail_gates"] == 0
    meta = {n: t.to("meta") for n, t in case.items()}
    with pytest.raises(ValueError, match="CUDA"):
        run_gates(tail_gates.gate_counts, meta, 3)


# -------------------------------------------------------- wrapper rules
def test_wrappers_refuse_other_devices_and_count_only_launches():
    ops.reset_launches()
    imgs = torch.zeros(1, 30, 30)
    ii, ii2, iic = ops.sat_tables(imgs)
    inv, _sums = fused_head.tile_pass(TCASC, 0, 1, ii, ii2, iic)
    haar_stage.stage_sums(TCASC, 0, ii, inv)
    window_variance.inv_sigma_grid(ii2, iic, 7, 7)
    assert set(ops.launches().values()) == {0}    # plain versions: no launch
    with pytest.raises(ValueError, match="CUDA"):
        integral_image.sat_tables(imgs.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        window_variance.inv_sigma_grid(ii2.to("meta"), iic.to("meta"), 7, 7)
    with pytest.raises(ValueError, match="CUDA"):
        haar_stage.stage_sums(TCASC, 0, ii.to("meta"), inv.to("meta"))


def test_every_public_wrapper_has_a_twin_and_a_race_test():
    names = [n for n in ops.__all__ if not n.endswith("_ref")
             and n not in ("launches", "reset_launches")]
    text = "".join(p.read_text() for p in TESTS.glob("test_torch_*.py"))
    for n in names:
        assert f"{n}_ref" in ops.__all__ and callable(getattr(ops, f"{n}_ref"))
        assert re.search(rf"\b{n}\b", text) and f"{n}_ref" in text, n


def test_build_flags_pin_ieee_arithmetic():
    flags = " ".join(native.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "fast_math" not in flags
    assert sorted(native.SOURCES) == sorted(
        p.name for p in native.CSRC.glob("*.cu"))
    assert set(native.KERNELS) == {Path(s).stem for s in native.SOURCES}
    assert native.BUILD_DIR.relative_to(native.CSRC.parents[2])
