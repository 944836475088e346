"""The port's streaming slice against the reference, on the CPU: stream
geometry field by field, the host tile planner, the tile-change functions
and their twins, the packed 1/sigma, the synthetic corpus, and whole
threshold-0 streams (``FrameStats`` and rects) over every scenario.  Then
the host-planned path's own contracts, as the reference's
``tests/test_stream.py`` states them: bit-identity with per-frame
``detect``, skips, keyframes, the capacity ladder, fallbacks, level
subsets, and the batched incremental tail.  Plus the dense-order prefix of
the packed tail (``s_dense``) that keeps a recomputed window's decisions
those of ``detect``'s kernel head."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import Detector as RDetector, EngineConfig as RConfig  # noqa: E402
from repro.core import paper_shaped_cascade as r_cascade  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.plan import StreamGeometry as RGeometry  # noqa: E402
from repro.stream import (VideoDetector as RVideo, StreamConfig as RStream,  # noqa: E402
                          make_video as r_make_video)
from repro.stream import tiles as rtiles  # noqa: E402
from repro.stream.engine import _packed_inv_sigma as r_packed_inv_sigma  # noqa: E402

from repro_torch.core import Detector, EngineConfig, paper_shaped_cascade  # noqa: E402
from repro_torch.core.cascade import WINDOW  # noqa: E402
from repro_torch.core.integral import (div_rn, integral_images,  # noqa: E402
                                      window_inv_sigma)
from repro_torch.core.pyramid import downscale_indices  # noqa: E402
from repro_torch.kernels import haar_stage, ops, packed_tail  # noqa: E402
from repro_torch.plan import (STREAM_CAP_BASE, StreamGeometry, compile_plan,  # noqa: E402
                              dense_on_kernels)
from repro_torch.stream import (SCENARIOS, StreamConfig, StreamEngine,  # noqa: E402
                                VideoDetector, changed_window_mask,
                                dilate_tiles, level_windows_from_raw,
                                make_video, tile_change_scores,
                                tile_grid_shape)
from repro_torch.stream.engine import _packed_inv_sigma  # noqa: E402

SMALL = [3, 4, 5, 6, 8]
KW = dict(mode="wave", step=2, scale_factor=1.3, min_neighbors=2)
HW = 96
CFG = StreamConfig(tile=12, keyframe_interval=4)


@pytest.fixture(scope="module")
def det():
    return Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                    EngineConfig(**KW), device="cpu")


@pytest.fixture(scope="module")
def rdet():
    return RDetector(r_cascade(0, stage_sizes=SMALL), RConfig(**KW))


@pytest.fixture(scope="module")
def engine(det):
    # one shared engine, as the reference's tests share jitted programs
    return StreamEngine(det, StreamConfig().max_changed_frac)


def _stream(det, engine, **cfg):
    return VideoDetector(det, StreamConfig(**cfg), engine=engine)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------- port vs reference
@pytest.mark.parametrize("pad,h,w", [(0, HW, HW), (64, 48, 64)])
def test_geometry_equals_reference(det, rdet, pad, h, w):
    if pad:
        det = Detector(det.cascade, det.config._replace(pad_multiple=pad),
                       device="cpu")
        rdet = RDetector(rdet.cascade, rdet.config._replace(pad_multiple=pad))
    hp, wp = det._bucket_hw(h, w)
    assert (hp, wp) == rdet._bucket_hw(h, w)
    got, want = StreamGeometry(det, hp, wp), RGeometry(rdet, hp, wp)
    assert got.plan == want.plan and got.step == want.step
    assert got.level_windows == want.level_windows
    assert got.slot_offsets == want.slot_offsets
    assert got.n_slots == want.n_slots and got.sat_sizes == want.sat_sizes
    for name in ("lvl_of_slot", "y_of_slot", "x_of_slot", "sat_base_of_lvl",
                 "sat_stride_of_lvl"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.limits(h, w) == [tuple(map(int, lim))
                                for lim in want.limits(h, w)]
    flat = np.arange(got.n_slots)
    for a, b in zip(got.split_levels(flat), want.split_levels(flat)):
        assert np.array_equal(a, b)
    n = len(got.plan)
    for levels in ((0,), (n - 1,), tuple(range(0, n, 2)), tuple(range(n))):
        sub, rsub = got.subset(levels), want.subset(levels)
        assert sub is got.subset(levels)            # cached by the compiler
        assert np.array_equal(sub.slot_indices, rsub.slot_indices)
        assert np.array_equal(sub.sat_base_of_lvl, rsub.sat_base_of_lvl)
        assert sub.n_slots == rsub.n_slots


@pytest.mark.parametrize("kind", SCENARIOS)
def test_synthetic_frames_equal_reference(kind):
    for (f, gt), (rf, rgt) in zip(make_video(kind, n_frames=6, h=70, w=90,
                                             seed=4),
                                  r_make_video(kind, n_frames=6, h=70, w=90,
                                               seed=4)):
        assert np.array_equal(f, rf) and np.array_equal(gt, rgt)


def test_host_tiles_equal_reference(det):
    rng = np.random.default_rng(2)
    prev = rng.random((50, 70), np.float32) * 255
    cur = prev.copy()
    cur[12:19, 33:41] += 0.5
    cur[40, 2] += 1e-3
    assert tile_grid_shape(50, 70, 12) == rtiles.tile_grid_shape(50, 70, 12)
    for exact in (True, False):
        got = tile_change_scores(prev, cur, 12, exact=exact)
        want = rtiles.tile_change_scores(prev, cur, 12, exact=exact)
        assert np.array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if exact:
            assert np.array_equal(got[1], want[1])
            for halo in (0, 1, 2):
                assert np.array_equal(dilate_tiles(got[1], halo),
                                      rtiles.dilate_tiles(want[1], halo))
    geo = StreamGeometry(det, HW, HW)
    changed = rng.random((8, 8)) < 0.2
    for lv, (y_lim, x_lim) in zip(geo.plan, geo.limits(90, 85)):
        assert np.array_equal(
            changed_window_mask(changed, 12, HW, HW, lv, 2, y_lim, x_lim),
            rtiles.changed_window_mask(changed, 12, HW, HW, lv, 2, y_lim,
                                       x_lim))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("halo", [0, 1])
def test_tile_change_mask_matches_reference_twin_and_host(exact, halo):
    rng = np.random.default_rng(0)
    prev = rng.random((50, 70), np.float32)
    cur = prev.copy()
    cur[12:19, 33:41] += 0.5          # a localized change
    cur[40, 2] += 1e-3                # a single-pixel tickle
    thr = 0.0 if exact else 1e-4
    changed, scores = ops.tile_change_mask(_t(prev), _t(cur), thr, tile=12,
                                           halo=halo, exact=exact)
    twin, twin_scores = ops.tile_change_mask_ref(_t(prev), _t(cur), thr,
                                                 tile=12, halo=halo,
                                                 exact=exact)
    ref, _ = rops.tile_change_mask(prev, cur, thr, tile=12, halo=halo,
                                   exact=exact)
    host_scores, host_any = tile_change_scores(prev, cur, 12, exact=True)
    host = host_any if exact else host_scores > thr
    assert changed.dtype == torch.bool and scores.dtype == torch.float32
    assert np.array_equal(changed.numpy(), np.asarray(ref))
    assert torch.equal(changed, twin)
    assert np.array_equal(changed.numpy(), dilate_tiles(host, halo))
    np.testing.assert_allclose(scores.numpy(), host_scores, rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(twin_scores.numpy(), host_scores, rtol=1e-5,
                               atol=0)


def test_changed_window_map_matches_reference_twin_and_host(det):
    rng = np.random.default_rng(1)
    # separable brackets, as the stream plan lays them out
    ty, tx, ny, nx = 7, 9, 6, 8
    changed = rng.random((ty, tx)) < 0.3
    ty0 = rng.integers(0, ty, ny).astype(np.int32)
    ty1 = np.minimum(ty0 + rng.integers(0, 3, ny), ty - 1).astype(np.int32)
    tx0 = rng.integers(0, tx, nx).astype(np.int32)
    tx1 = np.minimum(tx0 + rng.integers(0, 3, nx), tx - 1).astype(np.int32)
    valid = rng.random(ny * nx) < 0.9
    args = [_t(a) for a in (changed, ty0, ty1, tx0, tx1, valid)]
    got = ops.changed_window_map(*args)
    assert torch.equal(got, ops.changed_window_map_ref(*args))
    assert np.array_equal(got.numpy(), np.asarray(rops.changed_window_map(
        changed, ty0, ty1, tx0, tx1, valid)))
    brute = np.array([valid[i * nx + j] and changed[ty0[i]:ty1[i] + 1,
                                                    tx0[j]:tx1[j] + 1].any()
                      for i in range(ny) for j in range(nx)])
    assert np.array_equal(got.numpy(), brute)
    # every level of a real stream plan against the host mapping
    eng = StreamEngine(det)
    geo = eng.geometry(HW, HW)
    splan = eng.stream_plan(HW, HW, 90, 85, 12, 1)
    changed = rng.random((splan.ty, splan.tx)) < 0.15
    off = 0
    for lv, rng_l, lim in zip(geo.plan, splan.level_tile_ranges,
                              geo.limits(90, 85)):
        n = len(rng_l[0]) * len(rng_l[2])
        valid = _t(splan.limit_mask[off:off + n])
        off += n
        got = ops.changed_window_map(_t(changed), *map(_t, rng_l), valid)
        assert np.array_equal(got.numpy(), changed_window_mask(
            changed, 12, HW, HW, lv, 2, *lim))


def test_packed_inv_sigma_equals_window_inv_sigma_and_reference():
    rng = np.random.default_rng(3)
    shapes = [(60, 80), (40, 50)]
    imgs = [rng.integers(0, 256, s).astype(np.float32) for s in shapes]
    pairs, bases, strides, base = [], [], [], 0
    for im in imgs:
        _ii, pair = integral_images(_t(im))
        pairs.append(pair)
        bases.append(base)
        strides.append(im.shape[1] + 1)
        base += (im.shape[0] + 1) * (im.shape[1] + 1)
    pair_flat = torch.cat([p.reshape(2, -1) for p in pairs], 1)[None]
    lv = rng.integers(0, 2, 300)
    ys = np.array([rng.integers(0, shapes[v][0] - WINDOW + 1) for v in lv])
    xs = np.array([rng.integers(0, shapes[v][1] - WINDOW + 1) for v in lv])
    lanes = [_t(a).long() for a in (np.zeros(300, np.int64),
                                    np.take(bases, lv), np.take(strides, lv),
                                    ys, xs)]
    got = _packed_inv_sigma(pair_flat, *lanes)
    for v in (0, 1):
        m = torch.as_tensor(lv == v)
        want = window_inv_sigma(pairs[v], lanes[3][m], lanes[4][m], WINDOW)
        assert torch.equal(got[m], want)
    ref = r_packed_inv_sigma(pair_flat.numpy(), *(t.numpy() for t in lanes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("kind", SCENARIOS)
def test_port_stream_equals_reference(det, rdet, kind):
    """Threshold 0, host-planned: the same FrameStats on every frame and
    the same rects as the reference's VideoDetector."""
    rv = RVideo(rdet, RStream(tile=12, keyframe_interval=4))
    pv = VideoDetector(det, CFG)
    modes = []
    for (f, _gt) in make_video(kind, n_frames=10, h=HW, w=HW, seed=3):
        r_rects, r_st = rv.process(f)
        rects, st = pv.process(f)
        assert tuple(st) == tuple(r_st)
        assert np.array_equal(rects, r_rects), (kind, st)
        modes.append(st.mode)
    if kind == "static_cctv":
        assert "incremental" in modes


# ----------------------------------------------------- dense-order prefix
def _orders_disagree(casc, k, ii, inv):
    """Window (flat index) where weak classifier ``k``'s normalized feature
    differs between the dense kernels' order and the tail's, and the
    larger of its two values."""
    ny, nx = inv.shape[-2:]
    dense = torch.zeros_like(inv)
    tail = torch.zeros_like(inv)
    for (x, y, w, h), wr in zip(casc.rect_xywh[k].tolist(),
                                casc.rect_w[k].tolist()):
        a = ii[..., y:y + ny, x:x + nx]
        b = ii[..., y:y + ny, x + w:x + w + nx]
        c = ii[..., y + h:y + h + ny, x:x + nx]
        d = ii[..., y + h:y + h + ny, x + w:x + w + nx]
        dense = dense + wr * ((d - b) - (c - a))
        tail = tail + wr * (d - b - c + a)
    dense = (dense * inv * (1.0 / 576)).reshape(-1)
    tail = div_rn(tail * inv, 576.0).reshape(-1)
    i = int(torch.nonzero(dense != tail)[0])
    return i, max(float(dense[i]), float(tail[i]))


@pytest.mark.parametrize("backend", ["gather", "bulk"])
def test_tail_dense_prefix_takes_dense_head_bits(backend):
    """``s_dense`` stages of the packed tail give the dense kernels' plain
    sums bit for bit.  Large non-integer SAT entries round the two corner
    orders differently; a stump threshold set between the two orders'
    features of one window makes the tail's own order vote otherwise."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    rng = np.random.default_rng(5)
    img = _t((rng.random((1, 90, 110)) * 3e4).astype(np.float32))
    ii, ii2, iic = ops.sat_tables(img)
    ny, nx = 90 - WINDOW + 1, 110 - WINDOW + 1
    inv = window_inv_sigma((ii2, iic), torch.arange(ny)[:, None],
                           torch.arange(nx)[None, :], WINDOW)
    i, theta = _orders_disagree(casc, 1, ii, inv)
    wc = casc.wc_threshold.clone()
    wc[1] = theta
    casc = dataclasses.replace(casc, wc_threshold=wc)
    gy, gx = torch.meshgrid(torch.arange(ny), torch.arange(nx),
                            indexing="ij")
    zeros = torch.zeros(ny * nx, dtype=torch.int32)
    lanes = (zeros, zeros, torch.full_like(zeros, 111),
             gy.reshape(-1).int(), gx.reshape(-1).int())
    args = (casc, 0, 3, ii.reshape(1, -1), *lanes, inv.reshape(-1))
    dense = packed_tail.stage_sums(*args, backend=backend, s_dense=2)
    tail = packed_tail.stage_sums(*args, backend=backend)
    b = casc.bounds
    for s in range(2):
        want = haar_stage.dense_sums_plain(casc, b[s], b[s + 1], ii, inv)
        assert torch.equal(dense[s], want.reshape(-1))
    assert torch.equal(dense[2], tail[2])
    assert dense[0, i] != tail[0, i]         # the orders do vote otherwise


@pytest.mark.parametrize("use_pallas,step", [(True, 1), (True, 2),
                                             (False, 1)])
def test_stream_dense_order_follows_the_engine_head(use_pallas, step):
    """The stream's tail takes the dense kernels' order for exactly the
    stages ``detect`` runs on kernels A and B: one predicate
    (``plan.dense_on_kernels``) decides both the head and ``s_dense``."""
    cfg = EngineConfig(mode="wave", step=step, scale_factor=1.3,
                       use_pallas=use_pallas, tail_backend="pallas")
    d = Detector(paper_shaped_cascade(0, stage_sizes=SMALL), cfg,
                 device="cpu")
    plan = compile_plan(cfg, d.n_stages, HW, HW)
    on_kernels = dense_on_kernels(cfg, step)
    assert on_kernels == (use_pallas and step == 1)
    assert StreamEngine(d)._s_dense(HW, HW) == (
        plan.dense_prefix if on_kernels else 0)
    assert plan.dense_prefix > 0
    assert set(plan.head_modes) <= ({"fused", "split"} if on_kernels
                                    else {"split"})


def test_kernel_head_stream_equals_detect():
    """``use_pallas`` and step 1 (the kernel heads' arithmetic in
    ``detect``'s dense prefix): host-planned and device-state streams give
    ``detect``'s rects on every frame."""
    d = Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                 EngineConfig(mode="wave", step=1, scale_factor=1.3,
                              min_neighbors=2, use_pallas=True,
                              tail_backend="pallas"), device="cpu")
    cfg = CFG._replace(halo=0, full_refresh_frac=0.9)
    vh, vd = VideoDetector(d, cfg), VideoDetector(
        d, cfg._replace(device_state=True))
    assert vh.engine._s_dense(HW, HW) == 3
    modes = []
    for f, _gt in make_video("static_cctv", n_frames=4, h=HW, w=HW, seed=8):
        rh, sh = vh.process(f)
        rd, sd = vd.process(f)
        assert np.array_equal(rh, d.detect(f)) and np.array_equal(rd, rh)
        assert sh == sd
        modes.append(sh.mode)
    assert "incremental" in modes


def _detect_bitmap(d, geo, frame):
    bitmap = np.zeros(geo.n_slots, bool)
    for li, (ys, xs) in enumerate(level_windows_from_raw(d.detect_raw(frame))):
        nx = geo.level_windows[li][1]
        bitmap[geo.slot_offsets[li] + (ys // geo.step) * nx
               + xs // geo.step] = True
    return bitmap


def test_recomputed_windows_take_detect_decisions_where_sat_rounding_couples_windows():
    """A float32 SAT entry rounds a sum over every pixel above and left of
    it, so a window whose pixels did not change can change its decision
    between two frames (here at 192x256 already; often at 480x640).  The
    receptive-field mapping then leaves some cached windows off
    ``detect``'s decision; every recomputed window has ``detect``'s
    decision, and the host and device-state paths agree bit for bit."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    cfg = EngineConfig(mode="wave", step=1, scale_factor=1.2,
                       use_pallas=True, pad_multiple=32,
                       tail_backend="pallas")
    h, w = 192, 256
    n_tail = len(Detector(casc, cfg, device="cpu").batch_plan(
        h, w).tail_segments)
    d = Detector(casc, cfg._replace(capacity_fracs=(1.0,) * n_tail),
                 device="cpu")
    geo = StreamEngine(d).geometry(h, w)
    frames = [f for f, _ in make_video("moving_face", n_frames=8, h=h, w=w,
                                       seed=0)][:4]
    wants = [_detect_bitmap(d, geo, f) for f in frames]
    scfg = StreamConfig(tile=32, threshold=0.0, halo=1, keyframe_interval=0,
                        full_refresh_frac=1.1, max_changed_frac=1.0)
    vh = VideoDetector(d, scfg)
    vd = VideoDetector(d, scfg._replace(device_state=True),
                       decode_cap=1 << 15)
    rh, _ = vh.process(frames[0])
    rd, _ = vd.process(frames[0])
    assert np.array_equal(rh, d.detect(frames[0])) and np.array_equal(rd, rh)
    stale = 0
    for f, want in zip(frames[1:], wants[1:]):
        frame, plan = vh.plan_frame(f)
        assert plan.mode == "incremental"
        rects, st = vh.commit_planned(frame, plan)
        rd, sd = vd.process(f)
        assert np.array_equal(rd, rects) and sd == st
        assert np.array_equal(vd._dev_state.bitmap.numpy(), vh._bitmap)
        diff = vh._bitmap ^ want
        assert not (diff & np.concatenate(plan.masks)).any()
        stale += int(diff.sum())
    assert stale > 0, "fixture must couple windows through the SAT"


# ------------------------------------------- host path's own contracts
def test_static_video_identical_with_skips(det, engine):
    from repro_torch.core.training.data import render_scene
    frame = render_scene(np.random.default_rng(5), HW, HW, n_faces=1)[0]
    base = det.detect(frame)
    vd = _stream(det, engine, tile=16, threshold=0.0, keyframe_interval=0)
    for t in range(5):
        rects, st = vd.process(frame)
        assert np.array_equal(rects, base)
        assert st.mode == ("full" if t == 0 else "cached")
        if t:
            assert st.tile_skip_frac == 1.0 and st.windows_recomputed == 0


@pytest.mark.parametrize("kind", ["static_cctv", "moving_face",
                                  "camera_pan"])
def test_threshold0_bit_identical(det, engine, kind):
    vd = _stream(det, engine, tile=12, threshold=0.0, keyframe_interval=0)
    modes = []
    for frame, _gt in make_video(kind, n_frames=4, h=HW, w=HW, seed=11):
        rects, st = vd.process(frame)
        assert np.array_equal(rects, det.detect(frame)), (kind, st)
        modes.append(st.mode)
        if kind == "static_cctv" and st.frame_idx > 0:
            assert st.mode == "incremental"
            assert 0 < st.windows_recomputed < st.windows_total
            assert st.window_skip_frac > 0.5
    if kind == "static_cctv":
        assert "incremental" in modes


def test_keyframe_bounds_staleness(det, engine):
    frame_a = make_video("static_cctv", n_frames=1, h=HW, w=HW, seed=3)[0][0]
    frame_b = make_video("static_cctv", n_frames=1, h=HW, w=HW, seed=4)[0][0]
    base_a, base_b = det.detect(frame_a), det.detect(frame_b)
    vd = _stream(det, engine, tile=16, threshold=1e12, keyframe_interval=4)
    for _ in range(3):
        vd.process(frame_a)
    rects, st = vd.process(frame_b)
    assert st.mode == "cached" and np.array_equal(rects, base_a)
    rects, st = vd.process(frame_b)                 # frame 4 is a keyframe
    assert st.mode == "full" and np.array_equal(rects, base_b)
    never = _stream(det, engine, tile=16, threshold=1e12,
                    keyframe_interval=0)
    never.process(frame_a)
    for _ in range(6):
        assert never.process(frame_a)[1].mode == "cached"


def test_changed_window_mask_is_conservative(det):
    """Every window whose receptive field touches a changed pixel is in
    the mask (brute force over the nearest-neighbour map)."""
    rng = np.random.default_rng(9)
    geo = StreamGeometry(det, 64, 64)
    tile = 16
    for _ in range(3):
        changed = rng.random((4, 4)) < 0.3
        pix = np.repeat(np.repeat(changed, tile, 0), tile, 1)
        for lv, (ny, nx) in zip(geo.plan, geo.level_windows):
            mask = changed_window_mask(
                changed, tile, 64, 64, lv, geo.step,
                lv.height - WINDOW, lv.width - WINDOW).reshape(ny, nx)
            ys_map = downscale_indices(64, lv.height)
            xs_map = downscale_indices(64, lv.width)
            for iy in range(ny):
                for ix in range(nx):
                    y, x = iy * geo.step, ix * geo.step
                    if pix[np.ix_(ys_map[y:y + WINDOW],
                                  xs_map[x:x + WINDOW])].any():
                        assert mask[iy, ix], (lv, iy, ix)


def test_cap_for_rung_boundaries(engine):
    total = engine.geometry(HW, HW).n_slots
    assert total > STREAM_CAP_BASE
    assert engine._cap_for(total, 1, 0) == STREAM_CAP_BASE
    assert engine._cap_for(total, 1, STREAM_CAP_BASE) == STREAM_CAP_BASE
    assert engine._cap_for(total, 1, STREAM_CAP_BASE + 1) == \
        2 * STREAM_CAP_BASE
    assert engine._cap_for(10, 1, 9) == 10
    assert engine._cap_for(10, 2, 25) == 20
    assert engine._cap_for(0, 1, 0) == 1


def test_incremental_over_budget_returns_overflow(det):
    tight = StreamEngine(det, 0.01)          # budget = 1% of windows
    geo = tight.geometry(HW, HW)
    masks = [np.ones(ny * nx, bool) for (ny, nx) in geo.level_windows]
    bitmaps, counts, overflow = tight.incremental(
        [np.zeros((HW, HW), np.float32)], [masks], HW, HW)
    assert overflow and bitmaps == []
    assert counts.sum() == geo.n_slots
    assert tight.dispatches == 0 and tight.program_builds == 0


@pytest.mark.parametrize("backend", ["gather", "bulk", "pallas"])
def test_incremental_tail_backends_identical(det, backend):
    """Every packed-tail backend on the incremental path reproduces
    per-frame ``detect``."""
    kd = Detector(det.cascade, det.config._replace(tail_backend=backend),
                  device="cpu")
    vd = VideoDetector(kd, StreamConfig(tile=12, threshold=0.0,
                                        keyframe_interval=0))
    n_incr = 0
    for frame, _gt in make_video("static_cctv", n_frames=3, h=HW, w=HW,
                                 seed=2):
        rects, st = vd.process(frame)
        assert np.array_equal(rects, det.detect(frame))
        n_incr += st.mode == "incremental"
    assert n_incr >= 1


def test_overflow_falls_back_to_full(det):
    small = StreamEngine(det, 0.0001)   # budget ~1 window: always overflows
    vd = VideoDetector(det, StreamConfig(tile=12, threshold=0.0,
                                         keyframe_interval=0,
                                         full_refresh_frac=1.1),
                       engine=small)
    modes = []
    for frame, _gt in make_video("static_cctv", n_frames=3, h=HW, w=HW,
                                 seed=2):
        rects, st = vd.process(frame)
        assert np.array_equal(rects, det.detect(frame))
        modes.append(st.mode)
    assert modes == ["full"] * 3


def test_frame_shape_guards_and_sub_window_stream(det, engine):
    vd = _stream(det, engine, tile=16)
    vd.process(np.zeros((HW, HW), np.float32))
    with pytest.raises(ValueError, match="shape changed"):
        vd.process(np.zeros((HW, HW + 2), np.float32))
    with pytest.raises(ValueError, match="grayscale"):
        VideoDetector(det).process(np.zeros((4, HW, HW), np.float32))
    tiny = _stream(det, engine, tile=8)
    for _ in range(2):
        assert tiny.process(np.zeros((10, 10), np.float32))[0].shape == (0, 4)


def test_level_subsets_and_cached_levels_build_no_sat(det):
    """A 48-row frame in a 64-row bucket has dead levels: the subset
    executor never builds their SAT; a bit-identical frame builds none;
    the plan reports its active levels; results stay ``detect``'s."""
    pad_det = Detector(det.cascade, det.config._replace(pad_multiple=64),
                       device="cpu")
    eng = StreamEngine(pad_det)
    vd = VideoDetector(pad_det, StreamConfig(
        tile=12, threshold=0.0, keyframe_interval=0, full_refresh_frac=1.1),
        engine=eng)
    geo = eng.geometry(64, 64)
    dead = [li for li, (y_lim, _x) in enumerate(geo.limits(48, 64))
            if y_lim < 0]
    assert dead
    video = make_video("static_cctv", n_frames=3, h=48, w=64, seed=6)
    vd.process(video[0][0])
    _frame, plan = vd.plan_frame(video[1][0])
    assert plan.mode == "incremental"
    assert plan.active_levels == tuple(li for li, m in enumerate(plan.masks)
                                       if m.any())
    n_incr = 0
    for frame, _gt in video[1:]:
        before = eng.sat_level_builds
        rects, st = vd.process(frame)
        assert np.array_equal(rects, pad_det.detect(frame))
        if st.mode == "incremental":
            n_incr += 1
            built = eng.sat_level_builds - before
            assert built == st.levels_active <= len(geo.plan) - len(dead)
            assert st.level_skip_frac > 0
    assert n_incr >= 1
    before = (eng.sat_level_builds, eng.dispatches)
    _rects, st = vd.process(video[-1][0])
    assert st.mode == "cached" and st.levels_active == 0
    assert st.level_skip_frac == 1.0
    assert (eng.sat_level_builds, eng.dispatches) == before


def test_empty_masks_incremental_is_noop(engine):
    geo = engine.geometry(HW, HW)
    masks = [np.zeros(ny * nx, bool) for (ny, nx) in geo.level_windows]
    before = engine.sat_level_builds
    bitmaps, counts, overflow = engine.incremental(
        [np.zeros((HW, HW), np.float32)], [masks], HW, HW)
    assert not overflow and engine.sat_level_builds == before
    assert counts.sum() == 0 and len(bitmaps) == 1 and not bitmaps[0].any()


def test_intermittent_stream_level_sat_frac(det, engine):
    vd = _stream(det, engine, tile=12, threshold=0.0, keyframe_interval=0)
    fracs = []
    for i, (frame, _gt) in enumerate(make_video(
            "intermittent_cctv", n_frames=8, h=HW, w=HW, seed=4)):
        rects, st = vd.process(frame)
        assert np.array_equal(rects, det.detect(frame))
        if i:
            fracs.append(st.levels_active / max(st.levels_total, 1))
            assert st.mode in ("cached", "incremental")
    assert np.mean(fracs) < 0.5, fracs


def test_batched_incremental_matches_single(det, engine):
    """Two streams' changed windows share one packed compaction; each
    frame's result equals per-frame ``detect``."""
    videos = [make_video("static_cctv", n_frames=3, h=HW, w=HW, seed=s)
              for s in (0, 1)]
    vds = [_stream(det, engine, tile=12, threshold=0.0, keyframe_interval=0)
           for _ in videos]
    for vd, vid in zip(vds, videos):
        vd.process(vid[0][0])
    for t in range(1, 3):
        frames, plans = [], []
        for vd, vid in zip(vds, videos):
            frame, plan = vd.plan_frame(vid[t][0])
            assert plan.mode == "incremental"
            frames.append(frame)
            plans.append(plan)
        geo = vds[0]._geo
        bitmaps, _rec, overflow = engine.incremental(
            frames, [p.masks for p in plans], geo.hp, geo.wp)
        assert not overflow
        for vd, vid, plan, bm in zip(vds, videos, plans, bitmaps):
            rects, _st = vd.commit_incremental(vid[t][0], plan, bm)
            assert np.array_equal(rects, det.detect(vid[t][0]))
