"""The port's CUDA kernels on a card (``cuda`` marker): each kernel equal
bit for bit to its plain version on the same inputs (the dense heads A and
B in every head tile, on ragged grids), a small ``detect_batch`` on the
card equal to the port's CPU run, through every kernel, and a small
``calibrated`` run on the card whose rects and capacities equal the CPU
run's; kernel C's dense-order stage prefix, a small stream on the
card equal to the port's CPU run, a governed two-pod service flush on
the card equal to the CPU's rects, shares and modelled joules under the
same seeded rates, and a device-state session flushed by the service's
background thread.  Imports only torch, numpy and the port, so it runs
where jax is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.core import Detector, EngineConfig, paper_shaped_cascade  # noqa: E402
from repro_torch.core.training.data import render_scene  # noqa: E402
from repro_torch.kernels import fused_head, haar_stage, integral_image, ops  # noqa: E402
from repro_torch.kernels import packed_window, window_variance  # noqa: E402
from repro_torch.kernels.autotune import (HEAD_TILE_CANDIDATES,  # noqa: E402
                                          LANE_BLOCK_CANDIDATES)
from repro_torch.kernels.haar_stage import head_block_shape  # noqa: E402

SMALL = [3, 4, 5, 6, 8]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_plain_versions_on_card(card):
    casc = paper_shaped_cascade(0, stage_sizes=SMALL, device=card)
    rng = np.random.default_rng(4)
    imgs = torch.as_tensor(rng.integers(0, 256, (2, 70, 90)),
                           dtype=torch.float32, device=card)
    tables = integral_image.sat_tables(imgs)
    for got, want in zip(tables, integral_image.sat_tables_plain(imgs.cpu())):
        assert torch.equal(got.cpu(), want)
    inv, sums = fused_head.tile_pass(casc, 0, 3, *tables)
    p_inv, p_sums = fused_head.tile_pass_plain(casc, 0, 3, *tables)
    assert torch.equal(inv, p_inv) and torch.equal(sums, p_sums)
    b = casc.bounds
    for s in range(len(SMALL)):
        assert torch.equal(
            haar_stage.stage_sums(casc, s, tables[0], inv),
            haar_stage.dense_sums_plain(casc, b[s], b[s + 1], tables[0], inv))
    ii_flat = tables[0].reshape(2, -1)
    n = 5000
    lanes = [torch.as_tensor(a, dtype=torch.int32, device=card) for a in (
        rng.integers(0, 2, n), np.zeros(n), np.full(n, 91),
        rng.integers(0, 47, n), rng.integers(0, 67, n))]
    inv_l = inv.reshape(2, -1)[lanes[0].long(),
                               lanes[3].long() * 67 + lanes[4].long()]
    assert torch.equal(
        packed_window.stage_sums(casc, 0, 5, ii_flat, *lanes, inv_l),
        packed_window.stage_sums_plain(casc, 0, 5, ii_flat, *lanes, inv_l))


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["fused", "split"])
def test_detect_batch_on_card_equals_cpu(card, head):
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    rng = np.random.default_rng(7)
    imgs = [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(3)]
    cfg = EngineConfig(mode="wave", step=1, min_neighbors=2, use_pallas=True,
                       tail_backend="pallas", head_mode=head)
    ops.reset_launches()
    on_card = Detector(casc, cfg).detect_batch(imgs, group=False)
    counts = ops.launches()
    on_cpu = Detector(casc, cfg, device="cpu").detect_batch(imgs, group=False)
    for a, c in zip(on_card, on_cpu):
        assert np.array_equal(a, c)
    dense = "fused_head" if head == "fused" else "haar_stage"
    assert counts["integral_image"] > 0 and counts[dense] > 0
    assert counts["packed_window"] > 0


@pytest.mark.cuda
def test_window_variance_equals_plain_on_card(card):
    rng = np.random.default_rng(5)
    imgs = torch.as_tensor(rng.integers(0, 256, (3, 70, 90)),
                           dtype=torch.float32, device=card)
    _ii, ii2, iic = integral_image.sat_tables(imgs)
    for ny, nx in ((47, 67), (50, 75)):     # the grid, and past its edge
        got = window_variance.inv_sigma_grid(ii2, iic, ny, nx)
        assert torch.equal(got, window_variance.inv_sigma_grid_plain(
            ii2, iic, ny, nx))
        assert torch.equal(got.cpu(), window_variance.inv_sigma_grid_plain(
            ii2.cpu(), iic.cpu(), ny, nx))
    pairs = torch.stack([ii2, iic], dim=1)    # strided (B, 2, H1, W1) slices
    assert torch.equal(ops.window_inv_sigma_grid_batch(pairs, 47, 67),
                       window_variance.inv_sigma_grid(ii2, iic, 47, 67))


@pytest.mark.cuda
def test_calibrated_on_card_equals_cpu(card):
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    rng = np.random.default_rng(7)
    imgs = [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(3)]
    cfg = EngineConfig(mode="wave", step=1, min_neighbors=2, use_pallas=True,
                       tail_backend="pallas")
    ops.reset_launches()
    cal = Detector(casc, cfg).calibrated(imgs[0], tune_tail=True,
                                         tail_sizes=(64, 256), tune_head=True)
    counts = ops.launches()
    assert cal.device.type == "cuda"
    for k in ("integral_image", "fused_head", "haar_stage", "packed_window"):
        assert counts[k] > 0, k
    on_cpu = Detector(casc, cfg, device="cpu")
    cpu_cal = on_cpu.calibrated(imgs[0])
    assert cal.config.capacity_fracs == cpu_cal.config.capacity_fracs
    assert (cal.config.batch_capacity_fracs
            == cpu_cal.config.batch_capacity_fracs)
    for a, c in zip(cal.detect_batch(imgs, group=False),
                    on_cpu.detect_batch(imgs, group=False)):
        assert np.array_equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", [(2, 37, 70), (1, 1, 1), (3, 481, 33),
                                 (1, 100, 1000)])
def test_sat_kernel_equals_cpu_on_non_integer_input(card, bhw):
    """Kernel S's chained scan keeps the serial order: the CPU's bits on
    non-integer input, across several strips and chunks and ragged
    edges."""
    rng = np.random.default_rng(sum(bhw))
    imgs = (rng.random(bhw) * 255.0).astype(np.float32)
    got = integral_image.sat_tables(torch.from_numpy(imgs).to(card))
    want = integral_image.sat_tables_plain(torch.from_numpy(imgs))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.cpu(), w)


def _tail_lanes(card, rng, n):
    """Kernel C's test list over two 70x90 SATs: in-table windows and, at
    random places, lanes whose footprint leaves the table (clamped)."""
    imgs = torch.as_tensor(rng.integers(0, 256, (2, 70, 90)),
                           dtype=torch.float32, device=card)
    ii, _ii2, _iic = integral_image.sat_tables(imgs)
    ys = rng.integers(0, 47, n)
    far = rng.random(n) < 0.05
    ys[far] = rng.integers(47, 10 ** 6, far.sum())
    lanes = [torch.as_tensor(a, dtype=torch.int32, device=card) for a in (
        rng.integers(0, 2, n), np.zeros(n), np.full(n, 91), ys,
        rng.integers(0, 67, n))]
    inv = torch.as_tensor(rng.random(n) * 0.05 + 0.01, dtype=torch.float32,
                          device=card)
    return ii.reshape(2, -1), lanes, inv


@pytest.mark.cuda
@pytest.mark.parametrize("lane_block",
                         LANE_BLOCK_CANDIDATES + ((1, 128), (3, 96)))
def test_packed_kernel_equals_plain_per_block_and_live_count(card,
                                                             lane_block):
    """Every candidate block, and blocks whose thread lanes do not fill
    the kernel's groups; with and without a live count."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL, device=card)
    rng = np.random.default_rng(11)
    cap = 5000
    ii_flat, lanes, inv = _tail_lanes(card, rng, cap)
    full = packed_window.stage_sums(casc, 0, 5, ii_flat, *lanes, inv,
                                    lane_block=lane_block)
    assert torch.equal(full, packed_window.stage_sums_plain(
        casc, 0, 5, ii_flat, *lanes, inv))
    for n in (0, 1, cap - 1, cap, cap + 7, 3001):
        n_live = torch.tensor(n, dtype=torch.int64, device=card)
        got = packed_window.stage_sums(casc, 0, 5, ii_flat, *lanes, inv,
                                       n_live=n_live, lane_block=lane_block)
        assert torch.equal(got, packed_window.stage_sums_plain(
            casc, 0, 5, ii_flat, *lanes, inv, n_live)), n
        m = min(n, cap)
        assert torch.equal(got[:, :m], full[:, :m]), n
        assert not got[:, m:].any(), n


@pytest.mark.cuda
@pytest.mark.parametrize("s_dense", [1, 3, 5])
def test_packed_kernel_dense_prefix_equals_plain(card, s_dense):
    """Stages below ``s_dense`` in the dense kernels' order, on the fast
    and the clamped paths (lanes near the table's end), with a live
    count; and equal to kernel B's sums over the same windows."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL, device=card)
    rng = np.random.default_rng(12)
    cap = 5000
    ii_flat, lanes, inv = _tail_lanes(card, rng, cap)
    for n_live in (None, torch.tensor(3001, dtype=torch.int64, device=card)):
        got = packed_window.stage_sums(casc, 0, 5, ii_flat, *lanes, inv,
                                       n_live=n_live, s_dense=s_dense)
        assert torch.equal(got, packed_window.stage_sums_plain(
            casc, 0, 5, ii_flat, *lanes, inv, n_live, s_dense))
    imgs = torch.as_tensor((rng.random((1, 90, 110)) * 3e4).astype(
        np.float32), device=card)
    ii, ii2, iic = integral_image.sat_tables(imgs)
    inv_g, _ = fused_head.tile_pass(casc, 0, 1, ii, ii2, iic)
    gy, gx = torch.meshgrid(torch.arange(67, device=card),
                            torch.arange(87, device=card), indexing="ij")
    zero = torch.zeros(67 * 87, dtype=torch.int32, device=card)
    tail = packed_window.stage_sums(
        casc, 0, 5, ii.reshape(1, -1), zero, zero, zero + 111,
        gy.reshape(-1).int(), gx.reshape(-1).int(), inv_g.reshape(-1),
        s_dense=s_dense)
    for s in range(s_dense):
        assert torch.equal(tail[s], haar_stage.stage_sums(
            casc, s, ii, inv_g).reshape(-1)), s


@pytest.mark.cuda
def test_stream_on_card_equals_cpu_and_launches_s_and_c(card):
    """A small device-state and host-planned stream on the card: the port's
    CPU run's rects and stats on every frame; the incremental frames
    launch S and C and no dense kernel."""
    from repro_torch.stream import StreamConfig, VideoDetector, make_video
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    cfg = EngineConfig(mode="wave", step=1, scale_factor=1.3, min_neighbors=2,
                       use_pallas=True, tail_backend="pallas")
    scfg = StreamConfig(tile=12, keyframe_interval=4, halo=0,
                        full_refresh_frac=0.9)
    on_card, on_cpu = Detector(casc, cfg), Detector(casc, cfg, device="cpu")
    for kind in ("static_cctv", "intermittent_cctv", "moving_face"):
        frames = [f for f, _ in make_video(kind, n_frames=6, h=96, w=96,
                                           seed=2)]
        runs = {}
        for name, d, dev_state in (("card", on_card, True),
                                   ("card_host", on_card, False),
                                   ("cpu", on_cpu, True)):
            vd = VideoDetector(d, scfg._replace(device_state=dev_state))
            runs[name] = []
            for f in frames:
                ops.reset_launches()
                rects, st = vd.process(f)
                runs[name].append((rects, st, ops.launches()))
        for (rc, sc, counts), (rh, sh, _), (rp, sp, _) in zip(
                runs["card"], runs["card_host"], runs["cpu"]):
            assert np.array_equal(rc, rp) and np.array_equal(rh, rp)
            assert sc == sp and sh == sp
            if sc.mode == "incremental":
                assert counts["integral_image"] > 0
                assert counts["packed_window"] > 0
                assert counts["fused_head"] == counts["haar_stage"] == 0
                assert counts["window_variance"] == 0
        if kind == "static_cctv":
            assert any(st.mode == "incremental" for _, st, _ in runs["card"])


# (B, h, w) stacks: ragged in both grid dims, a 1x1 window grid, a grid
# one 256-wide tile does not cover (nx = 277), and the main path's level 0
HEAD_STACKS = [(3, 37, 70), (1, 24, 24), (2, 40, 300), (1, 480, 640)]
N_DENSE = 3
BIG_STAGE = 23          # the paper cascade's 211-classifier stage


@pytest.fixture(scope="module")
def paper_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return paper_shaped_cascade(0, device="cuda")


def _head_tables(bhw):
    rng = np.random.default_rng(sum(bhw))
    imgs = torch.as_tensor(rng.integers(0, 256, bhw), dtype=torch.float32,
                           device="cuda")
    return integral_image.sat_tables(imgs)


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", HEAD_STACKS)
@pytest.mark.parametrize("tile", HEAD_TILE_CANDIDATES)
def test_dense_heads_equal_plain_in_every_tile(paper_on_card, tile, bhw):
    """Kernel A's 1/sigma and sums and kernel B's sums (the dense prefix
    and the 211-classifier stage) equal their plain versions bit for bit
    in each head tile, each launched in that tile's block; A's sums equal
    B's given A's 1/sigma (fused == split)."""
    casc = paper_on_card
    ii, ii2, iic = _head_tables(bhw)
    inv, sums = fused_head.tile_pass(casc, 0, N_DENSE, ii, ii2, iic,
                                     tile=tile)
    assert fused_head.KERNEL.last_block == head_block_shape(tile)
    p_inv, p_sums = fused_head.tile_pass_plain(casc, 0, N_DENSE, ii, ii2,
                                               iic)
    assert torch.equal(inv, p_inv) and torch.equal(sums, p_sums)
    b = casc.bounds
    assert b[BIG_STAGE + 1] - b[BIG_STAGE] == 211
    for s in list(range(N_DENSE)) + [BIG_STAGE]:
        got = haar_stage.stage_sums(casc, s, ii, inv, tile=tile)
        assert haar_stage.KERNEL.last_block == head_block_shape(tile)
        assert torch.equal(got, haar_stage.dense_sums_plain(
            casc, b[s], b[s + 1], ii, inv)), s
        if s < N_DENSE:
            assert torch.equal(got, sums[:, s]), s


@pytest.mark.cuda
@pytest.mark.parametrize("tile", HEAD_TILE_CANDIDATES)
def test_fused_head_takes_a_dense_mode_run(paper_on_card, tile):
    """``EngineConfig(mode="dense")`` runs all 25 stages (2913 weak
    classifiers, many shared-memory chunks) through kernel A."""
    casc = paper_on_card
    ii, ii2, iic = _head_tables((2, 37, 70))
    n = casc.n_stages
    inv, sums = fused_head.tile_pass(casc, 0, n, ii, ii2, iic, tile=tile)
    p_inv, p_sums = fused_head.tile_pass_plain(casc, 0, n, ii, ii2, iic)
    assert torch.equal(inv, p_inv) and torch.equal(sums, p_sums)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["fused", "split"])
@pytest.mark.parametrize("tile", HEAD_TILE_CANDIDATES)
def test_plan_head_tile_reaches_the_launch(card, tile, head):
    """A detector whose plan carries ``head_tile`` launches its dense
    kernel in that tile's block, with the CPU run's rects."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    rng = np.random.default_rng(7)
    imgs = [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(3)]
    cfg = EngineConfig(mode="wave", step=1, min_neighbors=2, use_pallas=True,
                       tail_backend="pallas", head_mode=head, head_tile=tile)
    kernel = (fused_head if head == "fused" else haar_stage).KERNEL
    kernel.last_block = None
    on_card = Detector(casc, cfg).detect_batch(imgs, group=False)
    assert kernel.last_block == head_block_shape(tile)
    on_cpu = Detector(casc, cfg, device="cpu").detect_batch(imgs, group=False)
    for a, c in zip(on_card, on_cpu):
        assert np.array_equal(a, c)


# ---------------------------------------------------------------- service
SERVICE_CFG = EngineConfig(mode="wave", step=1, scale_factor=1.3,
                           min_neighbors=2, use_pallas=True, pad_multiple=32,
                           tail_backend="pallas")


def _governed_service(detector, **kw):
    from repro_torch.serve import DetectorService, PodSpec, ServiceConfig
    svc = DetectorService(detector, ServiceConfig(
        pods=(PodSpec("big", 1.0, "big"), PodSpec("little", 0.45, "LITTLE")),
        governor="energy", slo_ms=200.0, batch_sizes=(2,), **kw))
    svc.seed_rates([4.0e5, 1.8e5])
    return svc


@pytest.mark.cuda
def test_governed_service_flush_on_card_equals_cpu(card):
    """A fresh governed two-pod service on the card, rates seeded as on
    the CPU: the CPU run's rects, shares, decision and modelled joules;
    the flush launches S, A and C and neither B nor D."""
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    rng = np.random.default_rng(11)
    imgs = [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(8)]
    runs = {}
    for name, dev in (("card", None), ("cpu", "cpu")):
        svc = _governed_service(Detector(casc, SERVICE_CFG, device=dev))
        reqs = [svc.submit(im) for im in imgs]
        ops.reset_launches()
        svc.flush()
        counts = ops.launches()
        assert all(r.error is None for r in reqs)
        runs[name] = ([r.result() for r in reqs], svc.stats().as_dict(),
                      counts)
    (card_rects, card_st, counts), (cpu_rects, cpu_st, _) = (runs["card"],
                                                              runs["cpu"])
    for a, c in zip(card_rects, cpu_rects):
        assert np.array_equal(a, c)
    assert card_st["energy"] == cpu_st["energy"]
    assert card_st["last_plan"] == cpu_st["last_plan"]
    assert [p["images"] for p in card_st["pods"]] == \
        [p["images"] for p in cpu_st["pods"]]
    for k in ("integral_image", "fused_head", "packed_window"):
        assert counts[k] > 0, k
    assert counts["haar_stage"] == counts["window_variance"] == 0


@pytest.mark.cuda
def test_device_state_session_flushed_by_background_thread(card):
    """A device-state stream session and one-shots flushed by the
    service's ``start()`` thread on the card: every request completes
    without error, the frames equal a lone ``VideoDetector`` on the CPU
    (rects and ``FrameStats``), and the one-shots equal ``detect``."""
    from repro_torch.serve import DetectorService, ServiceConfig
    from repro_torch.stream import StreamConfig, VideoDetector, make_video
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    scfg = StreamConfig(tile=12, keyframe_interval=4, halo=0,
                        full_refresh_frac=0.9, device_state=True)
    frames = [f for f, _ in make_video("static_cctv", n_frames=6, h=96,
                                       w=96, seed=2)]
    rng = np.random.default_rng(3)
    imgs = [render_scene(rng, 96, 96, n_faces=1)[0] for _ in range(3)]
    on_card = Detector(casc, SERVICE_CFG)
    on_cpu = Detector(casc, SERVICE_CFG, device="cpu")
    svc = DetectorService(on_card, ServiceConfig(max_batch=2,
                                                 max_delay_ms=10.0,
                                                 stream_config=scfg))
    sess = svc.open_stream()
    svc.start()
    try:
        ones = [svc.submit(im) for im in imgs]
        reqs = [sess.submit_frame(f) for f in frames]
    finally:
        svc.stop()
    lone = VideoDetector(on_cpu, scfg)
    for r, f in zip(reqs, frames):
        rects, st = lone.process(f)
        assert r.done.is_set() and r.error is None
        assert np.array_equal(r.result(), rects) and r.stats == st
    assert any(r.stats.mode == "incremental" for r in reqs)
    for r, im in zip(ones, imgs):
        assert r.error is None
        assert np.array_equal(r.result(), on_cpu.detect(im))
