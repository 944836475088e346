"""The port's CUDA kernels on a card (``cuda`` marker): each kernel equal
bit for bit to its plain version on the same inputs (the dense heads A and
B in every head tile, on ragged grids), a small ``detect_batch`` on the
card equal to the port's CPU run, through every kernel, and a small
``calibrated`` run on the card whose rects and capacities equal the CPU
run's; kernel C's dense-order stage prefix, a small stream on the
card equal to the port's CPU run, a governed two-pod service flush on
the card equal to the CPU's rects, shares and modelled joules under the
same seeded rates, a device-state session flushed by the service's
background thread, a fleet's degraded sessions equal to lone CPU
``VideoDetector``s on their stretched configs, a tiny cascade trained
on the card equal bit for bit to the CPU's; and the LM stack: every
architecture's smoke config (forward, prefill and decode logits), greedy
``generate``, the blockwise flash forward and backward, and an olmo smoke
train step's metrics, gradients and AdamW update on the card equal to
the CPU's within the reference's tolerances (float32, TF32 off), a
checkpoint of bf16 leaves on the card restored bit for bit; and the mesh
path on a one-rank NCCL mesh: an olmo smoke train step equal bit for bit
to the one-device step, ``compressed_psum`` over NCCL, and a sharded
restore onto the card.  Imports
only torch, numpy and the port, so it runs where jax is not installed:

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
from repro_torch.kernels import packed_window, tail_gates, window_variance  # noqa: E402
from repro_torch.kernels.autotune import (HEAD_TILE_CANDIDATES,  # noqa: E402
                                          LANE_BLOCK_CANDIDATES)
from repro_torch.kernels.haar_stage import head_block_shape  # noqa: E402
from torch_gate_cases import (GATE_IMAGES, GATE_LIVE, GATE_ORDERS,  # noqa: E402
                              GATE_STAGES, gate_case, inline_formula,
                              run_gates)

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
    assert counts["tail_gates"] == counts["packed_window"]


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
@pytest.mark.parametrize("order", GATE_ORDERS)
@pytest.mark.parametrize("live", GATE_LIVE)
@pytest.mark.parametrize("n_img", GATE_IMAGES)
@pytest.mark.parametrize("k", GATE_STAGES)
def test_tail_gate_kernel_equals_twin_on_card(card, k, n_img, live, order):
    """Kernel E over 5000 lanes (several blocks) gates the mask and counts
    each image's survivors bit for bit as its twin and the tail's old
    per-stage ``index_add_``, on the card and on the CPU, for sorted,
    shuffled and dead-lane image indices and any live count."""
    case = gate_case(k, n_img, live, order, cap=5000, device=card)
    want_valid, want_counts = inline_formula(case, k)
    ops.reset_launches()
    out, valid, counts = run_gates(ops.tail_gate_counts, case, k)
    assert ops.launches()["tail_gates"] == 1
    assert out is valid
    _, twin_valid, twin_counts = run_gates(ops.tail_gate_counts_ref, case, k)
    on_cpu = {n: t.cpu() for n, t in case.items()}
    _, cpu_valid, cpu_counts = run_gates(ops.tail_gate_counts, on_cpu, k)
    for v, c in ((twin_valid, twin_counts), (want_valid, want_counts)):
        assert torch.equal(valid, v) and torch.equal(counts, c)
    assert torch.equal(valid.cpu(), cpu_valid)
    assert torch.equal(counts.cpu(), cpu_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_tail_gate_kernel_at_the_flush_first_segment(card, order):
    """The flush's first tail segment at 16 x 480x640: 13,802,064 lanes,
    about 2 M of them live, three stages; kernel E equals its twin."""
    cap, live, n_img, k = 13_802_064, 2_031_117, 16, 3
    gen = torch.Generator(device=card).manual_seed(27)
    b = torch.arange(live, device=card) * n_img // live
    if order == "shuffled":
        b = b[torch.randperm(live, generator=gen, device=card)]
    b_sel = torch.zeros(cap, dtype=torch.int64, device=card)
    b_sel[:live] = b
    valid = torch.zeros(cap, dtype=torch.bool, device=card)
    valid[:live] = True
    ss = torch.randn((k, cap), generator=gen, device=card) + 0.5
    ss[:, live:] = 0.0
    thr = torch.randn(k, generator=gen, device=card)
    n_live = torch.tensor(live, device=card)
    runs = []
    for fn in (tail_gates.gate_counts, ops.tail_gate_counts_ref):
        v = valid.clone()
        c = torch.zeros((k, n_img), dtype=torch.int32, device=card)
        runs.append((fn(ss, thr, v, b_sel, n_live, c), v, c))
    (_, valid_e, counts_e), (_, valid_r, counts_r) = runs
    assert torch.equal(valid_e, valid_r) and torch.equal(counts_e, counts_r)
    assert 0 < int(counts_e[-1].sum()) < int(counts_e[0].sum()) < live


@pytest.mark.cuda
def test_flush_gates_and_counts_on_kernel_e(paper_on_card, monkeypatch):
    """A flush of 16 x 480x640 scenes on the main path launches kernels C
    and E once per tail segment (8 each), and its result (mask, image,
    level, origin, overflow and every stage's per-image counts) and rects
    equal the same flush with the gates and counts on E's twin."""
    from repro_torch.core.engine import BatchResult
    rng = np.random.default_rng(27)
    imgs = [render_scene(rng, 480, 640, n_faces=3)[0] for _ in range(16)]
    cfg = EngineConfig(mode="wave", step=1, scale_factor=1.2,
                       use_pallas=True, pad_multiple=32, tail_backend="pallas")
    det = Detector(paper_on_card, cfg)
    hp, wp = det._bucket_hw(480, 640)
    assert len(det.batch_plan(hp, wp, 16).tail_segments) == 8
    det.detect_batch(imgs, group=False)          # builds the plan

    def flush():
        stack, valid_hw = det._pack_stack(imgs, hp, wp)
        head_fn, tail_fn = det.batch_parts(hp, wp, 16)
        res = tail_fn(*head_fn(*det._stack_to_device(stack, valid_hw)))
        return res, det.detect_batch(imgs, group=False)

    ops.reset_launches()
    res, rects = flush()
    counts = ops.launches()       # two flushes: tail_fn's and detect_batch's
    assert counts["tail_gates"] == counts["packed_window"] == 2 * 8
    monkeypatch.setattr(ops, "tail_gate_counts", ops.tail_gate_counts_ref)
    ops.reset_launches()
    res_ref, rects_ref = flush()
    assert ops.launches()["tail_gates"] == 0
    for f in BatchResult._fields:
        assert torch.equal(getattr(res, f), getattr(res_ref, f)), f
    assert not bool(res.overflow) and int(res.alive_counts[-1].sum()) > 0
    for a, b in zip(rects, rects_ref):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_full_width_flush_on_kernel_e_equals_cpu(paper_on_card):
    """Two 480x640 scenes through all 25 stages take the benchmark cell's
    8-segment tail plan; the card's flush, with kernels C and E launched
    once per segment, equals the port's CPU flush: its rects and its whole
    result, ``alive_counts`` included."""
    from repro_torch.core.engine import BatchResult
    rng = np.random.default_rng(28)
    imgs = [render_scene(rng, 480, 640, n_faces=3)[0] for _ in range(2)]
    cfg = EngineConfig(mode="wave", step=1, scale_factor=1.2,
                       use_pallas=True, pad_multiple=32, tail_backend="pallas")
    runs = {}
    for dev, casc in (("cuda", paper_on_card),
                      ("cpu", paper_shaped_cascade(0))):
        det = Detector(casc, cfg, device=dev)
        hp, wp = det._bucket_hw(480, 640)
        assert len(det.batch_plan(hp, wp, 2).tail_segments) == 8
        seen, parts = [], det.batch_parts

        def batch_parts(hp, wp, batch, parts=parts, seen=seen):
            head_fn, tail_fn = parts(hp, wp, batch)
            return head_fn, lambda *a: seen.append(tail_fn(*a)) or seen[-1]

        det.batch_parts = batch_parts
        if dev == "cuda":
            det.detect_batch(imgs, group=False)      # builds the plan
            ops.reset_launches()
        rects = det.detect_batch(imgs, group=False)
        if dev == "cuda":
            counts = ops.launches()
            assert counts["tail_gates"] == counts["packed_window"] == 8
        runs[dev] = (seen[-1], rects)
    (res, rects), (res_cpu, rects_cpu) = runs["cuda"], runs["cpu"]
    for f in BatchResult._fields:
        assert torch.equal(getattr(res, f).cpu(), getattr(res_cpu, f)), f
    assert int(res_cpu.alive_counts[-1].sum()) > 0
    for a, b in zip(rects, rects_cpu):
        assert np.array_equal(a, b)


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


@pytest.mark.cuda
def test_fleet_degraded_sessions_on_card_equal_lone_cpu_detectors(card):
    """A fleet on a card service degrades best_effort to the ladder's cap
    and standard after it, never realtime; each session's frames, flushed
    tier by tier, equal a lone CPU ``VideoDetector`` on its stretched
    config (rects, ``FrameStats``); the flushes launch S, A and C only."""
    from repro_torch.serve import (DetectorService, FleetScheduler,
                                   ServiceConfig)
    from repro_torch.stream import StreamConfig, VideoDetector, make_video
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    scfg = StreamConfig(tile=12, keyframe_interval=2, halo=0,
                        full_refresh_frac=0.9)
    on_cpu = Detector(casc, SERVICE_CFG, device="cpu")
    svc = DetectorService(Detector(casc, SERVICE_CFG),
                          ServiceConfig(stream_config=scfg))
    units = svc._work_units((96, 96))
    svc.seed_rates([4.0 * units])
    fleet = FleetScheduler(svc)
    sessions = [fleet.admit((96, 96), 1.0, tier=t, stream_config=c)
                for t, c in (("realtime", scfg),
                             ("standard", scfg._replace(device_state=True)),
                             ("best_effort", scfg))]
    for fs in sessions:
        fs.note_work_frac(1.0)
        fs.fps = 1.6
    fleet.rebalance()
    rt, st, be = sessions
    assert (rt.degrade_level, be.degrade_level) == (0, scfg.max_degrade_level)
    frames = [f for f, _ in make_video("static_cctv", n_frames=6, h=96, w=96,
                                       seed=4)]
    lone = [VideoDetector(on_cpu, fs.base_config.degraded(fs.degrade_level))
            for fs in sessions]
    ops.reset_launches()
    for f in frames:
        reqs = [fs.submit_frame(f) for fs in sessions]
        fleet.flush()
        for r, vd in zip(reqs, lone):
            rects, stats = vd.process(f)
            assert r.error is None and not r.dropped
            assert np.array_equal(r.result(), rects) and r.stats == stats
    counts = ops.launches()
    for k in ("integral_image", "fused_head", "packed_window"):
        assert counts[k] > 0, k
    assert counts["haar_stage"] == counts["window_variance"] == 0


@pytest.mark.cuda
def test_training_on_card_equals_cpu_bit_for_bit(card):
    """``train_cascade`` on the card and on the CPU (the tiny config of
    ``tests/test_adaboost.py``, three stages): the same cascade arrays bit
    for bit and the same per-stage history; ``feature_values`` equal too."""
    from repro_torch.core.training import TrainConfig, train_cascade
    from repro_torch.core.training.adaboost import (feature_pool,
                                                    feature_values)
    from repro_torch.core.training.data import window_dataset
    cfg = TrainConfig(n_stages=3, n_pos=120, n_neg=120, max_features=300,
                      max_weak_per_stage=8, stage_fpr=0.5, stage_dr=0.98,
                      seed=5)
    rx, rw = feature_pool(cfg)
    win = window_dataset(np.random.default_rng(3), 50, 50).windows
    assert np.array_equal(feature_values(win, rx, rw),
                          feature_values(win, rx, rw, device="cpu"))
    (c_casc, c_info), (p_casc, p_info) = (train_cascade(cfg),
                                          train_cascade(cfg, device="cpu"))
    assert c_casc.rect_xywh.is_cuda
    for f, a in c_casc.numpy().items():
        assert np.array_equal(a, p_casc.numpy()[f]), f
    assert c_info["stages"] == p_info["stages"]


# ------------------------------------------------------------- LM stack
LM_ATOL = 2e-3          # the reference's decode tolerance


def lm_pair(arch, card, n_layers=None):
    """The same smoke model and weights (drawn on the CPU) on the card and
    on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.models.transformer import tree_map
    cfg = get_smoke_config(arch)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    cpu = Model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    return (Model(cfg, card), tree_map(lambda t: t.to(card), params), cpu,
            params)


@pytest.fixture
def no_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-2b", "stablelm-1.6b",
                                  "olmo-1b", "qwen2-72b", "llama3-405b",
                                  "internvl2-1b", "musicgen-medium",
                                  "mamba2-780m"])
def test_lm_smoke_archs_on_card_equal_cpu(card, no_tf32, arch):
    """forward, prefill of 12 tokens and 4 decode steps: card == CPU
    within atol 2e-3."""
    gpu, g_params, cpu, c_params = lm_pair(arch, card)
    cfg = cpu.cfg
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    kw = {}
    if cfg.input_mode == "tokens+prefix":
        kw["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
    runs = []
    for m, p, dev in ((gpu, g_params, card), (cpu, c_params, "cpu")):
        kwd = {k: v.to(dev) for k, v in kw.items()}
        full, _ = m.forward(p, tokens.to(dev), **kwd)
        cache = m.init_cache(2, 32)
        lg, cache = m.prefill(p, tokens[:, :12].to(dev), cache, **kwd)
        steps = [lg]
        for t in range(12, 16):
            lg, cache = m.decode_step(p, tokens[:, t].to(dev), cache)
            steps.append(lg)
        runs.append((full.cpu(), torch.cat(steps, 1).cpu()))
    for got, want in zip(*runs):
        assert got.device.type == "cpu" and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=LM_ATOL)


@pytest.mark.cuda
def test_lm_generate_on_card_equals_cpu(card, no_tf32):
    from repro_torch.serve import generate
    gpu, g_params, cpu, c_params = lm_pair("olmo-1b", card, n_layers=6)
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cpu.cfg.vocab_size, (4, 12)))
    got = generate(gpu, g_params, prompt.to(card), max_new=8)
    assert got.is_cuda
    assert torch.equal(got.cpu(), generate(cpu, c_params, prompt, max_new=8))


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,g,causal,window,chunk", [
    (17, 2, 1, True, None, 32), (50, 6, 2, True, 24, 16),
    (96, 6, 2, False, None, 32), (300, 4, 2, True, None, 128)])
def test_lm_flash_forward_on_card_equals_cpu(card, no_tf32, s, hq, g, causal,
                                             window, chunk):
    from repro_torch.models.layers import attention_reference, flash_attention
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, s, h, 16)).astype(np.float32)) for h in (hq, hq // g, hq // g))
    got = flash_attention(q.to(card), k.to(card), v.to(card), causal, window,
                          chunk, chunk)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        got.cpu().numpy(), flash_attention(q, k, v, causal, window, chunk,
                                           chunk).numpy(), **tol)
    np.testing.assert_allclose(
        got.cpu().numpy(), attention_reference(q, k, v, causal,
                                               window).numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,g,causal,window,cq,ckv", [
    (50, 6, 2, True, 24, 16, 16), (96, 6, 2, False, None, 32, 32),
    (300, 4, 2, True, None, 128, 64)])
def test_lm_flash_backward_on_card_equals_cpu(card, no_tf32, s, hq, g, causal,
                                              window, cq, ckv):
    """dq, dk, dv on the card equal the CPU's within the reference's flash
    gradient tolerance (rtol 1e-3, atol 1e-4), float32."""
    from repro_torch.models.layers import flash_attention
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal((2, s, h, 16)).astype(np.float32)
              for h in (hq, hq // g, hq // g)]
    do = torch.from_numpy(rng.standard_normal((2, s, hq, 16)).astype(
        np.float32))
    grads = []
    for dev in (card, torch.device("cpu")):
        ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        flash_attention(*ts, causal, window, cq, ckv).backward(do.to(dev))
        grads.append([t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.cuda
def test_lm_train_step_on_card_equals_cpu(card, no_tf32):
    """olmo smoke, microbatches of 2: loss and metrics at rtol 1e-5, every
    gradient leaf within 1e-4 of its largest |g|; then ``adamw_update``
    fed the CPU's gradients on both sides within rtol 1e-6 (and 1e-6 of
    the leaf's largest |value|)."""
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train.train_step import batch_grads
    gpu, g_params, cpu, c_params = lm_pair("olmo-1b", card)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, cpu.cfg.vocab_size, (4, 33)).astype(np.int32))}
    g_gpu, m_gpu = batch_grads(gpu, g_params, {"tokens":
                                               batch["tokens"].to(card)},
                               microbatch=2)
    g_cpu, m_cpu = batch_grads(cpu, c_params, batch, microbatch=2)
    for k in m_cpu:
        np.testing.assert_allclose(float(m_gpu[k]), float(m_cpu[k]),
                                   rtol=1e-5, err_msg=k)
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    outs = []
    for p, dev in ((g_params, card), (c_params, torch.device("cpu"))):
        new_p, opt, _ = adamw_update(p, tree_map(lambda t: t.to(dev), g_cpu),
                                     adamw_init(p), 1e-3)
        outs.append([t.cpu() for t in tree_leaves([new_p, opt.m, opt.v])])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_lm_checkpoint_bf16_round_trip_on_card(card, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    gen = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn((3, 5), generator=gen, device=card).to(
                torch.bfloat16),
            "stack": [torch.randn((2, 4), generator=gen,
                                  device=card).to(torch.bfloat16)],
            "step": torch.tensor(7, dtype=torch.int32, device=card)}
    save_checkpoint(str(tmp_path), 7, tree)
    like = {k: (torch.zeros_like(v) if k != "stack"
                else [torch.zeros_like(v[0])]) for k, v in tree.items()}
    got, step, _ = restore_checkpoint(str(tmp_path), like, device=card)
    assert step == 7
    for a, b in ((got["w"], tree["w"]), (got["stack"][0], tree["stack"][0]),
                 (got["step"], tree["step"])):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL group (its store a file under ``tmp_path``) and a
    (1, 1) ("data", "model") mesh on the card; the group is destroyed
    after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), world_size=1, rank=0)
    try:
        yield make_smoke_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_mesh_train_step_on_card_equals_one_device_bit_for_bit(
        card, no_tf32, nccl_mesh):
    """olmo smoke, microbatches of 2: the mesh path (DTensor params, ZeRO,
    sequence parallelism, the flash and the loss under ``shard_map``) on
    one NCCL rank takes the one-device step's bits: loss, metrics,
    parameters and moments, placements kept.  No warm-up, so the step's
    learning rate is not 0 and the parameters move."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (batch_pspecs, distribute,
                                                  make_rules)
    from repro_torch.models import Model
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config("olmo-1b")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 33))).to(card)
    runs = []
    for rules in (None, make_rules(nccl_mesh)):
        model = Model(cfg, card, rules)
        state = init_train_state(model, torch.Generator(
            device=card).manual_seed(0))
        batch = {"tokens": tokens}
        if rules is not None:
            batch = distribute(batch, batch_pspecs(batch, rules), nccl_mesh)
        new, met = make_train_step(model, peak_lr=1e-3, warmup=0,
                                   microbatch=2)(state, batch)
        if rules is not None:
            assert all(a.placements == b.placements for a, b in zip(
                tree_leaves(state.params), tree_leaves(new.params)))
        runs.append((new, met))
    (one, m_one), (mesh, m_mesh) = runs
    for k in m_one:
        assert float(m_one[k]) == float(m_mesh[k]), k
    for a, b in zip(tree_leaves([one.params, one.opt.m, one.opt.v]),
                    tree_leaves([mesh.params, mesh.opt.m, mesh.opt.v])):
        assert torch.equal(a, b.to_local())


@pytest.mark.cuda
def test_compressed_psum_over_nccl_is_compress_decompress(card, nccl_mesh):
    import torch.distributed as dist
    from repro_torch.distributed import (compress_leaf, compressed_psum,
                                         decompress_leaf)
    g = torch.randn((257, 33), generator=torch.Generator(
        device=card).manual_seed(1), device=card)
    want = decompress_leaf(*compress_leaf(g)).view(torch.int32)
    for axis in ((nccl_mesh, "data"), (nccl_mesh, "model"),
                 dist.group.WORLD):
        assert torch.equal(compressed_psum(g, axis).view(torch.int32), want)


@pytest.mark.cuda
def test_sharded_restore_onto_the_card(card, nccl_mesh, tmp_path):
    """stablelm smoke in bf16: a mesh checkpoint restored with
    ``shardings=`` (each leaf read as its shard) onto the card's mesh,
    and whole into a one-device model: the saved bits and placements."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_rules, shardings_for
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves
    cfg = get_smoke_config("stablelm-1.6b").with_(param_dtype="bfloat16")
    rules = make_rules(nccl_mesh)
    params = Model(cfg, card, rules).init(
        torch.Generator(device=card).manual_seed(0))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, params)
    like = Model(cfg, "meta").init()
    got, step, _ = restore_checkpoint(d, like,
                                      shardings=shardings_for(like, rules))
    whole, _, _ = restore_checkpoint(d, like, device=card)
    assert step == 3
    for a, b, c in zip(tree_leaves(got), tree_leaves(params),
                       tree_leaves(whole)):
        assert a.to_local().is_cuda and a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())
        assert c.is_cuda and torch.equal(c, b.to_local())
