#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``) and
the repository checkout around this file; it imports nothing of JAX and
nothing of the reference package ``repro``.  Phases, each fatal on failure:

1. environment: versions, the card's name and power limit, and the build
   of every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all at once);
2. kernels: S, A, B, C and D each against its plain PyTorch version on
   the card, at the main path's shapes (level 0 of eight 480x640 images;
   the first tail segment's real packed list), each kernel and library
   call timed by its device time (``torch.profiler``), beside its plain
   version (CUDA events) and its bound; D also against A's 1/sigma;
   S also on non-integer input against the CPU, beside ``torch.cumsum``'s
   time and at every pyramid level of the flush; A and B in every head
   tile of ``autotune.HEAD_TILE_CANDIDATES`` (each its own launch shape,
   timed per tile; B also on the cascade's largest stage, and A's sums
   against B's); C with and without the compaction's live count (as the
   engine calls it) and in every lane block of
   ``autotune.LANE_BLOCK_CANDIDATES``;
3. main path: ``Detector.detect_batch`` on the paper-shaped 25-stage /
   2913-weak-classifier cascade over eight seeded 480x640 scenes, with the
   fused head and with the split head (equal rects), ``detect`` equal to
   the batch per image, no program rebuilt on a repeat flush; a flush per
   head and head tile launches A or B in that tile's block with the same
   rects; then ms per flush and images per second; then the public kernel
   API
   (``ops.integral_image(_batch)``, ``ops.window_inv_sigma_grid(_batch)``)
   at the kernel sweep's shapes and the main path's, against its twins;
4. card vs CPU: the pretrained 3-stage cascade on seeded 240x320 face
   scenes gives the same rects on the card as the port's own CPU run;
5. calibration: ``Detector.calibrated(tune_tail=True, tune_head=True)``
   on the flush image with the most survivors at the main path's width;
   the head-tile race's ms per candidate; the calibrated flush gives the
   default flush's rects, without overflow and without a rebuild on a
   repeat, and launches its dense kernels in the block of its plan's
   ``head_tile``; ms per flush beside the default's;
6. streaming: ``repro_torch.stream`` on the same cascade at the same width
   (``capacity_fracs`` all 1.0, since ``detect``'s halving capacities
   overflow on this cascade), ``STREAM_FRAMES`` seeded 480x640 frames of
   each of the five ``make_video`` scenarios, ``StreamConfig(tile=32,
   threshold=0, halo=1, keyframe_interval=16)`` with a decode list of
   ``STREAM_DECODE_CAP`` slots.  Per frame, a device-state stream through
   the depth-2 submit/retire loop and a host-planned stream give equal
   rects and ``FrameStats``; a full frame gives ``detect``'s rects, and on
   the other frames every window the stream recomputed has ``detect``'s
   decision (the cached windows that differ from ``detect``, through
   float32 SAT rounding, are counted).
   ``static_cctv`` has an incremental frame and builds no executor after
   its third frame (a sequential device-state run, equal to the pipelined
   one); ``intermittent_cctv`` has a cached frame.  Then per scenario the frames
   by mode, the share of windows recomputed, the bytes moved per frame,
   ms per frame of the pipelined stream and ``detect`` in turns (on
   ``static_cctv`` also of the host-planned stream), and the device time
   of one incremental frame's step (CUDA events, and the profiler's
   kernel time).  Kernel C is held against its plain version, bit for
   bit, on the inputs of that step's C call (the whole cascade, the
   dense-order prefix ``s_dense``, the rung's lanes with the live count),
   and timed there beside its bound (the ``stream_step`` entry of C's row
   in the kernels line).

Every path driven on the card runs with the launch counts set to 0 just
before it and read just after: each must have launched the kernels of its
path (fused: S, A, C; split: S, B, C; ``detect``: S, A, C; kernel API: S,
D; card vs CPU: S, A; calibrate: S, A, B, C; stream, the whole pipelined
device-state ``static_cctv`` run: S, A on keyframes, C; stream_incremental,
that stream's incremental frames alone, run one at a time: S and C) and
none it must not (no engine path launches D; no stream path B; an
incremental frame no dense kernel).

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, one ``{"stream": {...}}`` line, and last ``{"ok": true, "device":
{...}}``; it exits non-zero, with no result line, when there is no CUDA
device or no checkout around it.

Bounds (``bound_ms``) are the larger of the bytes the call must move (each
input read once, each output written once) over 3.35 TB/s and its float
operations over 67 TFLOP/s (H100 SXM float32, NVIDIA data sheet): add,
subtract, multiply, divide, square root, max, compare and select count one
each; a float64 add counts two (the card's float64 rate is half its
float32 rate).  Per weak classifier and window: 3 rectangles x (3 corner
add/sub + 1 multiply + 1 add) + normalize (2) + compare, select, add = 20.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BPS = 3.35e12
FP32_OPS = 67e12
SEED = 0
BATCH = 8
H, W = 480, 640
DEVICE = "cuda"
# packed-list sizes of phase 5's backend race: each size costs ~31 calls of
# the one-classifier-at-a-time gather backend (~1 s each at 2913
# classifiers); one size keeps the phase near half a minute
TAIL_SIZES = (2048,)
KERNEL_API_SHAPES = ((64, 128), (96, 96), (128, 256))   # bench_kernels sweep
INV_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_BYTES = 72     # one weak classifier's record, as the kernels read it
# phase 6: frames per scenario, the stream's configuration, and the decode
# list, sized past the 1,933-25,989 raw windows this cascade keeps per
# 480x640 frame (the default 2048 would send every incremental frame to a
# full refresh)
STREAM_FRAMES = 16
STREAM_CONFIG = dict(tile=32, threshold=0.0, halo=1, keyframe_interval=16)
STREAM_DECODE_CAP = 32768


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def diff(got, want) -> str:
    """'' when equal bit for bit, else how many entries differ and by how
    much."""
    if got.shape == want.shape and bool((got == want).all()):
        return ""
    if got.shape != want.shape:
        return f"shape {tuple(got.shape)} != {tuple(want.shape)}"
    bad = got != want
    return (f"{int(bad.sum())} of {bad.numel()} entries differ, max "
            f"{float((got - want).abs().max()):.3g}")


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_b, t_o = bytes_moved / MEM_BPS, ops / FP32_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def past_order_bound(torch, got, want, ii2, iic) -> int:
    """Windows where two 1/sigma grids, made from the same float32 tables
    by the same operations except the corner order (``(d - b) - (c - a)``
    in kernel D, ``d - b - c + a`` in kernel A and the oracle twins),
    differ by more than that order can explain.  Each order rounds its
    three adds by at most half an ulp of a partial sum no larger than 2m
    (m the largest corner), so the two window sums differ by at most
    3 ulp(2m); ``var = s2/576 - mean^2`` then by at most ``(ds2 + 2|mean|
    ds1 + ds1^2/576) / 576`` plus the roundings of its own operations
    (4 ulps of its largest term), and ``1/sqrt(var)`` by at most
    ``inv^3 / 2`` times that plus 4 ulps of ``inv``.  The reference's
    rtol 1e-4 holds at its test sizes; at 480x640 the tables reach ~1.2e9
    (an ulp of 128), and this bound is the check there."""
    ny, nx = got.shape[-2:]

    def ulp(x):
        x = x.abs().float()
        return (torch.nextafter(x, torch.full_like(x, float("inf")))
                - x).double()

    def window_sum_and_gap(t):
        a, b, c, d = (t[..., y:y + ny, x:x + nx]
                      for y, x in ((0, 0), (0, 24), (24, 0), (24, 24)))
        m = torch.stack([a.abs(), b.abs(), c.abs(), d.abs()]).amax(0)
        s = (d.double() - b.double()) - (c.double() - a.double())
        return s, 3 * ulp(2 * m)

    s2, g2 = window_sum_and_gap(ii2)
    s1, g1 = window_sum_and_gap(iic)
    mean = (s1 / 576).abs()
    d_var = ((g2 + 2 * mean * g1 + g1 * g1 / 576) / 576
             + 4 * ulp(torch.maximum(s2.abs() / 576, mean * mean)))
    inv = torch.maximum(got, want).double()
    bound = 0.5 * inv ** 3 * d_var + 4 * ulp(inv)
    return int(((got - want).abs().double() > bound).sum())


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (one
    warm-up call first), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(torch, fn, reps: int, kernel: str = "") -> float:
    """Mean device time per call of ``fn`` over ``reps`` calls (one warm-up
    call first) of every kernel it launches whose name contains ``kernel``
    (all of them by default), from ``torch.profiler``: the device's own
    time, which a clock around back-to-back calls misses when launching a
    call takes the host longer than the device takes to run it.  A profile
    whose trace holds no device time is taken again; after three, the call
    is timed with CUDA events instead, and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and kernel in e.key)
        if total > 0:
            return total / reps / 1e3
    print(f"chip_smoke: the profiler saw no device time of "
          f"{kernel or 'the call'}; timed with CUDA events instead")
    return cuda_ms(torch, fn, reps)


def ptxas_entries(log: str) -> list:
    """``[{"entry", "registers", "spill_stores", "spill_loads"}, ...]`` per
    kernel of an ``nvcc -Xptxas -v`` report."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            out.append({"entry": m.group(1)})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and out:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = map(int,
                                                                  m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def tile_label(tile) -> str:
    return f"{tile[0]}x{tile[1]}"


def scenes(render_scene, n: int, h: int, w: int, seed: int, **kw):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [render_scene(rng, h, w, **kw)[0] for _ in range(n)]


def main_path_config():
    """The main path's engine config."""
    from repro_torch.core import EngineConfig
    return EngineConfig(mode="wave", step=1, scale_factor=1.2,
                        use_pallas=True, pad_multiple=32,
                        tail_backend="pallas")


def main_path_workload(device):
    """The main path's workload: the paper-shaped cascade from ``SEED``,
    ``BATCH`` seeded ``H`` x ``W`` face scenes and the engine config.
    Needs ``src`` on ``sys.path``; ``scripts/port_profile.py`` measures
    the same workload through this function."""
    from repro_torch.core import paper_shaped_cascade
    from repro_torch.core.training.data import render_scene
    cascade = paper_shaped_cascade(SEED, device=device)
    imgs = scenes(render_scene, BATCH, H, W, SEED, n_faces=3)
    return cascade, imgs, main_path_config()


def stream_workload(device, n_frames: int = STREAM_FRAMES):
    """Phase 6's workload: a detector on the main path's cascade and
    config with every survivor kept (``capacity_fracs`` all 1.0), the
    stream config, and per scenario ``n_frames`` seeded ``H`` x ``W``
    frames (``make_video``).  ``scripts/port_profile.py --stream`` traces
    the same workload through this function."""
    from repro_torch.core import Detector, paper_shaped_cascade
    from repro_torch.stream import SCENARIOS, StreamConfig, make_video
    cascade = paper_shaped_cascade(SEED, device=device)
    cfg = main_path_config()
    base = Detector(cascade, cfg, device=device)
    n_tail = len(base.batch_plan(*base._bucket_hw(H, W)).tail_segments)
    det = Detector(cascade, cfg._replace(capacity_fracs=(1.0,) * n_tail),
                   device=device)
    videos = {kind: [f for f, _gt in make_video(kind, n_frames=n_frames,
                                                h=H, w=W, seed=SEED)]
              for kind in SCENARIOS}
    return det, StreamConfig(**STREAM_CONFIG), videos


def pipelined(vd, frames) -> list:
    """``vd``'s frames through the depth-2 submit/retire loop (frame i + 1
    is submitted before frame i is retired): ``[(rects, stats), ...]``."""
    out, prev = [], None
    for f in frames:
        tok = vd.submit(f)
        if prev is not None:
            out.append(vd.retire(prev))
        prev = tok
    out.append(vd.retire(prev))
    return out


def stream_step_replay(vd, frames, first: int = 2):
    """Run the device-state stream ``vd`` over ``frames`` one at a time up
    to the first frame at or after ``first`` that comes back incremental;
    return ``(fn, i)``: ``fn()`` enqueues frame ``i``'s device step again
    from the state it read, into the other buffer of the pair (the same
    output every call), and ``i`` is that frame."""
    cfg = vd.config
    for i, f in enumerate(frames):
        head = vd._dev_state
        _rects, st = vd.process(f)
        if i >= first and st.mode == "incremental":
            break
    else:
        raise RuntimeError("no incremental frame to replay")
    step = vd.engine.stream_step(vd._splan, vd._dev_rung,
                                 cfg.threshold <= 0, cfg.full_refresh_frac)
    spare = vd._bufs[1] if head is vd._bufs[0] else vd._bufs[0]
    frame = vd._upload_frame(frames[i])
    return (lambda: step(vd.detector.cascade, head, frame,
                         float(cfg.threshold), int(cfg.keyframe_interval),
                         spare)), i


def stream_step_c_call(fn):
    """The arguments ``(args, kwargs)`` of the one kernel C call
    (``packed_window.stage_sums``) that a call of the replayed stream step
    ``fn`` makes."""
    from repro_torch.kernels import packed_window
    real, seen = packed_window.stage_sums, []

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    packed_window.stage_sums = spy
    try:
        fn()
    finally:
        packed_window.stage_sums = real
    if len(seen) != 1:
        raise RuntimeError(f"the stream step called kernel C {len(seen)} "
                           "times, not once")
    return seen[0]


def check_stream_step_c(torch, fn, smi: str):
    """Kernel C on the inputs of the replayed incremental step ``fn``'s
    C call, against its plain version bit for bit (every lane: the plain
    version zeroes past the live count as C does), and timed beside its
    bound on the live lanes.  Returns ``(entry, error)``."""
    from repro_torch.kernels import packed_window
    args, kw = stream_step_c_call(fn)
    cascade, s0, s1, ii_flat = args[:4]
    inv = args[9]
    n_live, s_dense = kw["n_live"], kw["s_dense"]
    got = packed_window.stage_sums(*args, **kw)
    want = packed_window.stage_sums_plain(*args, n_live, s_dense)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    cap, live = inv.numel(), int(n_live)
    k = int(cascade.bounds[s1] - cascade.bounds[s0])
    b_ms, b_by = bound_ms(4 * ii_flat.numel() + 4 * 6 * live
                          + PARAM_BYTES * k + 4 * cap * (s1 - s0),
                          live * 20 * k)
    entry = {"max_abs_err": err, "stages": [s0, s1], "s_dense": s_dense,
             "weak": k, "lanes": cap, "live_lanes": live,
             "ms": profiled_ms(torch, lambda: packed_window.stage_sums(
                 *args, **kw), 10),
             "plain_ms": cuda_ms(torch, lambda: packed_window.stage_sums_plain(
                 *args, n_live, s_dense), 1),
             "bound_ms": b_ms, "bound_by": b_by}
    print(f"kernel C on the stream step's inputs: stages [{s0}, {s1}), "
          f"s_dense {s_dense}, {live} of {cap} lanes live: max_abs_err "
          f"{err:.3g} ms {entry['ms']:.4f} plain_ms {entry['plain_ms']:.4f} "
          f"bound_ms {b_ms:.4f} ({b_by}) [{smi}]")
    if s_dense <= s0 or live <= 0:
        return entry, (f"the stream step's C call has s_dense {s_dense} and "
                       f"{live} live lanes: no dense-order prefix checked")
    bad = diff(got, want)
    return entry, (f"kernel C on the stream step's inputs: {bad}"
                   if bad else "")


def check_kernel_api(torch, stack) -> list:
    """The public kernel API at the kernel sweep's shapes (two seeded
    images each) and on ``stack`` (the main path's): ``integral_image``
    (``_batch``) and ``window_inv_sigma_grid`` (``_batch``) against their
    twins, batch against single, kernel D against its plain version bit
    for bit.  The twins and A's 1/sigma (the split head's plain grid has
    its bits) combine corners ``d - b - c + a``: D agrees with them within
    the reference's rtol at the sweep's sizes and within the corner-order
    rounding bound everywhere.  Returns what disagreed."""
    import numpy as np
    from repro_torch.core.integral import window_inv_sigma
    from repro_torch.kernels import ops, window_variance
    dev = stack.device
    bad = []
    rng = np.random.default_rng(SEED)
    inputs = [torch.as_tensor(rng.integers(0, 256, (2, h, w)),
                              dtype=torch.float32, device=dev)
              for h, w in KERNEL_API_SHAPES] + [stack]
    for x in inputs:
        _b, h, w = x.shape
        gy, gx = h - 23, w - 23
        ii_b = ops.integral_image_batch(x)
        if not torch.allclose(ii_b, ops.integral_image_batch_ref(x),
                              rtol=1e-6, atol=1e-3):
            bad.append(f"integral_image_batch {h}x{w} vs its twin")
        if diff(ops.integral_image(x[0]), ii_b[0]):
            bad.append(f"integral_image {h}x{w} != batch")
        _ii, ii2, iic = ops.sat_tables(x)
        pairs = torch.stack([ii2, iic], dim=1)
        inv_b = ops.window_inv_sigma_grid_batch(pairs, gy, gx)
        inv_1 = ops.window_inv_sigma_grid(pairs[0], gy, gx)
        if diff(inv_b, window_variance.inv_sigma_grid_plain(
                ii2, iic, gy, gx)) or diff(inv_1, inv_b[0]):
            bad.append(f"window_inv_sigma_grid(_batch) {h}x{w} vs plain")
        others = {
            "batch twin": ops.window_inv_sigma_grid_batch_ref(pairs, gy, gx),
            "twin": ops.window_inv_sigma_grid_ref(pairs[0], gy, gx)[None],
            "kernel A": window_inv_sigma(
                (ii2, iic), torch.arange(gy, device=dev)[:, None],
                torch.arange(gx, device=dev)[None, :], 24)}
        for name, want in others.items():
            n = want.shape[0]
            if (x is not stack and not torch.allclose(inv_b[:n], want,
                                                      **INV_TOL)) \
                    or past_order_bound(torch, inv_b[:n], want, ii2[:n],
                                        iic[:n]):
                bad.append(f"window_inv_sigma_grid {h}x{w} vs {name}")
    return bad


def calibrate_main_path(det, imgs, probe: int):
    """Phase 5's calibrated detector: ``det``'s configuration profiled on
    ``imgs[probe]`` with ``calibrated(tune_tail=True, tune_head=True)``.
    The profiling detector keeps every survivor (``capacity_fracs`` of 1:
    ``detect``'s halving capacities overflow on this cascade).  Pick as
    ``probe`` the flush image with the most survivors at the first
    compaction (:func:`calibration_probe`), so the shared capacity holds
    the whole flush.  ``scripts/port_profile.py --calibrated`` profiles
    the same detector."""
    from repro_torch.core import Detector
    hp, wp = det._bucket_hw(*imgs[probe].shape)
    n_tail = len(det.batch_plan(hp, wp, len(imgs)).tail_segments)
    det_prof = Detector(det.cascade, det.config._replace(
        capacity_fracs=(1.0,) * n_tail), device=det.device)
    return det_prof.calibrated(imgs[probe], tune_tail=True, tune_head=True,
                               tail_sizes=TAIL_SIZES)


def calibration_probe(head_counts, plan) -> int:
    """The flush image with the most survivors after the dense prefix,
    from a batch head's ``counts`` (n_stages, B)."""
    return int(head_counts[plan.dense_prefix - 1].argmax())


def detect_bitmap(det, geo, frame):
    """``detect``'s raw survivors of ``frame`` as a flat bitmap over the
    stream geometry ``geo``'s slots."""
    import numpy as np
    from repro_torch.stream import level_windows_from_raw
    bitmap = np.zeros(geo.n_slots, bool)
    wins = level_windows_from_raw(det.detect_raw(frame))
    for li, (ys, xs) in enumerate(wins):
        nx = geo.level_windows[li][1]
        bitmap[geo.slot_offsets[li] + (ys // geo.step) * nx
               + xs // geo.step] = True
    return bitmap


def check_stream(torch, on_path, by_path: dict, smi: str):
    """Phase 6.  Returns ``(report, error)``; ``error`` is '' when every
    check held.

    The device-state and host-planned streams give equal rects and
    ``FrameStats`` on every frame, a full frame gives ``detect``'s rects,
    and on every other frame each window the stream recomputed has
    ``detect``'s decision; the cached windows whose decision differs from
    ``detect``'s (float32 SAT rounding couples a window to the pixels
    above and left of it) are counted, as are the frames whose rects
    differ from ``detect``'s."""
    from collections import Counter
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.stream import VideoDetector
    det, scfg, videos = stream_workload(DEVICE)
    dev_cfg = scfg._replace(device_state=True)
    head_s, head_a, split_b, tail_c, inv_d = (
        "integral_image", "fused_head", "haar_stage", "packed_window",
        "window_variance")
    out: dict = {"card": smi, "frames": STREAM_FRAMES, "hw": [H, W],
                 "config": STREAM_CONFIG, "decode_cap": STREAM_DECODE_CAP,
                 "scenarios": {}}
    for kind, frames in videos.items():
        n = len(frames)
        wants = [det.detect(f) for f in frames]
        vd = VideoDetector(det, dev_cfg, decode_cap=STREAM_DECODE_CAP)
        if kind == "static_cctv":
            dev_out, err = on_path("stream", lambda: pipelined(vd, frames),
                                   (head_s, head_a, tail_c),
                                   (split_b, inv_d))
            if err:
                return out, err
        else:
            dev_out = pipelined(vd, frames)
        vh = VideoDetector(det, scfg)
        geo = None
        stale, stale_frames = [], 0
        for i, f in enumerate(frames):
            frame, plan = vh.plan_frame(f)
            rh, sh = vh.commit_planned(frame, plan)
            rd, sd = dev_out[i]
            if not np.array_equal(rd, rh) or sd != sh:
                return out, (f"stream {kind} frame {i}: device-state "
                             f"{sd} != host-planned {sh}")
            want = wants[i]
            if sh.mode == "full":
                if not np.array_equal(rh, want):
                    return out, (f"stream {kind} frame {i} (full): rects "
                                 "differ from detect")
                stale.append(0)
                continue
            geo = geo or vh._geo
            diff = vh._bitmap ^ detect_bitmap(det, geo, f)
            if plan.mode == "incremental" and (
                    diff & np.concatenate(plan.masks)).any():
                return out, (f"stream {kind} frame {i}: a recomputed window "
                             "differs from detect")
            stale.append(int(diff.sum()))
            stale_frames += not np.array_equal(rh, want)
        stats = [st for _r, st in dev_out]
        modes = Counter(st.mode for st in stats)
        row = {"modes": dict(modes),
               "window_recompute_share":
                   sum(st.windows_recomputed for st in stats)
                   / sum(st.windows_total for st in stats),
               "xfer_bytes_per_frame": vd.xfer_bytes / n,
               "host_xfer_bytes_per_frame": vh.xfer_bytes / n,
               "stale_windows_per_frame": stale,
               "frames_rects_differ_from_detect": stale_frames,
               "program_builds": vd.engine.program_builds,
               "rung": vd._dev_rung}
        if kind == "static_cctv":
            # one frame at a time: the launches of the incremental frames
            # alone, and the executor builds after each frame
            vs = VideoDetector(det, dev_cfg, decode_cap=STREAM_DECODE_CAP)
            incr = {k: 0 for k in ops.launches()}
            builds = []
            for i, f in enumerate(frames):
                ops.reset_launches()
                rects, st = vs.process(f)
                counts = ops.launches()
                if st.mode == "incremental":
                    incr = {k: incr[k] + counts[k] for k in incr}
                builds.append(vs.engine.program_builds)
                if not np.array_equal(rects, dev_out[i][0]) \
                        or st != dev_out[i][1]:
                    return out, (f"stream static_cctv frame {i}: sequential "
                                 "!= pipelined")
            by_path["stream_incremental"] = incr
            print(f"stream_incremental launches: {incr}")
            missing = [k for k in (head_s, tail_c) if incr[k] <= 0]
            extra = [k for k in (head_a, split_b, inv_d) if incr[k]]
            if missing or extra:
                return out, (f"path stream_incremental: not launched "
                             f"{missing}, launched {extra}")
            if modes["incremental"] < 1:
                return out, "static_cctv had no incremental frame"
            if builds[-1] != builds[2]:
                return out, (f"static_cctv built executors after its third "
                             f"frame: {builds}")
            row["builds_per_frame"] = builds
            fn, i_step = stream_step_replay(
                VideoDetector(det, dev_cfg, decode_cap=STREAM_DECODE_CAP),
                frames)
            row["step_frame"] = i_step
            row["step_ms_events"] = cuda_ms(torch, fn, 20)
            row["step_device_ms"] = profiled_ms(torch, fn, 10)
            row["step_sat_ms"] = profiled_ms(torch, fn, 10, "sat_chained")
            row["step_c_ms"] = profiled_ms(torch, fn, 10, "packed_sums")
            out["step_kernel_c"], err = check_stream_step_c(torch, fn, smi)
            if err:
                return out, err
        if kind == "intermittent_cctv" and modes["cached"] < 1:
            return out, "intermittent_cctv had no cached frame"
        # ms per frame in turns: the pipelined device-state stream (a new
        # stream on the same engine, wall clock to a final synchronize) and
        # per-frame detect; on static_cctv also the host-planned stream,
        # once
        timed: dict = {"stream": [], "detect": []}
        turns = ["stream", "detect", "detect", "stream"]
        if kind == "static_cctv":
            turns.append("host")
        for label in turns:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if label == "stream":
                pipelined(VideoDetector(det, dev_cfg, vd.engine,
                                        decode_cap=STREAM_DECODE_CAP),
                          frames)
            elif label == "host":
                v = VideoDetector(det, scfg, vh.engine)
                for f in frames:
                    v.process(f)
            else:
                for f in frames:
                    det.detect(f)
            torch.cuda.synchronize()
            timed.setdefault(label, []).append(
                (time.perf_counter() - t0) * 1e3 / n)
        row["ms_per_frame"] = {k: sum(v) / len(v) for k, v in timed.items()}
        row["ms_per_frame_runs"] = timed
        out["scenarios"][kind] = row
        ms = row["ms_per_frame"]
        print(f"stream {kind}: modes {dict(modes)}, recompute share "
              f"{row['window_recompute_share']:.4f}, "
              f"{row['xfer_bytes_per_frame']:.0f} B/frame moved "
              f"(host-planned {row['host_xfer_bytes_per_frame']:.0f}); "
              f"cached windows off detect per frame {stale}, frames whose "
              f"rects differ {stale_frames}; ms/frame device-state "
              f"{ms['stream']:.2f}, detect {ms['detect']:.2f} [{smi}]")
        if kind == "static_cctv":
            print(f"  host-planned stream {ms['host']:.2f} ms/frame "
                  f"[{smi}]")
            print(f"  incremental step of frame {row['step_frame']}: "
                  f"{row['step_ms_events']:.3f} ms by CUDA events, device "
                  f"{row['step_device_ms']:.3f} ms (S {row['step_sat_ms']:.3f}"
                  f", C {row['step_c_ms']:.3f}) [{smi}]")
    return out, ""


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke run "
                    "needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {Path(__file__).name}: run "
                    "it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs import viola_jones
    from repro_torch.core import Detector
    from repro_torch.core.engine import nonzero_static
    from repro_torch.core.integral import window_inv_sigma
    from repro_torch.core.training.data import render_scene
    from repro_torch.kernels import native, ops
    from repro_torch.kernels import fused_head, haar_stage, packed_window
    from repro_torch.kernels import integral_image, window_variance
    from repro_torch.kernels.autotune import (DEFAULT_TILE,
                                              HEAD_TILE_CANDIDATES,
                                              LANE_BLOCK_CANDIDATES)
    from repro_torch.kernels.haar_stage import head_block_shape

    report: dict = {}
    # ------------------------------------------------------ 1. environment
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = nvidia_smi()
    print(f"card: {smi}")
    built = native.build_all()
    print(f"kernel build: {built['seconds']:.1f} s for "
          f"{len(built['built'])} sources")
    report["ptxas"] = {src: ptxas_entries(log)
                       for src, log in built["ptxas"].items()}
    for src, entries in report["ptxas"].items():
        for e in entries:
            print(f"  {src}: {e['entry']}: {e.get('registers')} registers, "
                  f"spill stores {e.get('spill_stores')} loads "
                  f"{e.get('spill_loads')} bytes")
    report["card"] = smi
    report["build_s"] = built["seconds"]

    dev = torch.device(DEVICE)
    cascade, imgs, cfg = main_path_workload(dev)
    stack = torch.from_numpy(np.stack(imgs)).to(dev)
    rows = []

    def row(name, kernel, source, replaces, err, ms, plain, work, lib=None):
        b_ms, b_by = bound_ms(*work)
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/csrc/{source}",
                     "replaces": replaces, "launches": 0,
                     "launches_by_path": {},
                     "max_abs_err": float(err), "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "_kernel": kernel})
        print(f"kernel {name}: max_abs_err {err:.3g} ms {ms:.4f} plain_ms "
              f"{plain:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {lib}")

    # ---------------------------------------------------------- 2. kernels
    # S: three SATs of level 0 of the flush
    ii, ii2, iic = integral_image.sat_tables(stack)
    plain = integral_image.sat_tables_plain(stack)
    torch.cuda.synchronize()
    err_s = max(float((a - b).abs().max()) for a, b in zip((ii, ii2, iic),
                                                           plain))
    for a, b in zip((ii, ii2, iic), plain):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-3)
    cpu = integral_image.sat_tables_plain(stack.cpu())
    n_diff = sum(int((a.cpu() != b).sum()) for a, b in zip((ii, ii2, iic),
                                                          cpu))
    if n_diff:
        return fail(f"kernel S differs from the CPU pinned order in {n_diff}"
                    " entries")
    # non-integer input: the float64 sums round, so only the serial order
    # gives the CPU's bits
    frac = torch.from_numpy((np.random.default_rng(SEED).random(
        (BATCH, H, W)) * 255.0).astype(np.float32))
    n_diff = sum(int((a.cpu() != b).sum()) for a, b in zip(
        integral_image.sat_tables(frac.to(dev)),
        integral_image.sat_tables_plain(frac)))
    if n_diff:
        return fail(f"kernel S differs from the CPU on non-integer input in "
                    f"{n_diff} entries")
    lib_in = torch.stack([stack, (stack - 128) ** 2, stack - 128])
    n_px = BATCH * H * W
    n_tab = BATCH * (H + 1) * (W + 1)
    s_ms = profiled_ms(torch, lambda: integral_image.sat_tables(stack), 20)
    cumsum_ms = profiled_ms(torch, lambda: torch.cumsum(torch.cumsum(
        lib_in, -2), -1), 20)
    print(f"kernel S == CPU on integer and non-integer input; S {s_ms:.4f} "
          f"ms, torch.cumsum {cumsum_ms:.4f} ms (x{cumsum_ms / s_ms:.2f}) at "
          f"{BATCH}x{H}x{W} [{smi}]")
    row("integral_image (S)", "integral_image", "integral_image.cu",
        "src/repro/kernels/integral_image.py:59", err_s, s_ms,
        cuda_ms(torch, lambda: integral_image.sat_tables_plain(stack), 3),
        (4 * n_px + 3 * 4 * n_tab, 14 * n_px), cumsum_ms)

    # A: the fused head's tile pass over S's tables, the dense prefix, in
    # every head tile (each its own launch shape); the row's ms is the
    # default tile's
    n_dense = 3
    kb = cascade.bounds
    k_dense = kb[n_dense]
    inv_p, sums_p = fused_head.tile_pass_plain(cascade, 0, n_dense, ii, ii2,
                                               iic)
    errors, err_a, a_ms, a_blocks = [], 0.0, {}, {}
    for tile in HEAD_TILE_CANDIDATES:
        label = tile_label(tile)
        inv_t, sums_t = fused_head.tile_pass(cascade, 0, n_dense, ii, ii2,
                                             iic, tile=tile)
        torch.cuda.synchronize()
        a_blocks[label] = fused_head.KERNEL.last_block
        if a_blocks[label] != head_block_shape(tile):
            errors.append(f"kernel A {label} launched in {a_blocks[label]}")
        errors += [f"kernel A {label} {what}: {d}" for what, d in (
            ("1/sigma", diff(inv_t, inv_p)), ("sums", diff(sums_t, sums_p)))
            if d]
        err_a = max(err_a, float((inv_t - inv_p).abs().max()),
                    float((sums_t - sums_p).abs().max()))
        a_ms[label] = profiled_ms(
            torch, lambda tile=tile: fused_head.tile_pass(
                cascade, 0, n_dense, ii, ii2, iic, tile=tile), 10)
        if tile == DEFAULT_TILE:
            inv_a, sums_a = inv_t, sums_t
    n_win = inv_p.numel()
    sat_bytes = 3 * 4 * n_tab
    param_bytes = PARAM_BYTES
    print(f"kernel A per head tile (ms, block): "
          f"{ {k: (round(v, 4), a_blocks[k]) for k, v in a_ms.items()} } "
          f"[{smi}]")
    row("fused_head (A)", "fused_head", "fused_head.cu",
        "src/repro/kernels/fused_head.py:124", err_a,
        a_ms[tile_label(DEFAULT_TILE)],
        cuda_ms(torch, lambda: fused_head.tile_pass_plain(
            cascade, 0, n_dense, ii, ii2, iic), 2),
        (sat_bytes + param_bytes * k_dense + 4 * n_win * (1 + n_dense),
         n_win * (13 + 20 * k_dense)))
    rows[-1].update(ms_by_tile=a_ms, block_by_tile=a_blocks)

    # D: the public API's 1/sigma grid over S's tables of level 0
    ny, nx = H - 23, W - 23
    inv_d = window_variance.inv_sigma_grid(ii2, iic, ny, nx)
    inv_dp = window_variance.inv_sigma_grid_plain(ii2, iic, ny, nx)
    torch.cuda.synchronize()
    if diff(inv_d, inv_dp):
        errors.append(f"kernel D: {diff(inv_d, inv_dp)}")
    gap = (inv_d - inv_a).abs()
    n_over = past_order_bound(torch, inv_d, inv_a, ii2, iic)
    if n_over:
        errors.append(f"kernel D vs kernel A 1/sigma: {n_over} windows past "
                      "the corner-order rounding bound")
    n_rel = int((~torch.isclose(inv_d, inv_a, **INV_TOL)).sum())
    print(f"kernel D vs kernel A 1/sigma (corner orders differ): max abs "
          f"{float(gap.max()):.3g}, max rel "
          f"{float((gap / inv_a).max()):.3g}; {n_rel} of {gap.numel()} "
          f"windows past {INV_TOL}, 0 past the rounding bound")
    report["d_vs_a"] = {"max_abs": float(gap.max()),
                        "max_rel": float((gap / inv_a).max()),
                        "past_rtol_1e-4": n_rel, "windows": gap.numel()}
    row("window_inv_sigma (D)", "window_variance", "window_variance.cu",
        "src/repro/kernels/window_variance.py:44",
        float((inv_d - inv_dp).abs().max()),
        profiled_ms(torch, lambda: window_variance.inv_sigma_grid(
            ii2, iic, ny, nx), 20),
        cuda_ms(torch, lambda: window_variance.inv_sigma_grid_plain(
            ii2, iic, ny, nx), 3),
        (2 * 4 * n_tab + 4 * n_win, 13 * n_win))

    # B: the dense stages and the cascade's largest stage over S's SAT and
    # the split head's 1/sigma grid, in every head tile; the dense stages'
    # sums equal A's (fused == split); timed on stage 2
    inv_b = window_inv_sigma((ii2, iic), torch.arange(ny, device=dev)[:, None],
                             torch.arange(nx, device=dev)[None, :], 24)
    if diff(inv_b, inv_a):
        errors.append(f"split-head 1/sigma vs kernel A: {diff(inv_b, inv_a)}")
    big = max(range(cascade.n_stages), key=lambda s: kb[s + 1] - kb[s])
    wants = {s: haar_stage.dense_sums_plain(cascade, kb[s], kb[s + 1], ii,
                                            inv_b)
             for s in (*range(n_dense), big)}
    s_b = 2
    err_b, b_ms, b_blocks = 0.0, {}, {}
    for tile in HEAD_TILE_CANDIDATES:
        label = tile_label(tile)
        for s, want in wants.items():
            got = haar_stage.stage_sums(cascade, s, ii, inv_b, tile=tile)
            torch.cuda.synchronize()
            if diff(got, want):
                errors.append(f"kernel B {label} stage {s}: "
                              f"{diff(got, want)}")
            if s < n_dense and diff(got, sums_a[:, s]):
                errors.append(f"kernel B {label} stage {s} vs kernel A: "
                              f"{diff(got, sums_a[:, s])}")
            err_b = max(err_b, float((got - want).abs().max()))
        b_blocks[label] = haar_stage.KERNEL.last_block
        if b_blocks[label] != head_block_shape(tile):
            errors.append(f"kernel B {label} launched in {b_blocks[label]}")
        b_ms[label] = profiled_ms(
            torch, lambda tile=tile: haar_stage.stage_sums(
                cascade, s_b, ii, inv_b, tile=tile), 10)
    k_b = kb[s_b + 1] - kb[s_b]
    print(f"kernel B stage {s_b} per head tile (ms, block): "
          f"{ {k: (round(v, 4), b_blocks[k]) for k, v in b_ms.items()} }; "
          f"stages {list(wants)} ({kb[big + 1] - kb[big]} classifiers in "
          f"stage {big}) equal to the plain version [{smi}]")
    row("haar_stage (B)", "haar_stage", "haar_stage.cu",
        "src/repro/kernels/haar_stage.py:71", err_b,
        b_ms[tile_label(DEFAULT_TILE)],
        cuda_ms(torch, lambda: haar_stage.dense_sums_plain(
            cascade, kb[s_b], kb[s_b + 1], ii, inv_b), 2),
        (4 * n_tab + 4 * n_win + param_bytes * k_b + 4 * n_win,
         n_win * 20 * k_b))
    rows[-1].update(ms_by_tile=b_ms, block_by_tile=b_blocks)

    # C: the first tail segment's real packed list of the main-path flush
    det = Detector(cascade, cfg, device=DEVICE)
    hp, wp = det._bucket_hw(H, W)
    plan = det.batch_plan(hp, wp, BATCH)
    head_fn, _tail_fn = det.batch_parts(hp, wp, BATCH)
    flush_in = det._stack_to_device(*det._pack_stack(imgs, hp, wp))
    alive_flat, inv_flat, ii_flat, head_counts = head_fn(*flush_in)
    # S at every pyramid level of the flush: the small levels take a few
    # microseconds of device time, less than the host needs to launch them,
    # so the profiler (not a clock around back-to-back calls) times them
    s_levels = [profiled_ms(torch, lambda x=torch.zeros(
        (BATCH, lp.height, lp.width), device=dev): integral_image.sat_tables(
        x), 5, "sat_chained") for lp in plan.levels]
    print(f"kernel S per level ({len(s_levels)} levels, {BATCH} images, "
          f"profiler device time): {[round(t, 4) for t in s_levels]} ms, "
          f"{sum(s_levels):.4f} ms per flush")
    report["sat_per_level_ms"] = s_levels
    seg = plan.tail_segments[0]
    idx, cnt = nonzero_static(alive_flat, seg.capacity)
    sel = idx.clamp(min=0)
    lay = plan.layout
    slot = (sel % plan.n_slots).cpu().numpy()
    lvl = lay.lvl_of_slot[slot]

    def lane(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    lanes = (lane((sel // plan.n_slots).cpu().numpy()),
             lane(lay.sat_base_of_lvl[lvl]), lane(lay.sat_stride_of_lvl[lvl]),
             lane(lay.y_of_slot[slot]), lane(lay.x_of_slot[slot]))
    inv_c = inv_flat[sel].contiguous()
    n_live = cnt.clamp(max=seg.capacity)      # as the engine's tail passes it
    c_args = (cascade, seg.s0, seg.s1, ii_flat, *lanes, inv_c)
    want = packed_window.stage_sums_plain(*c_args)
    want_live = packed_window.stage_sums_plain(*c_args, n_live)
    err_c = 0.0
    for block in LANE_BLOCK_CANDIDATES:
        for count, ref_out in ((None, want), (n_live, want_live)):
            got = packed_window.stage_sums(*c_args, n_live=count,
                                           lane_block=block)
            torch.cuda.synchronize()
            if diff(got, ref_out):
                errors.append(f"kernel C {block} n_live="
                              f"{'all' if count is None else 'live'}: "
                              f"{diff(got, ref_out)}")
            if got.numel():
                err_c = max(err_c, float((got - ref_out).abs().max()))
    if errors:
        return fail("; ".join(errors))
    cap = inv_c.numel()
    k_c = kb[seg.s1] - kb[seg.s0]
    n_run = seg.s1 - seg.s0
    n_valid = int((idx >= 0).sum())
    live = int(n_live)
    print(f"packed list: {cap} lanes, {n_valid} valid ({live} live), stages "
          f"[{seg.s0}, {seg.s1}), {k_c} weak classifiers")

    def c_work(lanes_read):
        """Bytes and operations of C evaluating ``lanes_read`` lanes: the
        SAT, those lanes' six arrays and the whole output."""
        return (4 * ii_flat.numel() + 4 * 6 * lanes_read + param_bytes * k_c
                + 4 * cap * n_run, lanes_read * 20 * k_c)

    c_all = profiled_ms(torch, lambda: packed_window.stage_sums(*c_args), 5)
    c_live = profiled_ms(torch, lambda: packed_window.stage_sums(
        *c_args, n_live=n_live), 10)
    b_all, _ = bound_ms(*c_work(cap))
    b_live, _ = bound_ms(*c_work(live))
    print(f"kernel C all {cap} lanes: {c_all:.4f} ms (bound {b_all:.4f}); "
          f"{live} live lanes (n_live): {c_live:.4f} ms (bound "
          f"{b_live:.4f}); x{c_all / c_live:.2f} [{smi}]")
    row("packed_window (C)", "packed_window", "packed_window.cu",
        "src/repro/kernels/packed_window.py:95", err_c, c_live,
        cuda_ms(torch, lambda: packed_window.stage_sums_plain(
            *c_args, n_live), 1), c_work(live))
    rows[-1].update(ms_all_lanes=c_all, bound_ms_all_lanes=b_all,
                    lanes=cap, live_lanes=live)
    report["packed_list"] = {"lanes": cap, "valid": n_valid, "live": live,
                             "stages": [seg.s0, seg.s1], "weak": k_c}

    # -------------------------------------------------------- 3. main path
    by_path: dict = {}

    def on_path(label, fn, need, never):
        """Run ``fn`` with the launch counts set to 0 just before it; ''
        when it launched every kernel of ``need`` and none of ``never``."""
        ops.reset_launches()
        out = fn()
        counts = ops.launches()
        by_path[label] = counts
        print(f"{label} launches: {counts}")
        missing = [k for k in need if counts[k] <= 0]
        extra = [k for k in never if counts[k] != 0]
        if missing or extra:
            return out, (f"path {label}: not launched {missing}, launched "
                         f"against its head {extra}")
        return out, ""

    det_split = Detector(cascade, cfg._replace(head_mode="split"),
                         device=DEVICE)
    head_s, head_a = "integral_image", "fused_head"
    split_b, tail_c = "haar_stage", "packed_window"
    inv_d_k = "window_variance"
    fused_rects, err = on_path(
        "fused", lambda: det.detect_batch(imgs, group=False),
        (head_s, head_a, tail_c), (split_b, inv_d_k))
    if err:
        return fail(err)
    split_rects, err = on_path(
        "split", lambda: det_split.detect_batch(imgs, group=False),
        (head_s, split_b, tail_c), (head_a, inv_d_k))
    if err:
        return fail(err)
    for i, (a, b) in enumerate(zip(fused_rects, split_rects)):
        if not np.array_equal(a, b):
            return fail(f"fused and split heads differ on image {i}")
    # detect's per-level halving capacities overflow on some levels of this
    # random cascade, so the single-image run keeps every survivor
    det_one = Detector(cascade, cfg._replace(
        capacity_fracs=(1.0,) * len(plan.tail_segments)), device=DEVICE)
    one_rects, err = on_path(
        "detect", lambda: [det_one.detect(imgs[i], group=False)
                           for i in range(2)],
        (head_s, head_a, tail_c), (split_b, inv_d_k))
    if err:
        return fail(err)
    for i, rects in enumerate(one_rects):
        if not np.array_equal(rects, fused_rects[i]):
            return fail(f"detect != detect_batch on image {i}")
    n_raw = [len(r) for r in fused_rects]
    if not all(np.isfinite(r).all() and r.shape[1] == 4
               for r in fused_rects) or sum(n_raw) == 0:
        return fail(f"unexpected detections {n_raw}")
    builds = det.program_builds
    det.detect_batch(imgs, group=False)
    if det.program_builds != builds:
        return fail("a repeat flush rebuilt a program")
    print(f"raw detections per image: {n_raw}")
    # the plan's head_tile reaches the launch: a flush per head and tile
    # launches its dense kernel in that tile's block, with the same rects
    for tile in HEAD_TILE_CANDIDATES:
        for head, mod in (("fused", fused_head), ("split", haar_stage)):
            d = Detector(cascade, cfg._replace(head_mode=head, head_tile=tile),
                         device=DEVICE)
            mod.KERNEL.last_block = None
            rects = d.detect_batch(imgs, group=False)
            if mod.KERNEL.last_block != head_block_shape(tile):
                return fail(f"{head} flush in head tile {tile} launched in "
                            f"{mod.KERNEL.last_block}")
            if any(not np.array_equal(a, b)
                   for a, b in zip(rects, fused_rects)):
                return fail(f"{head} flush in head tile {tile} changed the "
                            "rects")
    shapes = [head_block_shape(t) for t in HEAD_TILE_CANDIDATES]
    print(f"head tiles {list(HEAD_TILE_CANDIDATES)}: fused and split flushes "
          f"launched in blocks {shapes}, rects unchanged")
    flush = {}
    for label, d in (("fused", det), ("split", det_split)):
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            d.detect_batch(imgs, group=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        flush[label] = {"ms_per_flush": ms, "imgs_per_s": BATCH / ms * 1e3}
        print(f"main path {label}: {ms:.2f} ms per flush of {BATCH} x "
              f"{H}x{W}, {BATCH / ms * 1e3:.1f} imgs/s [{smi}]")
    head_fn, tail_fn = det.batch_parts(hp, wp, BATCH)
    head_out = head_fn(*flush_in)
    flush["head_ms"] = cuda_ms(torch, lambda: head_fn(*flush_in), 3)
    flush["tail_ms"] = cuda_ms(torch, lambda: tail_fn(*head_out), 3)
    print(f"fused flush device time: head {flush['head_ms']:.2f} ms, tail "
          f"{flush['tail_ms']:.2f} ms [{smi}]")
    report["main_path"] = flush
    report["raw_detections"] = n_raw

    bad, err = on_path("kernel_api", lambda: check_kernel_api(torch, stack),
                       (head_s, inv_d_k),
                       (head_a, split_b, tail_c))
    torch.cuda.synchronize()
    if err or bad:
        return fail(err or "; ".join(bad))
    print(f"kernel API == twins at {list(KERNEL_API_SHAPES) + [(H, W)]}")

    # ---------------------------------------------------- 4. card vs CPU
    pre, _meta = viola_jones.pretrained()
    faces = scenes(render_scene, 3, 240, 320, SEED + 1, n_faces=2)
    # the 3-stage cascade is all dense prefix: no tail, no kernel C
    on_card, err = on_path(
        "card_vs_cpu", lambda: Detector(pre, cfg, device=DEVICE).detect_batch(
            faces), (head_s, head_a), (split_b, inv_d_k))
    if err:
        return fail(err)
    on_cpu = Detector(pre, cfg, device="cpu").detect_batch(faces)
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if not np.array_equal(a, b):
            return fail(f"card and CPU rects differ on face scene {i}")
    print(f"card == CPU on {len(faces)} face scenes: "
          f"{[len(r) for r in on_card]} grouped rects")

    # ------------------------------------------------- 5. calibration
    t_cal = time.perf_counter()
    probe = calibration_probe(head_counts, plan)
    cal, err = on_path(
        "calibrate", lambda: calibrate_main_path(det, imgs, probe),
        (head_s, head_a, split_b, tail_c), (inv_d_k,))
    if err:
        return fail(err)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t_cal
    prof = cal.cal_profile
    cal_plan = cal.batch_plan(hp, wp, BATCH)
    cap_cal = cal_plan.tail_segments[0].capacity
    cap_def = plan.tail_segments[0].capacity
    print(f"calibration: probe image {probe}, {cal_s:.1f} s, tail sizes "
          f"{TAIL_SIZES} [{smi}]")
    print(f"  tail rungs {prof['tail']['rungs']} crossover "
          f"{prof['tail']['crossover']} ms {prof['tail']['ms']}")
    print(f"  head rungs {prof['head']['rungs']} crossover "
          f"{prof['head']['crossover']}")
    tile_ms = prof["head"]["tile_ms"]
    print(f"  head-tile race, fused device ms per level: {tile_ms}; totals "
          f"{ {k: round(sum(v), 4) for k, v in tile_ms.items()} }; winner "
          f"head_tiles {prof['head_tiles']}")
    # the chosen tile beside phase 2's profiled A times at level 0
    a_tile_ms = next(r for r in rows if r["name"] == "fused_head (A)")[
        "ms_by_tile"]
    fastest = min(a_tile_ms, key=a_tile_ms.get)
    print(f"  kernel A at level 0 (phase 2): chosen "
          f"{tile_label(prof['head_tiles'])} "
          f"{a_tile_ms[tile_label(prof['head_tiles'])]:.4f} ms, fastest "
          f"{fastest} {a_tile_ms[fastest]:.4f} ms")
    print(f"  lane_block {prof['lane_block']} of a race at "
          f"{prof['lane']['size']} lanes, ms per candidate "
          f"{dict(zip(map(str, prof['lane']['candidates']), prof['lane']['ms']))}")
    print(f"  batch_capacity_fracs {cal.config.batch_capacity_fracs}")
    print(f"  first tail segment: {cap_cal} lanes calibrated, {cap_def} "
          f"default")
    dense_kernels = (fused_head.KERNEL, haar_stage.KERNEL)
    for k in dense_kernels:
        k.last_block = None
    try:
        cal_rects = cal.detect_batch(imgs, group=False)
    except RuntimeError as e:
        return fail(f"calibrated flush: {e}")
    cal_block = head_block_shape(cal_plan.head_tile)
    blocks = [k.last_block for k in dense_kernels if k.last_block]
    if not blocks or any(b != cal_block for b in blocks):
        return fail(f"calibrated flush launched its dense kernels in "
                    f"{blocks}, not head_block_shape({cal_plan.head_tile}) "
                    f"= {cal_block}")
    print(f"  calibrated flush: head_tile {cal_plan.head_tile} launched in "
          f"block {cal_block}")
    for i, (a, b) in enumerate(zip(cal_rects, fused_rects)):
        if not np.array_equal(a, b):
            return fail(f"calibrated and default flushes differ on image {i}")
    builds = cal.program_builds
    cal.detect_batch(imgs, group=False)
    if cal.program_builds != builds:
        return fail("a repeat calibrated flush rebuilt a program")
    timed: dict = {"default": [], "calibrated": []}
    for label, d in (("default", det), ("calibrated", cal),
                     ("calibrated", cal), ("default", det)):
        t0 = time.perf_counter()
        for _ in range(3):
            d.detect_batch(imgs, group=False)
        torch.cuda.synchronize()
        timed[label].append((time.perf_counter() - t0) / 3 * 1e3)
    cal_head, cal_tail = cal.batch_parts(hp, wp, BATCH)
    cal_out = cal_head(*flush_in)
    calib = {"seconds": cal_s, "probe": probe, "tail_sizes": TAIL_SIZES,
             "tail_rungs": prof["tail"]["rungs"],
             "tail_crossover": prof["tail"]["crossover"],
             "tail_ms": prof["tail"]["ms"],
             "head_rungs": prof["head"]["rungs"],
             "head_crossover": prof["head"]["crossover"],
             "head_tiles": prof["head_tiles"],
             "head_tile_ms": prof["head"]["tile_ms"],
             "head_tile_block": cal_block,
             "head_tile_a_level0_ms": a_tile_ms,
             "lane_block": prof["lane_block"],
             "lane_race": {"size": prof["lane"]["size"],
                           "candidates": prof["lane"]["candidates"],
                           "ms": prof["lane"]["ms"]},
             "batch_capacity_fracs": cal.config.batch_capacity_fracs,
             "densities": prof["densities"],
             "first_segment_lanes": {"calibrated": cap_cal,
                                     "default": cap_def},
             "tail_ms_calibrated": cuda_ms(torch, lambda: cal_tail(*cal_out),
                                           3)}
    for label, ms_list in timed.items():
        ms = sum(ms_list) / len(ms_list)
        calib[label] = {"ms_per_flush": ms, "imgs_per_s": BATCH / ms * 1e3}
        print(f"{label} flush: {ms:.2f} ms per flush, "
              f"{BATCH / ms * 1e3:.1f} imgs/s (runs {ms_list}) [{smi}]")
    print(f"calibrated flush device time: tail "
          f"{calib['tail_ms_calibrated']:.2f} ms [{smi}]")
    report["calibration"] = calib

    # ------------------------------------------------------ 6. streaming
    t_stream = time.perf_counter()
    stream, err = check_stream(torch, on_path, by_path, smi)
    if err:
        return fail(err)
    stream["seconds"] = time.perf_counter() - t_stream
    print(f"streaming phase: {stream['seconds']:.1f} s")
    report["stream"] = stream
    # kernel C on the stream step's inputs, beside its batched-tail row
    next(r for r in rows if r["_kernel"] == tail_c)["stream_step"] = \
        stream.pop("step_kernel_c")

    # each kernel's launches are those of the first path that runs it: S, A
    # and C on the fused flush, B on the split flush, D on the kernel API
    launch_path = {split_b: "split", inv_d_k: "kernel_api"}
    for r in rows:
        k = r.pop("_kernel")
        r["launches"] = by_path[launch_path.get(k, "fused")][k]
        r["launches_by_path"] = {p: c[k] for p, c in by_path.items()}
    report["kernels"] = rows
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"stream": stream}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
