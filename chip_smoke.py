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
   in the kernels line);
7. the service: ``repro_torch.serve.DetectorService`` on phase 3's
   capacity-1.0 detector (the configuration of phase 6's streams) with two
   pods (big 1.0, LITTLE 0.45), ``max_batch`` 8 and the energy governor,
   its rates seeded from phase 3's measured flush.  Sixteen one-shot
   requests (the first eight frames of phase 6's ``static_cctv`` video,
   twice: the service groups rects, and grouping, quadratic in the raw
   windows, would take far longer on phase 3's scenes) in one flush give ``detect``'s
   rects per image, and a repeat flush under the same rates builds no
   program.  In one flush beside four one-shots, two device-state
   sessions and one host-planned session over the same frames (phase 6's
   stream config and decode list) give a lone ``VideoDetector``'s rects
   and ``FrameStats`` per frame, in order; every pod shard of frames that
   are all incremental or cached launches no dense kernel and makes at
   most one ``StreamEngine.incremental`` call.  The background flusher
   (``start()``, ``max_delay_ms`` 10), stopped with a device-state
   session and one-shots in flight, completes every request with the
   same rects.  No request may carry ``error``.  Then ms per flush of the
   service beside bare ``detect_batch`` of the same sixteen images (with
   and without grouping), in turns, the latency percentiles, pod shares
   and the governor's decision; and the paper's modelled pipeline from a
   profile measured on the card (``work_profile`` ->
   ``WorkModel.from_profile`` -> ``build_detection_dag`` -> ``simulate``
   under every policy on the Odroid XU4 and RPi 3B+ power models: their
   makespans and joules are those models', not the card's);
8. the fleet: ``repro_torch.serve.FleetScheduler`` over phase 7's service
   (its capacity the service's seeded rates), four sessions of phase 6's
   ``static_cctv`` and ``moving_face`` frames at 480x640: admissions up
   to and past the headroom, an overload that degrades best_effort to the
   ladder's cap before standard and never realtime, ``FLEET_FRAMES``
   frames per session flushed tier by tier (each session equal to a lone
   ``VideoDetector`` on its stretched config: rects, ``FrameStats``,
   order), shedding only once the ladder is exhausted and only
   best_effort, and recovery with hysteresis; ms per fleet flush and the
   launches of S, A and C per flush (``check_fleet``);
9. training: ``repro_torch.core.training.train_cascade`` at
   ``scripts/train_pretrained.py``'s widths (``n_stages`` cut to 3) on
   the card and on the CPU, the same stumps; seconds per stage, the
   profiler's device ms of one ``feature_values`` call and of one
   boosting round; then the trained cascade through ``detect_batch`` on
   the card (S, A, C) and on the CPU, equal rects (``check_training``);
10. LM serving: ``repro_torch.serve.generate`` at ``olmo-1b``'s full width
   in bf16 (weights from a seed): 8 prompts of 512 tokens, 32 new tokens,
   greedy; ms per prefill and per decode step, tokens per second, peak
   device memory; cascade early-exit decode steps (thresholds above 1
   give the plain decode's tokens at full depth, threshold 0 after group
   3 gives depth 4, one middle setting its mean depth and modelled
   saving); a float32 copy on the card and on the CPU, equal greedy tokens
   and logits within 2e-3; the blockwise flash forward against its oracle
   at (1, 4096, 16, 128) bf16, timed beside
   ``scaled_dot_product_attention``; the same prompts through prefill and
   decode steps made with ``donate=True`` (each step writes the cache it
   is given), interleaved step by step with the functional steps:
   ``generate``'s tokens from both, the cache's tensors returned, ms per
   prefill and decode step of both in one window (``check_lm``).  The
   LM stack has no hand kernel: this phase launches none of S, A, B, C, D.
11. LM training: ``repro_torch.train`` at ``olmo-1b``'s full width (bf16
   params, float32 moments, remat ``"block"``, weights from a seed),
   ``LM_TRAIN_STEPS`` steps of 8 x 2048 tokens in microbatches of 4:
   finite losses, grad norms, ms per step, tokens per second, model-FLOP
   utilisation, peak device memory beside the same step's with remat off;
   a float32 2-layer copy on the card and on the CPU (1 x 1100 tokens,
   TF32 off): loss and every gradient leaf within ``LM_TRAIN_CHECK``'s
   tolerances, then ``adamw_update`` fed the CPU's gradients on both;
   a restart (2 steps, checkpoint, restore, 2 steps) equal to 4 straight
   steps; the flash backward at (1, 4096, 16, 128) bf16 against float32
   autograd through the oracle, timed beside the backward of
   ``scaled_dot_product_attention`` and its bound; the same steps from
   the same state made with ``donate=True`` (parameters and moments
   updated in place): every loss and grad norm, and step 1's parameters
   and moments, equal to the functional run's bit for bit, every returned
   tensor the given one, ms per step, and the peak of allocated memory,
   split at the optimizer update into the forward-and-backward's and the
   update's (``check_lm_train``).  No hand kernel runs: this phase
   launches none of S, A, B, C, D.
12. the mesh path: ``repro_torch.distributed`` (DTensor) on a one-rank
   NCCL mesh (``one_rank_mesh``: ``make_smoke_mesh(1, 1)``, ZeRO and
   sequence parallelism on), at ``olmo-1b``'s full width: phase 11's
   steps from the same state (losses and step-1 parameters against phase
   11's, bit for bit or within the reference's sharded bounds;
   placements kept; ms per step beside phase 11's; peak memory; one
   profiled step's device time and the host's share), phase 10's prompts
   for ``MESH_NEW`` greedy tokens through the 2D decode layout (phase
   10's tokens; ms per prefill and decode step beside phase 10's), the
   ``qwen3-moe`` smoke experts in both ``shard_map`` forms against one
   device, ``compressed_psum`` over NCCL against
   ``decompress_leaf(compress_leaf(g))`` bit for bit, step 1's parameters
   saved and restored onto the mesh (``shardings=``) and into the
   one-device model (0 entries differ), the dry run of ``MESH_DRYRUN`` on
   the production meshes in subprocesses (per-device argument
   bytes, tracked peak, FLOPs and bytes accessed of the local operations,
   collective bytes, roofline terms; each step donating its state or
   cache), and phase 11's step against its analytic roofline at H100
   constants (``check_lm_mesh``).  No hand kernel runs: this phase
   launches none of S, A, B, C, D.
13. the examples: ``examples/torch_quickstart.py``,
   ``torch_cascade_serving.py``, ``torch_video_stream.py``,
   ``torch_energy_tuned_detection.py`` and ``torch_early_exit_serving.py``
   (the repository's user surfaces, through ``repro_torch`` only), each
   ``main()`` on the card (no ``--device``): it returns 0 and prints its
   identity lines (``batched==sequential: True`` for every image, ``rects
   == detect: True`` for every frame) (``check_examples``).  Its launches
   are counted and not required: the examples' detectors keep
   ``EngineConfig``'s default ``use_pallas=False``.
14. the static checks: ``python -m repro_torch.analysis`` with its default
   paths (the port's package, ``tests/test_torch_*.py``,
   ``examples/torch_*.py``, ``scripts/port_*.py`` and this file) in a
   subprocess from the repository root: exit code 0, the files scanned,
   the suppressed findings by rule, the gate's seconds and the subprocess's
   wall seconds, and the kernel / twin pairs its ``KERNEL_REF_TWIN`` reads
   from ``kernels/ops.py`` (``check_analysis``).  The gate runs on the
   host: this phase launches none of S, A, B, C, D.

Every path driven on the card runs with the launch counts set to 0 just
before it and read just after: each must have launched the kernels of its
path (fused: S, A, C; split: S, B, C; ``detect``: S, A, C; kernel API: S,
D; card vs CPU: S, A; calibrate: S, A, B, C; stream, the whole pipelined
device-state ``static_cctv`` run: S, A on keyframes, C; stream_incremental,
that stream's incremental frames alone, run one at a time: S and C;
service, the one-shot flush: S, A, C; service_stream, the sessions'
flush: S, A on keyframes and one-shots, C; service_background, the
background flusher's run: S, A, C; fleet, the fleet's frames: S, A on
keyframes, C; trained, the trained cascade's flush: S, A, C) and none it
must not (no engine, service or fleet path launches D; no stream,
service or fleet path B; an incremental frame no dense kernel; lm, the
whole LM phase, none of the five; lm_train, the whole training phase,
none of the five; lm_mesh, the whole mesh phase, none of the five;
examples, the five examples, any; analysis, the static checks, none of the
five).

Device times come from ``profiled_ms``, which divides a trace's device
time by the launches the trace holds, not by the calls requested.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, one ``{"stream": {...}}``, ``{"service": {...}}``, ``{"fleet":
{...}}``, ``{"training": {...}}``, ``{"lm": {...}}``, ``{"lm_train": {...}}``, ``{"lm_mesh":
{...}}``, ``{"examples": {...}}`` and ``{"analysis": {...}}`` line each, and
last ``{"ok": true,
"device": {...}}``; it exits non-zero, with no result line, when there is
no CUDA device or no checkout around it.

Bounds (``bound_ms``) are the larger of the bytes the call must move (each
input read once, each output written once) over 3.35 TB/s and its float
operations over 67 TFLOP/s (H100 SXM float32, NVIDIA data sheet): add,
subtract, multiply, divide, square root, max, compare and select count one
each; a float64 add counts two (the card's float64 rate is half its
float32 rate).  Per weak classifier and window: 3 rectangles x (3 corner
add/sub + 1 multiply + 1 add) + normalize (2) + compare, select, add = 20.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
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
# phase 2's kernel E row: the benchmark cell's flush of 16 scenes, whose
# first tail segment holds 13,802,064 lanes at 480x640
E_BATCH = 16
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
# phase 7: the service's pods (name, nominal speed, DVFS cluster) and the
# frames per stream session
SERVICE_PODS = (("big", 1.0, "big"), ("little", 0.45, "LITTLE"))
SERVICE_FRAMES = 8
# phase 8: the fleet's sessions' stream config (phase 6's, with a keyframe
# every other frame, so the ladder's stretched cadence shows) and frames
FLEET_STREAM = dict(STREAM_CONFIG, keyframe_interval=2)
FLEET_FRAMES = 6
# phase 9: scripts/train_pretrained.py's training widths, n_stages cut from
# 14 to 3 for time; card vs CPU tolerance; face scenes for detection
TRAIN_CONFIG = dict(n_stages=3, n_pos=1200, n_neg=1200, max_features=3500,
                    max_weak_per_stage=60, stage_fpr=0.4, stage_dr=0.997,
                    seed=7)
TRAIN_RTOL = 1e-6
TRAIN_SCENES = 3
# phase 10: LM serving at olmo-1b's full width (bf16): prompts, their
# length, new tokens per prompt, cascade steps; the float32 card-vs-CPU
# check (batch, prompt length, decode steps, the reference's decode
# tolerance, tests/test_models.py); the attention yardstick's (B, S, H, D)
LM_ARCH = "olmo-1b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 32
LM_CASCADE_STEPS = 8
# the float32 card-vs-CPU copy: a prompt past olmo-1b's attn_chunk_kv
# (1024) and attn_chunk_q (512), so the prefill's flash runs 3 q blocks
# over 2 kv blocks and each decode step reads a cache of 1100+ entries
LM_CHECK = dict(batch=1, prompt=1100, steps=4, atol=2e-3)
LM_ATTN_SHAPE = (1, 4096, 16, 128)
# the flash may differ from the float32 oracle by its rounding of the
# probabilities to bf16: at most this many of that rounding's standard
# deviations per entry (the CPU's largest at (1, 4096, 2, 128) was 3.1)
LM_ATTN_SIGMAS = 6.0
BF16_OPS = 989e12    # H100 SXM dense bf16 tensor-core rate (data sheet)
# phase 11: LM training at olmo-1b's full width: 8 sequences of OLMo's
# 2048-token context per step in microbatches of 4 (16,384 tokens); peak
# lr 4e-4 and 2000 warm-up steps as OLMo-1B (arXiv:2402.00838), AdamW's
# betas 0.9 / 0.95, weight decay 0.1 and clip 1.0 the port's defaults (the
# schedule's total length never matters inside the warm-up); the timed
# steps are the median of steps 2..6
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 8, 2048, 4
LM_TRAIN_STEPS = 6
LM_TRAIN_OPT = dict(peak_lr=4e-4, warmup=2000)
# the float32 card-vs-CPU and restart checks: n_layers cut 16 -> 2 (the
# CPU side near ten seconds), 1 x 1100 tokens (past both flash chunks);
# gradient leaves within grad_rel of the leaf's largest |g|, the loss at
# loss_rtol, AdamW's outputs within adamw_rtol (and that share of the
# leaf's largest |value|: the card's and the CPU's global norms are sums
# in another order)
LM_TRAIN_CHECK = dict(n_layers=2, batch=1, seq=1100, grad_rel=1e-4,
                      loss_rtol=1e-5, adamw_rtol=1e-6)
# the flash backward yardstick: each gradient entry within one bf16 ulp of
# the float32 oracle's plus this share of the tensor's largest |value|
# (the roundings of p and ds to bf16 before their products, summed over
# up to 4096 keys or queries, exceed one ulp of a small entry)
LM_BWD_ATOL_SHARE = 2 ** -6
# phase 12: the mesh path on a one-rank NCCL mesh, phase 11's training
# (steps from the same state; the first holds the step's DTensor set-up;
# at one rank every loss, grad norm and step-1 moment equals phase 11's
# bit for bit) and phase 10's serving (the first new tokens); the
# reference's sharded-vs-local MoE bounds (tests/test_distributed.py:
# 111-114); the dry-run cells (arch, shape, multi-pod) priced on the
# production meshes
MESH_TRAIN_STEPS = 3
MESH_NEW = 8
MESH_BOUNDS = dict(moe=5e-4, aux=5e-3)
MESH_MOE_TOKENS = (4, 16)
MESH_DRYRUN = (("olmo-1b", "train_4k", False),
               ("olmo-1b", "train_4k", True),
               ("qwen3-moe-235b-a22b", "decode_32k", False),
               ("recurrentgemma-2b", "decode_32k", False))
MESH_DRYRUN_TIMEOUT = 600
# phase 14: the static checks' time limit (the gate takes a few seconds)
ANALYSIS_TIMEOUT = 300


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


def rounding_sigma(torch, q, k, v):
    """Per output entry of causal attention (q, k, v: (B, S, H, D)), the
    standard deviation of what rounding each probability p_j to bf16
    (relative error at most 2^-8, zero mean, independent) adds to
    sum_j p_j v_j: 2^-8 / sqrt(3) * sqrt(sum_j p_j^2 v_j^2), float32."""
    S, D = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill_(~causal, float("-inf")), -1)
    vf = v.float()
    return (torch.einsum("bhqk,bkhd->bqhd", p.square_(), vf * vf).sqrt_()
            * 2 ** -8 / 3 ** 0.5)


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


# each hand kernel's entry name (what ``kernel`` filters a trace by) and
# the module whose wrapper counts its launches
KERNEL_ENTRIES = {"sat_chained": "integral_image", "fused_tiles": "fused_head",
                  "stage_sums": "haar_stage", "packed_sums": "packed_window",
                  "inv_sigma": "window_variance",
                  "gate_counts": "tail_gates"}


def profiled_ms(torch, fn, reps: int, kernel: str = "") -> float:
    """Mean device time per call of ``fn`` (one warm-up call first) of
    every kernel it launches whose name contains ``kernel`` (all of them by
    default), from ``torch.profiler``: the device's own time, which a clock
    around back-to-back calls misses when launching a call takes the host
    longer than the device takes to run it.

    The time is counted per traced launch, not per requested call: a
    trace of ``reps`` calls gives the device time and the launches it
    holds (``count`` in ``key_averages()``), and the result is that time
    over those launches, times the launches per call.  A trace can drop
    events: one kept a single launch of kernel C's ten, and dividing by
    the ten calls gave a tenth of the kernel's time.  For a hand kernel
    (``kernel`` one of :data:`KERNEL_ENTRIES`) the launches per call are
    its wrapper's count over the warm-up call; otherwise the larger of a
    one-call trace's count and the ``reps`` trace's count over ``reps``.
    A line says so whenever the trace holds other than ``reps`` times the
    launches per call.  A trace with no device time is taken again; after
    three, the call is timed with CUDA events instead, and a line says
    so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops

    def trace(n):
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and kernel in e.key]
        return (sum(e.self_device_time_total for e in ev),
                sum(e.count for e in ev))

    module = KERNEL_ENTRIES.get(kernel)
    before = ops.launches()
    fn()
    torch.cuda.synchronize()
    known = ops.launches()[module] - before[module] if module else 0
    for _ in range(3):
        one = known or trace(1)[1]
        total, count = trace(reps)
        if total > 0 and count > 0:
            per_call = known or max(one, count / reps)
            if count != reps * per_call:
                print(f"chip_smoke: the profiler traced {count} launches of "
                      f"{kernel or 'the call'} in {reps} calls of "
                      f"{per_call:g} launches: timed per traced launch")
            return total / count * per_call / 1e3
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


def lm_workload(torch, device, rules=None):
    """Phase 10's LM serving workload: ``LM_ARCH`` at full width, its
    weights drawn on ``device`` from seed ``SEED`` (the repo ships no LM
    weights) and ``LM_BATCH`` prompts of ``LM_PROMPT`` tokens from a numpy
    generator seeded ``SEED``.  With ``rules`` (phase 12) the model takes
    the mesh path: the same weights, placed by ``param_pspecs``, and the
    prompts spread over dp.  Returns ``(model, params, prompts)``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(LM_ARCH)
    model = Model(cfg, device, rules)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(device)
    if rules is not None:
        from repro_torch.distributed.sharding import batch_pspecs, distribute
        prompts = distribute({"t": prompts}, batch_pspecs(
            {"t": prompts}, rules), rules.mesh)["t"]
    return model, params, prompts


def lm_train_workload(torch, device, remat: str = "block", rules=None,
                      donate: bool = False):
    """Phase 11's training workload: ``LM_ARCH`` at full width (its remat
    set to ``remat``), a ``TrainState`` drawn on ``device`` from seed
    ``SEED``, the ``SyntheticTokens`` pipeline of ``LM_TRAIN_BATCH`` x
    ``LM_TRAIN_SEQ`` tokens and the train step (microbatch
    ``LM_TRAIN_MICRO``, ``LM_TRAIN_OPT``).  With ``rules`` (phase 12) the
    same state is placed by the mesh's specs and each batch spread over
    dp; with ``donate`` the step updates the state in place.  Returns
    ``(model, state, batch_at, step)``; ``batch_at(i)`` is step i's batch
    on the device."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.distributed.sharding import batch_pspecs, distribute
    from repro_torch.models import Model
    from repro_torch.train import init_train_state, make_train_step
    model = Model(get_config(LM_ARCH).with_(remat=remat), device, rules)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(SEED))
    pipe = SyntheticTokens(model.cfg.vocab_size, LM_TRAIN_BATCH,
                           LM_TRAIN_SEQ, seed=SEED)

    def batch_at(i):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe(i).items()}
        if rules is not None:
            batch = distribute(batch, batch_pspecs(batch, rules), rules.mesh)
        return batch

    return model, state, batch_at, make_train_step(
        model, microbatch=LM_TRAIN_MICRO, donate=donate, **LM_TRAIN_OPT)


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
                 *args, **kw), 10, "packed_sums"),
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
            row["step_c_ratio"] = (out["step_kernel_c"]["ms"]
                                   / row["step_c_ms"])
            print(f"  kernel C on the replayed step's inputs "
                  f"{out['step_kernel_c']['ms']:.4f} ms against C inside the"
                  f" step {row['step_c_ms']:.4f} ms (x{row['step_c_ratio']:.3f}"
                  f") [{smi}]")
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


def request_errors(reqs, wants, label: str) -> list:
    """What is wrong with completed requests ``reqs`` against the rects
    ``wants`` (and ``FrameStats`` where a want is ``(rects, stats)``)."""
    import numpy as np
    bad = []
    for i, (r, want) in enumerate(zip(reqs, wants)):
        stats = None
        if isinstance(want, tuple):
            want, stats = want
        if not r.done.is_set():
            bad.append(f"{label} request {i} not done")
        elif r.error is not None:
            bad.append(f"{label} request {i}: {type(r.error).__name__}: "
                       f"{r.error}")
        elif not np.array_equal(r.rects, want):
            bad.append(f"{label} request {i}: rects differ")
        elif stats is not None and r.stats != stats:
            bad.append(f"{label} request {i}: {r.stats} != {stats}")
    return bad


def spy_stream_shards(svc, ops):
    """Record, for every pod shard of stream frames ``svc`` runs, the
    frames' modes, the kernel launches of the shard and the frame counts
    of its ``StreamEngine.incremental`` calls: ``[(modes, launches,
    incremental_calls), ...]``."""
    shards, calls = [], []
    run_shard = svc._run_stream_shard
    incremental = svc.stream_engine.incremental

    def inc_spy(frames, *args, **kw):
        calls.append(len(frames))
        return incremental(frames, *args, **kw)

    def shard_spy(shard):
        before, n_calls = ops.launches(), len(calls)
        run_shard(shard)
        after = ops.launches()
        shards.append(([r.stats.mode if r.stats is not None else "error"
                        for r in shard],
                       {k: after[k] - before[k] for k in after},
                       calls[n_calls:]))

    svc.stream_engine.incremental = inc_spy
    svc._run_stream_shard = shard_spy
    return shards


def service_frames():
    """Phase 7's images: the first ``SERVICE_FRAMES`` frames of phase 6's
    seeded ``static_cctv`` video at ``H`` x ``W``, for the one-shots and
    the stream sessions alike.  The service groups every request's rects,
    as the reference's does, and grouping (``nms.group_rectangles``) is
    quadratic in the raw windows: phase 3's scenes keep 1,933-25,989 of
    them on this random cascade (phase 3 prints them), these frames
    ~1,400 (phase 7 prints them)."""
    from repro_torch.stream import make_video
    return [f for f, _gt in make_video("static_cctv", n_frames=SERVICE_FRAMES,
                                       h=H, w=W, seed=SEED)]


def check_service(torch, on_path, det, scene, flush_ms: float, smi: str):
    """Phase 7.  ``det`` is phase 3's capacity-1.0 detector, ``scene``
    one of phase 3's scenes (profiled for the modelled pipeline) and
    ``flush_ms`` phase 3's measured ms per flush of its scenes.  Returns
    ``(report, error)``; ``error`` is '' when every check held."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.scheduling import (
        BotlevScheduler, FIFOScheduler, HEFTScheduler, SequentialScheduler,
        StaticBlockScheduler, WorkModel, build_detection_dag, odroid_xu4,
        rpi3b, simulate)
    from repro_torch.serve import DetectorService, PodSpec, ServiceConfig
    from repro_torch.stream import StreamConfig, VideoDetector
    t_phase = time.perf_counter()
    head_s, head_a, split_b, tail_c, inv_d, tail_e = (
        "integral_image", "fused_head", "haar_stage", "packed_window",
        "window_variance", "tail_gates")
    pods = tuple(PodSpec(*p) for p in SERVICE_PODS)
    scfg = StreamConfig(**STREAM_CONFIG)
    dev_cfg = scfg._replace(device_state=True)
    cfg = ServiceConfig(pods=pods, max_batch=BATCH, governor="energy",
                        stream_config=scfg)
    # nominal rates: plan work units over phase 3's seconds per image,
    # times each pod's speed
    units = DetectorService(det, cfg)._work_units((H, W))
    base = units / (flush_ms / 1e3 / BATCH)
    rates = [p.speed * base for p in pods]
    out: dict = {"card": smi, "pods": [list(p) for p in SERVICE_PODS],
                 "governor": cfg.governor, "slo_ms": cfg.slo_ms,
                 "max_batch": cfg.max_batch, "units_per_image": units,
                 "seed_rates": rates}

    def service(**kw):
        svc = DetectorService(det, dataclasses.replace(cfg, **kw))
        svc.seed_rates(rates)
        return svc

    def session(svc, config):
        sess = svc.open_stream(config)
        # phase 6's decode list (the default would send every incremental
        # frame of this cascade to a full refresh)
        sess.video = VideoDetector(det, config, svc.stream_engine,
                                   decode_cap=STREAM_DECODE_CAP)
        return sess

    imgs = service_frames()
    out["raw_windows_per_image"] = [
        len(r) for r in det.detect_batch(imgs, group=False)]
    wants = [det.detect(im) for im in imgs]
    out["rects_per_image"] = [len(r) for r in wants]
    twice = imgs + imgs
    # ---- one-shot flush: sixteen requests, rects equal detect's
    svc = service()
    reqs = [svc.submit(im) for im in twice]
    _n, err = on_path("service", svc.flush, (head_s, head_a, tail_c, tail_e),
                      (split_b, inv_d))
    # one-shot flushes only: E gates each packed tail segment that C sums
    n = ops.launches()
    if not err and n[tail_e] != n[tail_c]:
        err = (f"service flush launched E {n[tail_e]} times and C "
               f"{n[tail_c]}, not once each per tail segment")
    bad = request_errors(reqs, wants + wants, "service")
    if err or bad:
        return out, err or "; ".join(bad)
    builds = det.program_builds
    svc.seed_rates(rates)       # the same placement, hence the same chunks
    reqs = [svc.submit(im) for im in twice]
    svc.flush()
    bad = request_errors(reqs, wants + wants, "service repeat")
    if bad:
        return out, "; ".join(bad)
    if det.program_builds != builds:
        return out, (f"a repeat service flush built "
                     f"{det.program_builds - builds} programs")
    # ---- ms per flush of sixteen: the service (fresh, rates seeded), bare
    # detect_batch, and detect_batch without grouping (the host's share),
    # in turns
    det.detect_batch(twice, group=False)
    timed: dict = {"service": [], "detect_batch": [], "ungrouped": []}
    for label in ("service", "detect_batch", "ungrouped", "ungrouped",
                  "detect_batch", "service"):
        if label == "service":
            svc = service()
            reqs = [svc.submit(im) for im in twice]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "service":
            svc.flush()
        else:
            got = det.detect_batch(twice, group=label == "detect_batch")
        torch.cuda.synchronize()
        timed[label].append((time.perf_counter() - t0) * 1e3)
        bad = []
        if label == "service":
            bad = request_errors(reqs, wants + wants, "timed service")
            st = svc.stats()
        elif label == "detect_batch":
            bad = [f"detect_batch image {i}" for i, g in enumerate(got)
                   if not np.array_equal(g, wants[i % len(wants)])]
        if bad:
            return out, "; ".join(bad)
    ms = {k: sum(v) / len(v) for k, v in timed.items()}
    out["ms_per_flush"] = ms
    out["ms_per_flush_runs"] = timed
    out["imgs_per_s"] = {k: len(twice) / v * 1e3 for k, v in ms.items()}
    out["latency_ms"] = {"p50": st.latency_ms_p50, "p95": st.latency_ms_p95,
                         "p99": st.latency_ms_p99}
    out["pod_shares"] = {p.name: p.images for p in st.pods}
    out["decision"] = st.energy.last_decision.as_dict()
    out["stats"] = st.as_dict()
    print(f"service: {len(twice)} one-shots per flush, {ms['service']:.2f} "
          f"ms per flush ({out['imgs_per_s']['service']:.1f} imgs/s) "
          f"against bare detect_batch {ms['detect_batch']:.2f} ms "
          f"({ms['ungrouped']:.2f} without grouping); latency "
          f"p50 {st.latency_ms_p50:.2f} p95 {st.latency_ms_p95:.2f} ms; "
          f"pod shares {out['pod_shares']}; governor "
          f"{out['decision']['ops']} (modelled, feasible "
          f"{out['decision']['feasible']}) [{smi}]")
    # ---- stream sessions over the same frames, beside four one-shots,
    # in one flush
    configs = (dev_cfg, dev_cfg, scfg)
    lone = {}
    for c in set(configs):
        vd = VideoDetector(det, c, decode_cap=STREAM_DECODE_CAP)
        lone[c] = [vd.process(f) for f in imgs]
    svc = service()
    sessions = [session(svc, c) for c in configs]
    shards = spy_stream_shards(svc, ops)
    frame_reqs = [[] for _ in sessions]
    for f in imgs:
        for k, sess in enumerate(sessions):
            frame_reqs[k].append(sess.submit_frame(f))
    ones = [svc.submit(im) for im in imgs[:4]]
    _n, err = on_path("service_stream", svc.flush,
                      (head_s, head_a, tail_c, tail_e), (split_b, inv_d))
    bad = request_errors(ones, wants, "service_stream one-shot")
    for k, reqs in enumerate(frame_reqs):
        bad += request_errors(reqs, lone[configs[k]], f"session {k}")
        if [r.stats.frame_idx for r in reqs if r.stats is not None] != \
                list(range(SERVICE_FRAMES)):
            bad.append(f"session {k}: frames out of order")
    if err or bad:
        return out, err or "; ".join(bad)
    quiet = [(modes, n, calls) for modes, n, calls in shards
             if "incremental" in modes
             and set(modes) <= {"incremental", "cached"}]
    loud = [n for _m, n, _c in quiet
            if n[head_a] or n[split_b] or n[inv_d] or n[head_s] <= 0
            or n[tail_c] <= 0]
    many = [calls for _m, _n, calls in shards if len(calls) > 1]
    if not quiet or loud or many:
        return out, (f"service_stream: {len(quiet)} incremental shards, "
                     f"launches {loud} against S and C only, incremental "
                     f"calls per shard {many}")
    modes = {}
    for reqs in frame_reqs:
        for r in reqs:
            modes[r.stats.mode] = modes.get(r.stats.mode, 0) + 1
    out["stream"] = {
        "sessions": ["device_state", "device_state", "host"],
        "frames": SERVICE_FRAMES, "modes": modes,
        "shards": len(shards), "incremental_shards": len(quiet),
        "incremental_shard_launches": [n for _m, n, _c in quiet],
        "incremental_calls": [c for _m, _n, c in shards],
        "stats": svc.stats().stream.as_dict()}
    print(f"service_stream: 3 sessions x {SERVICE_FRAMES} frames beside 4 "
          f"one-shots == lone VideoDetector; modes {modes}; "
          f"{len(quiet)} incremental pod shards launched S and C only")
    # ---- the background flusher, a device-state session among one-shots
    svc = service(max_delay_ms=10.0)
    sess = session(svc, dev_cfg)

    def background():
        svc.start()
        try:
            ones = [svc.submit(im) for im in imgs]
            frames = [sess.submit_frame(f) for f in imgs]
        finally:
            svc.stop()
        return ones, frames

    (ones, frames), err = on_path("service_background", background,
                                  (head_s, head_a, tail_c, tail_e),
                                  (split_b, inv_d))
    bad = (request_errors(ones, wants, "background one-shot")
           + request_errors(frames, lone[dev_cfg], "background frame"))
    if err or bad:
        return out, err or "; ".join(bad)
    out["background"] = {"requests": len(ones) + len(frames),
                         "n_done": svc.stats().n_done}
    print(f"service_background: {len(ones)} one-shots and {len(frames)} "
          f"device-state frames in flight at stop(): all complete, no error")
    # ---- the paper's modelled pipeline from a profile measured here
    prof = det.work_profile(scene)
    lv = prof["per_level"][0]
    sizes = det.cascade.stage_sizes()
    wm = WorkModel.from_profile(sizes, lv["alive_counts"], lv["windows"])
    dag = build_detection_dag(H, W, sizes, step=det.config.step,
                              scale_factor=det.config.scale_factor,
                              work_model=wm)
    model: dict = {"tasks": len(dag), "total_work": dag.total_work,
                   "level0_survival": [float(x) for x in wm.survival]}
    for plat in (odroid_xu4(), rpi3b()):
        row = {}
        for policy in (SequentialScheduler, FIFOScheduler,
                       StaticBlockScheduler, BotlevScheduler, HEFTScheduler):
            r = simulate(dag, plat, policy())
            if not (np.isfinite(r.makespan) and np.isfinite(r.energy)
                    and r.makespan > 0 and r.energy > 0):
                return out, f"modelled {plat.name} {policy.__name__}: {r}"
            row[policy.__name__] = {"makespan_s": r.makespan,
                                    "energy_J": r.energy,
                                    "avg_power_W": r.avg_power}
        model[plat.name] = row
        print(f"modelled pipeline on the {plat.name} power model (not the "
              f"card): " + ", ".join(
                  f"{k} {v['makespan_s']:.3f} s {v['energy_J']:.2f} J"
                  for k, v in row.items()))
    out["modelled"] = model
    out["seconds"] = time.perf_counter() - t_phase
    return out, ""


def check_fleet(torch, on_path, det, flush_ms: float, smi: str):
    """Phase 8.  ``det`` and ``flush_ms`` are phase 7's.  Returns
    ``(report, error)``; ``error`` is '' when every check held.

    Phase 7's service (two pods, the energy governor, rates seeded from
    phase 3's flush) under a :class:`FleetScheduler`, sessions on
    ``FLEET_STREAM`` (phase 6's stream config with a keyframe every
    ``keyframe_interval`` frames, so the ladder's stretched cadence shows
    within ``FLEET_FRAMES`` frames) and phase 6's decode list:

    - admission: three sessions (realtime, standard, best_effort) at an
      fps that fits three in the headroom, a fourth rejected, a fifth
      (best_effort, a tenth of the rate) admitted into what is left;
    - overload (every session at a full refresh per frame, twice the
      rate): ``rebalance`` degrades both best_effort sessions to the
      ladder's cap before it touches standard, and never realtime;
    - frames: every session's ``FLEET_FRAMES`` frames, one fleet flush
      per frame, each flush one service flush per tier in
      ``SLO_TIERS`` order carrying that tier's frames only; each session
      equals a lone ``VideoDetector`` on its stretched config (rects,
      ``FrameStats``, order);
    - shedding: a best_effort frame is not shed while the ladder has
      room; once every degradable session sits at the cap and demand
      exceeds capacity, best_effort frames are shed and standard and
      realtime frames are not;
    - recovery: at a demand between ``restore_margin`` times the budget
      and the budget nothing moves (hysteresis); below it, ``rebalance``
      restores every level to 0, one ladder step per session per call."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import (DetectorService, FleetScheduler, PodSpec,
                                   ServiceConfig, SLO_TIERS)
    from repro_torch.stream import StreamConfig, VideoDetector, make_video
    t_phase = time.perf_counter()
    head_s, head_a, split_b, tail_c, inv_d = (
        "integral_image", "fused_head", "haar_stage", "packed_window",
        "window_variance")
    fcfg = StreamConfig(**FLEET_STREAM)
    dev_cfg = fcfg._replace(device_state=True)
    pods = tuple(PodSpec(*p) for p in SERVICE_PODS)
    svc = DetectorService(det, ServiceConfig(
        pods=pods, max_batch=BATCH, governor="energy", stream_config=fcfg))
    units = svc._work_units((H, W))
    base = units / (flush_ms / 1e3 / BATCH)
    svc.seed_rates([p.speed * base for p in pods])
    fleet = FleetScheduler(svc)
    fps = fleet.budget_units_per_s / units / 3.5
    out: dict = {"card": smi, "frames": FLEET_FRAMES, "hw": [H, W],
                 "stream_config": FLEET_STREAM, "units_per_frame": units,
                 "capacity_units_per_s": fleet.capacity_units_per_s,
                 "fps": fps}
    videos = {kind: [f for f, _gt in make_video(kind, n_frames=FLEET_FRAMES,
                                                h=H, w=W, seed=SEED)]
              for kind in ("static_cctv", "moving_face")}
    plan = (("realtime", dev_cfg, "static_cctv", 1.0),
            ("standard", fcfg, "static_cctv", 1.0),
            ("best_effort", dev_cfg, "static_cctv", 1.0),
            ("standard", fcfg, "static_cctv", 1.0),
            ("best_effort", fcfg, "moving_face", 0.1))
    admitted, sessions = [], []
    for tier, cfg, kind, rate in plan:
        fs = fleet.admit((H, W), fps * rate, tier=tier, tenant=kind,
                         stream_config=cfg)
        admitted.append(fs is not None)
        if fs is not None:
            # phase 6's decode list (the default would send every
            # incremental frame of this cascade to a full refresh)
            fs.session.video = VideoDetector(det, cfg, svc.stream_engine,
                                             decode_cap=STREAM_DECODE_CAP)
            sessions.append((fs, kind))
    out["admitted"] = admitted
    if admitted != [True, True, True, False, True]:
        return out, f"fleet admissions {admitted}, not 3 then a rejection"
    rt, st, be, be2 = (fs for fs, _kind in sessions)
    cap = fcfg.max_degrade_level

    def levels():
        return [fs.degrade_level for fs, _kind in sessions]

    # ---- overload: best_effort to the cap first, realtime never
    for fs, _kind in sessions:
        fs.note_work_frac(1.0)
        fs.fps *= 2.0
    step = fleet.rebalance()
    out["overload"] = {"rebalance": step, "levels": levels()}
    if not (step["degraded"] > 0 and rt.degrade_level == 0
            and be.degrade_level == be2.degrade_level == cap
            and 0 < st.degrade_level < cap):
        return out, (f"overload degraded {levels()} (realtime, standard, "
                     f"best_effort x2), not best_effort to {cap} first")
    if step["demand_units_per_s"] > fleet.budget_units_per_s:
        return out, f"overload left demand over the budget: {step}"
    # ---- frames on the degraded ladder, tier by tier
    lone = {}
    for fs, kind in sessions:
        vd = VideoDetector(det, fs.base_config.degraded(fs.degrade_level),
                           decode_cap=STREAM_DECODE_CAP)
        lone[id(fs)] = [vd.process(f) for f in videos[kind]]
    tiers_seen: list = []
    real_flush = svc.flush

    def flush_spy(tier=None):
        with svc._lock:
            carried = sorted({r.tier for r in svc._queue if r.tier == tier})
        tiers_seen.append((tier, carried))
        return real_flush(tier=tier)

    svc.flush = flush_spy
    flush_ms_runs, per_flush = [], []
    reqs = {id(fs): [] for fs, _kind in sessions}

    def frames():
        for i in range(FLEET_FRAMES):
            for fs, kind in sessions:
                reqs[id(fs)].append(fs.submit_frame(videos[kind][i]))
            before = ops.launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.flush()
            torch.cuda.synchronize()
            flush_ms_runs.append((time.perf_counter() - t0) * 1e3)
            after = ops.launches()
            per_flush.append({k: after[k] - before[k] for k in after})

    # the fleet's flushes carry stream frames only: keyframes take the
    # level program, increments the stream step, neither kernel E
    _n, err = on_path("fleet", frames, (head_s, head_a, tail_c),
                      (split_b, inv_d, "tail_gates"))
    svc.flush = real_flush
    bad = []
    for fs, _kind in sessions:
        bad += request_errors(reqs[id(fs)], lone[id(fs)],
                              f"fleet {fs.tier} session")
        if [r.stats.frame_idx for r in reqs[id(fs)] if r.stats is not None] \
                != list(range(FLEET_FRAMES)):
            bad.append(f"fleet {fs.tier} session: frames out of order")
        if any(r.dropped for r in reqs[id(fs)]):
            bad.append(f"fleet {fs.tier} session: a frame was shed")
    want = [(t, [t]) for t in SLO_TIERS] * FLEET_FRAMES
    if tiers_seen != want:
        bad.append(f"fleet flushes ran tiers {tiers_seen}, not {want}")
    if err or bad:
        return out, err or "; ".join(bad)
    modes: dict = {}
    for fs, _kind in sessions:
        for r in reqs[id(fs)]:
            key = f"{fs.tier}/{r.stats.mode}"
            modes[key] = modes.get(key, 0) + 1
    mean = {k: sum(c[k] for c in per_flush) / len(per_flush)
            for k in (head_s, head_a, tail_c)}
    out["frame_modes"] = modes
    out["ms_per_fleet_flush"] = sum(flush_ms_runs) / len(flush_ms_runs)
    out["ms_per_fleet_flush_runs"] = flush_ms_runs
    out["launches_per_flush"] = per_flush
    print(f"fleet: 4 sessions x {FLEET_FRAMES} frames at levels {levels()} "
          f"== lone stretched VideoDetectors; modes {modes}; "
          f"{out['ms_per_fleet_flush']:.2f} ms per fleet flush "
          f"(runs {[round(x, 2) for x in flush_ms_runs]}); launches per "
          f"flush S {mean[head_s]:.2f} A {mean[head_a]:.2f} C "
          f"{mean[tail_c]:.2f} [{smi}]")
    # ---- shedding only once the ladder is exhausted
    frame = videos["static_cctv"][0]
    for fs, _kind in sessions:
        fs.note_work_frac(1.0)
    rt.fps = 5.0 * fps            # realtime alone over the capacity
    shed = [fleet.submit_frame(be, frame).dropped]
    fleet.rebalance()
    if levels()[1:] != [cap] * 3:
        return out, f"the ladder is not exhausted after overload: {levels()}"
    shed += [fleet.submit_frame(fs, frame).dropped for fs in (be, be2, st, rt)]
    svc.flush()
    out["shed"] = shed
    if shed != [False, True, True, False, False]:
        return out, (f"shed {shed}: best_effort with room, best_effort x2, "
                     "standard, realtime at the cap")
    # ---- recovery with hysteresis
    rt.fps = fps
    for fs, _kind in sessions:
        fs.note_work_frac(1.0)
    budget = fleet.budget_units_per_s
    mid = 0.5 * (1.0 + fleet.config.restore_margin) * budget
    scale = mid / fleet.demand_units_per_s()
    for fs, _kind in sessions:
        fs.fps *= scale
    held = fleet.rebalance()
    for fs, _kind in sessions:
        fs.fps *= 0.05
    restored = [fleet.rebalance() for _ in range(cap + 1)]
    out["recovery"] = {"held": held, "restored": restored,
                       "levels": levels()}
    if held["degraded"] or held["restored"] or levels() != [0, 0, 0, 0]:
        return out, (f"recovery: at {mid / budget:.2f} of the budget "
                     f"{held}; then {restored}, levels {levels()}")
    stats = svc.stats().fleet.as_dict()
    out["stats"] = stats
    if (stats["admitted"], stats["rejected"], stats["frames_dropped"]) != \
            (4, 1, 2):
        return out, f"fleet stats {stats}"
    print(f"fleet: admitted {stats['admitted']}, rejected "
          f"{stats['rejected']}; shed {shed} (best_effort with room, "
          f"best_effort x2, standard, realtime at the cap); held at "
          f"{mid / budget:.2f} of the budget, then restored "
          f"{[r['restored'] for r in restored]} to levels {levels()}; "
          f"degrade events {stats['degrade_events']}, restore events "
          f"{stats['restore_events']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out, ""


def train_spied(adaboost, cfg, device):
    """``adaboost.train_cascade(cfg, device)`` with every boosting round's
    inputs and choice recorded: ``(cascade, info, rounds, stage_s)``.
    ``rounds[k]`` is ``(vals_sorted, order, w, y, feat, theta, pol)`` as
    tensors on ``device``; ``stage_s[s]`` is ``(boosting seconds,
    seconds to the next stage's boosting)``: what follows a stage's
    boosting is mining the next stage's negatives on the host."""
    rounds, marks = [], []
    best, boost = adaboost._best_stump, adaboost._boost_stage

    def best_spy(vals_sorted, order, w, y):
        out = best(vals_sorted, order, w, y)
        rounds.append((vals_sorted, order, w, y, *out[1:4]))
        return out

    def boost_spy(*args, **kw):
        t0 = time.perf_counter()
        out = boost(*args, **kw)
        marks.append((t0, time.perf_counter()))
        return out

    adaboost._best_stump, adaboost._boost_stage = best_spy, boost_spy
    try:
        casc, info = adaboost.train_cascade(cfg, device=device)
    finally:
        adaboost._best_stump, adaboost._boost_stage = best, boost
    t_end = time.perf_counter()
    stage_s = [(b - a, (marks[i + 1][0] if i + 1 < len(marks) else t_end) - b)
               for i, (a, b) in enumerate(marks)]
    return casc, info, rounds, stage_s


def round_eps64(rnd, feat: int, theta, pol: int) -> float:
    """Weighted error in float64 of stump ``(feat, theta, pol)`` on the
    weights and feature values of boosting round ``rnd``."""
    import numpy as np
    vals_sorted, order, w, y = (t.cpu().numpy() for t in rnd[:4])
    col = np.empty(len(y), np.float32)
    col[order[:, feat]] = vals_sorted[:, feat]
    pred = (col < theta) if pol == 1 else (col > theta)
    return float(w.astype(np.float64)[pred != (y == 1)].sum())


def check_training(torch, on_path, smi: str):
    """Phase 9.  Returns ``(report, error)``; ``error`` is '' when every
    check held.

    ``train_cascade`` at ``scripts/train_pretrained.py``'s widths
    (``TRAIN_CONFIG``; ``n_stages`` cut from 14 to 3 for time) on the card
    and on the CPU, same seed.  The port pins every sum's order, so the
    two runs are expected to choose the same stumps with the same bits: the
    same features, polarities and weak classifiers per stage, thresholds,
    votes and stage thresholds within ``TRAIN_RTOL``.  A round where the
    runs choose differently must be an exact-arithmetic tie (both choices
    within 1e-6 in float64 error on the round's weights) and ends the
    comparison there.  Then the card's cascade through
    ``Detector.detect_batch`` on the card (S, A, C: ``dense_segments``
    ``(1,)`` puts stages 1-2 in the packed tail) and on the CPU over
    ``TRAIN_SCENES`` seeded 480x640 face scenes: equal rects."""
    import numpy as np
    from repro_torch.core import Detector
    from repro_torch.core.training import adaboost
    from repro_torch.core.training.data import render_scene, window_dataset
    t_phase = time.perf_counter()
    cfg = adaboost.TrainConfig(**TRAIN_CONFIG)
    out: dict = {"card": smi, "config": cfg._asdict(),
                 "cut": {"n_stages": [14, cfg.n_stages]}}
    print(f"training at scripts/train_pretrained.py's widths, n_stages cut "
          f"14 -> {cfg.n_stages} for time")
    runs = {}
    for name, dev in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        runs[name] = train_spied(adaboost, cfg, dev)
        out[f"{name}_seconds"] = time.perf_counter() - t0
    (c_casc, c_info, c_rounds, c_stage), (p_casc, p_info, p_rounds,
                                          p_stage) = runs["card"], runs["cpu"]
    out["stage_seconds"] = {"card": c_stage, "cpu": p_stage}
    out["info"] = {"card": c_info, "cpu": p_info}
    print(f"training seconds per stage (boosting, then mining the next "
          f"stage's negatives): card {[(round(a, 2), round(b, 2)) for a, b in c_stage]}, "
          f"CPU {[(round(a, 2), round(b, 2)) for a, b in p_stage]}; whole "
          f"run card {out['card_seconds']:.1f} s, CPU {out['cpu_seconds']:.1f}"
          f" s [{smi}]")
    # the first round where the runs choose differently, if any
    picks = [[(int(r[4]), float(r[5]), int(r[6])) for r in rounds]
             for rounds in (c_rounds, p_rounds)]
    first = next((k for k, (a, b) in enumerate(zip(*picks)) if a != b),
                 min(map(len, picks)))
    out["rounds"] = {"card": len(picks[0]), "cpu": len(picks[1]),
                     "first_divergence": first
                     if first < max(map(len, picks)) else None}
    if first < max(map(len, picks)):
        if first == min(map(len, picks)):
            return out, (f"training: the runs stop after {len(picks[0])} and "
                         f"{len(picks[1])} rounds with equal choices")
        rnd = p_rounds[first]
        gap = abs(round_eps64(rnd, *picks[0][first])
                  - round_eps64(rnd, *picks[1][first]))
        out["divergence_eps64_gap"] = gap
        print(f"training: card and CPU choose differently at round {first}"
              f" ({picks[0][first]} vs {picks[1][first]}); float64 error "
              f"gap {gap:.3g} on the CPU run's weights")
        if gap > 1e-6:
            return out, (f"training: card and CPU diverge at round {first} "
                         f"by a float64 error gap of {gap:.3g}: not a tie")
    c_arr, p_arr = c_casc.numpy(), p_casc.numpy()
    n_cmp = first        # weak classifiers chosen alike
    bounds = c_arr["stage_offsets"]
    done = [s for s in range(len(bounds) - 1) if bounds[s + 1] <= n_cmp]
    bad = []
    if first == len(picks[0]) == len(picks[1]):
        for f in ("stage_offsets", "rect_xywh", "rect_w"):
            if not np.array_equal(c_arr[f], p_arr[f]):
                bad.append(f"{f} differ")
    rel = {}
    for f in ("wc_threshold", "left_val", "right_val"):
        a, b = c_arr[f][:n_cmp], p_arr[f][:n_cmp]
        rel[f] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max()
                       ) if n_cmp else 0.0
        if not np.allclose(a, b, rtol=TRAIN_RTOL, atol=0):
            bad.append(f"{f} past rtol {TRAIN_RTOL}")
    a, b = c_arr["stage_threshold"][done], p_arr["stage_threshold"][done]
    if not np.allclose(a, b, rtol=TRAIN_RTOL, atol=0):
        bad.append(f"stage_threshold past rtol {TRAIN_RTOL}")
    bit_equal = all(np.array_equal(c_arr[f], p_arr[f]) for f in c_arr)
    out.update(max_rel=rel, bit_equal=bit_equal,
               stage_sizes=[int(x) for x in np.diff(bounds)])
    if bad:
        return out, "training card vs CPU: " + "; ".join(bad)
    print(f"training card == CPU: stages {out['stage_sizes']} weak "
          f"classifiers, same features and polarities, max rel "
          f"{ {k: f'{v:.3g}' for k, v in rel.items()} } (rtol {TRAIN_RTOL}),"
          f" bit for bit {bit_equal}; DR {c_info['overall_dr']:.4f} FPR "
          f"{c_info['overall_fpr']:.5f}")
    # ---- device time of the two inner functions at stage 0's widths
    rng = np.random.default_rng(cfg.seed)
    corpus = window_dataset(rng, cfg.n_pos, cfg.n_neg)
    rx, rw = adaboost.feature_pool(cfg)
    dev = torch.device(DEVICE)
    win = torch.as_tensor(corpus.windows, device=dev)
    rx_t, rw_t = torch.as_tensor(rx, device=dev), torch.as_tensor(rw,
                                                                  device=dev)
    fv_ms = profiled_ms(torch, lambda: adaboost._feature_values(win, rx_t,
                                                                rw_t), 5)
    vals_sorted, order = torch.sort(adaboost._feature_values(win, rx_t, rw_t),
                                    dim=0, stable=True)
    y = torch.as_tensor(corpus.labels, device=dev)
    w = torch.full((len(corpus.labels),), 1.0 / len(corpus.labels),
                   device=dev)
    round_ms = profiled_ms(torch, lambda: adaboost._best_stump(
        vals_sorted, order, w, y), 5)
    out["feature_values_ms"], out["boosting_round_ms"] = fv_ms, round_ms
    print(f"training device time: feature_values {fv_ms:.3f} ms per call "
          f"({len(corpus.labels)} windows x {len(rx)} features), one "
          f"boosting round {round_ms:.3f} ms [{smi}]")
    # ---- the trained cascade detects on the card as on the CPU
    head_s, head_a, split_b, tail_c, inv_d = (
        "integral_image", "fused_head", "haar_stage", "packed_window",
        "window_variance")
    dcfg = main_path_config()._replace(dense_segments=(1,))
    det = Detector(c_casc, dcfg, device=DEVICE)
    n_tail = len(det.batch_plan(*det._bucket_hw(H, W)).tail_segments)
    dcfg = dcfg._replace(capacity_fracs=(1.0,) * n_tail)
    imgs = scenes(render_scene, TRAIN_SCENES, H, W, SEED + 2, n_faces=3)
    on_card, err = on_path(
        "trained", lambda: Detector(c_casc, dcfg, device=DEVICE)
        .detect_batch(imgs), (head_s, head_a, tail_c), (split_b, inv_d))
    if err:
        return out, err
    on_cpu = Detector(c_casc.to("cpu"), dcfg, device="cpu").detect_batch(imgs)
    out["rects_per_scene"] = [len(r) for r in on_card]
    for i, (a, b) in enumerate(zip(on_card, on_cpu)):
        if not np.array_equal(a, b):
            return out, f"trained cascade: card and CPU rects differ on {i}"
    if not sum(out["rects_per_scene"]) or not all(
            np.isfinite(r).all() and r.shape[1] == 4 for r in on_card):
        return out, f"trained cascade: rects {out['rects_per_scene']}"
    print(f"trained cascade on {TRAIN_SCENES} scenes at {H}x{W}: card == CPU"
          f", {out['rects_per_scene']} grouped rects")
    out["seconds"] = time.perf_counter() - t_phase
    return out, ""


def check_lm(torch, on_path, smi: str, carry: dict | None = None):
    """Phase 10.  Returns ``(report, error)``; ``error`` is '' when every
    check held.

    LM serving through ``repro_torch.serve`` at ``LM_ARCH``'s full width
    (``get_config``: bf16, 16 layers, d_model 2048, vocab 50304), weights
    drawn on the card from seed ``SEED`` (the repo ships no LM weights):

    - ``generate`` of ``LM_BATCH`` seeded prompts of ``LM_PROMPT`` tokens,
      ``LM_NEW`` new tokens, greedy, twice (the second timed): the same
      tokens both times, in the vocabulary; ms per prefill and per decode
      step (CUDA events around ``Model.prefill`` / ``decode_step`` inside
      ``generate``; the median over the steps after the first), decoded
      tokens per second and the peak of allocated device memory (beside
      what earlier phases still hold);
    - cascade early exit from the prompts' prefilled cache: exits after
      groups 3, 7, 11 with thresholds above 1 give the plain decode's
      tokens over ``LM_CASCADE_STEPS`` steps, every depth 16; one exit
      after group 3 at threshold 0 gives depth 4 everywhere; thresholds
      (0.6, 0.5, 0.4) (``examples/early_exit_serving.py``'s) give the mean
      depth and ``CascadeBatcher``'s modelled layer-group saving; ms per
      cascade step beside the plain step;
    - card vs CPU: a float32 copy of the config, the same weights on both,
      batch 1, a ``LM_CHECK['prompt']``-token prompt (past both flash
      chunks) and ``LM_CHECK['steps']`` greedy decode steps, TF32 off:
      logits within ``LM_CHECK['atol']`` and equal tokens;
    - attention: the port's blockwise ``flash_attention`` on
      ``LM_ATTN_SHAPE`` bf16, causal, the config's chunks (512 / 1024: 8 q
      blocks over 4 kv blocks), against ``attention_reference`` (float32
      throughout, one rounding) element by element: within half an ulp of
      each side's bf16 output plus ``LM_ATTN_SIGMAS`` standard deviations
      of what rounding the probabilities to bf16 before P·V adds
      (``rounding_sigma``); timed beside ``scaled_dot_product_attention``
      on the same inputs (printed only; never on the path) and its bound
      at the bf16 tensor rate.

    No hand kernel runs on this path: the launch counts of S, A, B, C and
    D stay 0."""
    import statistics
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.early_exit import (CascadeBatcher, ExitConfig,
                                               expected_depth)
    from repro_torch.models.layers import attention_reference, flash_attention
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.serve import (generate, make_cascade_decode_step,
                                   make_decode_step, make_prefill_step)
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH)
    out: dict = {"card": smi, "arch": LM_ARCH, "dtype": cfg.param_dtype,
                 "batch": LM_BATCH, "prompt": LM_PROMPT, "new": LM_NEW}

    def serve():
        # device memory that earlier phases still hold
        out["memory_allocated_before"] = torch.cuda.memory_allocated()
        model, params, prompts = lm_workload(torch, dev)
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        marks: dict = {"prefill": [], "decode": []}

        def timed(name, fn):
            def run(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = fn(*a, **k)
                ev[1].record()
                marks[name].append(ev)
                return res
            return run

        model.prefill = timed("prefill", model.prefill)
        model.decode_step = timed("decode", model.decode_step)
        first = generate(model, params, prompts, max_new=LM_NEW)
        for v in marks.values():
            v.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = generate(model, params, prompts, max_new=LM_NEW)
        torch.cuda.synchronize()
        out["generate_s"] = time.perf_counter() - t0
        del model.prefill, model.decode_step
        ms = {n: [a.elapsed_time(b) for a, b in v] for n, v in marks.items()}
        out["ms_per_prefill"] = ms["prefill"][0]
        out["ms_per_decode_step"] = statistics.median(ms["decode"][1:])
        out["decode_tokens_per_s"] = (LM_BATCH * 1e3
                                      / out["ms_per_decode_step"])
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        if carry is not None:        # phase 12 serves the same prompts
            carry["tokens"] = toks
        if not torch.equal(first, toks):
            return "generate: two runs gave different tokens"
        if toks.shape != (LM_BATCH, LM_NEW) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            return f"generate: tokens {tuple(toks.shape)} out of range"
        print(f"lm {LM_ARCH} bf16 ({out['params']} parameters): generate "
              f"{LM_BATCH} x {LM_PROMPT} + {LM_NEW}: prefill "
              f"{out['ms_per_prefill']:.3f} ms, decode step "
              f"{out['ms_per_decode_step']:.3f} ms, "
              f"{out['decode_tokens_per_s']:.1f} tokens/s, peak "
              f"{out['max_memory_allocated'] / 2**30:.2f} GiB (earlier "
              f"phases hold {out['memory_allocated_before'] / 2**30:.2f}) "
              f"[{smi}]")
        return donated(model, params, prompts, toks) or cascade(
            model, params, prompts)

    def donated(model, params, prompts, want):
        """``generate``'s loop through steps made with ``donate=True``
        and through the functional steps, the two interleaved step by step
        (which goes first alternates) so that both are timed in one
        window: both loops' tokens, every donated step returning the
        cache's own tensors."""
        steps = {d: (make_prefill_step(model, donate=d),
                     make_decode_step(model, donate=d))
                 for d in (False, True)}
        caches = {d: model.init_cache(LM_BATCH, LM_PROMPT + LM_NEW)
                  for d in steps}
        ptrs = [t.data_ptr() for t in tree_leaves(caches[True]) if t.dim()]
        marks: dict = {d: [] for d in steps}
        toks: dict = {d: [] for d in steps}
        aliased = True
        for i in range(LM_NEW):
            for d in ((False, True) if i % 2 == 0 else (True, False)):
                prefill, decode = steps[d]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                if i == 0:
                    logits, caches[d] = prefill(params, prompts, caches[d])
                    tok = torch.argmax(logits[:, -1].float(), -1).to(
                        torch.int32)
                else:
                    tok, caches[d], _ = decode(params, toks[d][-1],
                                               caches[d])
                ev[1].record()
                marks[d].append(ev)
                toks[d].append(tok)
            aliased &= [t.data_ptr() for t in tree_leaves(caches[True])
                        if t.dim()] == ptrs
        torch.cuda.synchronize()
        ms = {d: [a.elapsed_time(b) for a, b in m] for d, m in marks.items()}
        equal = all(torch.equal(torch.stack(t, 1), want)
                    for t in toks.values())
        out["donated"] = {
            "tokens_equal": equal, "cache_aliased": aliased,
            "ms_per_prefill": ms[True][0],
            "ms_per_decode_step": statistics.median(ms[True][2:]),
            "functional_ms_per_prefill": ms[False][0],
            "functional_ms_per_decode_step": statistics.median(ms[False][2:])}
        d = out["donated"]
        print(f"lm donated steps (donate=True) interleaved with the "
              f"functional steps, the same {LM_BATCH} x {LM_PROMPT} + "
              f"{LM_NEW}: both runs' tokens equal generate's {equal}; "
              f"every donated step returned the given cache's tensors "
              f"{aliased}; prefill {d['ms_per_prefill']:.3f} ms "
              f"(functional {d['functional_ms_per_prefill']:.3f}), decode "
              f"step {d['ms_per_decode_step']:.3f} ms (functional "
              f"{d['functional_ms_per_decode_step']:.3f}) [{smi}]")
        if not (equal and aliased):
            return "donated serving: tokens differ or a new cache returned"
        return ""

    def cascade(model, params, prompts):
        cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_CASCADE_STEPS)
        logits, cache = model.prefill(params, prompts, cache)
        tok0 = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)
        plain = make_decode_step(model)

        def run(step, n):
            """Tokens and the third outputs (depths; a plain step's
            logits) of ``n`` steps from the prompts' cache."""
            tok, c, seen, thirds = tok0, cache, [], []
            for _ in range(n):
                tok, c, third = step(params, tok, c)
                seen.append(tok)
                thirds.append(third)
            return torch.stack(seen), thirds

        want, _ = run(plain, LM_CASCADE_STEPS)
        never = make_cascade_decode_step(model, ExitConfig(
            (3, 7, 11), (1.01,) * 3))
        got, depths = run(never, LM_CASCADE_STEPS)
        if not torch.equal(got, want) or not all(
                bool((d == model.n_scan).all()) for d in depths):
            return "cascade: thresholds above 1 changed tokens or depths"
        _, depths = run(make_cascade_decode_step(
            model, ExitConfig((3,), (0.0,))), 2)
        if not all(bool((d == 4).all()) for d in depths):
            return f"cascade: threshold 0 after group 3 gave {depths}"
        middle = make_cascade_decode_step(model, ExitConfig(
            (3, 7, 11), (0.6, 0.5, 0.4)))
        _, depths = run(middle, LM_CASCADE_STEPS)
        d = torch.stack(depths)
        batcher = CascadeBatcher(model.n_scan)
        for row in d.tolist():
            for b, depth in enumerate(row):
                batcher.observe(b, float(depth))
        wave = sum(batcher.group_budget(batcher.bucket(b))
                   for b in range(LM_BATCH))
        full = LM_BATCH * model.n_scan
        out["cascade"] = {
            "exit_groups": [3, 7, 11], "thresholds": [0.6, 0.5, 0.4],
            "mean_depth": float(d.float().mean()), "min_depth": int(d.min()),
            "max_depth": int(d.max()),
            "executed_fraction": expected_depth(d, model.n_scan),
            "wave_groups_per_step": wave, "full_groups_per_step": full,
            "modelled_saving": 1 - wave / full,
            "ms_per_step": cuda_ms(torch, lambda: middle(
                params, tok0, cache), 5),
            "plain_ms_per_step": cuda_ms(torch, lambda: plain(
                params, tok0, cache), 5)}
        c = out["cascade"]
        print(f"lm cascade exits after groups 3/7/11 at (0.6, 0.5, 0.4): "
              f"exit depth (of {model.n_scan} groups) mean "
              f"{c['mean_depth']:.2f}, min {c['min_depth']}, max "
              f"{c['max_depth']}; executed fraction "
              f"{c['executed_fraction']:.1%}; wave-compaction layer-groups"
              f"/step {wave} vs full {full}: modelled saving "
              f"{c['modelled_saving']:.1%}; {c['ms_per_step']:.3f} ms per "
              f"cascade step vs {c['plain_ms_per_step']:.3f} plain [{smi}]")
        return ""

    def card_vs_cpu():
        cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
        gpu, cpu = Model(cfg32, dev), Model(cfg32, "cpu")
        p_gpu = gpu.init(torch.Generator(device=dev).manual_seed(SEED))
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        prompt = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab_size, (LM_CHECK["batch"], LM_CHECK["prompt"])))
        runs, seconds = [], []
        for m, p in ((gpu, p_gpu), (cpu, p_cpu)):
            t0 = time.perf_counter()
            cache = m.init_cache(LM_CHECK["batch"],
                                 LM_CHECK["prompt"] + LM_CHECK["steps"])
            lg, cache = m.prefill(p, prompt.to(m.device), cache)
            logits, toks = [lg], []
            for _ in range(LM_CHECK["steps"]):
                toks.append(torch.argmax(lg[:, -1], -1))
                lg, cache = m.decode_step(p, toks[-1], cache)
                logits.append(lg)
            runs.append((torch.cat(logits, 1).cpu(),
                         torch.stack(toks).cpu()))
            seconds.append(time.perf_counter() - t0)
        (lg_g, tok_g), (lg_c, tok_c) = runs
        err = float((lg_g - lg_c).abs().max())
        out["card_vs_cpu"] = {"dtype": "float32", "prompt": LM_CHECK["prompt"],
                              "steps": LM_CHECK["steps"], "max_abs_err": err,
                              "atol": LM_CHECK["atol"],
                              "tokens_equal": bool(torch.equal(tok_g,
                                                               tok_c)),
                              "card_seconds": seconds[0],
                              "cpu_seconds": seconds[1]}
        print(f"lm card vs CPU (float32, TF32 off, {LM_CHECK['prompt']}-"
              f"token prompt + {LM_CHECK['steps']} steps): logits max abs "
              f"err {err:.3g} (atol {LM_CHECK['atol']}), tokens equal "
              f"{out['card_vs_cpu']['tokens_equal']}; card "
              f"{seconds[0]:.1f} s, CPU {seconds[1]:.1f} s")
        if not (err <= LM_CHECK["atol"]) or not torch.equal(tok_g, tok_c):
            return "card vs CPU: logits or greedy tokens differ"
        return ""

    def attention():
        B, S, Hh, D = LM_ATTN_SHAPE
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(LM_ATTN_SHAPE, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        chunks = (cfg.attn_chunk_q, cfg.attn_chunk_kv)
        got = flash_attention(q, k, v, True, None, *chunks).float()

        def ulp(x):
            """bf16's spacing at float32 ``x``: 2^(floor(log2 |x|) - 7)."""
            return torch.exp2(torch.floor(torch.log2(x.abs())) - 7)

        want = attention_reference(q, k, v, True).float()
        err = (got - want).abs()
        sigma = rounding_sigma(torch, q, k, v)
        # past the output roundings (half an ulp of each side), in sigmas
        z = float(((err - (ulp(got) + ulp(want)) / 2).clamp_min(0)
                   / sigma.clamp_min(1e-30)).max())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        flops = 2 * 2 * B * Hh * S * (S + 1) / 2 * D     # causal QK^T, PV
        b_ms = max(4 * q.numel() * 2 / MEM_BPS, flops / BF16_OPS) * 1e3
        out["attention"] = {
            "shape": list(LM_ATTN_SHAPE), "dtype": "bfloat16",
            "chunks": list(chunks),
            "max_abs_err": float(err.max()), "max_sigmas": z,
            "sigmas_allowed": LM_ATTN_SIGMAS,
            "ms": cuda_ms(torch, lambda: flash_attention(
                q, k, v, True, None, *chunks), 5),
            "oracle_ms": cuda_ms(torch, lambda: attention_reference(
                q, k, v, True), 3),
            "sdpa_ms": cuda_ms(torch, lambda: sdpa(qt, kt, vt,
                                                   is_causal=True), 10),
            "bound_ms": b_ms, "bound_by": "operations (bf16 tensor rate)"}
        a = out["attention"]
        print(f"lm attention {LM_ATTN_SHAPE} bf16 causal, chunks "
              f"{chunks}: blockwise flash {a['ms']:.3f} ms; vs the oracle "
              f"max abs err {a['max_abs_err']:.3g}, at most {z:.2f} sigmas "
              f"of its bf16 probabilities past the output roundings "
              f"(allowed {LM_ATTN_SIGMAS}); oracle {a['oracle_ms']:.3f} ms, "
              f"sdpa {a['sdpa_ms']:.3f} ms, bound {b_ms:.4f} ms [{smi}]")
        if not z <= LM_ATTN_SIGMAS:
            return (f"attention: an entry {z:.2f} sigmas past the oracle "
                    f"(allowed {LM_ATTN_SIGMAS})")
        return ""

    def phase():
        for part in (serve, card_vs_cpu, attention):
            err = part()
            torch.cuda.empty_cache()
            if err:
                return err
        return ""

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err, path_err = on_path("lm", phase, (),
                                tuple(KERNEL_ENTRIES.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
    return out, err or path_err



def check_lm_train(torch, on_path, smi: str, carry: dict | None = None):
    """Phase 11.  Returns ``(report, error)``; ``error`` is '' when every
    check held.

    LM training through ``repro_torch.train`` at ``LM_ARCH``'s full width
    (``lm_train_workload``: bf16 params, float32 moments, remat
    ``"block"``, weights drawn on the card from seed ``SEED``):

    - ``LM_TRAIN_STEPS`` steps of ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``
      tokens in microbatches of ``LM_TRAIN_MICRO``: every loss and grad
      norm finite; ms per step (CUDA events around each step; the median
      of steps 2..6), tokens per second, model-FLOP utilisation
      (6 N tokens per step over the step time, at ``BF16_OPS``), the peak
      of allocated device memory over the last step, and over one step of
      the same state and batch with remat off;
    - card vs CPU: a float32 copy of the config cut to
      ``LM_TRAIN_CHECK['n_layers']`` layers, the same weights on both, one
      ``LM_TRAIN_CHECK['seq']``-token sequence, TF32 off: the loss within
      ``loss_rtol`` and every gradient leaf within ``grad_rel`` of its
      largest |g|; then ``adamw_update`` on both fed the CPU's gradients
      (the first AdamW step is about lr sign(g), so params updated with
      each side's own gradients would test the sign of near-zero
      gradients): params and moments within ``adamw_rtol``;
    - restart, on that float32 model: 4 steps straight equal 2 steps,
      ``save_checkpoint`` into a temporary directory, ``restore_checkpoint``
      into a fresh state and 2 more, bit for bit;
    - the flash backward at ``LM_ATTN_SHAPE`` bf16 (causal, the config's
      chunks) against float32 autograd through ``attention_reference``:
      each of dq, dk, dv within one bf16 ulp of the oracle's entry plus
      ``LM_BWD_ATOL_SHARE`` of the oracle's largest |value|; the port's
      backward timed beside the backward of
      ``scaled_dot_product_attention`` (printed only; never on the path)
      and its bound at the bf16 tensor rate.

    No hand kernel runs on this path: the launch counts of S, A, B, C and
    D stay 0."""
    import shutil
    import statistics
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.layers import (_flash_bwd, _flash_fwd,
                                           attention_reference)
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import train_step as train_step_mod
    from repro_torch.train.train_step import batch_grads
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH)
    out: dict = {"card": smi, "arch": LM_ARCH, "dtype": cfg.param_dtype,
                 "remat": cfg.remat, "batch": LM_TRAIN_BATCH,
                 "seq": LM_TRAIN_SEQ, "microbatch": LM_TRAIN_MICRO,
                 "steps": LM_TRAIN_STEPS, "opt": LM_TRAIN_OPT}
    held: dict = {}            # step 1's state, for the donated run

    def train():
        out["memory_allocated_before"] = torch.cuda.memory_allocated()
        model, state, batch_at, step = lm_train_workload(torch, dev)
        n = sum(t.numel() for t in tree_leaves(state.params))
        out["params"] = n
        marks, metrics = [], []
        for i in range(LM_TRAIN_STEPS):
            batch = batch_at(i)
            if i == LM_TRAIN_STEPS - 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, m = step(state, batch)
            ev[1].record()
            marks.append(ev)
            metrics.append(m)
            if i == 0:      # the donated run's and phase 12's comparison
                held["params_step1"] = state.params
                # on the host, so phase 11's peak stays its own
                held["opt_step1"] = tree_map(lambda t: t.cpu(),
                                             (state.opt.m, state.opt.v))
                if carry is not None:
                    carry.update(held)
        torch.cuda.synchronize()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        ms = [a.elapsed_time(b) for a, b in marks]
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        out["ms_per_step_runs"] = ms
        out["ms_per_step"] = statistics.median(ms[1:])
        if carry is not None:
            carry.update(loss=[float(x["loss"]) for x in metrics],
                         grad_norm=[float(x["grad_norm"]) for x in metrics],
                         ms_per_step=out["ms_per_step"])
        out["tokens_per_s"] = tokens * 1e3 / out["ms_per_step"]
        out["model_flops_per_step"] = 6 * n * tokens
        out["mfu"] = (out["model_flops_per_step"] / (out["ms_per_step"]
                                                     * 1e-3) / BF16_OPS)
        out["bf16_peak_flops"] = BF16_OPS
        out["loss"] = [float(m["loss"]) for m in metrics]
        out["grad_norm"] = [float(m["grad_norm"]) for m in metrics]
        out["tokens_per_batch"] = [float(m["tokens"]) for m in metrics]
        # the same step with remat off: its peak beside the remat step's
        off = Model(model.cfg.with_(remat="none"), dev)
        step_off = make_train_step(off, microbatch=LM_TRAIN_MICRO,
                                   **LM_TRAIN_OPT)
        batch = batch_at(LM_TRAIN_STEPS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, m_off = step_off(state, batch)
        torch.cuda.synchronize()
        out["max_memory_allocated_no_remat"] = torch.cuda.max_memory_allocated()
        out["loss_no_remat_step"] = float(m_off["loss"])
        print(f"lm_train {LM_ARCH} bf16 ({n} parameters), {LM_TRAIN_BATCH} "
              f"x {LM_TRAIN_SEQ} tokens a step in microbatches of "
              f"{LM_TRAIN_MICRO}, remat {model.cfg.remat}: "
              f"{out['ms_per_step']:.1f} ms per step (steps "
              f"{[round(x, 1) for x in ms]}), "
              f"{out['tokens_per_s']:.0f} tokens/s, MFU "
              f"{out['mfu']:.2%} of {BF16_OPS / 1e12:.0f} TFLOP/s bf16; "
              f"peak {out['max_memory_allocated'] / 2**30:.2f} GiB, with "
              f"remat off {out['max_memory_allocated_no_remat'] / 2**30:.2f}"
              f" GiB (earlier phases hold "
              f"{out['memory_allocated_before'] / 2**30:.2f}); losses "
              f"{[round(x, 4) for x in out['loss']]}, grad norms "
              f"{[round(x, 4) for x in out['grad_norm']]} [{smi}]")
        bad = [x for x in out["loss"] + out["grad_norm"]
               + [out["loss_no_remat_step"]] if not np.isfinite(x)]
        if bad:
            return f"training: non-finite losses or grad norms {bad}"
        if out["tokens_per_batch"] != [float(LM_TRAIN_BATCH
                                             * LM_TRAIN_SEQ)] * LM_TRAIN_STEPS:
            return f"training: token counts {out['tokens_per_batch']}"
        return ""

    ck = LM_TRAIN_CHECK
    cfg32 = cfg.with_(n_layers=ck["n_layers"], param_dtype="float32",
                      compute_dtype="float32")

    def card_vs_cpu():
        gpu, cpu = Model(cfg32, dev), Model(cfg32, "cpu")
        p_gpu = gpu.init(torch.Generator(device=dev).manual_seed(SEED))
        p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
        tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
            0, cfg.vocab_size, (ck["batch"], ck["seq"] + 1)).astype(
                np.int32))
        runs, seconds = [], []
        for m, p in ((gpu, p_gpu), (cpu, p_cpu)):
            t0 = time.perf_counter()
            g, met = batch_grads(m, p, {"tokens": tokens.to(m.device)})
            runs.append((tree_map(lambda t: t.cpu(), g), float(met["loss"])))
            seconds.append(time.perf_counter() - t0)
        (g_gpu, l_gpu), (g_cpu, l_cpu) = runs
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu)))
        finite = all(bool(torch.isfinite(a).all())
                     for a in tree_leaves(g_gpu))
        # AdamW on both sides, fed the CPU's gradients
        upd = []
        for p, dv in ((p_gpu, dev), (p_cpu, torch.device("cpu"))):
            g = tree_map(lambda t: t.to(dv), g_cpu)
            new_p, opt, _ = adamw_update(p, g, adamw_init(p), 4e-4)
            upd.append([t.cpu() for t in tree_leaves([new_p, opt.m,
                                                      opt.v])])
        a_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(*upd))
        a_ok = all(bool(((a - b).abs() <= ck["adamw_rtol"] * (
            b.abs() + b.abs().max())).all()) for a, b in zip(*upd))
        out["card_vs_cpu"] = {
            "dtype": "float32", "n_layers": ck["n_layers"],
            "tokens": ck["seq"], "loss": [l_gpu, l_cpu],
            "loss_rel_err": abs(l_gpu - l_cpu) / abs(l_cpu),
            "grad_max_rel_err": rel, "grad_rel_allowed": ck["grad_rel"],
            "adamw_max_rel_err": a_rel, "adamw_rtol": ck["adamw_rtol"],
            "card_seconds": seconds[0], "cpu_seconds": seconds[1]}
        c = out["card_vs_cpu"]
        print(f"lm_train card vs CPU (float32, TF32 off, {ck['n_layers']} "
              f"layers, {ck['seq']} tokens): loss {l_gpu:.6f} vs "
              f"{l_cpu:.6f} (rel err {c['loss_rel_err']:.3g}, allowed "
              f"{ck['loss_rtol']}); gradient leaves within "
              f"{rel:.3g} of their largest |g| (allowed {ck['grad_rel']}); "
              f"adamw_update on the CPU's gradients within {a_rel:.3g} of "
              f"the leaf's largest |value| (rtol {ck['adamw_rtol']}); card "
              f"{seconds[0]:.1f} s, CPU {seconds[1]:.1f} s [{smi}]")
        if not (finite and c["loss_rel_err"] <= ck["loss_rtol"]
                and rel <= ck["grad_rel"]):
            return "card vs CPU: loss or gradients differ"
        if not a_ok:
            return "card vs CPU: adamw_update differs"
        return ""

    def restart():
        model = Model(cfg32, dev)
        step = make_train_step(model, peak_lr=4e-4, warmup=0)
        tokens = np.random.default_rng(SEED + 3).integers(
            0, cfg.vocab_size, (4, ck["batch"], ck["seq"] + 1)).astype(
                np.int32)
        batches = [{"tokens": torch.from_numpy(t).to(dev)} for t in tokens]

        def fresh():
            return init_train_state(
                model, torch.Generator(device=dev).manual_seed(SEED))

        straight = fresh()
        for b in batches:
            straight, _ = step(straight, b)
        resumed = fresh()
        for b in batches[:2]:
            resumed, _ = step(resumed, b)
        d = tempfile.mkdtemp(prefix="lm_train_ckpt_")
        try:
            save_checkpoint(d, 2, resumed)
            del resumed
            resumed, at, _ = restore_checkpoint(d, fresh(), device=dev)
        finally:
            shutil.rmtree(d)
        for b in batches[2:]:
            resumed, _ = step(resumed, b)
        a, b = tree_leaves(list(straight)), tree_leaves(list(resumed))
        n_diff = sum(int((x != y).sum()) for x, y in zip(a, b))
        out["restart"] = {"restored_step": at, "steps": 4,
                          "leaves": len(a), "entries_differ": n_diff}
        print(f"lm_train restart: 2 steps, checkpoint, restore (step {at})"
              f", 2 steps vs 4 straight: {n_diff} of "
              f"{sum(x.numel() for x in a)} entries differ over {len(a)} "
              f"leaves [{smi}]")
        if at != 2 or n_diff:
            return "restart: the resumed run differs from the straight one"
        return ""

    def backward():
        B, S, Hh, D = LM_ATTN_SHAPE
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        q, k, v, do = (torch.randn(LM_ATTN_SHAPE, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        args = (True, None, cfg.attn_chunk_q, cfg.attn_chunk_kv, None)
        o, lse = _flash_fwd(q, k, v, *args)
        got = _flash_bwd(q, k, v, o, lse, do, *args)
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        attention_reference(*leaves, True).backward(do.float())
        worst, rel = 0.0, []
        for g, w in zip(got, (t.grad for t in leaves)):
            err = (g.float() - w).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                w.abs().clamp_min(1e-30))) - 7)
            allowed = ulp + LM_BWD_ATOL_SHARE * w.abs().max()
            worst = max(worst, float((err / allowed).max()))
            rel.append(float(err.max() / w.abs().max()))
        del leaves
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        o_sdpa = sdpa(qt, kt, vt, is_causal=True)
        do_t = do.transpose(1, 2)
        pairs = S * (S + 1) / 2
        # five products (s, dp, dv, dk, dq) over the causal half
        flops = 5 * 2 * B * Hh * pairs * D
        bytes_moved = (8 * q.numel() * 2          # read q k v o dO, write 3
                       + lse.numel() * 4)
        b_ms = max(bytes_moved / MEM_BPS, flops / BF16_OPS) * 1e3
        out["flash_backward"] = {
            "shape": list(LM_ATTN_SHAPE), "dtype": "bfloat16",
            "chunks": list(args[2:4]),
            "max_err_over_allowed": worst,
            "atol_share": LM_BWD_ATOL_SHARE,
            "max_err_rel_to_max": dict(zip(("dq", "dk", "dv"), rel)),
            "ms": cuda_ms(torch, lambda: _flash_bwd(q, k, v, o, lse, do,
                                                    *args), 3),
            "sdpa_backward_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                o_sdpa, (qt, kt, vt), do_t, retain_graph=True), 10),
            "bound_ms": b_ms, "bound_by": "operations (bf16 tensor rate)"
            if flops / BF16_OPS >= bytes_moved / MEM_BPS else "bytes"}
        f = out["flash_backward"]
        print(f"lm_train flash backward {LM_ATTN_SHAPE} bf16 causal, chunks "
              f"{tuple(args[2:4])}: {f['ms']:.3f} ms; dq/dk/dv vs float32 "
              f"autograd through the oracle: largest error "
              f"{worst:.3f} of one bf16 ulp + {LM_BWD_ATOL_SHARE} x max|g| "
              f"(max err / max|g|: "
              f"{', '.join(f'{r:.3g}' for r in rel)}); sdpa backward "
              f"{f['sdpa_backward_ms']:.3f} ms, bound {b_ms:.4f} ms "
              f"({f['bound_by']}) [{smi}]")
        if not worst <= 1.0:
            return (f"flash backward: an entry {worst:.3f} of its allowance "
                    f"from the oracle")
        return ""

    def donated():
        """Phase 11's steps from the same state with ``donate=True``."""
        model, state, batch_at, step = lm_train_workload(torch, dev,
                                                         donate=True)

        def leaves(st):
            return tree_leaves([st.params, st.opt.m, st.opt.v])

        ptrs = [t.data_ptr() for t in leaves(state)]
        peaks: dict = {}
        update = train_step_mod.adamw_update

        def spied(*a, **k):
            """The update with the peak before it (the forward's and
            backward's) and its own."""
            torch.cuda.synchronize()
            peaks["backward"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = update(*a, **k)
            torch.cuda.synchronize()
            peaks["update"] = torch.cuda.max_memory_allocated()
            return res

        marks, losses, norms, aliased = [], [], [], True
        try:
            for i in range(LM_TRAIN_STEPS):
                batch = batch_at(i)
                if i == LM_TRAIN_STEPS - 1:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    train_step_mod.adamw_update = spied
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state, m = step(state, batch)
                ev[1].record()
                marks.append(ev)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                aliased &= [t.data_ptr() for t in leaves(state)] == ptrs
                if i == 0:
                    # the functional run's step-1 parameters stay held to
                    # the end, as they were through its steps
                    diffs = [leaf_diff(torch, state.params,
                                       held["params_step1"])] + [
                        leaf_diff(torch, a, b) for a, b in zip(
                            (state.opt.m, state.opt.v),
                            held.pop("opt_step1"))]
        finally:
            train_step_mod.adamw_update = update
        held.clear()
        ms = [a.elapsed_time(b) for a, b in marks]
        peak = max(peaks.values())
        out["donated"] = {
            "loss_equal": losses == out["loss"],
            "grad_norm_equal": norms == out["grad_norm"],
            "step1_entries_differ": {n: d[0] for n, d in zip(
                ("params", "m", "v"), diffs)},
            "step1_entries": diffs[0][2],
            "aliased": aliased, "ms_per_step_runs": ms,
            "ms_per_step": statistics.median(ms[1:]),
            "max_memory_allocated": peak,
            "max_memory_allocated_backward": peaks["backward"],
            "max_memory_allocated_update": peaks["update"],
            "peak_set_by": max(peaks, key=peaks.get),
            "functional_max_memory_allocated": out["max_memory_allocated"],
            "functional_ms_per_step": out["ms_per_step"]}
        d = out["donated"]
        n_diff = sum(d["step1_entries_differ"].values())
        print(f"lm_train donated (donate=True), phase 11's state and "
              f"batches: losses equal {d['loss_equal']}, grad norms equal "
              f"{d['grad_norm_equal']}; after step 1, entries differing "
              f"from the functional run's: {d['step1_entries_differ']} of "
              f"{d['step1_entries']} each; every step returned the given "
              f"tensors {aliased}; {d['ms_per_step']:.1f} ms per step "
              f"(functional {out['ms_per_step']:.1f}); peak "
              f"{peak / 2**30:.2f} GiB (functional "
              f"{out['max_memory_allocated'] / 2**30:.2f}), forward and "
              f"backward {peaks['backward'] / 2**30:.2f}, update "
              f"{peaks['update'] / 2**30:.2f}: set by the "
              f"{d['peak_set_by']} [{smi}]")
        if not (d["loss_equal"] and d["grad_norm_equal"] and aliased) \
                or n_diff:
            return ("donated training: off the functional run's bits or "
                    "new tensors returned")
        return ""

    def phase():
        for part in (train, donated, card_vs_cpu, restart, backward):
            err = part()
            torch.cuda.empty_cache()
            if err:
                return err
        return ""

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err, path_err = on_path("lm_train", phase, (),
                                tuple(KERNEL_ENTRIES.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
    return out, err or path_err


@contextlib.contextmanager
def one_rank_mesh(torch):
    """A one-rank NCCL process group (its store a file in a temporary
    directory) and ``make_smoke_mesh(1, 1)`` on the card; the group is
    destroyed and the directory removed on exit."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    d = tempfile.mkdtemp(prefix="nccl_store_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(d, "store"), 1), world_size=1, rank=0)
    try:
        yield make_smoke_mesh(1, 1)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(d, ignore_errors=True)


def leaf_diff(torch, got, want) -> tuple[int, float, int]:
    """(entries that differ, largest |difference|, entries) over two
    trees of tensors (DTensors compared by their local shards, whole on
    one rank; each leaf of ``want`` brought to ``got``'s device)."""
    from repro_torch.tree import tree_leaves
    n_diff, worst, total = 0, 0.0, 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a = a.to_local() if hasattr(a, "to_local") else a
        b = b.to_local() if hasattr(b, "to_local") else b
        b = b.to(a.device)
        bad = a != b
        n_diff += int(bad.sum())
        total += a.numel()
        if bool(bad.any()):
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    return n_diff, worst, total


def dryrun_cells(cells) -> list:
    """``python -m repro_torch.launch.dryrun`` for each (arch, shape,
    multi-pod), all at once, each in a process of its own (the fake world
    never touches this one); started here, read by ``finish()``."""
    import tempfile
    d = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi_pod in cells:
        path = os.path.join(d, f"{arch}_{shape}_{int(multi_pod)}.json")
        procs.append((path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", path]
            + (["--multi-pod"] if multi_pod else []),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))

    def finish() -> list:
        results = []
        for path, proc in procs:
            try:
                log, _ = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
            finally:
                proc.kill()
            if proc.returncode != 0 or not os.path.exists(path):
                raise RuntimeError(f"dryrun exit {proc.returncode}: "
                                   f"{log[-2000:]}")
            with open(path) as f:
                results.extend(json.load(f))
        return results

    return finish


def check_lm_mesh(torch, on_path, smi: str, lm: dict, lm_train: dict,
                  carry: dict):
    """Phase 12.  Returns ``(report, error)``; ``error`` is '' when every
    check held.  ``lm`` / ``lm_train`` are phases 10 and 11's reports and
    ``carry`` what they handed on (phase 10's tokens, phase 11's losses
    and its parameters after step 1).

    The mesh path (``repro_torch.distributed``, DTensor) on a one-rank
    NCCL mesh (``one_rank_mesh``), ``make_rules(mesh)`` with ZeRO and
    sequence parallelism on:

    - training: ``lm_train_workload`` with the rules (the same state and
      batches as phase 11, placed by the specs), ``MESH_TRAIN_STEPS``
      steps: every loss and grad norm, and the parameters and both AdamW
      moments after step 1, equal phase 11's bit for bit (one rank: its
      collectives are copies).  Step 1's learning rate is 0 in the
      warm-up, so its parameters are the initial draw; the moments carry
      its gradients (m = 0.1 g, v = 0.05 g^2, g clipped), so they are
      what holds the mesh's forward and backward; placements kept; ms per step (CUDA events; the median after the
      first) beside phase 11's, host ms, peak memory; one more step under
      ``torch.profiler``: device ms, device operations and the host's
      share (1 - device ms / the untraced step's ms);
    - serving: ``lm_workload`` with the rules, ``generate`` of phase 10's
      prompts for ``MESH_NEW`` tokens through the 2D decode layout: phase
      10's first tokens; ms per prefill and decode step beside phase
      10's;
    - MoE: ``qwen3-moe-235b-a22b``'s smoke config at capacity 16 (float32)
      on the mesh, its forward (1D ``shard_map``) and its layer-0 experts
      in the 2D decode form, against the one-device model;
    - ``compressed_psum`` over the mesh's ``data`` dim and over the world
      group: ``decompress_leaf(*compress_leaf(g))``'s bits;
    - elastic restore: step 1's mesh parameters saved (gathered, bf16),
      restored with ``shardings=`` onto the mesh and with none into the
      one-device model: 0 entries differ; the directory removed;
    - the dry-run of ``MESH_DRYRUN`` on the production meshes, (16, 16)
      and (2, 16, 16), in subprocesses (a fake world of 256 or 512 ranks
      each): per-device argument bytes, tracked peak, collective bytes by
      kind, roofline terms at H100 constants, trace seconds;
    - the yardstick: ``analytic_cost`` of phase 11's step at H100 bf16 /
      HBM rates beside phase 11's measured ms (a roofline fraction).

    No hand kernel runs: the launch counts of S, A, B, C and D stay 0."""
    import shutil
    import statistics
    import tempfile
    from dataclasses import replace
    import numpy as np
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.distributed.tensor import distribute_tensor
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
    from repro_torch.distributed import (compress_leaf, compressed_psum,
                                         decompress_leaf)
    from repro_torch.distributed.sharding import (batch_pspecs, distribute,
                                                  local_bytes, make_rules,
                                                  param_pspecs, placements,
                                                  shardings_of)
    from repro_torch.launch.roofline import analytic_cost
    from repro_torch.models import Model
    from repro_torch.serve import generate
    from repro_torch.tree import tree_leaves
    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    out: dict = {"card": smi, "arch": LM_ARCH, "mesh": {"data": 1,
                                                        "model": 1},
                 "backend": "nccl", "rules": {"fsdp": True, "sp": True}}
    held: dict = {}

    def train(mesh):
        rules = make_rules(mesh)
        out["memory_allocated_before"] = torch.cuda.memory_allocated()
        model, state, batch_at, step = lm_train_workload(torch, dev,
                                                         rules=rules)
        placed = [t.placements for t in tree_leaves(state.params)]
        marks, walls, losses, norms = [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(MESH_TRAIN_STEPS):
            batch = batch_at(i)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            state, m = step(state, batch)
            ev[1].record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            marks.append(ev)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                held["step1"] = state.params
                # the moments against phase 11's now, so neither pair is
                # held through the later steps
                moments = [leaf_diff(torch, a, b) for a, b in zip(
                    (state.opt.m, state.opt.v), carry.pop("opt_step1"))]
        ms = [a.elapsed_time(b) for a, b in marks]
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["ms_per_step_runs"] = ms
        out["ms_per_step"] = statistics.median(ms[1:])
        out["host_ms_per_step_runs"] = walls
        out["phase11_ms_per_step"] = lm_train["ms_per_step"]
        out["loss"] = losses
        out["phase11_loss"] = carry["loss"][:MESH_TRAIN_STEPS]
        out["grad_norm"] = norms
        out["phase11_grad_norm"] = carry["grad_norm"][:MESH_TRAIN_STEPS]
        n_diff, worst, total = leaf_diff(torch, held["step1"],
                                         carry["params_step1"])
        out["params_step1"] = {"entries_differ": n_diff, "max_abs_diff":
                               worst, "entries": total}
        for name, (nd, w, _) in zip(("m", "v"), moments):
            out[f"opt_{name}_step1"] = {"entries_differ": nd,
                                        "max_abs_diff": w}
        m_diff = moments[0][0] + moments[1][0]
        kept = all(t.placements == p for t, p in zip(
            tree_leaves(state.params), placed)) and all(
            t.placements == p for t, p in zip(tree_leaves(state.opt.m),
                                              placed))
        out["placements_kept"] = kept
        batch = batch_at(MESH_TRAIN_STEPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        out["profiled_step"] = {
            "traced_ms": traced, "device_ms": busy,
            "device_ops": sum(e.count for e in events),
            "host_share": 1.0 - busy / statistics.median(walls[1:])}
        p = out["profiled_step"]
        same_loss = losses == out["phase11_loss"]
        same_norm = norms == out["phase11_grad_norm"]
        print(f"lm_mesh train {LM_ARCH} bf16 on a one-rank NCCL mesh "
              f"(data 1, model 1; ZeRO, SP), phase 11's state and batches: "
              f"losses {losses} vs phase 11 {out['phase11_loss']} (equal "
              f"{same_loss}); grad norms {norms} vs {out['phase11_grad_norm']}"
              f" (equal {same_norm}); after step 1, entries differing from "
              f"phase 11's: params {n_diff} of {total} (lr 0 in the "
              f"warm-up), moment m {moments[0][0]} (max "
              f"{moments[0][1]:.3g}), v {moments[1][0]} (max "
              f"{moments[1][1]:.3g}); "
              f"placements kept {kept}; {out['ms_per_step']:.1f} ms per "
              f"step (steps {[round(x, 1) for x in ms]}; host clock "
              f"{[round(x, 1) for x in walls]}) vs phase 11's "
              f"{lm_train['ms_per_step']:.1f}; peak "
              f"{out['max_memory_allocated'] / 2**30:.2f} GiB (earlier "
              f"phases hold {out['memory_allocated_before'] / 2**30:.2f}); "
              f"one traced step: device {busy:.1f} ms of {traced:.1f} ms, "
              f"{p['device_ops']} device operations, host share "
              f"{p['host_share']:.3f} [{smi}]")
        bad = [x for x in losses + norms if not np.isfinite(x)]
        if bad or not kept:
            return (f"mesh training: losses {losses}, grad norms {norms}, "
                    f"placements kept {kept}")
        if not (same_loss and same_norm) or n_diff or m_diff:
            return (f"mesh training: off phase 11's bits (losses equal "
                    f"{same_loss}, grad norms equal {same_norm}; step 1 "
                    f"entries differ: params {n_diff}, moments {m_diff})")
        return ""

    def serve(mesh):
        model, params, prompts = lm_workload(torch, dev, make_rules(mesh))
        marks: dict = {"prefill": [], "decode": []}

        def timed(name, fn):
            def run(*a, **k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = fn(*a, **k)
                ev[1].record()
                marks[name].append(ev)
                return res
            return run

        model.prefill = timed("prefill", model.prefill)
        model.decode_step = timed("decode", model.decode_step)
        generate(model, params, prompts, max_new=MESH_NEW)     # warm-up
        for v in marks.values():
            v.clear()
        toks = generate(model, params, prompts, max_new=MESH_NEW)
        torch.cuda.synchronize()
        ms = {n: [a.elapsed_time(b) for a, b in v] for n, v in marks.items()}
        got = toks.full_tensor()
        want = carry["tokens"][:, :MESH_NEW]
        equal = bool(torch.equal(got, want))
        out["serve"] = {"batch": LM_BATCH, "prompt": LM_PROMPT,
                        "new": MESH_NEW, "tokens_equal_phase10": equal,
                        "ms_per_prefill": ms["prefill"][0],
                        "ms_per_decode_step": statistics.median(
                            ms["decode"][1:]),
                        "phase10_ms_per_prefill": lm["ms_per_prefill"],
                        "phase10_ms_per_decode_step":
                            lm["ms_per_decode_step"]}
        v = out["serve"]
        print(f"lm_mesh serve {LM_ARCH} bf16, {LM_BATCH} x {LM_PROMPT} + "
              f"{MESH_NEW} greedy through the 2D decode layout: tokens "
              f"equal phase 10's {equal}; prefill {v['ms_per_prefill']:.3f}"
              f" ms (phase 10 {lm['ms_per_prefill']:.3f}), decode step "
              f"{v['ms_per_decode_step']:.3f} ms (phase 10 "
              f"{lm['ms_per_decode_step']:.3f}) [{smi}]")
        if not equal:
            return "mesh serving: greedy tokens differ from phase 10's"
        return ""

    def moe(mesh):
        cfg = get_smoke_config("qwen3-moe-235b-a22b")
        cfg = cfg.with_(moe=replace(cfg.moe, capacity_factor=16.0))
        rules = make_rules(mesh)
        one, sharded = Model(cfg, dev), Model(cfg, dev, rules)
        params = one.init(torch.Generator(device=dev).manual_seed(SEED))
        p_mesh = distribute(params, param_pspecs(params, rules), mesh)
        tokens = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
            0, cfg.vocab_size, MESH_MOE_TOKENS)).to(dev)
        with torch.no_grad():
            want, aux1 = one.forward(params, tokens)
            got, aux2 = sharded.forward(p_mesh, distribute(
                {"t": tokens}, batch_pspecs({"t": tokens}, rules),
                mesh)["t"])
            x = torch.randn((MESH_MOE_TOKENS[0], 1, cfg.d_model),
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED + 5), device=dev)
            layer = {k: ({"w": v["w"][0]} if k == "router" else v[0])
                     for k, v in params["scan"][0]["ffn"]["moe"].items()}
            layer_m = {k: ({"w": v["w"][0]} if k == "router" else v[0])
                       for k, v in p_mesh["scan"][0]["ffn"]["moe"].items()}
            y1, a1 = one._moe(layer, x)
            xd = distribute_tensor(x, mesh, placements(
                rules.spec(None, None, "dp"), mesh))
            y2, a2 = sharded._moe(layer_m, xd, decode2d=True)
        err1 = float((got.full_tensor() - want).abs().max())
        err2 = float((y2.full_tensor() - y1).abs().max())
        daux = [abs(float(aux1) - float(aux2)), abs(float(a1) - float(a2))]
        out["moe"] = {"config": "qwen3-moe-235b-a22b smoke, capacity 16",
                      "forward_err": err1, "decode2d_err": err2,
                      "aux_diff": daux, "bounds": [MESH_BOUNDS["moe"],
                                                   MESH_BOUNDS["aux"]]}
        print(f"lm_mesh moe (qwen3-moe smoke, capacity 16, float32): 1D "
              f"forward max err {err1:.3g}, 2D decode form {err2:.3g} "
              f"(bound {MESH_BOUNDS['moe']}); |d aux| {daux} (bound "
              f"{MESH_BOUNDS['aux']}) [{smi}]")
        if not (err1 < MESH_BOUNDS["moe"] and err2 < MESH_BOUNDS["moe"]
                and max(daux) < MESH_BOUNDS["aux"]):
            return "mesh MoE: outside the reference's bounds"
        return ""

    def psum(mesh):
        g = torch.randn(1 << 20, generator=torch.Generator(device=dev)
                        .manual_seed(SEED + 6), device=dev)
        want = decompress_leaf(*compress_leaf(g))
        same = []
        for axis in ((mesh, "data"), dist.group.WORLD):
            got = compressed_psum(g, axis)
            same.append(bool(torch.equal(got.view(torch.int32),
                                         want.view(torch.int32))))
        out["compressed_psum"] = {"entries": g.numel(),
                                  "bit_equal": same}
        print(f"lm_mesh compressed_psum over NCCL ({g.numel()} entries; "
              f"mesh dim 'data', world group): equal to "
              f"decompress_leaf(compress_leaf(g)) bit for bit {same} "
              f"[{smi}]")
        return "" if all(same) else "compressed_psum: bits differ"

    def restore(mesh):
        saved = held.pop("step1")
        d = tempfile.mkdtemp(prefix="lm_mesh_ckpt_")
        try:
            t0 = time.perf_counter()
            save_checkpoint(d, 1, saved)
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            onto, _, _ = restore_checkpoint(d, saved,
                                            shardings=shardings_of(saved))
            t_mesh = time.perf_counter() - t0
            n_mesh = leaf_diff(torch, onto, saved)[0]
            kept = all(a.placements == b.placements for a, b in zip(
                tree_leaves(onto), tree_leaves(saved)))
            del onto
            t0 = time.perf_counter()
            whole, _, _ = restore_checkpoint(d, carry["params_step1"],
                                             device=dev)
            t_one = time.perf_counter() - t0
            n_one = leaf_diff(torch, whole, saved)[0]
            del whole
        finally:
            shutil.rmtree(d)
        out["restore"] = {"bytes": local_bytes(saved), "save_s": t_save,
                          "restore_mesh_s": t_mesh, "restore_one_s": t_one,
                          "entries_differ_mesh": n_mesh,
                          "entries_differ_one_device": n_one,
                          "placements_kept": kept}
        print(f"lm_mesh elastic restore: step 1's params "
              f"({local_bytes(saved) / 1e9:.2f} GB bf16) saved in "
              f"{t_save:.1f} s; restored onto the mesh with shardings= in "
              f"{t_mesh:.1f} s ({n_mesh} entries differ, placements kept "
              f"{kept}) and into the one-device model in {t_one:.1f} s "
              f"({n_one} differ) [{smi}]")
        if n_mesh or n_one or not kept:
            return "elastic restore: entries or placements differ"
        return ""

    def yardstick():
        spec = ShapeSpec("phase11", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
        cost = analytic_cost(get_config(LM_ARCH), spec)
        compute_ms = cost["flops"] / BF16_OPS * 1e3
        memory_ms = cost["hbm_bytes"] / MEM_BPS * 1e3
        bound = max(compute_ms, memory_ms)
        out["yardstick"] = {
            "analytic_flops": cost["flops"],
            "analytic_hbm_bytes": cost["hbm_bytes"],
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "bound_ms": bound, "phase11_ms": lm_train["ms_per_step"],
            "roofline_fraction": bound / lm_train["ms_per_step"],
            "mesh_roofline_fraction": bound / out["ms_per_step"]}
        y = out["yardstick"]
        print(f"lm_mesh yardstick: analytic_cost of phase 11's step "
              f"({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, remat) "
              f"{cost['flops'] / 1e12:.2f} TFLOP, "
              f"{cost['hbm_bytes'] / 1e9:.2f} GB: compute bound "
              f"{compute_ms:.1f} ms at {BF16_OPS / 1e12:.0f} TFLOP/s, "
              f"memory {memory_ms:.1f} ms at {MEM_BPS / 1e12:.2f} TB/s; "
              f"phase 11 {lm_train['ms_per_step']:.1f} ms = "
              f"{y['roofline_fraction']:.2%} of the bound; mesh step "
              f"{y['mesh_roofline_fraction']:.2%} [{smi}]")
        return ""

    def dryrun(finish):
        cells = finish()
        out["dryrun"] = cells
        for c in cells:
            if not c.get("ok"):
                return f"dryrun {c['arch']} x {c['shape']}: {c.get('error')}"
            if not all(isinstance(c[k], float) and c[k] > 0
                       for k in ("flops", "bytes_accessed")):
                return (f"dryrun {c['arch']} x {c['shape']}: flops "
                        f"{c['flops']}, bytes accessed {c['bytes_accessed']}")
            m, r = c["memory"], c["roofline"]
            print(f"lm_mesh dryrun [{c['mesh']}] {c['arch']} x {c['shape']}"
                  f": per device arguments "
                  f"{m['argument_size_in_bytes'] / 2**30:.3f} GiB, tracked "
                  f"peak {m['peak_memory_in_bytes'] / 2**30:.3f} GiB "
                  f"({m['peak_memory_in_bytes']} bytes), flops "
                  f"{c['flops']:.6g}, bytes accessed "
                  f"{c['bytes_accessed']:.6g} (local operations, donated "
                  f"state or cache); "
                  f"collectives {c['collective_bytes'] / 2**30:.3f} GiB "
                  f"{ {k: round(v / 2**30, 3) for k, v in c['collective_ops'].items()} }"
                  f" in {r['collective_ops']} ops; roofline at H100: "
                  f"compute {r['compute_s'] * 1e3:.2f} ms, memory "
                  f"{r['memory_s'] * 1e3:.2f} ms, collective "
                  f"{r['collective_s'] * 1e3:.2f} ms ({r['dominant']}); "
                  f"trace {c['t_trace_s']} s [{smi}]")
        return ""

    def phase():
        with one_rank_mesh(torch) as mesh:
            for part in (train, serve):
                err = part(mesh)
                torch.cuda.empty_cache()
                if err:
                    return err
            # the untimed checks overlap the dry-run's host processes
            finish = dryrun_cells(MESH_DRYRUN)
            for part in (moe, psum, restore):
                err = part(mesh)
                torch.cuda.empty_cache()
                if err:
                    finish()
                    return err
        for part in (lambda: dryrun(finish), yardstick):
            err = part()
            if err:
                return err
        return ""

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        err, path_err = on_path("lm_mesh", phase, (),
                                tuple(KERNEL_ENTRIES.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["seconds"] = time.perf_counter() - t_phase
    return out, err or path_err


EXAMPLES = ("torch_quickstart", "torch_cascade_serving",
            "torch_video_stream", "torch_energy_tuned_detection",
            "torch_early_exit_serving")
# (example, identity line, lines that must print it)
EXAMPLE_IDENTITIES = (("torch_cascade_serving", "batched==sequential: True",
                       8),
                      ("torch_video_stream", "rects == detect: True", 10))


def check_examples(torch, on_path, smi: str):
    """Phase 13.  Returns ``(report, error)``; ``error`` is '' when every
    check held.  Each of ``EXAMPLES`` (``examples/<name>.py``) loaded and
    its ``main([])`` run in this process on the card (no ``--device``):
    it returns 0 or None, and the identity lines of
    ``EXAMPLE_IDENTITIES`` print ``True`` for every image or frame.  The
    output is echoed; the launches are counted, none required."""
    import importlib.util
    import io
    t_phase = time.perf_counter()
    out: dict = {"card": smi}

    def run_all():
        for name in EXAMPLES:
            spec = importlib.util.spec_from_file_location(
                name, ROOT / "examples" / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main([])
            torch.cuda.synchronize()
            text = buf.getvalue()
            print(text, end="")
            out[name] = {"returned": rc, "seconds":
                         time.perf_counter() - t0, "lines": text.count("\n")}
            print(f"example {name}: returned {rc} in "
                  f"{out[name]['seconds']:.1f} s [{smi}]")
            if rc not in (None, 0) or f"device: {DEVICE}" not in text:
                return f"example {name}: returned {rc}"
            for ex, line, n in EXAMPLE_IDENTITIES:
                if ex == name and text.count(line) != n:
                    return (f"example {name}: {text.count(line)} of {n} "
                            f"lines say {line!r}")
        return ""

    err, path_err = on_path("examples", run_all, (), ())
    out["seconds"] = time.perf_counter() - t_phase
    return out, err or path_err


def check_analysis(on_path, smi: str):
    """Phase 14.  Returns ``(report, error)``; ``error`` is '' when the
    port's gate, ``python -m repro_torch.analysis`` with its default paths
    run from the repository root, exits 0.  The report here holds, from
    the gate's JSON report (written to a temporary directory), the files
    scanned, the suppressed findings by rule, the gate's own seconds and
    the subprocess's wall seconds, and the kernel / twin pairs that
    ``KERNEL_REF_TWIN`` reads (``kernel_pairs`` over ``kernels/ops.py``
    and ``kernels/ref.py``)."""
    import tempfile
    from repro_torch.analysis.project import Project
    from repro_torch.analysis.rules.kernel_oracle import kernel_pairs
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out: dict = {"card": smi}

    def run_gate():
        with tempfile.TemporaryDirectory() as tmp:
            return gate(Path(tmp) / "analysis.json")

    def gate(path):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--json",
             str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=ANALYSIS_TIMEOUT)
        out["wall_s"] = time.perf_counter() - t0
        out["exit_code"] = proc.returncode
        print(proc.stdout, end="")
        print(proc.stderr, end="", file=sys.stderr)
        if proc.returncode != 0:
            return f"python -m repro_torch.analysis exited {proc.returncode}"
        doc = json.loads(path.read_text())
        by_rule: dict = {}
        for f in doc["suppressed"]:
            by_rule[f["rule"]] = by_rule.get(f["rule"], 0) + 1
        out.update(files=doc["files"], seconds=doc["seconds"],
                   findings=len(doc["findings"]),
                   suppressed=dict(sorted(by_rule.items())))
        if doc["findings"] or not doc["suppressed"]:
            return (f"the gate reports {len(doc['findings'])} findings and "
                    f"{len(doc['suppressed'])} suppressed")
        kernels = ROOT / "src" / "repro_torch" / "kernels"
        proj = Project.load([kernels / "ops.py", kernels / "ref.py"])
        out["kernel_twins"] = [
            [k, t] for k, t, _line in kernel_pairs(
                proj.modules["repro_torch.kernels.ops"],
                proj.modules["repro_torch.kernels.ref"])]
        if not out["kernel_twins"] or any(t is None
                                          for _k, t in out["kernel_twins"]):
            return f"kernel twins: {out['kernel_twins']}"
        print(f"analysis: exit 0, {out['files']} files, suppressed "
              f"{out['suppressed']}, {len(out['kernel_twins'])} kernel / "
              f"twin pairs, gate {out['seconds']:.2f} s, wall "
              f"{out['wall_s']:.2f} s [{smi}]")
        return ""

    err, path_err = on_path("analysis", run_gate, (), (
        "integral_image", "fused_head", "haar_stage", "packed_window",
        "window_variance"))
    return out, err or path_err


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
    s_ms = profiled_ms(torch, lambda: integral_image.sat_tables(stack), 20,
                       "sat_chained")
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
                cascade, 0, n_dense, ii, ii2, iic, tile=tile), 10,
            "fused_tiles")
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
            ii2, iic, ny, nx), 20, "inv_sigma"),
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
                cascade, s_b, ii, inv_b, tile=tile), 10, "stage_sums")
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

    def lane(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    def packed_list(plan, alive_flat, inv_flat):
        """The first tail segment's compaction, as the engine's tail makes
        it: the compacted index, the live count, and kernel C's five lane
        arrays and 1/sigma."""
        seg = plan.tail_segments[0]
        idx, cnt = nonzero_static(alive_flat, seg.capacity)
        sel = idx.clamp(min=0)
        lay = plan.layout
        slot = (sel % plan.n_slots).cpu().numpy()
        lvl = lay.lvl_of_slot[slot]
        lanes = (lane((sel // plan.n_slots).cpu().numpy()),
                 lane(lay.sat_base_of_lvl[lvl]),
                 lane(lay.sat_stride_of_lvl[lvl]),
                 lane(lay.y_of_slot[slot]), lane(lay.x_of_slot[slot]))
        # the live count as the engine's tail passes it
        return (idx, cnt.clamp(max=seg.capacity), lanes,
                inv_flat[sel].contiguous())

    idx, n_live, lanes, inv_c = packed_list(plan, alive_flat, inv_flat)
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

    c_all = profiled_ms(torch, lambda: packed_window.stage_sums(*c_args), 5,
                        "packed_sums")
    c_live = profiled_ms(torch, lambda: packed_window.stage_sums(
        *c_args, n_live=n_live), 10, "packed_sums")
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

    # E: the gates and per-image counts of the first tail segment of a
    # flush of E_BATCH scenes, on kernel C's sums of that flush's packed
    # list; integer counts and a bool mask, so exactly its twin's
    e_imgs = imgs + scenes(render_scene, E_BATCH - BATCH, H, W, SEED + 2,
                           n_faces=3)
    plan_e = det.batch_plan(hp, wp, E_BATCH)
    head_e, _tail_e = det.batch_parts(hp, wp, E_BATCH)
    alive_e, inv_e, ii_e, _counts = head_e(*det._stack_to_device(
        *det._pack_stack(e_imgs, hp, wp)))
    seg_e = plan_e.tail_segments[0]
    idx_e, n_live_e, lanes_e, inv_ce = packed_list(plan_e, alive_e, inv_e)
    del alive_e, inv_e
    ss_e = packed_window.stage_sums(cascade, seg_e.s0, seg_e.s1, ii_e,
                                    *lanes_e, inv_ce, n_live=n_live_e)
    del ii_e, lanes_e, inv_ce
    thr_e = cascade.stage_threshold[seg_e.s0:seg_e.s1]
    b_e = idx_e.clamp(min=0) // plan_e.n_slots
    valid_e = idx_e >= 0
    k_e = seg_e.s1 - seg_e.s0

    def gates(fn):
        v = valid_e.clone()
        c = torch.zeros((k_e, E_BATCH), dtype=torch.int32, device=dev)
        fn(ss_e, thr_e, v, b_e, n_live_e, c)
        return v, c

    got_v, got_c = gates(ops.tail_gate_counts)
    want_v, want_c = gates(ops.tail_gate_counts_ref)
    torch.cuda.synchronize()
    if not (torch.equal(got_v, want_v) and torch.equal(got_c, want_c)):
        return fail(f"kernel E differs from its twin at the first segment "
                    f"of {E_BATCH} scenes: {int((got_v != want_v).sum())} "
                    f"lanes of the mask, counts {diff(got_c, want_c)}")
    cap_e = valid_e.numel()
    live_e = int(n_live_e)
    valid_in = int(valid_e.sum())
    # lanes each stage compares: those still valid when it begins
    entering = [valid_in] + [int(n) for n in want_c.sum(1)[:-1]]
    e_work = (9 * live_e + 4 * sum(entering)
              + (valid_in - int(want_c[-1].sum())) + 4 * k_e * E_BATCH,
              sum(entering))
    e_ms = profiled_ms(torch, lambda: gates(ops.tail_gate_counts), 10,
                       "gate_counts")
    e_plain = cuda_ms(torch, lambda: gates(ops.tail_gate_counts_ref), 3)
    print(f"kernel E at the first segment of {E_BATCH} scenes: {cap_e} "
          f"lanes, {live_e} live, stages [{seg_e.s0}, {seg_e.s1}), "
          f"survivors {[int(n) for n in want_c.sum(1)]}; == twin [{smi}]")
    row("tail_gates (E)", "tail_gates", "tail_gates.cu",
        "src/repro/core/engine.py:550", 0.0, e_ms, e_plain, e_work)
    rows[-1].update(lanes=cap_e, live_lanes=live_e, images=E_BATCH,
                    stages=[seg_e.s0, seg_e.s1])
    del ss_e, b_e, valid_e, got_v, want_v

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
    inv_d_k, tail_e = "window_variance", "tail_gates"
    fused_rects, err = on_path(
        "fused", lambda: det.detect_batch(imgs, group=False),
        (head_s, head_a, tail_c, tail_e), (split_b, inv_d_k))
    if err:
        return fail(err)
    split_rects, err = on_path(
        "split", lambda: det_split.detect_batch(imgs, group=False),
        (head_s, split_b, tail_c, tail_e), (head_a, inv_d_k))
    if err:
        return fail(err)
    # a packed flush gates and counts each tail segment once, after C
    n_seg = len(plan.tail_segments)
    for label in ("fused", "split"):
        got = (by_path[label][tail_c], by_path[label][tail_e])
        if got != (n_seg, n_seg):
            return fail(f"{label} flush launched C and E {got} times, not "
                        f"once per tail segment ({n_seg})")
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
        (head_s, head_a, tail_c), (split_b, inv_d_k, tail_e))
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
                       (head_a, split_b, tail_c, tail_e))
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
            faces), (head_s, head_a), (split_b, inv_d_k, tail_e))
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

    # -------------------------------------------------------- 7. service
    service, err = check_service(torch, on_path, det_one, imgs[0],
                                 flush["fused"]["ms_per_flush"], smi)
    if err:
        return fail(err)
    print(f"service phase: {service['seconds']:.1f} s")
    report["service"] = service

    # ---------------------------------------------------------- 8. fleet
    fleet, err = check_fleet(torch, on_path, det_one,
                             flush["fused"]["ms_per_flush"], smi)
    if err:
        return fail(err)
    print(f"fleet phase: {fleet['seconds']:.1f} s")
    report["fleet"] = fleet

    # ------------------------------------------------------- 9. training
    training, err = check_training(torch, on_path, smi)
    if err:
        return fail(err)
    print(f"training phase: {training['seconds']:.1f} s")
    report["training"] = training

    # ----------------------------------------------------- 10. LM serving
    carry: dict = {"lm": {}, "lm_train": {}}
    lm, err = check_lm(torch, on_path, smi, carry["lm"])
    if err:
        return fail(f"LM serving: {err}")
    print(f"LM serving phase: {lm['seconds']:.1f} s")
    report["lm"] = lm

    # --------------------------------------------------- 11. LM training
    lm_train, err = check_lm_train(torch, on_path, smi, carry["lm_train"])
    if err:
        return fail(f"LM training: {err}")
    print(f"LM training phase: {lm_train['seconds']:.1f} s")
    report["lm_train"] = lm_train

    # ----------------------------------------------- 12. the mesh path
    # one dict holds what phases 10 and 11 handed on, so what phase 12
    # pops is freed
    lm_mesh, err = check_lm_mesh(torch, on_path, smi, lm, lm_train,
                                 {**carry.pop("lm"), **carry.pop("lm_train")})
    del carry
    if err:
        return fail(f"mesh path: {err}")
    print(f"mesh phase: {lm_mesh['seconds']:.1f} s")
    report["lm_mesh"] = lm_mesh

    # ---------------------------------------------------- 13. the examples
    examples, err = check_examples(torch, on_path, smi)
    if err:
        return fail(f"examples: {err}")
    print(f"examples phase: {examples['seconds']:.1f} s")
    report["examples"] = examples

    # ---------------------------------------------- 14. the static checks
    analysis, err = check_analysis(on_path, smi)
    if err:
        return fail(f"static checks: {err}")
    print(f"static checks phase: {analysis['wall_s']:.1f} s")
    report["analysis"] = analysis

    # each kernel's launches are those of the first path that runs it: S, A,
    # C and E on the fused flush, B on the split flush, D on the kernel API
    launch_path = {split_b: "split", inv_d_k: "kernel_api", tail_e: "fused"}
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
    print(json.dumps({"service": service}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"training": training}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"lm_train": lm_train}))
    print(json.dumps({"lm_mesh": lm_mesh}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"analysis": analysis}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
