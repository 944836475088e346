#!/usr/bin/env python3
"""Where a flush of the port's main path spends its time, on one GPU.

    python3 scripts/port_profile.py [--flushes 3] [--head fused|split]
                                    [--calibrated] [--stream [FRAMES]]
                                    [--lm [STEPS]] [--train [STEPS]]
                                    [--mesh [STEPS]]

Builds the port's kernels, warms ``Detector.detect_batch`` (packed
strategy) on the main path's workload as ``chip_smoke.main_path_workload``
defines it (the paper-shaped 25-stage cascade, 8 seeded 480x640 scenes,
the engine config), then traces ``--flushes`` flushes
with ``torch.profiler`` and prints, per flush: the host wall time, the
summed device time of every kernel and copy (from the trace), the device
operations launched, the device's idle share (1 - device time / wall
time; device work does not overlap itself on one stream), and the
operations that took the most device time.  It then splits the flush into
its two halves (``Detector.batch_parts``: the per-level dense heads, then
the shared compactions and the packed tail) and gives each one's host wall
time, device time and device operations; the rest of the flush's wall
time is the host's packing, copies and decode.
``--calibrated`` profiles instead the calibrated detector of
``chip_smoke.py``'s phase 5 (``chip_smoke.calibrate_main_path``: measured
capacities, tail and head ladders; about a minute of racing first), whose
head mode its ladder picks.  Writes the same as JSON to
``chiprun_out/port_profile_<head or calibrated>.json``.

``--stream`` instead traces ``FRAMES`` (default 4) incremental frames of
``chip_smoke.py``'s phase-6 ``static_cctv`` stream
(``chip_smoke.stream_workload``: the same cascade at 480x640, the
device-state ``VideoDetector`` one frame at a time, after its keyframe
and first incremental frame): per frame the host wall time, the device
time by operation, the device operations, the idle share and the host's
decode and grouping of the survivors, then the device step of one of
those frames alone (``chip_smoke.stream_step_replay``).  Writes
``chiprun_out/port_profile_stream.json``.

``--lm`` instead traces LM serving as ``chip_smoke.py``'s phase 10 runs
it (``olmo-1b`` at full width in bf16, weights from seed 0, 8 seeded
prompts of 512 tokens): one prefill, then ``STEPS`` (default 8) greedy
decode steps, each: host wall time, device time by operation, device
operations and the idle share.  Before and after the traces it times
the same prefill and decode steps untraced (host clock around each call,
synchronised; the median): a process that has run ``torch.profiler``
may launch more slowly afterwards.  Writes
``chiprun_out/port_profile_lm.json``.

``--train`` instead traces LM training as ``chip_smoke.py``'s phase 11
runs it (``chip_smoke.lm_train_workload``: ``olmo-1b`` at full width,
bf16 params, float32 moments, remat ``"block"``, 8 x 2048 tokens a step
in microbatches of 4): after two warm-up steps, ``STEPS`` (default 1)
train steps untraced (host clock, synchronised), then traced: host wall
time, device time by operation, device operations and the idle share.
Writes ``chiprun_out/port_profile_train.json``.

``--mesh`` traces the same step both ways, one after the other in one
process: phase 11's one-device step, then ``chip_smoke.py``'s phase-12
step through the mesh path (``chip_smoke.lm_train_workload`` with
``make_rules`` of ``chip_smoke.one_rank_mesh``: DTensor parameters, ZeRO
and sequence parallelism on a one-rank NCCL mesh), each as ``--train``
traces it.  Writes ``chiprun_out/port_profile_mesh.json``.
Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flushes", type=int, default=3)
    ap.add_argument("--head", choices=("fused", "split"), default="fused")
    ap.add_argument("--calibrated", action="store_true")
    ap.add_argument("--stream", type=int, nargs="?", const=4, default=0,
                    metavar="FRAMES")
    ap.add_argument("--lm", type=int, nargs="?", const=8, default=0,
                    metavar="STEPS")
    ap.add_argument("--train", type=int, nargs="?", const=1, default=0,
                    metavar="STEPS")
    ap.add_argument("--mesh", type=int, nargs="?", const=1, default=0,
                    metavar="STEPS")
    args = ap.parse_args()
    sys.stdout.reconfigure(line_buffering=True)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import (calibrate_main_path, calibration_probe,
                            main_path_workload)
    from repro_torch.core import Detector
    from repro_torch.kernels import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    if args.lm:
        return profile_lm(torch, smi, args.lm)
    if args.train:
        return profile_train(torch, smi, args.train)
    if args.mesh:
        return profile_mesh(torch, smi, args.mesh)
    native.build_all()
    if args.stream:
        return profile_stream(torch, smi, args.stream)
    cascade, imgs, cfg = main_path_workload("cuda")
    det = Detector(cascade, cfg._replace(head_mode=args.head))
    label = args.head
    if args.calibrated:
        hp, wp = det._bucket_hw(*imgs[0].shape)
        head_fn, _tail_fn = det.batch_parts(hp, wp, len(imgs))
        counts = head_fn(*det._stack_to_device(
            *det._pack_stack(imgs, hp, wp)))[3]
        probe = calibration_probe(counts, det.batch_plan(hp, wp, len(imgs)))
        det = calibrate_main_path(Detector(cascade, cfg), imgs, probe)
        label = "calibrated"
        plan = det.batch_plan(hp, wp, len(imgs))
        print(f"calibrated on image {probe}: tail segments "
              f"{[seg.capacity for seg in plan.tail_segments]} lanes, head "
              f"modes {plan.head_modes}")
    for _ in range(2):
        det.detect_batch(imgs, group=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.flushes):
            det.detect_batch(imgs, group=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.flushes
    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the time of the kernels it launched
    events = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / args.flushes
    top = [{"name": e.key, "calls_per_flush": e.count / args.flushes,
            "device_ms_per_flush": e.self_device_time_total / 1e3
            / args.flushes} for e in events[:15]]
    ops_per_flush = sum(e.count for e in events) / args.flushes
    parts = halves(torch, det, imgs, args.flushes)
    out = {"card": smi, "head": label, "flushes": args.flushes,
           "wall_ms_per_flush": wall_ms,
           "device_ms_per_flush": device_ms,
           "device_ops_per_flush": ops_per_flush,
           "idle_share": 1.0 - device_ms / wall_ms, "halves": parts,
           "top": top}
    print(f"card: {smi}")
    print(f"{label}: wall {wall_ms:.2f} ms per flush, device "
          f"{device_ms:.2f} ms, {ops_per_flush:.0f} device operations, "
          f"idle share {out['idle_share']:.3f}")
    for name, p in parts.items():
        print(f"  {name}: wall {p['wall_ms']:.2f} ms, device "
              f"{p['device_ms']:.2f} ms, {p['device_ops']:.0f} device "
              f"operations")
    for t in top:
        print(f"  {t['device_ms_per_flush']:9.3f} ms  "
              f"{t['calls_per_flush']:7.1f} calls  {t['name'][:90]}")
    if not events:
        print("port_profile: the trace holds no device time",
              file=sys.stderr)
        return 1
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"port_profile_{label}.json").write_text(
        json.dumps(out, indent=1))
    return 0


def profile_stream(torch, smi: str, n_frames: int) -> int:
    """``--stream``: trace ``n_frames`` incremental frames of the phase-6
    ``static_cctv`` stream, then one of their device steps alone."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import (STREAM_DECODE_CAP, stream_step_replay,
                            stream_workload)
    from repro_torch.stream import VideoDetector
    first = 3              # after the keyframe and the first rung growth
    det, scfg, videos = stream_workload("cuda", n_frames=first + n_frames)
    frames = videos["static_cctv"]
    cfg = scfg._replace(device_state=True)
    vd = VideoDetector(det, cfg, decode_cap=STREAM_DECODE_CAP)
    for f in frames[:first]:
        vd.process(f)
    torch.cuda.synchronize()
    modes, decode = [], {"ms": 0.0, "slots": 0}
    real_decode = vd._decode_slots

    def timed_decode(slots):
        # the host half of commit_token: rects from the survivor slots and
        # their grouping (nms.group_rectangles)
        t = time.perf_counter()
        rects = real_decode(slots)
        decode["ms"] += (time.perf_counter() - t) * 1e3
        decode["slots"] += len(slots)
        return rects

    vd._decode_slots = timed_decode
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[first:]:
            modes.append(vd.process(f)[1].mode)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    events = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / n_frames
    top = [{"name": e.key, "calls_per_frame": e.count / n_frames,
            "device_ms_per_frame": e.self_device_time_total / 1e3
            / n_frames} for e in events[:15]]
    ops_per_frame = sum(e.count for e in events) / n_frames
    fn, i_step = stream_step_replay(
        VideoDetector(det, cfg, decode_cap=STREAM_DECODE_CAP), frames,
        first)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        fn()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / n_frames
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_frames):
            fn()
        torch.cuda.synchronize()
    step_events = device_events(prof)
    step = {"frame": i_step, "wall_ms": step_wall,
            "device_ms": sum(e.self_device_time_total for e in step_events)
            / 1e3 / n_frames,
            "device_ops": sum(e.count for e in step_events) / n_frames}
    out = {"card": smi, "scenario": "static_cctv", "frames": n_frames,
           "modes": modes, "wall_ms_per_frame": wall_ms,
           "device_ms_per_frame": device_ms,
           "device_ops_per_frame": ops_per_frame,
           "idle_share": 1.0 - device_ms / wall_ms, "step": step,
           "decode_ms_per_frame": decode["ms"] / n_frames,
           "survivors_per_frame": decode["slots"] / n_frames, "top": top}
    print(f"card: {smi}")
    print(f"stream static_cctv frames {first}..{first + n_frames - 1} "
          f"({modes}): wall {wall_ms:.2f} ms per frame, device "
          f"{device_ms:.3f} ms, {ops_per_frame:.0f} device operations, idle "
          f"share {out['idle_share']:.3f}")
    print(f"  host decode and grouping: {out['decode_ms_per_frame']:.2f} ms "
          f"per frame of {out['survivors_per_frame']:.0f} survivor windows")
    print(f"  step of frame {i_step} alone: wall {step['wall_ms']:.2f} ms, "
          f"device {step['device_ms']:.3f} ms, {step['device_ops']:.0f} "
          f"device operations")
    for t in top:
        print(f"  {t['device_ms_per_frame']:9.3f} ms  "
              f"{t['calls_per_frame']:7.1f} calls  {t['name'][:90]}")
    if not events:
        print("port_profile: the trace holds no device time",
              file=sys.stderr)
        return 1
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "port_profile_stream.json").write_text(json.dumps(out, indent=1))
    return 0


def profile_lm(torch, smi: str, n_steps: int) -> int:
    """``--lm``: trace one prefill and ``n_steps`` decode steps of phase
    10's LM serving."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import LM_ARCH, LM_BATCH, LM_PROMPT, lm_workload
    from repro_torch.serve import make_decode_step, make_prefill_step
    model, params, prompts = lm_workload(torch, "cuda")
    prefill, decode = make_prefill_step(model), make_decode_step(model)

    def prefill_once():
        return prefill(params, prompts, model.init_cache(
            LM_BATCH, LM_PROMPT + n_steps + 1))

    logits, cache = prefill_once()                  # warm-up
    tok, _, _ = decode(params, logits[:, -1].argmax(-1), cache)
    torch.cuda.synchronize()

    def untraced():
        """Median host ms of 3 prefills and of ``n_steps`` decode steps,
        each call synchronised."""
        def ms(fn):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, res
        state = {"c": cache, "t": tok}

        def step():
            state["t"], state["c"], _ = decode(params, state["t"],
                                               state["c"])
        return {"prefill_ms": statistics.median(
                    ms(prefill_once)[0] for _ in range(3)),
                "decode_step_ms": statistics.median(
                    ms(step)[0] for _ in range(n_steps))}

    out = {"card": smi, "arch": LM_ARCH, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "steps": n_steps,
           "untraced_before": untraced()}
    for label, reps, fn in (("prefill", 1, prefill_once),
                            ("decode_step", n_steps, None)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if fn is not None:
                fn()
            else:
                c, t = cache, tok
                for _ in range(reps):
                    t, c, _ = decode(params, t, c)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        events = device_events(prof)
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
            / reps
        ops = sum(e.count for e in events) / reps
        out[label] = {
            "wall_ms": wall_ms, "device_ms": device_ms, "device_ops": ops,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": [{"name": e.key, "calls": e.count / reps,
                     "device_ms": e.self_device_time_total / 1e3 / reps}
                    for e in events[:15]]}
        print(f"lm {label}: wall {wall_ms:.2f} ms, device {device_ms:.3f} "
              f"ms, {ops:.0f} device operations, idle share "
              f"{out[label]['idle_share']:.3f} [{smi}]")
        for t in out[label]["top"]:
            print(f"  {t['device_ms']:9.3f} ms  {t['calls']:7.1f} calls  "
                  f"{t['name'][:90]}")
        if not events:
            print("port_profile: the trace holds no device time",
                  file=sys.stderr)
            return 1
    out["untraced_after"] = untraced()
    for k in ("untraced_before", "untraced_after"):
        print(f"lm {k.replace('_', ' ')} the traces: prefill "
              f"{out[k]['prefill_ms']:.2f} ms, decode step "
              f"{out[k]['decode_step_ms']:.2f} ms [{smi}]")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "port_profile_lm.json").write_text(json.dumps(out, indent=1))
    return 0


def profile_train(torch, smi: str, n_steps: int) -> int:
    """``--train``: trace ``n_steps`` train steps of phase 11's LM
    training."""
    out = train_trace(torch, smi, n_steps)
    if out is None:
        return 1
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "port_profile_train.json").write_text(json.dumps(out, indent=1))
    return 0


def profile_mesh(torch, smi: str, n_steps: int) -> int:
    """``--mesh``: phase 11's step, then phase 12's mesh step, traced."""
    from chip_smoke import one_rank_mesh
    from repro_torch.distributed.sharding import make_rules
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # as phases 11, 12
    try:
        one = train_trace(torch, smi, n_steps)
        torch.cuda.empty_cache()
        with one_rank_mesh(torch) as mesh:
            mesh_out = train_trace(torch, smi, n_steps, make_rules(mesh))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if one is None or mesh_out is None:
        return 1
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "port_profile_mesh.json").write_text(json.dumps(
        {"one_device": one, "mesh": mesh_out}, indent=1))
    return 0


def train_trace(torch, smi: str, n_steps: int, rules=None) -> dict | None:
    """Trace ``n_steps`` steps of phase 11's training (through the mesh
    path with ``rules``) after two warm-up steps and as many untraced;
    prints and returns the report (None when the trace holds no device
    time)."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import (LM_ARCH, LM_TRAIN_BATCH, LM_TRAIN_MICRO,
                            LM_TRAIN_SEQ, lm_train_workload)
    model, state, batch_at, step = lm_train_workload(torch, "cuda",
                                                     rules=rules)
    label = "one device" if rules is None else "mesh (1 x 1, NCCL)"
    for i in range(2):                                   # warm-up
        state, _ = step(state, batch_at(i))
    batches = [batch_at(2 + i) for i in range(n_steps)]
    torch.cuda.synchronize()
    walls, cpus = [], []
    for b in batches:
        t0, c0 = time.perf_counter(), time.process_time()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        cpus.append((time.process_time() - c0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    events = device_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 \
        / n_steps
    out = {"card": smi, "arch": LM_ARCH, "path": label,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "microbatch": LM_TRAIN_MICRO, "remat": model.cfg.remat,
           "steps": n_steps, "untraced_wall_ms": walls,
           "untraced_host_cpu_ms": cpus, "wall_ms": wall_ms,
           "device_ms": device_ms,
           "device_ops": sum(e.count for e in events) / n_steps,
           "idle_share": 1.0 - device_ms / wall_ms,
           "untraced_idle_share": 1.0 - device_ms / statistics.median(walls),
           "by_category": by_category(events, n_steps),
           "top": [{"name": e.key, "calls": e.count / n_steps,
                    "device_ms": e.self_device_time_total / 1e3 / n_steps}
                   for e in events[:25]]}
    print(f"train step, {label} ({LM_ARCH}, {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}, microbatch {LM_TRAIN_MICRO}, remat "
          f"{model.cfg.remat}): wall {wall_ms:.1f} ms (untraced "
          f"{[round(w, 1) for w in walls]}, host CPU "
          f"{[round(c, 1) for c in cpus]}), device {device_ms:.1f} ms, "
          f"{out['device_ops']:.0f} device operations, idle share "
          f"{out['idle_share']:.3f} (untraced "
          f"{out['untraced_idle_share']:.3f}) [{smi}]")
    for name, c in out["by_category"].items():
        print(f"  {name}: {c['device_ms']:.1f} ms in {c['calls']:.0f} "
              f"calls")
    for t in out["top"]:
        print(f"  {t['device_ms']:9.3f} ms  {t['calls']:7.1f} calls  "
              f"{t['name'][:90]}")
    if not events:
        print("port_profile: the trace holds no device time",
              file=sys.stderr)
        return None
    return out


# device operations by kernel name, first match wins: cuBLAS / CUTLASS
# float32 GEMMs (SIMT ``sgemm``, ``f32f32`` xmma), the Hopper ``nvjet``
# GEMMs (bf16 here: float32 GEMMs take the SIMT kernels with TF32 off),
# copies and dtype casts, reductions, other elementwise kernels
CATEGORIES = (("float32 GEMM", ("sgemm", "f32f32_f32")),
              ("bf16 GEMM", ("nvjet", "gemm")),
              ("copies and casts", ("copy",)),
              ("reductions", ("reduce_kernel",)),
              ("elementwise", ("elementwise",)))


def by_category(events, n: int) -> dict:
    """Device ms and calls per ``CATEGORIES`` entry (and "other"), each
    over ``n`` steps."""
    out = {name: {"device_ms": 0.0, "calls": 0.0}
           for name in [c[0] for c in CATEGORIES] + ["other"]}
    for e in events:
        name = next((c for c, keys in CATEGORIES
                     if any(k in e.key for k in keys)), "other")
        out[name]["device_ms"] += e.self_device_time_total / 1e3 / n
        out[name]["calls"] += e.count / n
    return out


def device_events(prof) -> list:
    """The trace's device-side events (kernels, copies), most device time
    first: a CPU op's entry repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    return events


def halves(torch, det, imgs, reps: int) -> dict:
    """Host wall ms (clock around ``reps`` calls, device drained before
    and after), device ms and device operations per call of the flush's
    head half and tail half, each run alone on the flush's input."""
    from torch.profiler import ProfilerActivity, profile
    hp, wp = det._bucket_hw(*imgs[0].shape)
    head_fn, tail_fn = det.batch_parts(hp, wp, len(imgs))
    flush_in = det._stack_to_device(*det._pack_stack(imgs, hp, wp))
    head_out = head_fn(*flush_in)
    out = {}
    for name, fn in (("head", lambda: head_fn(*flush_in)),
                     ("tail", lambda: tail_fn(*head_out))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        out[name] = {
            "wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in events)
            / 1e3 / reps,
            "device_ops": sum(e.count for e in events) / reps}
    return out


if __name__ == "__main__":
    sys.exit(main())
