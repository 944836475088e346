#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 cascade_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (it exits with code 2 and prints no result without them; it never
falls back to the CPU).  The cell, its configuration, its traffic mix and
its metrics are found by name from ``BENCHMARK.json`` (see
``cascade_bench/bench.py``).  The run:

1. set-up: builds the port's kernels (only the first run in a checkout
   compiles; the libraries stay in ``build/``), makes the cascade arrays,
   renders the traffic's scene pool from ``--seed``, builds the port's
   ``Detector`` and warms it with two flushes, which build every plan the
   traffic uses;
2. the window: a closed loop of ``detect_batch(images, group=False)``
   flushes for ``--seconds`` (the last one finishes), timed by the host
   clock, the card's energy counter read at both ends; with ``--trace 1``
   the window's first ``tracing.TRACE_S`` seconds run under
   ``torch.profiler`` with the benchmark's spans;
3. the check: the device's memory peak is read, the program freed, and
   the plain reference (``reference/<name>.py``) detects every scene of
   the pool; every answer of the window is compared with it
   (``check.py``);
4. the result: earlier lines say what ran (card, power limit, set-up
   parts, launches per flush); the last lines on standard error give each
   number compared beside its limit, and the last line on standard output
   is one JSON object (``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
   ``checks`` last).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import resource
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_FLUSHES = 2


def _paths(root: Path) -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, in clock ticks)."""
    stat = Path("/proc/self/stat").read_text()
    start = int(stat[stat.rindex(")") + 2:].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, compared whole,
    is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, flush=True)


def run_cell(root: Path, bench: dict, workload: str, seed: int,
             seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of one cell; returns the result object (without printing).
    ``device`` is a seam for the CPU tests, which run the whole of a run
    on the port's CPU path; the command always runs on the card."""
    import numpy as np
    import torch
    from cascade_bench import bench as benchlib
    from cascade_bench import check, counts, program, tracing
    from cascade_bench import traffic as trafficlib

    cell = benchlib.cell(bench, root, workload)
    cfg, trf = cell["config"], cell["traffic"]
    dev = torch.device(device)
    ref = benchlib.reference(root, cfg["reference"])
    readers = {m["name"]: benchlib.metric_reader(root, m["name"])
               for m in (cell["per_layer"] if trace else cell["end_to_end"])}

    t = time.perf_counter()
    built = program.build_kernels(dev)
    parts = {"kernels_s": time.perf_counter() - t,
             "kernels_built": len(built["built"])}
    t = time.perf_counter()
    arrays = program.cascade_arrays(cfg, cell["config_dir"])
    scenes = [img for _g, _i, img in trafficlib.pool(trf, seed)]
    sched = trafficlib.schedule(trf, seed)
    parts["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    det = program.detector(arrays, cfg["engine"], dev)
    for k in range(WARM_FLUSHES):
        program.flush(det, [scenes[i] for i in sched[k]])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["warm_s"] = time.perf_counter() - t

    card = name = None
    if dev.type == "cuda":
        from cascade_bench.energy import Card, NvmlError
        name = torch.cuda.get_device_name(dev)
        try:
            card = Card(torch.cuda.get_device_properties(dev))
            log(f"card: {name}, power limit {card.power_limit_w()} W "
                f"(NVML, PCI {card.bus_id})")
        except NvmlError as e:
            log(f"card: {name}; energy counter not readable: {e}")
        program.reset_launches()
    halves = tracing.Halves(det, torch) if trace else None
    setup_s = process_age_s()
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in parts.items()))

    answers, flush_s, done = [], [], []
    attempted = failed = traced_flushes = 0
    traced = tracing.Profile(torch) if trace else None
    e0 = card.energy_j() if card else None
    if traced:
        traced.start()
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        ids = sched[(k + WARM_FLUSHES) % len(sched)]
        imgs = [scenes[i] for i in ids]
        attempted += len(ids)
        a = time.perf_counter()
        try:
            with traced.span("flush") if traced else contextlib.nullcontext():
                out = program.flush(det, imgs)
        except RuntimeError as e:
            log(f"flush {k} failed: {e}")
            out = None
            failed += len(ids)
        flush_s.append(time.perf_counter() - a)
        done.append(0 if out is None else len(ids))
        answers.append((ids, out))
        k += 1
        if traced and traced.open and \
                time.perf_counter() - t0 >= tracing.TRACE_S:
            traced.stop()
            traced_flushes = k
    t1 = time.perf_counter()
    e1 = card.energy_j() if card else None
    if traced and traced.open:
        traced.stop()
        traced_flushes = k
    ms = np.asarray(flush_s) * 1e3
    half = max(len(ms) // 2, 1)
    log(f"{len(ms)} flushes, ms: min {ms.min():.3f} median "
        f"{np.median(ms):.3f} mean {ms.mean():.3f} max {ms.max():.3f}; mean "
        f"of the first half {ms[:half].mean():.3f}, of the rest "
        f"{ms[half:].mean() if len(ms) > 1 else ms[0]:.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {n: c / len(flush_s)
                    for n, c in program.launches().items() if c}
        log("launches per flush: " + json.dumps(launches))
    else:
        peak = 0
    halves_s = halves.elapsed_s() if halves else {}
    del det, halves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = None
    if traced:
        from torch.autograd import DeviceType
        t = time.perf_counter()
        summary = tracing.summarize(*tracing.events(traced.prof,
                                                    DeviceType.CPU))
        log(f"trace of {len(summary.flushes)} flushes read in "
            f"{time.perf_counter() - t:.3f} s")
        del traced
    t = time.perf_counter()
    expected = ref.detect(scenes, arrays, cfg["engine"], dev)
    values = check.compare(answers, [r["rects"] for r in expected])
    log(f"reference and comparison {time.perf_counter() - t:.3f} s over "
        f"{len(scenes)} scenes, {len(answers)} flushes; host peak "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    log("reference over the pool: windows entering each stage "
        f"{sum(r['entering'] for r in expected).tolist()}, rects "
        f"{sum(r['accepted'] for r in expected)}; in the rounding band: "
        f"{sum(r['band_evals'] for r in expected)} stage evaluations, "
        f"{sum(len(r['band_rects']) for r in expected)} rects")
    if card:
        card.close()

    ops = counts.stage_ops(arrays)
    n_dense = ref.dense_prefix(cfg["engine"], len(ops))
    per_image = [counts.image_work(r, ops, n_dense) for r in expected]
    work = [{key: sum(per_image[i][key] for i in ids)
             for key in per_image[0]} for ids, _ in answers]
    peaks = json.loads((root / benchlib.FOLDER / "peaks.json").read_text()
                       ).get(name)
    run = SimpleNamespace(
        setup_s=setup_s, window_s=t1 - t0, flush_s=flush_s, images=done,
        energy_j=None if e0 is None else e1 - e0, trace=summary,
        halves_s=halves_s, work=work, peaks=peaks,
        traced_flushes=traced_flushes)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = readers[m["name"]](run)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {
        "correct": failed == 0 and check.passed(values),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": name, "count": cell["workload"]["chips"],
                   "memory_peak_bytes": int(peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s,
                                window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = check.report(values)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)
    _paths(ROOT)
    from cascade_bench import bench as benchlib
    bench = benchlib.load(ROOT)
    chips = benchlib.cell(bench, ROOT, args.workload)["workload"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 1
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
