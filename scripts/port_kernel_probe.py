#!/usr/bin/env python3
"""Kernels S, C, A and B of the port at shapes beside the main path's, on
one GPU: what their designs trade, as device time (``torch.profiler``).

    python3 scripts/port_kernel_probe.py [--only sat packed race dense]

- S (``integral_image.sat_tables``) at shapes that separate its two serial
  chains: one strip (the column chain over 32-row chunks), one chunk (the
  hand-offs across 32-column strips), and the main path's 8 x 480x640;
  each checked bit for bit against the CPU plain version.
- C (``packed_window.stage_sums``) on the main path's first tail segment
  (``chip_smoke.main_path_workload``), with the engine's live count and over
  all lanes, in each lane block of ``autotune.LANE_BLOCK_CANDIDATES`` and
  ``EXTRA_BLOCKS``; each checked bit for bit against the default block.
- ``autotune.measure_lane_block`` at 2048, 16384 and 131072 lanes (whole
  cascade): how a block of r x c lanes fares on short lists.
- A (``fused_head.tile_pass``, the dense prefix) and B
  (``haar_stage.stage_sums``, each dense stage) at every pyramid level of
  the main path's flush, in each head tile of
  ``autotune.HEAD_TILE_CANDIDATES``: level 0 and the sum over the flush's
  levels, each checked bit for bit against the default tile.

Prints the card's name and power limit and writes the same as JSON to
``chiprun_out/port_kernel_probe.json``.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
S_SHAPES = ((1, 1, 1), (1, 32, 32), (1, 32, 64), (1, 32, 640), (1, 480, 32),
            (1, 480, 640), (8, 26, 35), (8, 480, 640))
EXTRA_BLOCKS = ((4, 256), (2, 256), (1, 128))   # beside the candidates
RACE_SIZES = (2048, 16384, 131072)
PARTS = ("sat", "packed", "race", "dense")


def probe_dense(torch, cs, cascade, plan, stack, n_dense: int) -> list:
    """A and B per head tile at every level of the flush (see the module's
    docstring)."""
    from repro_torch.core.pyramid import downscale_indices
    from repro_torch.kernels import autotune, fused_head, haar_stage
    from repro_torch.kernels import integral_image
    dev = stack.device
    levels = []
    for lp in plan.levels:
        ys = torch.as_tensor(downscale_indices(plan.hp, lp.height), device=dev)
        xs = torch.as_tensor(downscale_indices(plan.wp, lp.width), device=dev)
        levels.append(integral_image.sat_tables(
            stack[:, ys[:, None], xs[None, :]].contiguous()))
    want = fused_head.tile_pass(cascade, 0, n_dense, *levels[0])
    rows = []
    for tile in autotune.HEAD_TILE_CANDIDATES:
        shape = haar_stage.head_block_shape(tile)
        got = fused_head.tile_pass(cascade, 0, n_dense, *levels[0], tile=tile)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        equal = equal and all(torch.equal(haar_stage.stage_sums(
            cascade, s, levels[0][0], want[0], tile=tile), want[1][:, s])
            for s in range(n_dense))
        a_ms, b_ms = [], []
        for t in levels:
            a_ms.append(cs.profiled_ms(
                torch, lambda t=t: fused_head.tile_pass(
                    cascade, 0, n_dense, *t, tile=tile), 5, "fused_tiles"))
            inv = fused_head.tile_pass(cascade, 0, 1, *t)[0]
            b_ms.append([cs.profiled_ms(
                torch, lambda t=t, s=s, inv=inv: haar_stage.stage_sums(
                    cascade, s, t[0], inv, tile=tile), 5, "stage_sums")
                for s in range(n_dense)])
        row = {"tile": tile, "block": shape, "equal": equal,
               "a_level0_ms": a_ms[0], "a_flush_ms": sum(a_ms),
               "b_level0_stage2_ms": b_ms[0][2],
               "b_flush_ms": sum(map(sum, b_ms)),
               "a_ms_per_level": a_ms, "b_ms_per_level": b_ms}
        rows.append(row)
        print(f"A/B {tile} block {shape}: A level 0 {a_ms[0]:.4f} ms, "
              f"flush {sum(a_ms):.4f} ms; B level 0 stage 2 "
              f"{b_ms[0][2]:.4f} ms, flush {row['b_flush_ms']:.4f} ms; "
              f"== default {equal}")
    return rows


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    parts = ap.parse_args().only
    sys.stdout.reconfigure(line_buffering=True)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("port_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core import Detector
    from repro_torch.core.engine import nonzero_static
    from repro_torch.kernels import autotune, integral_image, native
    from repro_torch.kernels import packed_window

    smi = cs.nvidia_smi()
    print(f"card: {smi}")
    native.build_all()
    dev = torch.device("cuda")
    out: dict = {"card": smi, "sat": [], "packed": [], "race": [],
                 "dense": []}

    rng = np.random.default_rng(cs.SEED)
    for shape in S_SHAPES if "sat" in parts else ():
        x = torch.from_numpy((rng.random(shape) * 255.0).astype(np.float32))
        got = integral_image.sat_tables(x.to(dev))
        equal = all(torch.equal(a.cpu(), b) for a, b in
                    zip(got, integral_image.sat_tables_plain(x)))
        xd = x.to(dev)
        ms = cs.profiled_ms(torch, lambda: integral_image.sat_tables(xd), 20,
                            "sat_chained")
        out["sat"].append({"shape": shape, "equal_cpu": equal, "ms": ms})
        print(f"S {shape}: {ms:.4f} ms, == CPU {equal}")

    cascade, imgs, cfg = cs.main_path_workload(dev)
    det = Detector(cascade, cfg)
    hp, wp = det._bucket_hw(cs.H, cs.W)
    plan = det.batch_plan(hp, wp, cs.BATCH)
    if "dense" in parts:
        stack = torch.from_numpy(np.stack(imgs)).to(dev)
        out["dense"] = probe_dense(torch, cs, cascade, plan, stack,
                                   plan.dense_prefix)
    head_fn, _tail_fn = det.batch_parts(hp, wp, cs.BATCH)
    alive_flat, inv_flat, ii_flat, _counts = head_fn(
        *det._stack_to_device(*det._pack_stack(imgs, hp, wp)))
    seg = plan.tail_segments[0]
    idx, cnt = nonzero_static(alive_flat, seg.capacity)
    sel = idx.clamp(min=0)
    lay = plan.layout
    slot = (sel % plan.n_slots).cpu().numpy()
    lvl = lay.lvl_of_slot[slot]

    def lane(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    args = (cascade, seg.s0, seg.s1, ii_flat,
            lane((sel // plan.n_slots).cpu().numpy()),
            lane(lay.sat_base_of_lvl[lvl]), lane(lay.sat_stride_of_lvl[lvl]),
            lane(lay.y_of_slot[slot]), lane(lay.x_of_slot[slot]),
            inv_flat[sel].contiguous())
    n_live = cnt.clamp(max=seg.capacity)
    want = packed_window.stage_sums(*args, n_live=n_live)
    print(f"C list: {seg.capacity} lanes, {int(n_live)} live")
    for block in (autotune.LANE_BLOCK_CANDIDATES + EXTRA_BLOCKS
                  if "packed" in parts else ()):
        equal = torch.equal(packed_window.stage_sums(
            *args, n_live=n_live, lane_block=block), want)
        live = cs.profiled_ms(torch, lambda: packed_window.stage_sums(
            *args, n_live=n_live, lane_block=block), 10, "packed_sums")
        full = cs.profiled_ms(torch, lambda: packed_window.stage_sums(
            *args, lane_block=block), 3, "packed_sums")
        out["packed"].append({"lane_block": block, "equal": equal,
                              "live_ms": live, "all_ms": full})
        print(f"C {block}: live {live:.4f} ms, all {full:.4f} ms "
              f"(x{full / live:.2f}), == default block {equal}")

    cands = autotune.LANE_BLOCK_CANDIDATES + ((1, 256),)
    for size in RACE_SIZES if "race" in parts else ():
        r = autotune.measure_lane_block(cascade, size=size, candidates=cands)
        out["race"].append({"size": size, "candidates": r["candidates"],
                            "ms": r["ms"]})
        print(f"lane-block race at {size} lanes: "
              f"{[(c, round(m, 3)) for c, m in zip(r['candidates'], r['ms'])]}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "port_kernel_probe.json").write_text(json.dumps(out, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
