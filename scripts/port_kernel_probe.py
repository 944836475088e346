#!/usr/bin/env python3
"""Kernel S and kernel C of the port at shapes beside the main path's, on
one GPU: what their designs trade, as device time (``torch.profiler``).

    python3 scripts/port_kernel_probe.py

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


def main() -> int:
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
    out: dict = {"card": smi, "sat": [], "packed": [], "race": []}

    rng = np.random.default_rng(cs.SEED)
    for shape in S_SHAPES:
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
    for block in autotune.LANE_BLOCK_CANDIDATES + EXTRA_BLOCKS:
        equal = torch.equal(packed_window.stage_sums(
            *args, n_live=n_live, lane_block=block), want)
        live = cs.profiled_ms(torch, lambda: packed_window.stage_sums(
            *args, n_live=n_live, lane_block=block), 10)
        full = cs.profiled_ms(torch, lambda: packed_window.stage_sums(
            *args, lane_block=block), 3)
        out["packed"].append({"lane_block": block, "equal": equal,
                              "live_ms": live, "all_ms": full})
        print(f"C {block}: live {live:.4f} ms, all {full:.4f} ms "
              f"(x{full / live:.2f}), == default block {equal}")

    cands = autotune.LANE_BLOCK_CANDIDATES + ((1, 256),)
    for size in RACE_SIZES:
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
