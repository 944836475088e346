#!/usr/bin/env python3
"""The control of the comparison, on the card at a cell's own size.

    python3 cascade_bench/control.py --workload <cell> --seeds <n> ...

For each seed it renders the cell's scene pool as a run does and puts the
plain reference, computed in bfloat16 (the precision below the float32
the configuration states: SAT lookups, 1/sigma, features, votes and sums),
in the program's place: its rects are compared with the float32
reference's, each scene once, as ``check.compare`` compares a run's
answers.  The comparison has to fail on every seed; the smallest reading
is the upper reading of ``rect_mismatch``'s limit.  Beside it, the
float32 reference with every stage in the tail's corner and scale order
(``order_swap_mismatch``) shows how many rects an order change alone
moves.  The benchmark's own runs never run this.  Prints one JSON line
per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, bench: dict, workload: str, seed: int, device,
             dtype) -> dict:
    """``rect_mismatch`` of the reference in ``dtype`` against the float32
    reference over one seed's pool, with the rect counts."""
    import torch
    from cascade_bench import bench as benchlib
    from cascade_bench import check, program
    from cascade_bench import traffic as trafficlib
    cell = benchlib.cell(bench, root, workload)
    cfg = cell["config"]
    ref = benchlib.reference(root, cfg["reference"])
    arrays = program.cascade_arrays(cfg, cell["config_dir"])
    scenes = [img for _g, _i, img in trafficlib.pool(cell["traffic"], seed)]
    t = time.perf_counter()
    want = ref.detect(scenes, arrays, cfg["engine"], device)
    got = ref.detect(scenes, arrays, cfg["engine"], device, dtype=dtype)
    swapped = ref.detect(scenes, arrays, dict(cfg["engine"], use_pallas=False),
                         device)
    ids = list(range(len(scenes)))
    values = check.compare([(ids, [g["rects"] for g in got])],
                           [w["rects"] for w in want])
    swap = check.compare([(ids, [g["rects"] for g in swapped])],
                         [w["rects"] for w in want])
    return dict(workload=workload, seed=seed, dtype=str(dtype).split(".")[-1],
                rects_reference=sum(len(w["rects"]) for w in want),
                rects_control=sum(len(g["rects"]) for g in got),
                band_evals=sum(w["band_evals"] for w in want),
                band_rects=sum(len(w["band_rects"]) for w in want),
                order_swap_mismatch=swap["rect_mismatch"],
                seconds=time.perf_counter() - t, **values,
                correct=check.passed(values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    from cascade_bench import bench as benchlib
    bench = benchlib.load(ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, bench, args.workload, seed,
                                  torch.device("cuda"), torch.bfloat16)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
