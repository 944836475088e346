"""Multi-pod dry-run on a fake process group.

For every (architecture x input shape x mesh): build the step function
and its fake DTensor inputs (``launch/cells.py``), run one step on those
fake tensors (``FakeTensorMode``: shapes only, nothing allocated) on the
production mesh over a fake world of 256 or 512 ranks, and record per
device the argument bytes (this rank's shards of the inputs), the
tracked peak, the FLOPs and the bytes accessed (``roofline.LocalCost``:
inputs plus every tensor the step's local operations hold at once; each
local operation's FLOPs and its operands' and outputs' bytes), the
collective footprint (``roofline.CollectiveCounter``) and the roofline
terms at H100 constants.  The step donates what the reference's dry run
donates to its jitted step: the train state, or the serving cache
(``build_cell`` builds it with ``donate=True``), so a buffer written in
place is counted once.  A cell failing here is a bug in the distribution
config.

The fake world starts when this module is imported, before anything
else: it is a script entry point only, never imported by library or
test code (the reference sets its host device count the same way).

It has no device option: its tensors are fake and allocate nothing, so
it runs on no device; its mesh takes the host's device type (``cpu``),
and its numbers are the same on any machine.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out r.json]
"""

import sys

import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore


def _fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks (this process is rank 0)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


_fake_world(512 if "--multi-pod" in sys.argv else 256)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import SHAPES, list_archs  # noqa: E402
from repro_torch.distributed.sharding import local_bytes  # noqa: E402
from repro_torch.launch.cells import build_cell, cell_applicable  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     mesh_chips)
from repro_torch.launch.roofline import (CollectiveCounter,  # noqa: E402
                                         LocalCost, roofline_from_trace)
from repro_torch.tree import tree_leaves  # noqa: E402

__all__ = ["run_cell", "main"]

def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             fsdp: bool = True, verbose: bool = True) -> dict:
    """One cell's step traced on the fake world."""
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        fn, inputs = build_cell(arch, shape, mesh, fsdp=fsdp)
    arg_bytes = local_bytes(inputs)
    # the step runs outside the fake mode: its fake inputs carry it, so
    # DTensor's sharding propagation runs in a fake mode of its own, which
    # LocalCost leaves out; the few small tensors the step makes from
    # nothing (positions, zero scalars) are real
    mem = LocalCost(fake, [t.to_local() if isinstance(t, DTensor) else t
                           for t in tree_leaves(list(inputs.values()))])
    counter = CollectiveCounter()
    with mem, counter:
        out = fn(**inputs)
    del out
    t_trace = time.time() - t0
    peak = mem.peak
    coll = counter.result()
    roof = roofline_from_trace(arch, shape, mesh_chips(mesh), coll, mem)
    result = {
        "arch": arch, "shape": shape,
        "mesh": "pod2x16x16" if multi_pod else "16x16",
        "chips": mesh_chips(mesh),
        "ok": True,
        "t_trace_s": round(t_trace, 1),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "peak_memory_in_bytes": peak,
                   "temp_size_in_bytes": peak - arg_bytes,
                   # args live in HBM beside temps: the fit criterion
                   "bytes_per_device": peak},
        # XLA's per-device cost analysis, counted on the local operations
        # (roofline.LocalCost: unfused, every loop iteration counted)
        "flops": float(mem.flops),
        "bytes_accessed": float(mem.bytes_accessed),
        "collective_bytes": coll["total_bytes"],
        "collective_ops": coll["per_kind"],
        "roofline": roof,
    }
    if verbose:
        print(f"[{result['mesh']}] {arch} x {shape}: trace {t_trace:.0f}s  "
              f"args/device {arg_bytes / 2**30:.2f} GiB  peak/device "
              f"{peak / 2**30:.2f} GiB  flops/device {mem.flops:.4g}  "
              f"bytes accessed/device {mem.bytes_accessed:.4g}  coll "
              f"{coll['total_bytes'] / 2**30:.2f} GiB", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                if cell_applicable(arch, shape):
                    cells.append((arch, shape))
    elif not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    else:
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    results = []
    for mp in meshes:
        for arch, shape in cells:
            try:
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        fsdp=not args.no_fsdp))
            except Exception as e:                      # noqa: BLE001
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "pod2x16x16" if mp else "16x16",
                                "ok": False, "error": f"{type(e).__name__}:"
                                f" {e}"})
                print(f"FAILED {arch} x {shape}", flush=True)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells passed")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
