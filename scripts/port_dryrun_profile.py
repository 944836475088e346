"""Where the dry run's host time goes, for one cell.

    PYTHONPATH=src python scripts/port_dryrun_profile.py --arch deepseek-v2-236b --shape train_4k [--cprofile OUT.prof]
    PYTHONPATH=src python scripts/port_dryrun_profile.py --stats OUT.prof

Runs ``repro_torch.launch.dryrun.run_cell`` once (a fake world of 256
ranks) with its ``roofline.LocalCost`` timed: the seconds inside each
local operation's own implementation, split by whose tensors it makes:
the step's local shards (the dry run's fake mode), DTensor's sharding
propagation (fake tensors of another mode), real host tensors; the rest
of the trace is DTensor's dispatch, the autograd engine and the port's
own Python.  With ``--cprofile`` the same run goes under ``cProfile``
and the script also prints self time by file, each builtin's charged to
its callers: fake tensor and meta code, DTensor's Python, the port's
Python, the rest.  ``cProfile`` slows the Python it sees, so its
seconds are larger than the timed run's.  ``--stats`` prints that split
for a profile written before (``python -m cProfile -o OUT.prof -m
repro_torch.launch.dryrun ...`` also writes one).
"""

import argparse
import collections
import cProfile
import json
import pstats
import sys
import time

from repro_torch.launch import dryrun
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
import torch.utils._pytree as pytree


class TimedCost(dryrun.LocalCost):
    """``LocalCost`` that also times each operation's implementation by
    the kind of tensors it makes."""

    seconds: collections.Counter = collections.Counter()
    ops: collections.Counter = collections.Counter()
    by_op: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        dt = time.perf_counter() - t0
        kind = "other"
        for t in pytree.tree_leaves(out):
            if isinstance(t, FakeTensor):
                kind = ("step" if t.fake_mode is self.fake_mode
                        else "propagation")
                break
            if hasattr(t, "device") and t.device.type != "meta":
                kind = "real"
                break
        TimedCost.seconds[kind] += dt
        TimedCost.ops[kind] += 1
        TimedCost.by_op[f"{kind} {func}"] += dt
        return self.count(func, args, kwargs, out)


def _category(fn: str):
    if any(k in fn for k in ("_subclasses", "_prims", "_decomp", "_refs",
                             "_meta_registrations", "meta_utils")):
        return "fake tensor and meta code"
    if "distributed/tensor" in fn:
        return "DTensor Python"
    if "repro_torch" in fn or "scripts/" in fn:
        return "the port's Python"
    if fn == "~":
        return None                  # builtins: charged to their callers
    return "the rest"


def self_time(path: str) -> dict:
    """Self seconds by ``_category``, each builtin's split over its callers
    by the time they spent in it."""
    st = pstats.Stats(path)
    out = collections.Counter()
    for key, (_, _, tt, _, callers) in st.stats.items():
        cat = _category(key[0])
        if cat is not None:
            out[cat] += tt
            continue
        total = sum(v[2] for v in callers.values()) or 1.0
        for ck, v in callers.items():
            out[_category(ck[0]) or "builtins"] += tt * v[2] / total
    return dict(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--cprofile", default=None)
    ap.add_argument("--stats", default=None)
    args = ap.parse_args()
    if args.stats:
        print(json.dumps(self_time(args.stats), indent=1))
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --stats")
    dryrun.LocalCost = TimedCost
    prof = cProfile.Profile() if args.cprofile else None
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    cell = dryrun.run_cell(args.arch, args.shape)
    if prof:
        prof.disable()
        prof.dump_stats(args.cprofile)
    wall = time.perf_counter() - t0
    inside = sum(TimedCost.seconds.values())
    report = {"arch": args.arch, "shape": args.shape, "wall_s": wall,
              "t_trace_s": cell["t_trace_s"],
              "inside_operations_s": dict(TimedCost.seconds),
              "operations": dict(TimedCost.ops),
              "slowest_operations_s": dict(TimedCost.by_op.most_common(12)),
              "outside_operations_s": wall - inside,
              "peak": cell["memory"]["peak_memory_in_bytes"],
              "flops": cell["flops"],
              "bytes_accessed": cell["bytes_accessed"],
              "collective_bytes": cell["collective_bytes"]}
    if prof:
        report["cprofile_self_s"] = self_time(args.cprofile)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    sys.exit(main())
