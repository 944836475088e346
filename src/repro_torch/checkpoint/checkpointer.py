"""Atomic checkpointing in the reference's layout.

Layout: ``<dir>/step_<k:010d>/`` holding one ``leaf_<i>.npy`` per tree
leaf plus ``manifest.json`` (structure, shapes, dtypes, user metadata).
Writes go to ``step_<k>.tmp`` and are renamed only after
``manifest.json`` lands, so a preempted writer never corrupts the latest
complete checkpoint; the newest ``keep`` are kept.

Leaves are numbered in the reference's flatten order (``jax.tree``'s):
dict keys sorted, lists and tuples in order, NamedTuple fields in order,
``None`` holding no leaf.  A ``TrainState`` written by either package
restores in the other.

bfloat16 leaves are written as their bits: two-byte void records, as
``np.save`` writes the reference's ``ml_dtypes.bfloat16`` arrays, with
``"bfloat16"`` in the manifest.  On restore both packages' files are read
by viewing the bits as int16, then as ``torch.bfloat16``.  (The
reference's own restore cannot cast such a file and raises.)  A float32
leaf restored into a bf16 template rounds to nearest even, as the
reference's cast does.

Elasticity: leaves are saved whole and placed on load, so a checkpoint
written on one mesh restores onto another.  A DTensor leaf is never
gathered: rank 0 lays out each leaf's file, every rank writes its own
shard into its place in the file (one rank per set of replicas), and
all meet at barriers before rank 0 publishes.  ``restore_checkpoint(...,
shardings=)`` gives each leaf its ``(mesh, placements)``: each rank reads
only its own shard of the file (a memory map).  So no rank holds a whole
leaf, on the card or the host; the ranks share the checkpoint's file
system.
"""

from __future__ import annotations

import json
import math
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..device import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_MANIFEST = "manifest.json"


def _children(tree) -> list | None:
    """A node's children in flatten order; None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if tree is None:
        return []
    return None


def _flatten(tree) -> list:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for k in kids for leaf in _flatten(k)]


def _describe(tree) -> str:
    """The structure with '*' at the leaves (recorded, never parsed)."""
    kids = _children(tree)
    if kids is None:
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if tree is None:
        return "None"
    inner = ", ".join(_describe(k) for k in kids)
    if isinstance(tree, list):
        return f"[{inner}]"
    return f"{type(tree).__name__}({inner})"


def _unflatten(like, leaves):
    """``like``'s structure (its key order too) over ``leaves``, consumed
    in flatten order from an iterator."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if like is None:
        return None
    got = [_unflatten(k, leaves) for k in kids]
    if isinstance(like, list):
        return got
    return type(like)(*got) if hasattr(like, "_fields") else tuple(got)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to save, its manifest dtype) of a plain leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _file_dtype(dtype: torch.dtype) -> tuple[np.dtype, str]:
    """(the file's numpy dtype, the manifest's name) of a tensor dtype."""
    if dtype == torch.bfloat16:
        return np.dtype("V2"), "bfloat16"
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return np_dtype, str(np_dtype)


def _shard_region(t: DTensor) -> tuple | None:
    """The index of this rank's shard in the whole leaf, or None when
    another rank writes the same shard (this one is not the first of its
    replicas)."""
    coord = t.device_mesh.get_coordinate()
    if any(c and not pl.is_shard() for c, pl in zip(coord, t.placements)):
        return None
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def _write_shard(path: str, t: DTensor) -> None:
    """This rank's shard of ``t`` into its place in the laid-out file, one
    write per contiguous run (a run: the shard's slice of the last dim it
    does not cover whole, times the whole dims after it)."""
    region = _shard_region(t)
    if region is None or t.to_local().numel() == 0:
        return
    local = t.to_local().detach().cpu().contiguous()
    if local.dtype == torch.bfloat16:
        local = local.view(torch.int16)
    arr = local.numpy()
    shape = tuple(t.shape)
    start = np.load(path, mmap_mode="r").offset
    part = [d for d, (sl, n) in enumerate(zip(region, shape))
            if sl.stop - sl.start != n]
    with open(path, "r+b") as f:
        if not part:
            f.seek(start)
            f.write(arr.tobytes())
            return
        k = part[-1]
        inner = math.prod(shape[k + 1:])
        runs = arr.reshape(-1, arr.shape[k] * inner)
        for row, idx in zip(runs, np.ndindex(*arr.shape[:k])):
            at = region[k].start * inner + sum(
                (region[d].start + i) * math.prod(shape[d + 1:])
                for d, i in enumerate(idx))
            f.seek(start + at * arr.itemsize)
            f.write(row.tobytes())


def save_checkpoint(directory: str, step: int, tree, *, metadata=None,
                    keep: int = 3) -> str:
    """Write ``tree`` atomically; prune to the newest ``keep``
    checkpoints.  Returns the checkpoint's directory.  With DTensor
    leaves every rank must call it: each writes its shards, rank 0 the
    rest, and all ranks leave together."""
    leaves = _flatten(tree)
    sharded = any(isinstance(t, DTensor) for t in leaves)
    writer = not sharded or dist.get_rank() == 0
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    paths = [os.path.join(tmp, f"leaf_{i}.npy") for i in range(len(leaves))]
    spec = []
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    for path, leaf in zip(paths, leaves):
        if isinstance(leaf, DTensor):
            np_dtype, dtype = _file_dtype(leaf.dtype)
            if writer:          # the file laid out, its shards to come
                np.lib.format.open_memmap(path, mode="w+", dtype=np_dtype,
                                          shape=tuple(leaf.shape)).flush()
            spec.append({"shape": list(leaf.shape), "dtype": dtype})
            continue
        arr, dtype = _to_numpy(leaf)
        if writer:
            np.save(path, arr)
        spec.append({"shape": list(arr.shape), "dtype": dtype})
    if sharded:
        dist.barrier()                 # every file laid out
        for path, leaf in zip(paths, leaves):
            if isinstance(leaf, DTensor):
                _write_shard(path, leaf)
        dist.barrier()                 # every shard written
    if writer:
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "treedef": _describe(tree),
            "leaves": spec,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        _prune(directory, keep)
    if sharded:
        dist.barrier()
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def _complete_steps(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def _load_leaf(path: str, dtype: str, sharding=None) -> torch.Tensor:
    """The leaf's file as a host tensor; with ``(mesh, placements)`` only
    this rank's shard of it (read through a memory map)."""
    arr = np.load(path, mmap_mode="r" if sharding is not None else None)
    if sharding is not None:
        mesh, pl = sharding
        shape, offset = compute_local_shape_and_global_offset(
            arr.shape, mesh, pl)
        arr = np.ascontiguousarray(arr[tuple(
            slice(o, o + n) for o, n in zip(offset, shape))])
    if dtype == "bfloat16":              # two-byte void records: the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_shardings(like, shardings) -> list:
    """``shardings``' entry for each leaf of ``like``, in flatten order (an
    entry is ``(mesh, placements)`` or None)."""
    kids = _children(like)
    if kids is None:
        return [shardings]
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _leaf_shardings(like[k], shardings[k])]
    return [s for i, k in enumerate(kids)
            for s in _leaf_shardings(k, shardings[i])]


def restore_checkpoint(directory: str, like, *, step: int | None = None,
                       shardings=None, device=None):
    """Restore into the structure of ``like`` (a tree of tensors: the
    template's shapes and dtypes) on ``device`` (the card unless the
    caller names one; with shardings, each mesh's device).
    ``shardings``: a matching tree of ``(mesh, placements)`` (or None for
    a leaf restored whole), as ``distributed.sharding.shardings_for`` /
    ``shardings_of`` give; such leaves come back as DTensors, each rank
    reading only its shard.  Returns (tree, step, metadata)."""
    dev = resolve_device(device) if shardings is None else None
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = _flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, template has "
            f"{len(leaves)}: incompatible structures")
    placed = (_leaf_shardings(like, shardings) if shardings is not None
              else [None] * len(leaves))
    out = []
    for i, (tmpl, spec, shd) in enumerate(zip(leaves, manifest["leaves"],
                                              placed)):
        if tuple(spec["shape"]) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: checkpoint shape "
                             f"{tuple(spec['shape'])} != template "
                             f"{tuple(tmpl.shape)}")
        t = _load_leaf(os.path.join(path, f"leaf_{i}.npy"), spec["dtype"],
                       shd).to(tmpl.dtype)
        if shd is None:
            out.append(t.to(dev if dev is not None else tmpl.device))
            continue
        mesh, pl = shd
        t = t.to(_mesh_device(mesh))
        out.append(DTensor.from_local(t, mesh, pl, run_check=False,
                                      shape=torch.Size(spec["shape"]),
                                      stride=_contiguous(spec["shape"])))
    return _unflatten(like, iter(out)), step, manifest["metadata"]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
