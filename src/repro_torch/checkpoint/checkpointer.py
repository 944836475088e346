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

The reference's elastic ``shardings=`` restore comes with the
distributed slice.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

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
    """(array to save, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree, *, metadata=None,
                    keep: int = 3) -> str:
    """Write ``tree`` atomically; prune to the newest ``keep``
    checkpoints.  Returns the checkpoint's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    spec = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        spec.append({"shape": list(arr.shape), "dtype": dtype})
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


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":              # two-byte void records: the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, like, *, step: int | None = None,
                       device=None):
    """Restore into the structure of ``like`` (a tree of tensors: the
    template's shapes and dtypes) on ``device`` (the card unless the
    caller names one).  Returns (tree, step, metadata)."""
    dev = resolve_device(device)
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
    out = []
    for i, (tmpl, spec) in enumerate(zip(leaves, manifest["leaves"])):
        t = _load_leaf(os.path.join(path, f"leaf_{i}.npy"), spec["dtype"])
        if tuple(t.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} "
                             f"!= template {tuple(tmpl.shape)}")
        out.append(t.to(tmpl.dtype).to(dev))
    return _unflatten(like, iter(out)), step, manifest["metadata"]
