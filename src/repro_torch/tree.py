"""Nested dicts / lists of tensors as trees (the port's pytrees)."""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_unzip"]


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts / lists of equal structure."""
    t = trees[0]
    if isinstance(t, dict):
        if any(x.keys() != t.keys() for x in trees[1:]):
            raise ValueError(f"dict keys differ: {[list(x) for x in trees]}")
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        if any(len(x) != len(t) for x in trees[1:]):
            raise ValueError("list lengths differ")
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts / lists, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unzip(tree, n: int) -> tuple:
    """``n`` trees from the output of ``tree_map`` over a function that
    returns ``n``-tuples (the tuples are its leaves)."""
    if isinstance(tree, tuple):
        return tree
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    parts = [tree_unzip(v, n) for v in tree]
    return tuple([p[i] for p in parts] for i in range(n))
