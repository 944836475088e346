"""The reference's named-axis collectives (``psum``, ``pmax``,
``axis_index``) over a mesh's named dims or a process group.

An *axis* is ``(mesh, names)`` (a ``DeviceMesh`` and one dim name or a
tuple of them, major first) or a ``ProcessGroup``.  The reductions are
c10d functional collectives.  ``psum`` and ``pmean`` differentiate as
JAX's do under ``shard_map`` when their result is used alike on every
rank of the axis (each rank then receives the whole cotangent, and the
backward passes it through); the callers' ``local_map`` regions declare
the inputs' gradients partial over the axis where that holds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

__all__ = ["axis_groups", "axis_index", "axis_size", "psum", "pmax",
           "pmean"]


def axis_groups(axis) -> list:
    """The process groups of ``axis``, major first."""
    if isinstance(axis, dist.ProcessGroup):
        return [axis]
    mesh, names = axis
    names = names if isinstance(names, tuple) else (names,)
    return [mesh.get_group(n) for n in names]


def axis_size(axis) -> int:
    n = 1
    for g in axis_groups(axis):
        n *= dist.get_world_size(g)
    return n


def axis_index(axis) -> int:
    """This rank's index along ``axis`` (the names major first)."""
    idx = 0
    for g in axis_groups(axis):
        idx = idx * dist.get_world_size(g) + dist.get_rank(g)
    return idx


def _reduce(x: torch.Tensor, op: str, axis) -> torch.Tensor:
    for g in axis_groups(axis):
        x = funcol.wait_tensor(funcol.all_reduce(x, op, g))
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum over the ranks of ``axis`` (every rank gets it)."""
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    n = torch.scalar_tensor(axis_size(axis), dtype=x.dtype, device=x.device)
    return psum(x, axis) / n


def pmax(x: torch.Tensor, axis) -> torch.Tensor:
    """Max over the ranks of ``axis`` (no gradient)."""
    return _reduce(x.detach(), "max", axis)
