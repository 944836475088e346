"""AdamW with a cosine schedule, over explicit state.

The moments mirror the parameter tree (nested dicts and lists of
tensors), in ``moment_dtype`` (float32 by default).  ``adamw_update``
returns new tensors and leaves its inputs as they were, or, with
``donate=True``, writes the new parameters and moments into its inputs'
tensors (the reference's dry run donates the train state to its jitted
step).  The global-norm clip is folded into the update, and stacked
(scan-layer) leaves of at least ``CHUNK_MIN_SIZE`` elements are updated
one dim-0 slice at a time, each slice written into the new buffers (or
back into the donated ones) after its own math, so the float32
intermediates of one update stay O(slice), not O(leaf).  At olmo-1b's
full width the stacked MLP leaves (16 x 2048 x 8192 = 2^28 elements) take
that path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map, tree_unzip

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "CHUNK_MIN_SIZE"]

# stacked leaves at least this large stream their update per layer slice
CHUNK_MIN_SIZE = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    m: dict
    v: dict


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim float32 tensor on ``like``'s device: dividing by
    it is IEEE division on every device (CUDA's division by a Python
    scalar multiplies by its reciprocal)."""
    return torch.scalar_tensor(x, dtype=torch.float32, device=like.device)


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros_like(p, dtype=moment_dtype)

    return AdamWState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_scalar(max_norm, gn) / torch.clamp(gn, min=1e-9),
                       max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 donate: bool = False):
    """One AdamW step: ``(params', state', {"grad_norm": gn})``.  ``lr``
    may be a float or a 0-dim tensor (a schedule value).  Weight decay
    skips leaves with ``ndim < 2`` (norms, biases); bias corrections use
    ``b1 ** t`` in float32.

    ``donate=True``: params' and the moments are ``params``' and
    ``state``'s own tensors (a DTensor's local shards), written in place
    with the bits the functional update returns.  The caller gives them
    up: JAX raises on a donated buffer's later use, the port cannot, and
    the old tensors simply hold the new values."""
    gn = global_norm(grads)
    scale = _local(_clip_scale(gn, max_grad_norm))
    lr = _local(lr)
    t = state.step + 1
    tf = t.float()
    c1 = 1.0 - torch.pow(b1, tf)
    c2 = 1.0 - torch.pow(b2, tf)

    def math_(p, g, m, v, wd):
        gf = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if wd:
            delta = delta + weight_decay * p.float()
        p_new = p.float() - lr * delta
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    def upd(p, g, m, v):
        if isinstance(p, DTensor):
            # elementwise on each rank's shards (the moments and, after
            # the train step's reduce-scatter, the gradients share the
            # parameter's placements); the norm above is global
            out = upd_local(*(t.to_local() for t in (p, g, m, v)),
                            p.dim() >= 2)
            if donate:
                return p, m, v
            return tuple(DTensor.from_local(o, t.device_mesh, t.placements,
                                            shape=t.shape, stride=t.stride())
                         for o, t in zip(out, (p, m, v)))
        return upd_local(p, g, m, v, p.dim() >= 2)

    def upd_local(p, g, m, v, matrix: bool):
        wd = bool(matrix and weight_decay)
        if p.dim() >= 3 and p.shape[0] >= 8 and p.numel() >= CHUNK_MIN_SIZE:
            n = p.shape[0]
            while p.shape[0] % n or n > 16:      # <= 16 even chunks
                n -= 1
            if n > 1:
                ck = p.shape[0] // n
                out = ((p, m, v) if donate
                       else tuple(torch.empty_like(x) for x in (p, m, v)))
                for i in range(0, p.shape[0], ck):
                    sl = slice(i, i + ck)
                    for buf, new in zip(out, math_(p[sl], g[sl], m[sl],
                                                   v[sl], wd)):
                        buf[sl] = new
                return out
        new = math_(p, g, m, v, wd)
        if donate:
            for buf, x in zip((p, m, v), new):
                buf.copy_(x)
            return p, m, v
        return new

    p_new, m_new, v_new = tree_unzip(
        tree_map(upd, params, grads, state.m, state.v), 3)
    return p_new, AdamWState(t, m_new, v_new), {"grad_norm": gn}


def _local(x):
    """A replicated DTensor's local value; anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def cosine_schedule(step, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor_frac``
    of it; a float32 0-dim tensor (on ``step``'s device when it is one)."""
    if isinstance(step, torch.Tensor):
        s = step.float()
    else:
        s = torch.scalar_tensor(step, dtype=torch.float32)
    warm = peak_lr * torch.clamp(s / _scalar(max(warmup, 1), s), max=1.0)
    prog = torch.clamp((s - warmup) / _scalar(max(total - warmup, 1), s),
                       0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return torch.where(s < warmup, warm, peak_lr * cos)
