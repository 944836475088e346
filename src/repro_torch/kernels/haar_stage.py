"""Kernel B: one stage's vote sums over a stride-1 window grid.

``stage_sums(cascade, s, ii, inv, tile)`` takes padded SATs ``ii`` (B,
H1, W1) and 1/sigma grids ``inv`` (B, ny, nx) with ``H1 >= ny + 24`` and
``W1 >= nx + 24``, and returns stage ``s``'s sums (B, ny, nx).  The split
dense head calls it once per (stage, level) over the whole stack.

``tile`` is the plan's ``head_tile`` ``(ty, tx)`` (empty means
``autotune.DEFAULT_TILE``): the launch shape of kernels A and B
(:func:`head_block_shape`), a block over ``ty x tx`` window origins,
``tx`` threads across and 4 windows per thread down.  The plain version
ignores it; the sums never depend on it.

On a CUDA tensor it launches ``csrc/haar_stage.cu`` (the port of
``repro.kernels.haar_stage._stage_kernel``); on a CPU tensor it runs
:func:`dense_sums_plain`, the same arithmetic in plain PyTorch: for a
fixed weak classifier every window's corner is one SAT slice shifted by a
constant (the TPU kernel's trick), corners ``(d - b) - (c - a)``, all three
rectangles added in order, ``feat * inv * (1/576)``, votes in ascending k.
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import Cascade, WINDOW

from . import native
from .autotune import DEFAULT_TILE
from .native import CASCADE_ARGTYPES, I32, P, cascade_ptrs, ptr, stream_of

__all__ = ["stage_sums", "dense_sums_plain", "head_block_shape",
           "HEAD_ROWS", "KERNEL"]

_INV_AREA = 1.0 / float(WINDOW * WINDOW)

# window rows per tile the dense kernels are built for; each thread walks
# at most 4 of them (csrc/common.cuh kDenseRows), so 1, 2 or 4
HEAD_ROWS = (1, 2, 4, 8, 16)
_ROWS_PER_THREAD = 4
_MAX_THREADS = 1024                     # CUDA's threads per block

KERNEL = native.Kernel(
    "haar_stage.cu", "haar_stage_sums",
    [P, P, P, I32, I32, I32, I32, I32] + CASCADE_ARGTYPES
    + [I32, I32, I32, I32, I32, I32, I32, P])


def head_block_shape(tile=None) -> tuple[int, int, int]:
    """Kernels A and B's launch shape ``(windows per thread, block x, block
    y)`` for a plan's ``head_tile`` ``(ty, tx)`` (empty: ``DEFAULT_TILE``):
    ``ty`` rounded down to one of :data:`HEAD_ROWS`, ``r`` = min(ty, 4)
    windows per thread down one column, and a block of ``tx x ty / r``
    threads (``tx`` rounded down to a multiple of 32, at most 1024 threads
    in all) over the tile's ``ty x tx`` window origins."""
    ty, tx = (int(v) for v in (tile or DEFAULT_TILE))
    rows = max(r for r in HEAD_ROWS if r <= max(ty, 1))
    rpt = min(rows, _ROWS_PER_THREAD)
    by = rows // rpt
    cap = _MAX_THREADS // by // 32 * 32
    return rpt, min(max(tx // 32 * 32, 32), cap), by


def stage_sums(cascade: Cascade, s: int, ii: torch.Tensor,
               inv: torch.Tensor, tile=DEFAULT_TILE) -> torch.Tensor:
    """Stage ``s`` vote sums (B, ny, nx) over a stack of dense grids,
    launched in the block of ``tile``."""
    k0, k1 = cascade.bounds[s], cascade.bounds[s + 1]
    if ii.device.type == "cpu":
        return dense_sums_plain(cascade, k0, k1, ii, inv)
    native.check_cuda(ii, torch.float32, 3, "ii")
    native.check_cuda(inv, torch.float32, 3, "inv")
    b, h1, w1 = ii.shape
    ny, nx = inv.shape[1:]
    if inv.shape[0] != b or h1 < ny + WINDOW or w1 < nx + WINDOW:
        raise ValueError(f"SAT {tuple(ii.shape)} does not cover the "
                         f"window grid {tuple(inv.shape)}")
    out = torch.empty_like(inv)
    if out.numel():
        block = head_block_shape(tile)
        KERNEL(ptr(ii), ptr(inv), ptr(out), b, h1, w1, ny, nx,
               *cascade_ptrs(cascade, ii), s, k0, k1, *block,
               ii.device.index, stream_of(ii), block=block)
    return out


def dense_sums_plain(cascade: Cascade, k0: int, k1: int, ii: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the dense stage sum of weak classifiers
    ``[k0, k1)`` (kernels A and B share it): same ordering, same bits."""
    ny, nx = inv.shape[-2:]
    rects = cascade.rect_xywh[k0:k1].tolist()
    weights = cascade.rect_w[k0:k1].tolist()
    theta = cascade.wc_threshold[k0:k1].tolist()
    left = cascade.left_val[k0:k1].tolist()
    right = cascade.right_val[k0:k1].tolist()
    acc = torch.zeros_like(inv)
    for k in range(k1 - k0):
        feat = torch.zeros_like(inv)
        for (x, y, w, h), wr in zip(rects[k], weights[k]):
            a = ii[..., y:y + ny, x:x + nx]
            b = ii[..., y:y + ny, x + w:x + w + nx]
            c = ii[..., y + h:y + h + ny, x:x + nx]
            d = ii[..., y + h:y + h + ny, x + w:x + w + nx]
            feat = feat + wr * ((d - b) - (c - a))
        f_norm = feat * inv * _INV_AREA
        acc = acc + torch.where(f_norm < theta[k], left[k], right[k])
    return acc
