"""Kernel A: the tile pass of the fused dense head.

``tile_pass(cascade, s0, s1, ii, ii2, iic, tile)`` reads the three padded
SATs (B, H+1, W+1) of kernel S and returns ``(inv, sums)``: the (B, ny,
nx) 1/sigma grid and the (B, s1 - s0, ny, nx) vote sums of every stage of
the dense run ``[s0, s1)``, with ``ny = H - 23`` and ``nx = W - 23``.  The
port's fused head is kernel S then this pass
(:func:`repro_torch.kernels.ops.fused_head_batch`): two launches.
``tile`` is the plan's ``head_tile``, launched as kernel B's
(:func:`repro_torch.kernels.haar_stage.head_block_shape`); the plain
version ignores it.

On a CUDA tensor it launches ``csrc/fused_head.cu`` (the port of
``repro.kernels.fused_head._fused_kernel``); on a CPU tensor it runs
:func:`tile_pass_plain`.  Both keep the TPU kernel's orderings: 1/sigma
from corners ``d - b - c + a``, ``var = s2/576 - (s1/576)^2``,
``1/sqrt(max(var, 1))``; stage sums as kernel B's
(:func:`repro_torch.kernels.haar_stage.dense_sums_plain`).
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import Cascade, WINDOW
from repro_torch.core.integral import div_rn, inv_sigma_of

from . import native
from .autotune import DEFAULT_TILE
from .haar_stage import dense_sums_plain, head_block_shape
from .native import CASCADE_ARGTYPES, I32, P, cascade_ptrs, ptr, stream_of

__all__ = ["tile_pass", "tile_pass_plain", "KERNEL"]

_AREA = float(WINDOW * WINDOW)

KERNEL = native.Kernel(
    "fused_head.cu", "fused_head_tiles",
    [P, P, P, P, P, I32, I32, I32] + CASCADE_ARGTYPES
    + [I32, I32, I32, I32, I32, I32, I32, I32, P])


def tile_pass(cascade: Cascade, s0: int, s1: int, ii: torch.Tensor,
              ii2: torch.Tensor, iic: torch.Tensor, tile=DEFAULT_TILE):
    """``(inv (B, ny, nx), sums (B, s1 - s0, ny, nx))`` from kernel S's
    tables, launched in the block of ``tile``."""
    if ii.device.type == "cpu":
        return tile_pass_plain(cascade, s0, s1, ii, ii2, iic)
    for name, t in (("ii", ii), ("ii2", ii2), ("iic", iic)):
        native.check_cuda(t, torch.float32, 3, name)
        if t.shape != ii.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != "
                             f"{tuple(ii.shape)}")
    b, h1, w1 = ii.shape
    ny, nx = h1 - WINDOW, w1 - WINDOW
    if ny <= 0 or nx <= 0 or s1 <= s0:
        raise ValueError(f"no window grid or no stage: SAT "
                         f"{tuple(ii.shape)}, stages [{s0}, {s1})")
    k0, k1 = cascade.bounds[s0], cascade.bounds[s1]
    inv = torch.empty((b, ny, nx), dtype=torch.float32, device=ii.device)
    sums = torch.empty((b, s1 - s0, ny, nx), dtype=torch.float32,
                       device=ii.device)
    if b:
        block = head_block_shape(tile)
        KERNEL(ptr(ii), ptr(ii2), ptr(iic), ptr(inv), ptr(sums), b, h1, w1,
               *cascade_ptrs(cascade, ii), s0, s1, k0, k1, *block,
               ii.device.index, stream_of(ii), block=block)
    return inv, sums


def window_sum(t: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Stride-1 24x24 window sums of a padded SAT, corners d - b - c + a."""
    a = t[..., :ny, :nx]
    b = t[..., :ny, WINDOW:WINDOW + nx]
    c = t[..., WINDOW:WINDOW + ny, :nx]
    d = t[..., WINDOW:WINDOW + ny, WINDOW:WINDOW + nx]
    return d - b - c + a


def tile_pass_plain(cascade: Cascade, s0: int, s1: int, ii: torch.Tensor,
                    ii2: torch.Tensor, iic: torch.Tensor):
    """Plain PyTorch version of :func:`tile_pass` (same bits)."""
    ny, nx = ii.shape[-2] - WINDOW, ii.shape[-1] - WINDOW
    s2 = window_sum(ii2, ny, nx)
    mean = div_rn(window_sum(iic, ny, nx), _AREA)
    inv = inv_sigma_of(div_rn(s2, _AREA) - mean * mean)
    b = cascade.bounds
    sums = torch.stack([dense_sums_plain(cascade, b[s], b[s + 1], ii, inv)
                        for s in range(s0, s1)], dim=-3)
    return inv, sums
