"""Kernel D: the stride-1 grid of 24x24 window 1/sigma values.

``inv_sigma_grid(ii2, iic, ny, nx)`` takes the padded SATs of the centred
square and of the centred image, (B, H+1, W+1) float32 each, and returns
the (B, ny, nx) float32 grid of ``1 / sqrt(max(var, 1))`` per window
origin, with ``var = s2/576 - (s1/576) * (s1/576)`` and each window sum
``(d - b) - (c - a)`` (the TPU kernel's corner order, not kernel A's).
Where ``ny`` / ``nx`` reach past the tables, corner indices clamp to the
last row / column, which is the reference wrapper's edge padding.

On a CUDA tensor it launches ``csrc/window_variance.cu`` (the port of
``repro.kernels.window_variance.window_inv_sigma_kernel``); on a CPU
tensor it runs :func:`inv_sigma_grid_plain`, the same arithmetic in plain
PyTorch with IEEE division (``core.integral.div_rn``) and a correctly
rounded root (``core.integral.inv_sigma_of``).  No engine calls it: the
public wrappers ``ops.window_inv_sigma_grid(_batch)`` do.
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import WINDOW
from repro_torch.core.integral import div_rn, inv_sigma_of

from . import native
from .native import I32, I64, P, ptr, stream_of

__all__ = ["inv_sigma_grid", "inv_sigma_grid_plain", "KERNEL"]

_AREA = float(WINDOW * WINDOW)

KERNEL = native.Kernel("window_variance.cu", "window_inv_sigma",
                       [P, P, I64, I64, P, I32, I32, I32, I32, I32, I32, P])


def _check_table(t: torch.Tensor, name: str) -> None:
    """A CUDA float32 (B, H1, W1) table whose rows are contiguous (the
    batch dim may be strided, as in a slice of stacked pairs)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 3:
        raise TypeError(f"{name} must be (B, H1, W1) float32, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
        raise ValueError(f"{name} rows must be contiguous")


def inv_sigma_grid(ii2: torch.Tensor, iic: torch.Tensor, ny: int,
                   nx: int) -> torch.Tensor:
    """(B, ny, nx) 1/sigma grid from (B, H+1, W+1) SATs."""
    if ii2.device.type == "cpu":
        return inv_sigma_grid_plain(ii2, iic, ny, nx)
    _check_table(ii2, "ii2")
    _check_table(iic, "iic")
    if iic.shape != ii2.shape or iic.device != ii2.device:
        raise ValueError(f"iic {tuple(iic.shape)} on {iic.device} does not "
                         f"match ii2 {tuple(ii2.shape)} on {ii2.device}")
    b, h1, w1 = ii2.shape
    if ny < 0 or nx < 0 or h1 == 0 or w1 == 0:
        raise ValueError(f"bad grid ({ny}, {nx}) over tables "
                         f"{tuple(ii2.shape)}")
    out = torch.empty((b, ny, nx), dtype=torch.float32, device=ii2.device)
    if out.numel():
        KERNEL(ptr(ii2), ptr(iic), ii2.stride(0), iic.stride(0), ptr(out), b,
               h1, w1, ny, nx, ii2.device.index, stream_of(ii2))
    return out


def inv_sigma_grid_plain(ii2: torch.Tensor, iic: torch.Tensor, ny: int,
                         nx: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`inv_sigma_grid` (same bits)."""
    h1, w1 = ii2.shape[-2:]
    dev = ii2.device
    ys = torch.arange(ny, device=dev)[:, None]
    xs = torch.arange(nx, device=dev)[None, :]
    y0, y1 = ys.clamp(max=h1 - 1), (ys + WINDOW).clamp(max=h1 - 1)
    x0, x1 = xs.clamp(max=w1 - 1), (xs + WINDOW).clamp(max=w1 - 1)

    def window_sum(t):
        return ((t[..., y1, x1] - t[..., y0, x1])
                - (t[..., y1, x0] - t[..., y0, x0]))

    mean = div_rn(window_sum(iic), _AREA)
    return inv_sigma_of(div_rn(window_sum(ii2), _AREA) - mean * mean)
