"""Kernel S, the SAT phase: three padded summed-area tables per image.

``sat_tables(imgs)`` takes a (B, H, W) float32 stack and returns
``(ii, ii2, iic)``, each (B, H+1, W+1) with a zero top row and left
column: the SAT of the image, of ``(img - 128)^2`` and of ``img - 128``.
Both dense heads of the port take their tables from here, so the fused
and split heads see one SAT.

On a CUDA tensor it launches ``csrc/integral_image.cu`` (which ports
``repro.kernels.integral_image.integral_image_kernel`` and the SAT build
of ``repro.kernels.fused_head._fused_kernel``); on a CPU tensor it runs
:func:`sat_tables_plain`, the same pinned order in plain PyTorch (column
then row cumsum, float64 accumulation, float32 entries).  The kernel is a
chained scan across strips of ``STRIP`` table columns; for each launch
the wrapper allocates its hand-off buffer (a ticket and the float64 row
carries between strips), filled with ``SENTINEL``.
"""

from __future__ import annotations

import torch

from repro_torch.core.integral import CENTRE, integral_image

from . import native
from .native import I32, I64, P, U64, ptr, stream_of

__all__ = ["sat_tables", "sat_tables_plain", "KERNEL"]

KERNEL = native.Kernel("integral_image.cu", "sat_tables",
                       [P, P, P, P, I32, I32, I32, P, I64, U64, I32, P])

STRIP = 32             # table columns per block, as in csrc/integral_image.cu
# the unwritten mark of a carry slot: a signalling-NaN bit pattern, which no
# float64 add or conversion produces
SENTINEL = 0x7FF0DEAD0000BEEF


def sat_tables(imgs: torch.Tensor):
    """(B, H, W) float32 -> ``(ii, ii2, iic)``, each (B, H+1, W+1)."""
    if imgs.device.type == "cpu":
        return sat_tables_plain(imgs)
    native.check_cuda(imgs, torch.float32, 3, "imgs")
    b, h, w = imgs.shape
    if not imgs.numel():
        out = torch.zeros((3, b, h + 1, w + 1), dtype=torch.float32,
                          device=imgs.device)
        return out[0], out[1], out[2]
    out = torch.empty((3, b, h + 1, w + 1), dtype=torch.float32,
                      device=imgs.device)
    hand = torch.full((1 + b * -(-w // STRIP) * h * 3,), SENTINEL,
                      dtype=torch.int64, device=imgs.device)
    KERNEL(ptr(imgs), ptr(out[0]), ptr(out[1]), ptr(out[2]), b, h, w,
           ptr(hand), hand.numel(), SENTINEL, imgs.device.index,
           stream_of(imgs))
    return out[0], out[1], out[2]


def sat_tables_plain(imgs: torch.Tensor):
    """Plain PyTorch version of :func:`sat_tables` (same bits)."""
    img = imgs.to(torch.float32)
    centred = img - CENTRE
    return (integral_image(img), integral_image(centred * centred),
            integral_image(centred))
