"""Kernel C: vote sums of a stage run over a packed window list.

``stage_sums(cascade, s0, s1, ii_flat, img, base, stride, ys, xs, inv)``
takes every image's every level's SAT flattened into ``ii_flat`` (B, S)
and a packed list of ``cap`` lanes, each addressed by its image index,
its level's flat SAT base and row stride and its origin ``(y, x)``, with
its 1/sigma.  It returns (s1 - s0, cap) float32 sums.  This is the
``"pallas"`` backend of :func:`repro_torch.kernels.packed_tail.stage_sums`.

On a CUDA tensor it launches ``csrc/packed_window.cu`` (the port of
``repro.kernels.packed_window._packed_kernel``); on a CPU tensor it runs
:func:`stage_sums_plain`.  Both read the SAT at the flat index
``img * S + base + y * stride + x`` clamped into ``[0, B*S - 1]`` (as
``jnp.take(mode="clip")``), combine corners ``d - b - c + a``, add all
three rectangles, normalize ``feat * inv / 576`` and add votes in
ascending k.
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import Cascade, WINDOW
from repro_torch.core.integral import div_rn

from . import native
from .native import CASCADE_ARGTYPES, I32, I64, P, cascade_ptrs, ptr, stream_of

__all__ = ["stage_sums", "stage_sums_plain", "KERNEL"]

_AREA = float(WINDOW * WINDOW)

KERNEL = native.Kernel(
    "packed_window.cu", "packed_stage_sums",
    [P, I64, I64, P, P, P, P, P, P, P, I32] + CASCADE_ARGTYPES
    + [I32, I32, I32, I32, I32, P])


def stage_sums(cascade: Cascade, s0: int, s1: int, ii_flat: torch.Tensor,
               img: torch.Tensor, base: torch.Tensor, stride: torch.Tensor,
               ys: torch.Tensor, xs: torch.Tensor,
               inv: torch.Tensor) -> torch.Tensor:
    """(s1 - s0, cap) vote sums over the packed list (int32 lanes)."""
    if ii_flat.device.type == "cpu":
        return stage_sums_plain(cascade, s0, s1, ii_flat, img, base, stride,
                                ys, xs, inv)
    native.check_cuda(ii_flat, torch.float32, 2, "ii_flat")
    lanes = (("img", img), ("base", base), ("stride", stride), ("ys", ys),
             ("xs", xs))
    for name, t in lanes:
        native.check_cuda(t, torch.int32, 1, name)
    native.check_cuda(inv, torch.float32, 1, "inv")
    cap = inv.shape[0]
    if any(t.shape[0] != cap for _, t in lanes):
        raise ValueError("packed lane arrays differ in length")
    k0, k1 = cascade.bounds[s0], cascade.bounds[s1]
    out = torch.empty((s1 - s0, cap), dtype=torch.float32,
                      device=ii_flat.device)
    if out.numel():
        if ii_flat.numel() == 0:
            raise ValueError("empty SAT for a non-empty packed list")
        KERNEL(ptr(ii_flat), ii_flat.numel(), ii_flat.shape[1], ptr(img),
               ptr(base), ptr(stride), ptr(ys), ptr(xs), ptr(inv), ptr(out),
               cap, *cascade_ptrs(cascade, ii_flat), s0, s1, k0, k1,
               ii_flat.device.index, stream_of(ii_flat))
    return out


def stage_sums_plain(cascade: Cascade, s0: int, s1: int,
                     ii_flat: torch.Tensor, img: torch.Tensor,
                     base: torch.Tensor, stride: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_sums` (same bits)."""
    cap = inv.shape[0]
    if cap == 0 or s1 <= s0:
        return torch.zeros((s1 - s0, cap), dtype=torch.float32,
                           device=inv.device)
    flat = ii_flat.reshape(-1)
    last = flat.numel() - 1
    off = img.long() * ii_flat.shape[1] + base.long()
    st = stride.long()
    y = ys.long()
    x = xs.long()

    def at(yy, xx):
        return flat[torch.clamp(off + yy * st + xx, 0, last)]

    kb, ke = cascade.bounds[s0], cascade.bounds[s1]
    rects = cascade.rect_xywh[kb:ke].tolist()
    weights = cascade.rect_w[kb:ke].tolist()
    theta = cascade.wc_threshold[kb:ke].tolist()
    left = cascade.left_val[kb:ke].tolist()
    right = cascade.right_val[kb:ke].tolist()
    rows = []
    for s in range(s0, s1):
        acc = torch.zeros_like(inv)
        for k in range(cascade.bounds[s] - kb, cascade.bounds[s + 1] - kb):
            feat = torch.zeros_like(inv)
            for (rx, ry, rw, rh), wr in zip(rects[k], weights[k]):
                y0, x0 = y + ry, x + rx
                y1, x1 = y0 + rh, x0 + rw
                area = at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)
                feat = feat + wr * area
            f_norm = div_rn(feat * inv, _AREA)
            acc = acc + torch.where(f_norm < theta[k], left[k], right[k])
        rows.append(acc)
    return torch.stack(rows)
