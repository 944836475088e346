"""Kernel C: vote sums of a stage run over a packed window list.

``stage_sums(cascade, s0, s1, ii_flat, img, base, stride, ys, xs, inv)``
takes every image's every level's SAT flattened into ``ii_flat`` (B, S)
and a packed list of ``cap`` lanes, each addressed by its image index,
its level's flat SAT base and row stride and its origin ``(y, x)``, with
its 1/sigma.  It returns (s1 - s0, cap) float32 sums.  This is the
``"pallas"`` backend of :func:`repro_torch.kernels.packed_tail.stage_sums`.

``n_live`` (a 0-dim int64 tensor on the lanes' device, or ``None`` for
all lanes) says that only the first ``min(n_live, cap)`` lanes are live,
as a static-capacity compaction leaves them: the rest get 0 in every row
(the kernel reads it on the device, so nothing syncs).  ``lane_block``
``(r, c)`` (the plan's; ``None`` means ``autotune.DEFAULT_TILE``) shapes
the launch: ``c`` threads per block, ``cap / (r c)`` blocks, ``r`` lanes
per thread (:func:`block_shape`; fewer when the kernel spreads a short
live prefix over the whole grid).  The plain version ignores it; the sums
never depend on it.

On a CUDA tensor it launches ``csrc/packed_window.cu`` (the port of
``repro.kernels.packed_window._packed_kernel``); on a CPU tensor it runs
:func:`stage_sums_plain`.  Both read the SAT at the flat index
``img * S + base + y * stride + x`` clamped into ``[0, B*S - 1]`` (as
``jnp.take(mode="clip")``), combine corners ``d - b - c + a``, add all
three rectangles, normalize ``feat * inv / 576`` and add votes in
ascending k.

``s_dense`` (default 0) gives stages below it the dense kernels'
arithmetic instead, corners ``(d - b) - (c - a)`` and ``feat * inv *
(1/576)`` (kernels A and B, :func:`repro_torch.kernels.haar_stage
.dense_sums_plain`).  The batched tail never passes it; the stream's
incremental tail evaluates windows from stage 0 and passes the dense
prefix's length, so its decisions there are those of ``detect``'s dense
head.
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import Cascade, WINDOW
from repro_torch.core.integral import div_rn

from . import native
from .autotune import DEFAULT_TILE
from .native import CASCADE_ARGTYPES, I32, I64, P, cascade_ptrs, ptr, stream_of

__all__ = ["stage_sums", "stage_sums_plain", "block_shape", "zero_past_live",
           "KERNEL"]

_AREA = float(WINDOW * WINDOW)
_INV_AREA = 1.0 / _AREA

KERNEL = native.Kernel(
    "packed_window.cu", "packed_stage_sums",
    [P, I64, I64, P, P, P, P, P, P, P, P, I32] + CASCADE_ARGTYPES
    + [I32, I32, I32, I32, I32, I32, I32, I32, P])


def block_shape(lane_block=None) -> tuple[int, int]:
    """Kernel C's ``(lanes per thread, threads per block)`` for a plan's
    ``lane_block`` ``(r, c)``: ``r`` at least 1, ``c`` rounded down to a
    multiple of 32 in [32, 1024] (the launch lowers it further if the
    kernel's registers allow fewer threads per block)."""
    r, c = (int(v) for v in (lane_block or DEFAULT_TILE))
    return max(r, 1), min(max(c // 32 * 32, 32), 1024)


def zero_past_live(out: torch.Tensor, n_live) -> torch.Tensor:
    """``out`` (rows, cap) with every lane at or past ``n_live`` set to 0
    (no host sync); ``n_live=None`` keeps every lane."""
    if n_live is None:
        return out
    lanes = torch.arange(out.shape[-1], device=out.device)
    return torch.where(lanes < n_live, out, 0.0)


def stage_sums(cascade: Cascade, s0: int, s1: int, ii_flat: torch.Tensor,
               img: torch.Tensor, base: torch.Tensor, stride: torch.Tensor,
               ys: torch.Tensor, xs: torch.Tensor, inv: torch.Tensor,
               n_live: torch.Tensor | None = None,
               lane_block=None, s_dense: int = 0) -> torch.Tensor:
    """(s1 - s0, cap) vote sums over the packed list (int32 lanes); lanes
    at or past ``n_live`` get 0; stages below ``s_dense`` in the dense
    order."""
    if ii_flat.device.type == "cpu":
        return stage_sums_plain(cascade, s0, s1, ii_flat, img, base, stride,
                                ys, xs, inv, n_live, s_dense)
    native.check_cuda(ii_flat, torch.float32, 2, "ii_flat")
    lanes = (("img", img), ("base", base), ("stride", stride), ("ys", ys),
             ("xs", xs))
    for name, t in lanes:
        native.check_cuda(t, torch.int32, 1, name)
    native.check_cuda(inv, torch.float32, 1, "inv")
    cap = inv.shape[0]
    if any(t.shape[0] != cap for _, t in lanes):
        raise ValueError("packed lane arrays differ in length")
    if n_live is not None:
        native.check_cuda(n_live, torch.int64, 0, "n_live")
    lanes_per_thread, threads = block_shape(lane_block)
    k0, k1 = cascade.bounds[s0], cascade.bounds[s1]
    out = torch.empty((s1 - s0, cap), dtype=torch.float32,
                      device=ii_flat.device)
    if out.numel():
        if ii_flat.numel() == 0:
            raise ValueError("empty SAT for a non-empty packed list")
        KERNEL(ptr(ii_flat), ii_flat.numel(), ii_flat.shape[1], ptr(img),
               ptr(base), ptr(stride), ptr(ys), ptr(xs), ptr(inv),
               None if n_live is None else ptr(n_live), ptr(out), cap,
               *cascade_ptrs(cascade, ii_flat), s0, s1, k0, k1, s_dense,
               lanes_per_thread, threads, ii_flat.device.index,
               stream_of(ii_flat))
    return out


def stage_sums_plain(cascade: Cascade, s0: int, s1: int,
                     ii_flat: torch.Tensor, img: torch.Tensor,
                     base: torch.Tensor, stride: torch.Tensor,
                     ys: torch.Tensor, xs: torch.Tensor, inv: torch.Tensor,
                     n_live: torch.Tensor | None = None,
                     s_dense: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`stage_sums` (same bits; it
    evaluates every lane, then zeroes those at or past ``n_live``)."""
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
    k_dense = cascade.bounds[min(max(s_dense, s0), s1)] - kb
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
                a, b, c, d = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
                area = (d - b) - (c - a) if k < k_dense else d - b - c + a
                feat = feat + wr * area
            f_norm = (feat * inv * _INV_AREA if k < k_dense
                      else div_rn(feat * inv, _AREA))
            acc = acc + torch.where(f_norm < theta[k], left[k], right[k])
        rows.append(acc)
    return zero_past_live(torch.stack(rows), n_live)
