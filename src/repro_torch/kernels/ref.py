"""Plain-torch twins of the reference's oracles (``repro.kernels.ref``).

These follow the reference oracles' arithmetic, not the kernels': corners
``d - b - c + a`` and ``feat * inv_sigma / 576`` throughout, the
weak-classifier parameters read as tensors.  Given the same SAT and
1/sigma they give the reference oracles' bits; against the dense kernels
(whose stage sums use ``(d - b) - (c - a)`` and ``* (1/576)``) they agree
to the reference's tolerances.  The tile-change oracles are independent
algorithms, as the reference's: direct per-tile reshape sums instead of
SAT corner lookups, and a range-indicator integer matmul instead of the
integer SAT, so a SAT indexing bug cannot hide in its own oracle.  The
tail's gates and counts have no reference oracle; their twin is the
reference batch program's own formula (``repro.core.engine``: a gate per
stage, then a scatter-add of each lane's mask into its image's count).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.cascade import WINDOW
from repro_torch.core.integral import CENTRE, div_rn, inv_sigma_of, rect_sum

__all__ = ["integral_image_ref", "window_inv_sigma_ref",
           "dense_stage_sums_ref", "fused_head_ref", "fused_head_batch_ref",
           "packed_stage_sums_ref", "dense_stage_sums_batch_ref",
           "tile_change_mask_ref", "changed_window_map_ref",
           "tail_gate_counts_ref"]

_AREA = float(WINDOW * WINDOW)


def integral_image_ref(img: torch.Tensor) -> torch.Tensor:
    """Inclusive 2-D cumulative sum (unpadded), the port's pinned order;
    works on (H, W) or (B, H, W)."""
    cols = torch.cumsum(img.to(torch.float32).double(), dim=-2).float()
    return torch.cumsum(cols.double(), dim=-1).float()


def window_inv_sigma_ref(ii2: torch.Tensor, iic: torch.Tensor, ny: int,
                         nx: int, window: int = WINDOW) -> torch.Tensor:
    """(..., ny, nx) grid of 1/sigma per stride-1 window origin.  Corner
    indices past the tables clamp to their last row / column, as jnp's
    gathers do."""
    n = float(window * window)
    h1, w1 = ii2.shape[-2:]
    ys = torch.arange(ny, device=ii2.device)[:, None]
    xs = torch.arange(nx, device=ii2.device)[None, :]
    y0, y1 = ys.clamp(max=h1 - 1), (ys + window).clamp(max=h1 - 1)
    x0, x1 = xs.clamp(max=w1 - 1), (xs + window).clamp(max=w1 - 1)

    def rect(t):
        return t[..., y1, x1] - t[..., y0, x1] - t[..., y1, x0] + t[..., y0, x0]

    mean = div_rn(rect(iic), n)
    return inv_sigma_of(div_rn(rect(ii2), n) - mean * mean)


def dense_stage_sums_ref(rect_xywh, rect_w, wc_threshold, left_val,
                         right_val, ii: torch.Tensor,
                         inv_sigma: torch.Tensor) -> torch.Tensor:
    """Stage sums over a dense stride-1 grid of the given weak classifiers;
    ``ii`` (..., H+1, W+1) and ``inv_sigma`` (..., ny, nx)."""
    ny, nx = inv_sigma.shape[-2:]
    ys = torch.arange(ny, device=ii.device)[:, None]
    xs = torch.arange(nx, device=ii.device)[None, :]
    acc = torch.zeros_like(inv_sigma)
    for k in range(rect_xywh.shape[0]):
        feat = torch.zeros_like(inv_sigma)
        for r in range(rect_xywh.shape[1]):
            rx, ry, rw, rh = rect_xywh[k, r]
            feat = feat + rect_w[k, r] * rect_sum(ii, ys + ry, xs + rx, rh, rw)
        f_norm = div_rn(feat * inv_sigma, _AREA)
        acc = acc + torch.where(f_norm < wc_threshold[k], left_val[k],
                                right_val[k])
    return acc


def fused_head_ref(rect_xywh, rect_w, wc_threshold, left_val, right_val,
                   rel_bounds: tuple, img: torch.Tensor):
    """Oracle twin of the fused head: ``(ii, inv_sigma, sums)`` composed
    from this module's pieces; works on (H, W) or (B, H, W)."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    ny, nx = h - WINDOW + 1, w - WINDOW + 1
    ii = F.pad(integral_image_ref(img), (1, 0, 1, 0))
    centred = img - CENTRE
    ii2 = F.pad(integral_image_ref(centred * centred), (1, 0, 1, 0))
    iic = F.pad(integral_image_ref(centred), (1, 0, 1, 0))
    inv = window_inv_sigma_ref(ii2, iic, ny, nx)
    sums = torch.stack([
        dense_stage_sums_ref(rect_xywh[a:b], rect_w[a:b], wc_threshold[a:b],
                             left_val[a:b], right_val[a:b], ii, inv)
        for a, b in zip(rel_bounds[:-1], rel_bounds[1:])], dim=-3)
    return ii, inv, sums


fused_head_batch_ref = fused_head_ref
dense_stage_sums_batch_ref = dense_stage_sums_ref


def packed_stage_sums_ref(rect_xywh, rect_w, wc_threshold, left_val,
                          right_val, k0: int, rel_bounds: tuple,
                          ii_flat: torch.Tensor, img, base, stride, ys, xs,
                          inv_sigma: torch.Tensor) -> torch.Tensor:
    """(n_run, cap) stage sums over a packed window list: the gather
    oracle of the packed kernel (2-D ``ii_flat[img, flat]`` lookups)."""
    img, base, stride = img.long(), base.long(), stride.long()

    def rect(y0, x0, rh, rw):
        y1, x1 = y0 + rh, x0 + rw
        return (ii_flat[img, base + y1 * stride + x1]
                - ii_flat[img, base + y0 * stride + x1]
                - ii_flat[img, base + y1 * stride + x0]
                + ii_flat[img, base + y0 * stride + x0])

    rows = []
    for si in range(len(rel_bounds) - 1):
        acc = torch.zeros_like(inv_sigma)
        for k in range(k0 + rel_bounds[si], k0 + rel_bounds[si + 1]):
            feat = torch.zeros_like(inv_sigma)
            for r in range(rect_xywh.shape[1]):
                rx, ry, rw, rh = rect_xywh[k, r]
                feat = feat + rect_w[k, r] * rect(ys.long() + ry,
                                                  xs.long() + rx, rh, rw)
            f_norm = div_rn(feat * inv_sigma, _AREA)
            acc = acc + torch.where(f_norm < wc_threshold[k], left_val[k],
                                    right_val[k])
        rows.append(acc)
    return torch.stack(rows)


def tail_gate_counts_ref(ss_run: torch.Tensor, thr: torch.Tensor,
                         valid: torch.Tensor, b_sel: torch.Tensor, n_live,
                         counts: torch.Tensor) -> torch.Tensor:
    """Gate ``valid`` by each of the k stages of ``ss_run`` (k, cap) in turn
    and add the survivors of stage ``j`` to ``counts[j]`` (k, B), image by
    image, with one ``index_add_`` over every lane; both in place, returns
    ``valid``.  ``n_live`` is not read: lanes past it are invalid on entry
    and stay so."""
    for j in range(ss_run.shape[0]):
        valid &= ss_run[j] >= thr[j]
        per_img = torch.zeros(counts.shape[1], dtype=torch.int32,
                              device=counts.device)
        per_img.index_add_(0, b_sel, valid.to(torch.int32))
        counts[j] += per_img
    return valid


def tile_change_mask_ref(prev: torch.Tensor, cur: torch.Tensor,
                         threshold: float, *, tile: int, halo: int = 0,
                         exact: bool = True):
    """(changed, scores) per tile via direct zero-padded reshape sums."""
    from .tile_change import dilate
    h, w = cur.shape
    ty, tx = -(-h // tile), -(-w // tile)
    d = cur.double() - prev.double()
    pad = (0, tx * tile - w, 0, ty * tile - h)
    sq = F.pad(d * d, pad).reshape(ty, tile, tx, tile)
    area = F.pad(torch.ones_like(d), pad).reshape(ty, tile, tx, tile)
    scores = sq.sum(dim=(1, 3)) / torch.clamp(area.sum(dim=(1, 3)), min=1.0)
    if exact:
        changed = F.pad(d != 0.0, pad).reshape(ty, tile, tx, tile).any(
            dim=3).any(dim=1)
    else:
        changed = scores > threshold
    return dilate(changed, halo), scores.float()


def changed_window_map_ref(changed: torch.Tensor, ty0, ty1, tx0, tx1,
                           valid: torch.Tensor) -> torch.Tensor:
    """Flat window mask via explicit range-indicator integer matmuls."""
    ty, tx = changed.shape
    ar_y = torch.arange(ty, device=changed.device)
    ar_x = torch.arange(tx, device=changed.device)
    ry = ((ar_y[None, :] >= ty0.long()[:, None])
          & (ar_y[None, :] <= ty1.long()[:, None])).long()
    rx = ((ar_x[None, :] >= tx0.long()[:, None])
          & (ar_x[None, :] <= tx1.long()[:, None])).long()
    cnt = ry @ changed.long() @ rx.T
    return (cnt > 0).reshape(-1) & valid
