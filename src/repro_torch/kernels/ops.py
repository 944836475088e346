"""Public wrappers over the port's kernels, at natural shapes.

Each wrapper takes CUDA tensors to its hand-written kernel and CPU tensors
to that kernel's plain PyTorch version; any other device raises.  Callers
never see padding or launch shapes.  Every public wrapper has a ``*_ref``
twin over :mod:`repro_torch.kernels.ref` (the reference oracles' plain
twins), which agrees with it bit for bit where the arithmetic is the same
(the packed tail) and to the reference's tolerances where it is not (the
dense heads combine corners as ``(d - b) - (c - a)``).

Kernels and what they port:

- S  ``sat_tables``                 <- ``integral_image_kernel`` + the SAT
                                        build of ``_fused_kernel``
- A  ``fused_head(_batch)``          <- ``fused_head_kernel`` (S, then A)
- B  ``dense_stage_sums(_batch)``    <- ``haar_stage_sums_kernel``
- C  ``packed_stage_sums``           <- ``packed_stage_sums_kernel``
- D  ``window_inv_sigma_grid(_batch)`` <- ``window_inv_sigma_kernel``
- E  ``tail_gate_counts``           <- no TPU kernel: the batch program's
                                        per-stage gate and per-image
                                        scatter-add of the packed tail

and the stream's two tile-planning functions, which are jnp in the
reference (``repro.kernels.tile_change``) and plain PyTorch here, on the
frame's device: ``tile_change_mask`` and ``changed_window_map``.

``integral_image(_batch)`` run kernel S and return its first table (the
padded SAT of the image), as the reference's ``integral_image_kernel``
wrappers do.  The dense heads take the plan's ``head_tile`` as ``tile``
(the reference's keyword), which shapes kernels A and B's launch
(:func:`repro_torch.kernels.haar_stage.head_block_shape`) and never the
sums; their twins take none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.cascade import Cascade
from repro_torch.core.integral import CENTRE

from . import fused_head as _fused
from . import haar_stage as _haar
from . import packed_window as _packed
from . import ref
from . import tail_gates as _gates
from . import tile_change as _tc
from . import window_variance as _wv
from .autotune import DEFAULT_TILE
from .integral_image import sat_tables
from .native import launches, reset_launches

__all__ = ["sat_tables", "sat_tables_ref",
           "integral_image", "integral_image_ref",
           "integral_image_batch", "integral_image_batch_ref",
           "window_inv_sigma_grid", "window_inv_sigma_grid_ref",
           "window_inv_sigma_grid_batch", "window_inv_sigma_grid_batch_ref",
           "fused_head", "fused_head_ref",
           "fused_head_batch", "fused_head_batch_ref",
           "dense_stage_sums", "dense_stage_sums_ref",
           "dense_stage_sums_batch", "dense_stage_sums_batch_ref",
           "packed_stage_sums", "packed_stage_sums_ref",
           "tail_gate_counts", "tail_gate_counts_ref",
           "tile_change_mask", "tile_change_mask_ref",
           "changed_window_map", "changed_window_map_ref",
           "launches", "reset_launches"]


def _run_params(cascade: Cascade, s0: int, s1: int):
    """The weak-classifier arrays of stages ``[s0, s1)`` and their stage
    boundaries relative to the run's first classifier."""
    b = cascade.bounds
    k0, k1 = b[s0], b[s1]
    rel = tuple(v - k0 for v in b[s0:s1 + 1])
    arrays = (cascade.rect_xywh[k0:k1], cascade.rect_w[k0:k1],
              cascade.wc_threshold[k0:k1], cascade.left_val[k0:k1],
              cascade.right_val[k0:k1])
    return arrays, rel


# ------------------------------------------------------------------ SAT (S)
def sat_tables_ref(imgs: torch.Tensor):
    """Oracle twin of :func:`sat_tables`."""
    img = imgs.to(torch.float32)
    centred = img - CENTRE
    return tuple(F.pad(ref.integral_image_ref(t), (1, 0, 1, 0))
                 for t in (img, centred * centred, centred))


def integral_image_batch(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H+1, W+1) padded SATs (kernel S's first table)."""
    return sat_tables(imgs)[0]


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Padded SAT (H+1, W+1) of one (H, W) image."""
    return integral_image_batch(img[None])[0]


def integral_image_batch_ref(imgs: torch.Tensor) -> torch.Tensor:
    """Oracle twin of :func:`integral_image_batch`."""
    return F.pad(ref.integral_image_ref(imgs), (1, 0, 1, 0))


integral_image_ref = integral_image_batch_ref


# ------------------------------------------------------------ 1/sigma (D)
def window_inv_sigma_grid_batch(ii_pairs: torch.Tensor, ny: int,
                                nx: int) -> torch.Tensor:
    """(B, ny, nx) 1/sigma grids from stacked (B, 2, H+1, W+1) ``(ii2,
    iic)`` SAT pairs; ``ny`` / ``nx`` may reach past the tables (edge
    clamp)."""
    return _wv.inv_sigma_grid(ii_pairs[:, 0], ii_pairs[:, 1], ny, nx)


def window_inv_sigma_grid(ii_pair: torch.Tensor, ny: int,
                          nx: int) -> torch.Tensor:
    """(ny, nx) 1/sigma grid from one stacked (2, H+1, W+1) pair."""
    return window_inv_sigma_grid_batch(ii_pair[None], ny, nx)[0]


def window_inv_sigma_grid_batch_ref(ii_pairs: torch.Tensor, ny: int,
                                    nx: int) -> torch.Tensor:
    """Oracle twin of :func:`window_inv_sigma_grid_batch`."""
    return ref.window_inv_sigma_ref(ii_pairs[:, 0], ii_pairs[:, 1], ny, nx)


def window_inv_sigma_grid_ref(ii_pair: torch.Tensor, ny: int,
                              nx: int) -> torch.Tensor:
    """Oracle twin of :func:`window_inv_sigma_grid`."""
    return ref.window_inv_sigma_ref(ii_pair[0], ii_pair[1], ny, nx)


# ---------------------------------------------------------------- fused (A)
def fused_head_batch(cascade: Cascade, s0: int, s1: int,
                     imgs: torch.Tensor, tile=DEFAULT_TILE):
    """Fused dense head for stages ``[s0, s1)`` over a (B, H, W) stack:
    ``(ii (B, H+1, W+1), inv (B, ny, nx), sums (B, s1-s0, ny, nx))``.
    Kernel S builds the SATs, kernel A does the tile pass in ``tile``."""
    ii, ii2, iic = sat_tables(imgs)
    inv, sums = _fused.tile_pass(cascade, s0, s1, ii, ii2, iic, tile)
    return ii, inv, sums


def fused_head(cascade: Cascade, s0: int, s1: int, img: torch.Tensor,
               tile=DEFAULT_TILE):
    """:func:`fused_head_batch` of one (H, W) image."""
    ii, inv, sums = fused_head_batch(cascade, s0, s1, img[None], tile)
    return ii[0], inv[0], sums[0]


def fused_head_batch_ref(cascade: Cascade, s0: int, s1: int,
                         imgs: torch.Tensor):
    """Oracle twin of :func:`fused_head_batch`."""
    arrays, rel = _run_params(cascade, s0, s1)
    return ref.fused_head_batch_ref(*arrays, rel, imgs)


def fused_head_ref(cascade: Cascade, s0: int, s1: int, img: torch.Tensor):
    """Oracle twin of :func:`fused_head`."""
    arrays, rel = _run_params(cascade, s0, s1)
    return ref.fused_head_ref(*arrays, rel, img)


# ---------------------------------------------------------------- dense (B)
def dense_stage_sums_batch(cascade: Cascade, s: int, ii: torch.Tensor,
                           inv_sigma_grid: torch.Tensor,
                           tile=DEFAULT_TILE) -> torch.Tensor:
    """(B, ny, nx) stage-``s`` sums from (B, H+1, W+1) SATs and (B, ny, nx)
    1/sigma grids, kernel B launched in ``tile``."""
    return _haar.stage_sums(cascade, s, ii, inv_sigma_grid, tile)


def dense_stage_sums(cascade: Cascade, s: int, ii: torch.Tensor,
                     inv_sigma_grid: torch.Tensor,
                     tile=DEFAULT_TILE) -> torch.Tensor:
    """:func:`dense_stage_sums_batch` of one (H+1, W+1) SAT."""
    return _haar.stage_sums(cascade, s, ii[None], inv_sigma_grid[None],
                            tile)[0]


def dense_stage_sums_ref(cascade: Cascade, s: int, ii: torch.Tensor,
                         inv_sigma_grid: torch.Tensor) -> torch.Tensor:
    """Oracle twin of :func:`dense_stage_sums`."""
    arrays, _rel = _run_params(cascade, s, s + 1)
    return ref.dense_stage_sums_ref(*arrays, ii, inv_sigma_grid)


dense_stage_sums_batch_ref = dense_stage_sums_ref


# --------------------------------------------------------------- packed (C)
def packed_stage_sums(cascade: Cascade, s0: int, s1: int,
                      ii_flat: torch.Tensor, img: torch.Tensor,
                      base: torch.Tensor, stride: torch.Tensor,
                      ys: torch.Tensor, xs: torch.Tensor,
                      inv_sigma: torch.Tensor) -> torch.Tensor:
    """(s1 - s0, cap) stage sums over a packed window list (int32 lanes)."""
    return _packed.stage_sums(cascade, s0, s1, ii_flat, img, base, stride,
                              ys, xs, inv_sigma)


def packed_stage_sums_ref(cascade: Cascade, s0: int, s1: int,
                          ii_flat: torch.Tensor, img: torch.Tensor,
                          base: torch.Tensor, stride: torch.Tensor,
                          ys: torch.Tensor, xs: torch.Tensor,
                          inv_sigma: torch.Tensor) -> torch.Tensor:
    """Oracle twin of :func:`packed_stage_sums`."""
    b = cascade.bounds
    rel = tuple(v - b[s0] for v in b[s0:s1 + 1])
    return ref.packed_stage_sums_ref(
        cascade.rect_xywh, cascade.rect_w, cascade.wc_threshold,
        cascade.left_val, cascade.right_val, b[s0], rel, ii_flat, img, base,
        stride, ys, xs, inv_sigma)


# ------------------------------------------------------ tail gates (E)
def tail_gate_counts(ss_run: torch.Tensor, thr: torch.Tensor,
                     valid: torch.Tensor, b_sel: torch.Tensor,
                     n_live: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    """Gate the (cap,) ``valid`` mask by a segment's (k, cap) stage sums
    and (k,) thresholds, and add each image's survivors after each stage
    to the int32 (k, B) ``counts`` (both in place; returns ``valid``).
    ``n_live`` is the compaction's live count, a 0-dim int64 tensor on the
    lanes' device; lanes at or past it must be invalid on entry."""
    return _gates.gate_counts(ss_run, thr, valid, b_sel, n_live, counts)


def tail_gate_counts_ref(ss_run: torch.Tensor, thr: torch.Tensor,
                         valid: torch.Tensor, b_sel: torch.Tensor,
                         n_live: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Oracle twin of :func:`tail_gate_counts`."""
    return ref.tail_gate_counts_ref(ss_run, thr, valid, b_sel, n_live,
                                    counts)


# ------------------------------------------------------- stream tile planning
def tile_change_mask(prev: torch.Tensor, cur: torch.Tensor,
                     threshold: float = 0.0, *, tile: int, halo: int = 0,
                     exact: bool = True):
    """(changed, scores) tile grids of ``cur`` vs ``prev``: the device
    twin of the host ``tile_change_scores`` + ``dilate_tiles`` pair."""
    return _tc.tile_change_mask_kernel(prev, cur, threshold, tile=tile,
                                       halo=halo, exact=exact)


def tile_change_mask_ref(prev: torch.Tensor, cur: torch.Tensor,
                         threshold: float = 0.0, *, tile: int, halo: int = 0,
                         exact: bool = True):
    """Oracle twin of :func:`tile_change_mask`."""
    return ref.tile_change_mask_ref(prev, cur, threshold, tile=tile,
                                    halo=halo, exact=exact)


def changed_window_map(changed: torch.Tensor, ty0: torch.Tensor,
                       ty1: torch.Tensor, tx0: torch.Tensor,
                       tx1: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Flat per-level window recompute mask from a changed-tile grid and
    the plan's tile-range brackets: the device twin of the host
    ``changed_window_mask``."""
    return _tc.changed_window_map_kernel(changed, ty0, ty1, tx0, tx1, valid)


def changed_window_map_ref(changed: torch.Tensor, ty0: torch.Tensor,
                           ty1: torch.Tensor, tx0: torch.Tensor,
                           tx1: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """Oracle twin of :func:`changed_window_map`."""
    return ref.changed_window_map_ref(changed, ty0, ty1, tx0, tx1, valid)
