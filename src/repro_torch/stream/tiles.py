"""Temporal tile grid: change scores, halo dilation, window mapping.

The host planner, copied from ``repro.stream.tiles`` (numpy only).

The paper's RIT relation (§5, Eq. 6) says cascade work tracks *image
content*; on video, content that did not change since the previous frame
cannot change any window's decision, up to the rounding of float32 SAT
entries: an entry rounds a sum over every pixel above and left of it, so
at large frame sizes a change elsewhere can move an unchanged window's
corner values (see :mod:`repro_torch.stream.video`).  This module turns a
frame delta into the set of detection windows whose own pixels changed,
the windows that must be re-evaluated:

1. the frame is covered by a grid of ``tile x tile`` cells (image coords);
2. each tile gets a *change score* — mean squared pixel change, read from
   the summed-area table of the squared frame delta (4 lookups per tile,
   one SAT pass per frame, Fig. 4 arithmetic);
3. tiles over threshold are dilated by a ``halo`` ring (hysteresis against
   flicker at tile borders — correctness never depends on it);
4. per pyramid level, a window must be recomputed iff its receptive field
   (in source coords, through the nearest-neighbour downscale map) overlaps
   a changed tile.  This is a 2-D range-OR, answered exactly with an
   *integer* SAT over the changed-tile mask.

Exactness: with ``threshold <= 0`` the change test must be "any pixel
differs".  Float SAT partial sums cannot promise that (a tiny squared delta
can be absorbed into a large cumulative sum), so the threshold-0 path uses
an exact per-tile any-reduction of ``delta != 0`` instead of the score.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import WINDOW
from repro_torch.core.pyramid import PyramidLevel

__all__ = ["tile_grid_shape", "tile_change_scores", "dilate_tiles",
           "changed_window_mask"]


def tile_grid_shape(h: int, w: int, tile: int) -> tuple[int, int]:
    """(rows, cols) of the tile grid covering an (h, w) frame."""
    return -(-h // tile), -(-w // tile)


def tile_change_scores(prev: np.ndarray, cur: np.ndarray, tile: int,
                       exact: bool = True
                       ) -> tuple[np.ndarray, np.ndarray | None]:
    """Per-tile change of ``cur`` vs ``prev``.

    Returns ``(scores, changed_any)`` over the tile grid:

    - ``scores`` — mean squared pixel change per tile, via rect sums on the
      SAT of the squared delta (the cheap, thresholdable signal);
    - ``changed_any`` — exact "some pixel in this tile differs" mask (the
      threshold-0 signal; immune to float absorption in the SAT).  Costs an
      extra full-frame compare + reduction, so callers thresholding on
      ``scores`` alone pass ``exact=False`` and get ``None``.
    """
    prev = np.asarray(prev, np.float32)
    cur = np.asarray(cur, np.float32)
    if prev.shape != cur.shape:
        raise ValueError(f"frame shape changed: {prev.shape} -> {cur.shape}")
    h, w = cur.shape
    ty, tx = tile_grid_shape(h, w, tile)
    d = cur.astype(np.float64) - prev.astype(np.float64)
    sat = np.zeros((h + 1, w + 1), np.float64)
    np.cumsum(np.cumsum(d * d, axis=0), axis=1, out=sat[1:, 1:])
    ys = np.minimum(np.arange(ty + 1) * tile, h)
    xs = np.minimum(np.arange(tx + 1) * tile, w)
    corners = sat[np.ix_(ys, xs)]
    sums = (corners[1:, 1:] - corners[:-1, 1:]
            - corners[1:, :-1] + corners[:-1, :-1])
    areas = np.outer(np.diff(ys), np.diff(xs)).astype(np.float64)
    scores = sums / np.maximum(areas, 1.0)

    if not exact:
        return scores, None
    nz = d != 0.0
    pad = np.zeros((ty * tile, tx * tile), bool)
    pad[:h, :w] = nz
    changed_any = pad.reshape(ty, tile, tx, tile).any(axis=(1, 3))
    return scores, changed_any


def dilate_tiles(mask: np.ndarray, halo: int) -> np.ndarray:
    """Chebyshev dilation of a boolean tile mask by ``halo`` rings."""
    if halo <= 0 or not mask.any():
        return mask
    out = mask.copy()
    for _ in range(halo):
        grown = out.copy()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def changed_window_mask(changed_tiles: np.ndarray, tile: int,
                        src_h: int, src_w: int, level: PyramidLevel,
                        step: int, y_lim: int, x_lim: int) -> np.ndarray:
    """Flat (ny*nx,) bool mask of windows to recompute at one pyramid level.

    A window rooted at level coords ``(y, x)`` samples source rows
    ``(r * src_h) // level_h`` for ``r in [y, y + WINDOW)`` (the
    ``downscale_indices`` map), a monotone set bracketed by its endpoints —
    so the window's source-coord receptive field is covered by the closed
    tile range ``[sy0 // tile, sy1 // tile]``.  The window is marked iff any
    tile in that range is changed, answered with an integer SAT over the
    changed-tile mask (exact; conservative only through the bracketing).

    ``src_h``/``src_w`` are the *padded* source dims the pyramid was planned
    on; ``y_lim``/``x_lim`` are the inclusive max window origins from
    ``repro_torch.plan.window_limits`` (windows past them are never live
    in the baseline engine, so they are never recomputed here either).
    """
    ny = (level.height - WINDOW) // step + 1
    nx = (level.width - WINDOW) // step + 1
    ty, tx = changed_tiles.shape
    if not changed_tiles.any():
        return np.zeros(ny * nx, bool)

    sat = np.zeros((ty + 1, tx + 1), np.int64)
    np.cumsum(np.cumsum(changed_tiles.astype(np.int64), axis=0), axis=1,
              out=sat[1:, 1:])

    def tile_range(origins: np.ndarray, level_dim: int, src_dim: int,
                   n_tiles: int) -> tuple[np.ndarray, np.ndarray]:
        s0 = (origins * src_dim) // level_dim
        s1 = ((origins + WINDOW - 1) * src_dim) // level_dim
        t0 = np.clip(s0 // tile, 0, n_tiles - 1)
        t1 = np.clip(s1 // tile, 0, n_tiles - 1)
        return t0, t1

    oy = np.arange(ny, dtype=np.int64) * step
    ox = np.arange(nx, dtype=np.int64) * step
    ty0, ty1 = tile_range(oy, level.height, src_h, ty)
    tx0, tx1 = tile_range(ox, level.width, src_w, tx)
    cnt = (sat[np.ix_(ty1 + 1, tx1 + 1)] - sat[np.ix_(ty0, tx1 + 1)]
           - sat[np.ix_(ty1 + 1, tx0)] + sat[np.ix_(ty0, tx0)])
    mask = cnt > 0
    mask &= (oy <= y_lim)[:, None] & (ox <= x_lim)[None, :]
    return mask.reshape(-1)
