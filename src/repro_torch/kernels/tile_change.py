"""Device-side temporal tile planning: change scoring and window mapping.

The port of ``repro.kernels.tile_change`` (two jnp functions in the
reference, not Pallas kernels), in plain PyTorch on the frame's device, so
the device-resident stream step (:meth:`repro_torch.stream.StreamEngine
.stream_step`) plans a frame without a host round trip:

- :func:`tile_change_mask_kernel`: per-tile mean squared change from the
  SAT of the squared frame delta (four corner lookups per tile), the exact
  or thresholded changed mask, and ``halo`` rounds of 4-neighbour dilation;
- :func:`changed_window_map_kernel`: the changed-tile to window range-OR
  of one pyramid level, an integer SAT over the tile mask read through the
  plan's per-window tile brackets.

Geometry never originates here: the brackets and window-limit masks come
from :func:`repro_torch.plan.compile_stream_plan`.  With ``exact=True``
the changed test is a per-tile any-reduction of ``delta != 0``, exact on
every device.  The delta, its square and the SAT are float64, as in the
host planner (:func:`repro_torch.stream.tiles.tile_change_scores`), so a
positive threshold classifies a tile as the host does up to the order of
the float64 sums; the returned scores are rounded to float32, the width of
the stream's drift state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["tile_change_mask_kernel", "changed_window_map_kernel",
           "range_any", "dilate"]


def dilate(changed: torch.Tensor, halo: int) -> torch.Tensor:
    """``halo`` rounds of 4-neighbour dilation of a boolean tile grid."""
    for _ in range(halo):
        grown = changed.clone()
        grown[1:, :] |= changed[:-1, :]
        grown[:-1, :] |= changed[1:, :]
        grown[:, 1:] |= changed[:, :-1]
        grown[:, :-1] |= changed[:, 1:]
        changed = grown
    return changed


def tile_change_mask_kernel(prev: torch.Tensor, cur: torch.Tensor,
                            threshold: float, *, tile: int, halo: int = 0,
                            exact: bool = True
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(changed, scores)`` over the tile grid of ``cur`` vs ``prev``.

    ``changed`` (ty, tx) bool is the dilated mask (any pixel differs when
    ``exact``, else ``score > threshold``); ``scores`` (ty, tx) float32 the
    mean squared pixel change per tile.  Partial edge tiles divide by their
    true area, like the host path.
    """
    h, w = cur.shape
    ty, tx = -(-h // tile), -(-w // tile)
    d = cur.double() - prev.double()
    sat = F.pad(torch.cumsum(torch.cumsum(d * d, 0), 1), (1, 0, 1, 0))
    ys = torch.clamp(torch.arange(ty + 1, device=cur.device) * tile, max=h)
    xs = torch.clamp(torch.arange(tx + 1, device=cur.device) * tile, max=w)
    corners = sat[ys[:, None], xs[None, :]]
    sums = (corners[1:, 1:] - corners[:-1, 1:]
            - corners[1:, :-1] + corners[:-1, :-1])
    areas = (torch.diff(ys)[:, None] * torch.diff(xs)[None, :]).double()
    scores = sums / torch.clamp(areas, min=1.0)
    if exact:
        nz = F.pad(d != 0.0, (0, tx * tile - w, 0, ty * tile - h))
        changed = nz.reshape(ty, tile, tx, tile).any(dim=3).any(dim=1)
    else:
        changed = scores > threshold
    return dilate(changed, halo), scores.float()


def range_any(changed: torch.Tensor, ty0: torch.Tensor, ty1: torch.Tensor,
              tx0: torch.Tensor, tx1: torch.Tensor) -> torch.Tensor:
    """Whether any tile of ``changed`` lies in the closed tile ranges
    ``[ty0, ty1] x [tx0, tx1]`` (bracket tensors broadcast together), from
    an integer SAT over the changed tiles: exact, four lookups a range."""
    sat = F.pad(torch.cumsum(torch.cumsum(changed.to(torch.int32), 0,
                                          dtype=torch.int32), 1,
                             dtype=torch.int32), (1, 0, 1, 0))
    y1, x1 = ty1.long() + 1, tx1.long() + 1
    y0, x0 = ty0.long(), tx0.long()
    return (sat[y1, x1] - sat[y0, x1] - sat[y1, x0] + sat[y0, x0]) > 0


def changed_window_map_kernel(changed: torch.Tensor, ty0: torch.Tensor,
                              ty1: torch.Tensor, tx0: torch.Tensor,
                              tx1: torch.Tensor, valid: torch.Tensor
                              ) -> torch.Tensor:
    """Flat (ny*nx,) bool mask of windows overlapping a changed tile.

    ``ty0/ty1`` (ny,) and ``tx0/tx1`` (nx,) are the closed tile-range
    brackets of each window origin's receptive field; ``valid`` is the flat
    window-limit mask.  The range-OR is :func:`range_any`, the arithmetic
    of the host :func:`repro_torch.stream.tiles.changed_window_mask`; the
    stream step reads every level at once through it, with the brackets
    flattened per window.
    """
    return (range_any(changed, ty0[:, None], ty1[:, None], tx0[None, :],
                      tx1[None, :]).reshape(-1) & valid)
