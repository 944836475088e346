"""Image pyramid (paper section 4, Fig. 7): the window stays 24x24 and the
image is downscaled by ``scale_factor`` with nearest-neighbour
interpolation until it no longer holds a window.  The plan and the index
arithmetic are numpy, index-equal to ``repro.core.pyramid``; the resize is
a tensor gather on the image's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .cascade import WINDOW

__all__ = ["PyramidLevel", "pyramid_plan", "downscale_indices",
           "downscale_nearest", "build_pyramid"]


class PyramidLevel(NamedTuple):
    height: int
    width: int
    scale: float  # original_size / level_size


def pyramid_plan(height: int, width: int, scale_factor: float = 1.2,
                 min_size: int = WINDOW) -> list[PyramidLevel]:
    """Host-side plan of the pyramid's level shapes."""
    levels: list[PyramidLevel] = []
    s = 1.0
    while True:
        h = int(math.floor(height / s))
        w = int(math.floor(width / s))
        if h < min_size or w < min_size:
            break
        levels.append(PyramidLevel(h, w, s))
        s *= scale_factor
    return levels


def downscale_indices(src: int, dst: int) -> np.ndarray:
    """Nearest-neighbour source index per destination pixel: the one
    definition of the resize arithmetic, shared by every path."""
    return (np.arange(dst) * src) // dst


def downscale_nearest(img: torch.Tensor, out_h: int, out_w: int
                      ) -> torch.Tensor:
    """Nearest-neighbour resize of the last two dims of ``img``."""
    h, w = img.shape[-2:]
    ys = torch.as_tensor(downscale_indices(h, out_h), device=img.device)
    xs = torch.as_tensor(downscale_indices(w, out_w), device=img.device)
    return img[..., ys[:, None], xs[None, :]]


def build_pyramid(img: torch.Tensor, scale_factor: float = 1.2,
                  min_size: int = WINDOW
                  ) -> list[tuple[torch.Tensor, PyramidLevel]]:
    """Every level of ``img``'s pyramid with its plan entry:
    ``[(downscaled image, PyramidLevel), ...]``."""
    plan = pyramid_plan(img.shape[-2], img.shape[-1], scale_factor, min_size)
    return [(downscale_nearest(img, lv.height, lv.width), lv) for lv in plan]
