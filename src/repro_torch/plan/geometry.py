"""Host-side geometry views over a bucket's :class:`CascadePlan`, copied
from ``repro.plan.geometry``.

:class:`StreamGeometry` is the streaming layer's handle on one shape
bucket: the pyramid plan, per-level window grids, flat slot layout, window
limits for a true (unpadded) frame shape, and cached
:class:`~repro_torch.plan.ir.SlotLayout` views over active level subsets.
It reads everything off :func:`compile_plan` and :func:`window_limits`
and computes no geometry of its own, so host code (tile-to-window mapping,
bitmap merging) reads the plan without touching the executors.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.pyramid import PyramidLevel

from .compiler import compile_plan, window_limits
from .ir import SlotLayout

__all__ = ["StreamGeometry", "LevelSubset"]

# the subset slot/SAT layout *is* the generic plan layout
LevelSubset = SlotLayout


class StreamGeometry:
    """Static per-bucket geometry shared by host planning and the stream
    executors: pyramid plan, per-level window grids, flat slot layout, SAT
    layout, all read off the bucket's compiled :class:`CascadePlan`."""

    def __init__(self, detector, hp: int, wp: int):
        cfg = detector.config
        base = compile_plan(cfg, detector.n_stages, hp, wp)
        self.base_plan = base
        self.hp, self.wp = hp, wp
        self.step = cfg.step
        self._config = cfg
        self._n_stages = detector.n_stages
        self.plan = [PyramidLevel(lp.height, lp.width, lp.scale)
                     for lp in base.levels_all]
        self.level_windows = [(lp.ny, lp.nx) for lp in base.levels_all]
        self.slot_offsets = [0] + [lp.slot_offset + lp.n_windows
                                   for lp in base.levels_all]
        self.n_slots = base.n_slots
        self.sat_sizes = [lp.sat_size for lp in base.levels_all]
        layout = base.layout
        self.lvl_of_slot = layout.lvl_of_slot
        self.y_of_slot = layout.y_of_slot
        self.x_of_slot = layout.x_of_slot
        self.sat_base_of_lvl = layout.sat_base_of_lvl
        self.sat_stride_of_lvl = layout.sat_stride_of_lvl

    def limits(self, h: int, w: int) -> list[tuple[int, int]]:
        """Per-level inclusive (y_lim, x_lim) for a true (h, w) frame."""
        return [window_limits(h, w, lp.height, lp.width, self.hp, self.wp)
                for lp in self.base_plan.levels_all]

    def split_levels(self, flat: np.ndarray) -> list[np.ndarray]:
        """Flat (n_slots,) per-window array -> one array per level."""
        return [flat[self.slot_offsets[li]:self.slot_offsets[li + 1]]
                for li in range(len(self.plan))]

    def subset(self, levels: tuple[int, ...]) -> SlotLayout:
        """Flat layout over an active level subset (sorted ids); cached by
        the plan compiler, so repeated calls return the same object."""
        return compile_plan(self._config, self._n_stages, self.hp, self.wp,
                            levels=tuple(levels)).layout
