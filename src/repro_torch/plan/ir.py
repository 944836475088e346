"""Typed cascade-plan IR, copied from ``repro.plan.ir`` (numpy only).

The port keeps its own copy so it never imports the reference package;
plans must stay equal to the reference's field by field.

The *model* of one cascade workload.

The paper's scheduling story rests on a model of the cascade's work that
is computed once and consumed by executors (CATS-style cost models lifted
out of the worker loop).  These types are that model for our engines:

- :class:`LevelPlan` — one pyramid level's static geometry (shape, window
  grid, flat-slot and flat-SAT placement);
- :class:`SegmentPlan` — one run of cascade stages and, for compacted tail
  segments, the survivor capacity entering the run plus the packed-tail
  backend chosen for that capacity;
- :class:`SlotLayout` — the flat slot / SAT layout over an (optionally
  subset) tuple of levels: the index tables every packed program gathers
  through, plus the subset→full slot mapping host code merges bitmaps with;
- :class:`CascadePlan` — the whole compiled plan for one (bucket, batch,
  level subset, capacity rung): levels + segments + layout, with a
  hashable ``key`` that *is* the jit-cache identity of the program built
  from it;
- :class:`LevelWavePlan` — the single-image per-level wave program's plan
  (dense window grid, per-compaction capacity ladder).

Everything here is derived data; :mod:`repro_torch.plan.compiler` is the
only producer.  Executors (``Detector._build_level_fn``,
``Detector._build_batch_fn``, ``StreamEngine._build_fn``) consume these
objects and derive nothing themselves.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["LevelPlan", "SegmentPlan", "SlotLayout", "CascadePlan",
           "LevelWavePlan", "StreamStatePlan"]


class LevelPlan(NamedTuple):
    """Static geometry of one pyramid level inside a bucket's plan."""
    index: int          # position in the bucket's full pyramid plan
    height: int
    width: int
    scale: float        # original_size / level_size
    ny: int             # window-grid rows ((h - WINDOW) // step + 1)
    nx: int             # window-grid cols
    slot_offset: int    # first flat slot of this level in the *full* layout

    @property
    def n_windows(self) -> int:
        return self.ny * self.nx

    @property
    def sat_size(self) -> int:
        return (self.height + 1) * (self.width + 1)

    @property
    def sat_stride(self) -> int:
        return self.width + 1


class SegmentPlan(NamedTuple):
    """A run of cascade stages ``[s0, s1)`` executed as one unit."""
    s0: int
    s1: int
    dense: bool         # dense full-grid wave vs compacted packed tail
    capacity: int = 0   # survivor capacity entering the segment (tail only)
    backend: str = ""   # packed-tail backend for that capacity (tail only;
    #                     the single-image wave tail runs on the dense grid
    #                     and carries no backend)

    @property
    def depth(self) -> int:
        """Cascade stages this segment evaluates per live lane."""
        return self.s1 - self.s0


class SlotLayout:
    """Flat slot / SAT layout over an active subset of pyramid levels.

    ``slot_indices`` maps each layout slot back to the full-layout flat
    slot id (the identity mapping when every level is active), so cached
    per-level bitmaps merge on host.  ``sat_base_of_lvl`` is addressed by
    *original* level id; inactive levels keep base 0 — no layout slot
    refers to them, so the value never feeds a gather.
    """

    def __init__(self, levels_all: tuple[LevelPlan, ...],
                 active: tuple[int, ...], step: int):
        self.active = active
        parts = [np.arange(levels_all[li].slot_offset,
                           levels_all[li].slot_offset
                           + levels_all[li].n_windows, dtype=np.int64)
                 for li in active]
        self.slot_indices = (np.concatenate(parts) if parts
                             else np.zeros(0, np.int64))
        self.n_slots = int(self.slot_indices.shape[0])
        lvl_parts, y_parts, x_parts = [], [], []
        for li in active:
            lp = levels_all[li]
            gy = np.arange(lp.ny, dtype=np.int32) * step
            gx = np.arange(lp.nx, dtype=np.int32) * step
            lvl_parts.append(np.full(lp.n_windows, li, np.int32))
            y_parts.append(np.repeat(gy, lp.nx))
            x_parts.append(np.tile(gx, lp.ny))
        self.lvl_of_slot = (np.concatenate(lvl_parts) if lvl_parts
                            else np.zeros(0, np.int32))
        self.y_of_slot = (np.concatenate(y_parts) if y_parts
                          else np.zeros(0, np.int32))
        self.x_of_slot = (np.concatenate(x_parts) if x_parts
                          else np.zeros(0, np.int32))
        sizes = [levels_all[li].sat_size for li in active]
        bases = (np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
                 if active else np.zeros(0, np.int32))
        self.sat_base_of_lvl = np.zeros(max(len(levels_all), 1), np.int32)
        for li, b in zip(active, bases):
            self.sat_base_of_lvl[li] = b
        self.sat_stride_of_lvl = np.asarray(
            [lp.sat_stride for lp in levels_all], np.int32)


class CascadePlan:
    """One compiled plan: everything a packed cascade program needs.

    ``key`` is the hashable identity of the plan (and therefore of the
    program built from it) — two calls that compile the same key must
    reuse the same program.  ``levels`` are the *active* levels (the full
    pyramid unless a subset was requested); ``segments`` carry the
    per-segment capacities and tail backends; ``layout`` is the flat
    slot / SAT layout over the active levels.
    """

    __slots__ = ("key", "hp", "wp", "batch", "step", "levels_all", "active",
                 "levels", "segments", "capacities", "layout", "head_modes",
                 "head_tile", "lane_block")

    def __init__(self, key: tuple, hp: int, wp: int, batch: int, step: int,
                 levels_all: tuple[LevelPlan, ...], active: tuple[int, ...],
                 segments: tuple[SegmentPlan, ...],
                 capacities: tuple[int, ...], layout: SlotLayout,
                 head_modes: tuple[str, ...] = (),
                 head_tile: tuple[int, ...] = (),
                 lane_block: tuple[int, ...] = ()):
        self.key = key
        self.hp, self.wp = hp, wp
        self.batch = batch
        self.step = step
        self.levels_all = levels_all
        self.active = active
        self.levels = tuple(levels_all[li] for li in active)
        self.segments = segments
        self.capacities = capacities
        self.layout = layout
        # per-active-level dense-head execution mode ("fused": kernels S +
        # A; "split": S, plain 1/sigma, kernel B per stage) plus the tuned
        # tile shapes the executors pass straight to the kernels; defaults
        # mean "split with package-default tiles" so pre-head-mode
        # constructors stay valid
        self.head_modes = (head_modes if head_modes
                           else ("split",) * len(self.levels))
        self.head_tile = head_tile
        self.lane_block = lane_block

    @property
    def n_slots(self) -> int:
        """Flat slots of the *active* layout (== full count when all
        levels are active)."""
        return self.layout.n_slots

    @property
    def n_windows_total(self) -> int:
        """Window count of the full pyramid (all levels, active or not)."""
        return sum(lp.n_windows for lp in self.levels_all)

    @property
    def work_units(self) -> int:
        """Modeled evaluation cost of the whole plan: lanes × stage depth
        summed over segments.  Dense segments sweep every slot of the batch
        for their stage run; a compacted tail segment evaluates at most its
        survivor ``capacity`` lanes per stage.  This is the cost weight the
        serving scheduler and energy governor shard and budget by — a deep
        tail costs more than its window count alone suggests, and two
        buckets of equal window count but different segmentation cost
        differently."""
        dense_lanes = self.n_slots * self.batch
        total = 0
        for seg in self.segments:
            lanes = dense_lanes if seg.dense else min(seg.capacity,
                                                      dense_lanes)
            total += lanes * seg.depth
        return max(total, 1)

    @property
    def dense_prefix(self) -> int:
        return sum(s.s1 - s.s0 for s in self.segments if s.dense)

    @property
    def tail_segments(self) -> tuple[SegmentPlan, ...]:
        return tuple(s for s in self.segments if not s.dense)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, CascadePlan) and self.key == other.key

    def __repr__(self):
        return (f"CascadePlan(hp={self.hp}, wp={self.wp}, batch={self.batch},"
                f" levels={len(self.levels)}/{len(self.levels_all)},"
                f" n_slots={self.n_slots}, segments={self.segments})")


class LevelWavePlan(NamedTuple):
    """Plan of the single-image per-level wave program: dense window grid
    plus the per-compaction capacity ladder (fractions of *this* level's
    window count — the batched engine instead shares
    :attr:`CascadePlan.capacities` across the whole stack).  ``head_mode``
    is this level's dense-head execution choice ("fused": kernels S +
    A; "split": S, plain 1/sigma, kernel B per stage) and
    ``head_tile`` the tuned tile shape the executor hands the kernel
    (empty = package default)."""
    key: tuple
    height: int
    width: int
    step: int
    ny: int
    nx: int
    segments: tuple[SegmentPlan, ...]
    capacities: tuple[int, ...]
    head_mode: str = "split"
    head_tile: tuple = ()

    @property
    def n_windows(self) -> int:
        return self.ny * self.nx


class StreamStatePlan:
    """Compiler-owned geometry of the device-resident stream step.

    Everything the stream step (ported with the streaming slice) needs
    beyond a :class:`CascadePlan`: the tile grid covering the true (h, w) frame inside its (hp, wp)
    bucket, the per-level closed tile-range brackets of each window
    origin's receptive field (the host ``changed_window_mask``'s
    ``tile_range`` tables, precomputed), the flat window-limit mask, the
    live-window count the full-refresh fraction is measured against, and
    the static capacity of the decoded-survivor slot list shipped back
    to host each frame.  ``key`` is the plan's hashable identity — with
    the evaluation rung and exactness flag it keys the compiled step
    program.  :func:`repro_torch.plan.compile_stream_plan` is the
    only producer.
    """

    __slots__ = ("key", "hp", "wp", "h", "w", "tile", "halo", "ty", "tx",
                 "level_tile_ranges", "limit_mask", "n_live", "n_slots",
                 "decode_cap")

    def __init__(self, key: tuple, hp: int, wp: int, h: int, w: int,
                 tile: int, halo: int, ty: int, tx: int,
                 level_tile_ranges: tuple, limit_mask: np.ndarray,
                 n_live: int, n_slots: int, decode_cap: int):
        self.key = key
        self.hp, self.wp = hp, wp
        self.h, self.w = h, w
        self.tile, self.halo = tile, halo
        self.ty, self.tx = ty, tx
        # per level: (ty0, ty1, tx0, tx1) int32 closed tile-range brackets
        self.level_tile_ranges = level_tile_ranges
        self.limit_mask = limit_mask          # flat (n_slots,) bool
        self.n_live = n_live
        self.n_slots = n_slots
        self.decode_cap = decode_cap

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, StreamStatePlan) and self.key == other.key

    def __repr__(self):
        return (f"StreamStatePlan(hp={self.hp}, wp={self.wp}, h={self.h}, "
                f"w={self.w}, tile={self.tile}, halo={self.halo}, "
                f"grid=({self.ty}, {self.tx}), n_slots={self.n_slots}, "
                f"n_live={self.n_live}, decode_cap={self.decode_cap})")
