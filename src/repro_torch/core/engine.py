"""Detection engine: thin executors over compiled plans, in PyTorch.

The port of ``repro.core.engine``.  The cascade semantics, the plans
(:mod:`repro_torch.plan`), the configuration and the results are the
reference's; the execution is eager PyTorch on one device, with the dense
heads and the packed tail on the port's CUDA kernels:

- the dense head of each pyramid level is either *fused* (kernel S builds
  the three SATs, kernel A computes 1/sigma and every dense stage's sums)
  or *split* (kernel S, then plain-torch 1/sigma, then kernel B once per
  dense stage), as the plan chose; both take their SATs from kernel S, so
  they give the same bits;
- survivors are compacted into static-capacity lists (the reference's
  ``jnp.nonzero(size=cap, fill_value=-1)``: the first ``cap`` survivors in
  ascending index, ``-1`` fill, an overflow flag) without a host sync;
- each compacted tail segment runs through
  :func:`repro_torch.kernels.packed_tail.stage_sums` with the plan's
  backend (``"pallas"`` = kernel C, launched in the plan's ``lane_block``)
  and the compaction's live count, so kernel C skips the ``-1`` fill;
  in ``detect_batch`` kernel E (:func:`repro_torch.kernels.ops
  .tail_gate_counts`) then gates the segment's lanes by its stages and
  counts each image's survivors, over the live prefix only.

``detect_batch`` (packed strategy) shares one compaction across every
image and pyramid level of a flush and reads the device once, for the
overflow flag, before decoding.  ``detect`` runs the same level program
as ``detect_batch(strategy="vmap")`` with a batch of one, so both are
equal to ``detect_batch`` image by image.  The single-image tail, which the
reference evaluates with the gather oracle, goes through the packed-tail
evaluator with the backend the plan layer picks for its capacity; every
backend gives the oracle's bits.

Executors are built once per ``plan.key`` (``program_builds`` counts the
builds); their index tables go to the device once, at build time.
``h2d_bytes`` and ``d2h_bytes`` count the bytes of every copy the detector
makes between host and device, at the copy, whatever the device (so a CPU
detector counts what a card's would).  ``detect_batch``'s work runs inside
profiler spans (:func:`repro_torch.spans.span`: ``detect_batch`` around
``pack``, ``upload``, ``head``, ``tail``, ``sync``, ``copy_back`` and
``decode``), which cost a check each when no profiler records.

``Detector.calibrated`` profiles one image and returns a detector whose
capacities (and, on request, tail and head ladders) are measured on this
device; ``calibrate_capacities`` is its safety shaping and
``work_profile`` the per-level weak-evaluation accounting, both as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cascade import Cascade, WINDOW
from .features import stage_sum_windows
from .integral import window_inv_sigma
from .pyramid import downscale_indices, downscale_nearest
from . import nms
from repro_torch.device import resolve_device
from repro_torch.spans import span
from repro_torch.kernels import autotune as kautotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels import packed_tail
import repro_torch.plan as planlib

__all__ = ["EngineConfig", "LevelResult", "BatchResult", "Detector",
           "calibrate_capacities", "nonzero_static", "resolve_device"]


class EngineConfig(NamedTuple):
    """The reference's ``EngineConfig``: same fields, same defaults, so
    plans and their keys are equal to the reference's.  ``interpret`` (a
    Pallas switch) has no effect in the port; ``lane_block`` shapes kernel
    C's launch (``packed_window.block_shape``) and ``head_tile`` kernels A
    and B's (``haar_stage.head_block_shape``).
    ``tail_backend="pallas"`` selects kernel C."""
    step: int = 1
    scale_factor: float = 1.2
    mode: str = "wave"             # 'dense' | 'wave'
    dense_segments: tuple = (1, 2)
    compact_every: int = 3
    capacity_fracs: tuple = ()
    use_pallas: bool = False       # dense waves through the dense kernels
    min_neighbors: int = 3
    interpret: bool = True
    pad_multiple: int = 0
    batch_capacity_fracs: tuple = ()
    tail_backend: str = "auto"     # 'gather' | 'bulk' | 'pallas' | 'auto'
    tail_rungs: tuple = ()
    head_mode: str = "auto"        # 'fused' | 'split' | 'auto'
    head_rungs: tuple = ()
    head_tile: tuple = ()
    lane_block: tuple = ()


class LevelResult(NamedTuple):
    ys: torch.Tensor            # (..., cap) int64 window origins (-1 = invalid)
    xs: torch.Tensor            # (..., cap) int64
    valid: torch.Tensor         # (..., cap) bool
    alive_counts: torch.Tensor  # (..., n_stages) int32 survivors per stage
    overflow: torch.Tensor      # (...) bool: capacity exceeded


class BatchResult(NamedTuple):
    """Survivors of a whole (batch x pyramid) packed detection pass."""
    img: torch.Tensor           # (cap,) int64 batch index (-1 = invalid lane)
    lvl: torch.Tensor           # (cap,) int64 pyramid-level index
    ys: torch.Tensor            # (cap,) int64 window origin at that level
    xs: torch.Tensor            # (cap,) int64
    valid: torch.Tensor         # (cap,) bool
    alive_counts: torch.Tensor  # (n_stages, B) int32 per-image survivors
    overflow: torch.Tensor      # () bool: shared capacity exceeded


def calibrate_capacities(alive_counts, n_windows: int,
                         safety: float = 2.0) -> tuple:
    """Profile-guided capacity fractions from measured per-stage survivor
    counts: ``min(1, count / n_windows * safety + 1e-3)`` each."""
    fr = np.asarray(alive_counts, np.float64) / max(n_windows, 1)
    return tuple(float(min(1.0, f * safety + 1e-3)) for f in fr)


def nonzero_static(mask: torch.Tensor, cap: int):
    """``jnp.nonzero(size=cap, fill_value=-1)`` along the last dim.

    Returns ``(idx, count)``: the indices of the first ``cap`` true entries
    in ascending order, ``-1`` filled, and the number of true entries (so
    ``count > cap`` is the overflow flag).  Static shapes, no host sync.
    """
    n = mask.shape[-1]
    lead = mask.shape[:-1]
    out = torch.full((*lead, cap + 1), -1, dtype=torch.int64,
                     device=mask.device)
    if n == 0:
        return out[..., :cap], torch.zeros(lead, dtype=torch.int64,
                                           device=mask.device)
    pos = torch.cumsum(mask, dim=-1)
    target = torch.where(mask & (pos <= cap), pos - 1, cap)
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    out.scatter_(-1, target, src)      # everything past cap lands in slot cap
    return out[..., :cap], pos[..., -1]


class Detector:
    """Multi-scale face detector over one cascade, on one device.

    ``device=None`` means the card (``cuda``) and raises when there is
    none; ``device="cpu"`` runs every kernel's plain version.
    """

    def __init__(self, cascade: Cascade, config: EngineConfig = EngineConfig(),
                 device=None):
        self.device = resolve_device(device)
        self.cascade = cascade.to(self.device)
        self.config = config
        self.stage_bounds = tuple(cascade.bounds)
        self.n_stages = cascade.n_stages
        planlib.validate_config(self.n_stages, config)
        self.cal_profile: dict = {}      # set by calibrated() on its result
        self.program_builds = 0          # executor builds (plan-cache probe)
        self.h2d_bytes = 0               # host -> device copies, bytes
        self.d2h_bytes = 0               # device -> host copies, bytes
        self._level_fns: dict = {}       # level-plan key -> level fn
        self._batch_fns: dict = {}       # batch-plan key -> (head, tail)

    # ---------------------------------------------------------------- plan
    def level_plan(self, h: int, w: int):
        return planlib.compile_level_plan(self.config, self.n_stages, h, w)

    def batch_plan(self, hp: int, wp: int, batch: int = 1):
        return planlib.compile_plan(self.config, self.n_stages, hp, wp,
                                    batch=batch)

    # -------------------------------------------------------- dense heads
    def _head(self, img: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
              fused: bool, n_dense: int, tile: tuple):
        """SAT (B, h+1, w+1), 1/sigma grid (B, ny, nx) and, for the fused
        head, the dense stages' sums (B, n_dense, ny, nx), kernel A
        launched in the plan's head ``tile``."""
        if fused:
            return kops.fused_head_batch(self.cascade, 0, n_dense, img,
                                         tile=tile)
        ii, ii2, iic = kops.sat_tables(img)
        inv = window_inv_sigma((ii2, iic), gy[:, None], gx[None, :], WINDOW)
        return ii, inv, None

    def _dense_sums(self, s: int, ii, inv_grid, sums, ys, xs, use_kernel,
                    tile: tuple):
        """(B, n) stage-``s`` sums of the dense grid (fused output, kernel
        B in the plan's head ``tile``, or the plain oracle for strided /
        non-kernel configs)."""
        b = ii.shape[0]
        if sums is not None:
            return sums[:, s].reshape(b, -1)
        if use_kernel:
            return kops.dense_stage_sums_batch(self.cascade, s, ii, inv_grid,
                                               tile=tile).reshape(b, -1)
        k0, k1 = self.stage_bounds[s], self.stage_bounds[s + 1]
        return stage_sum_windows(self.cascade, ii, ys, xs,
                                 inv_grid.reshape(b, -1), k0, k1)

    # ---------------------------------------------------------------- build
    def _build_level_fn(self, lp):
        """Executor of one level plan over a (B, h, w) stack: the dense
        waves on the full grid, then per-image compactions and the tail
        segments (``detect`` runs it with B = 1)."""
        cfg = self.config
        step = lp.step
        segs = lp.segments
        self.program_builds += 1
        cascade = self.cascade
        thr = cascade.stage_threshold
        dev = self.device
        n_dense = sum(seg.s1 - seg.s0 for seg in segs if seg.dense)
        fused = lp.head_mode == "fused" and n_dense > 0
        use_kernel = planlib.dense_on_kernels(cfg, step)
        gy = torch.arange(lp.ny, device=dev) * step
        gx = torch.arange(lp.nx, device=dev) * step
        ys = gy.repeat_interleave(lp.nx)
        xs = gx.repeat(lp.ny)
        stride = lp.width + 1
        backends = [planlib.select_backend(cfg, seg.capacity)
                    for seg in segs if not seg.dense]

        def level_fn(img: torch.Tensor, limits: torch.Tensor) -> LevelResult:
            b = img.shape[0]
            ii, inv_grid, sums = self._head(img, gy, gx, fused, n_dense,
                                            lp.head_tile)
            inv = inv_grid.reshape(b, -1)
            alive = (ys[None] <= limits[:, :1]) & (xs[None] <= limits[:, 1:])
            counts: list = []
            overflow = torch.zeros(b, dtype=torch.bool, device=dev)
            cur = None            # (valid, ys, xs, inv) of the compacted list
            tail = iter(backends)
            for seg in segs:
                if seg.dense:
                    for s in range(seg.s0, seg.s1):
                        ss = self._dense_sums(s, ii, inv_grid, sums, ys, xs,
                                              use_kernel, lp.head_tile)
                        alive = alive & (ss >= thr[s])
                        counts.append(alive.sum(1))
                    continue
                src = cur or (alive, ys.expand(b, -1), xs.expand(b, -1), inv)
                idx, cnt = nonzero_static(src[0], seg.capacity)
                overflow = overflow | (cnt > seg.capacity)
                sel = idx.clamp(min=0)
                cur = (idx >= 0,) + tuple(torch.gather(t, 1, sel)
                                          for t in src[1:])
                cap = seg.capacity
                lane_img = torch.arange(b, device=dev).repeat_interleave(cap)
                # each image's live lanes are a prefix of its own row, so
                # the flattened list has one live prefix only when b == 1
                n_live = cnt[0].clamp(max=cap) if b == 1 else None
                ss_run = packed_tail.stage_sums(
                    cascade, seg.s0, seg.s1, ii.reshape(b, -1), lane_img,
                    torch.zeros_like(lane_img),
                    torch.full_like(lane_img, stride), cur[1].reshape(-1),
                    cur[2].reshape(-1), cur[3].reshape(-1),
                    backend=next(tail), n_live=n_live,
                    lane_block=cfg.lane_block)
                valid = cur[0]
                for j, s in enumerate(range(seg.s0, seg.s1)):
                    valid = valid & (ss_run[j].reshape(b, cap) >= thr[s])
                    counts.append(valid.sum(1))
                cur = (valid,) + cur[1:]
            if cur is None:       # dense mode: one final compaction
                cap = lp.capacities[0]
                idx, cnt = nonzero_static(alive, cap)
                overflow = cnt > cap
                sel = idx.clamp(min=0)
                cur = (idx >= 0, ys[sel], xs[sel])
            valid = cur[0]
            return LevelResult(torch.where(valid, cur[1], -1),
                               torch.where(valid, cur[2], -1), valid,
                               torch.stack(counts, dim=1).to(torch.int32),
                               overflow)

        return level_fn

    def _level_fn(self, h: int, w: int):
        lp = self.level_plan(h, w)
        if lp.key not in self._level_fns:
            self._level_fns[lp.key] = self._build_level_fn(lp)
        return self._level_fns[lp.key]

    # ------------------------------------------------------------ buckets
    def _bucket_hw(self, h: int, w: int) -> tuple[int, int]:
        m = self.config.pad_multiple
        if m <= 0:
            return h, w
        hp = max(((h + m - 1) // m) * m, WINDOW)
        wp = max(((w + m - 1) // m) * m, WINDOW)
        return hp, wp

    @staticmethod
    def _decode_rects(ys: np.ndarray, xs: np.ndarray,
                      scales: np.ndarray) -> np.ndarray:
        """Window origins (level coords) -> (N, 4) int32 [x, y, w, h] rects
        in image coords (round-half-even, matching ``round``)."""
        ys = np.asarray(ys, np.float64)
        xs = np.asarray(xs, np.float64)
        scales = np.broadcast_to(np.asarray(scales, np.float64), ys.shape)
        w = np.rint(WINDOW * scales)
        return np.stack([np.rint(xs * scales), np.rint(ys * scales), w, w],
                        axis=1).astype(np.int32).reshape(-1, 4)

    def _to_device(self, a) -> torch.Tensor:
        """``a`` copied to the device; counts its bytes."""
        a = np.asarray(a)
        self.h2d_bytes += a.nbytes
        return torch.as_tensor(a, device=self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """``t`` copied to the host as numpy; counts its bytes."""
        a = t.cpu().numpy()
        self.d2h_bytes += a.nbytes
        return a

    def _stack_to_device(self, stack: np.ndarray, valid_hw: np.ndarray):
        with span("upload"):
            return (self._to_device(stack),
                    self._to_device(valid_hw.astype(np.int64)))

    def _levels_raw(self, stack: np.ndarray, valid_hw: np.ndarray, hp: int,
                    wp: int):
        """Batched per-level results of the level programs for a same-bucket
        (B, hp, wp) stack: ``[(LevelResult with leading B, scale), ...]``."""
        levels = self.batch_plan(hp, wp).levels_all
        if not levels:          # bucket smaller than the detection window
            return []
        lims = np.asarray([np.stack(planlib.window_limits(
            valid_hw[:, 0], valid_hw[:, 1], lp.height, lp.width, hp, wp),
            axis=1) for lp in levels], np.int64).reshape(len(levels), -1, 2)
        stack_t, lims_t = self._stack_to_device(stack, lims)
        out = []
        for li, lp in enumerate(levels):
            ys_idx = self._to_device(downscale_indices(hp, lp.height))
            xs_idx = self._to_device(downscale_indices(wp, lp.width))
            img_l = stack_t[:, ys_idx[:, None], xs_idx[None, :]]
            res = self._level_fn(lp.height, lp.width)(img_l, lims_t[li])
            out.append((res, lp.scale))
        return out

    # ---------------------------------------------------------------- public
    def detect_raw(self, image) -> list[tuple[LevelResult, float]]:
        """Per-level raw results (device tensors) + level scales."""
        image = np.asarray(image, np.float32)
        h, w = image.shape
        hp, wp = self._bucket_hw(h, w)
        stack, valid_hw = self._pack_stack([image], hp, wp)
        return [(LevelResult(*(t[0] for t in res)), scale)
                for res, scale in self._levels_raw(stack, valid_hw, hp, wp)]

    def detect(self, image, group: bool = True) -> np.ndarray:
        """Detect faces; returns (M, 4) int32 [x, y, w, h] in image coords."""
        levels = self.detect_raw(image)
        if levels and self._to_host(
                torch.stack([r.overflow for r, _ in levels]).any()):
            raise RuntimeError(
                "wave-engine capacity overflow; raise capacity_fracs "
                "(see calibrate_capacities)")
        rects = []
        for res, scale in levels:
            val = self._to_host(res.valid)
            rects.append(self._decode_rects(self._to_host(res.ys)[val],
                                            self._to_host(res.xs)[val], scale))
        rects = (np.concatenate(rects, axis=0) if rects
                 else np.zeros((0, 4), np.int32))
        if not group:
            return rects
        return nms.group_rectangles(rects, self.config.min_neighbors)

    # ---------------------------------------------------------------- batch
    def _build_batch_fn(self, plan):
        """The packed batch program of one plan (bucket shape, batch size):
        per-level dense waves over the whole stack, then compactions shared
        by every (image, level) pair for the tail segments.  Returns the
        ``(head_fn, tail_fn)`` halves."""
        cfg = self.config
        step = plan.step
        batch = plan.batch
        hp, wp = plan.hp, plan.wp
        n_dense = plan.dense_prefix
        n_stages = self.n_stages
        cascade = self.cascade
        thr = cascade.stage_threshold
        dev = self.device
        use_kernel = planlib.dense_on_kernels(cfg, step)
        self.program_builds += 1

        on_dev = self._to_device
        layout = plan.layout
        lvl_of_slot = on_dev(layout.lvl_of_slot).long()
        y_of_slot = on_dev(layout.y_of_slot).long()
        x_of_slot = on_dev(layout.x_of_slot).long()
        sat_base_of_lvl = on_dev(layout.sat_base_of_lvl).long()
        sat_stride_of_lvl = on_dev(layout.sat_stride_of_lvl).long()
        n_slots = plan.n_slots
        cap0 = plan.capacities[0]
        tail_segs = plan.tail_segments
        levels = []
        for li, lp in enumerate(plan.levels):
            sl = slice(lp.slot_offset, lp.slot_offset + lp.n_windows)
            levels.append(dict(
                lp=lp,
                ys_idx=on_dev(downscale_indices(hp, lp.height)),
                xs_idx=on_dev(downscale_indices(wp, lp.width)),
                gy=torch.arange(lp.ny, device=dev) * step,
                gx=torch.arange(lp.nx, device=dev) * step,
                ys_w=y_of_slot[sl], xs_w=x_of_slot[sl],
                fused=plan.head_modes[li] == "fused" and n_dense > 0))

        def head_fn(stack: torch.Tensor, valid_hw: torch.Tensor):
            # stack: (B, hp, wp) float32; valid_hw: (B, 2) int64 true shapes
            counts = torch.zeros((n_stages, batch), dtype=torch.int32,
                                 device=dev)
            sat_parts, alive_parts, inv_parts = [], [], []
            for L in levels:
                lp = L["lp"]
                img_l = stack[:, L["ys_idx"][:, None], L["xs_idx"][None, :]]
                ii_l, inv_grid_l, sums_l = self._head(
                    img_l, L["gy"], L["gx"], L["fused"], n_dense,
                    plan.head_tile)
                inv_l = inv_grid_l.reshape(batch, -1)
                if tail_segs:
                    sat_parts.append(ii_l.reshape(batch, -1))
                y_lim, x_lim = planlib.window_limits(
                    valid_hw[:, 0], valid_hw[:, 1], lp.height, lp.width,
                    hp, wp)
                alive_l = ((L["ys_w"][None, :] <= y_lim[:, None])
                           & (L["xs_w"][None, :] <= x_lim[:, None]))
                for s in range(n_dense):
                    ss = self._dense_sums(s, ii_l, inv_grid_l, sums_l,
                                          L["ys_w"], L["xs_w"], use_kernel,
                                          plan.head_tile)
                    alive_l = alive_l & (ss >= thr[s])
                    counts[s] += alive_l.sum(1).to(torch.int32)
                alive_parts.append(alive_l)
                inv_parts.append(inv_l)
            alive_flat = torch.cat(alive_parts, dim=1).reshape(-1)
            inv_flat = torch.cat(inv_parts, dim=1).reshape(-1)
            ii_flat = torch.cat(sat_parts, dim=1) if tail_segs else None
            return alive_flat, inv_flat, ii_flat, counts

        def tail_fn(alive_flat, inv_flat, ii_flat, counts) -> BatchResult:
            counts = counts.clone()
            idx, cnt = nonzero_static(alive_flat, cap0)
            overflow = cnt > cap0
            sel = idx.clamp(min=0)
            valid = idx >= 0
            b_sel = sel // n_slots
            slot = sel % n_slots
            lvl_sel = lvl_of_slot[slot]
            y_sel = y_of_slot[slot]
            x_sel = x_of_slot[slot]
            inv_sel = inv_flat[sel]
            for ki, seg in enumerate(tail_segs):
                if ki > 0:       # recompact the shrinking shared list
                    idx, cnt = nonzero_static(valid, seg.capacity)
                    overflow = overflow | (cnt > seg.capacity)
                    sel = idx.clamp(min=0)
                    b_sel, lvl_sel, y_sel, x_sel, inv_sel = (
                        t[sel] for t in (b_sel, lvl_sel, y_sel, x_sel,
                                         inv_sel))
                    valid = idx >= 0
                n_live = cnt.clamp(max=seg.capacity)
                ss_run = packed_tail.stage_sums(
                    cascade, seg.s0, seg.s1, ii_flat, b_sel,
                    sat_base_of_lvl[lvl_sel], sat_stride_of_lvl[lvl_sel],
                    y_sel, x_sel, inv_sel, backend=seg.backend,
                    n_live=n_live, lane_block=plan.lane_block)
                # kernel E: the segment's gates and per-image counts
                valid = kops.tail_gate_counts(
                    ss_run, thr[seg.s0:seg.s1], valid, b_sel, n_live,
                    counts[seg.s0:seg.s1])
            return BatchResult(
                img=torch.where(valid, b_sel, -1),
                lvl=torch.where(valid, lvl_sel, -1),
                ys=torch.where(valid, y_sel, -1),
                xs=torch.where(valid, x_sel, -1),
                valid=valid, alive_counts=counts, overflow=overflow)

        return head_fn, tail_fn

    def batch_parts(self, hp: int, wp: int, batch: int):
        """The packed batch program's ``(head_fn, tail_fn)`` halves.

        ``head_fn(stack, valid_hw)`` runs the per-level dense waves and
        returns ``(alive_flat, inv_flat, ii_flat, counts)``;
        ``tail_fn(*that)`` runs the shared compactions and the packed tail
        to a :class:`BatchResult`.
        """
        plan = self.batch_plan(hp, wp, batch)
        if plan.key not in self._batch_fns:
            self._batch_fns[plan.key] = self._build_batch_fn(plan)
        return self._batch_fns[plan.key]

    @staticmethod
    def _pack_stack(imgs: list, hp: int, wp: int):
        """Zero-pad images into one (B, hp, wp) stack + their true shapes."""
        with span("pack"):
            stack = np.zeros((len(imgs), hp, wp), np.float32)
            valid_hw = np.zeros((len(imgs), 2), np.int32)
            for i, im in enumerate(imgs):
                h, w = im.shape
                stack[i, :h, :w] = im
                valid_hw[i] = (h, w)
            return stack, valid_hw

    def detect_batch_raw(self, images) -> list[tuple[LevelResult, float]]:
        """vmap strategy: per-level ``LevelResult``s with a leading batch
        dim for a same-bucket list of images (per-image overflow)."""
        imgs = [np.asarray(im, np.float32) for im in images]
        hws = {self._bucket_hw(*im.shape) for im in imgs}
        if len(hws) != 1:
            raise ValueError(
                f"detect_batch_raw needs a single shape bucket, got {hws}")
        (hp, wp), = hws
        stack, valid_hw = self._pack_stack(imgs, hp, wp)
        return self._levels_raw(stack, valid_hw, hp, wp)

    def detect_batch(self, images, group: bool = True,
                     strategy: str = "packed") -> list[np.ndarray]:
        """Detect faces in many images; one (M, 4) rect array per image,
        equal per image to sequential :meth:`detect`."""
        with span("detect_batch"):
            imgs = [np.asarray(im, np.float32) for im in images]
            out: list = [None] * len(imgs)
            buckets: dict[tuple[int, int], list[int]] = {}
            for i, im in enumerate(imgs):
                buckets.setdefault(self._bucket_hw(*im.shape), []).append(i)
            for (hp, wp), idxs in buckets.items():
                if strategy == "packed":
                    per_img_rects = self._detect_bucket_packed(
                        [imgs[i] for i in idxs], hp, wp)
                elif strategy == "vmap":
                    per_img_rects = self._detect_bucket_vmap(
                        [imgs[i] for i in idxs], idxs)
                else:
                    raise ValueError(f"unknown batch strategy: {strategy!r}")
                for i, rects in zip(idxs, per_img_rects):
                    out[i] = (nms.group_rectangles(rects,
                                                   self.config.min_neighbors)
                              if group else rects)
            return out

    def _detect_bucket_packed(self, imgs: list, hp: int, wp: int) -> list:
        n = len(imgs)
        plan = self.batch_plan(hp, wp, n)
        if not plan.levels:  # bucket smaller than the detection window
            return [np.zeros((0, 4), np.int32) for _ in range(n)]
        stack, valid_hw = self._pack_stack(imgs, hp, wp)
        head_fn, tail_fn = self.batch_parts(hp, wp, n)
        flush_in = self._stack_to_device(stack, valid_hw)
        with span("head"):
            parts = head_fn(*flush_in)
        del flush_in        # each half's inputs go once it has run: the
        with span("tail"):  # device's peak holds one stack at a time
            res = tail_fn(*parts)
        del parts
        with span("sync"):              # the flush's one wait for the device
            overflow = self._to_host(res.overflow)
        if overflow:
            raise RuntimeError(
                "batched-engine shared capacity overflow; raise "
                "batch_capacity_fracs / capacity_fracs (see "
                "Detector.calibrated)")
        with span("copy_back"):
            # one whole list on the host at a time: its copy is masked to
            # the live lanes before the next one comes back
            val = self._to_host(res.valid)
            b, lvl, ys, xs = (self._to_host(t)[val] for t in (
                res.img, res.lvl, res.ys, res.xs))
        with span("decode"):
            scales = np.asarray([lp.scale for lp in plan.levels])
            out = []
            for i in range(n):
                m = b == i
                out.append(self._decode_rects(ys[m], xs[m], scales[lvl[m]]))
        return out

    def _detect_bucket_vmap(self, imgs: list, idxs: list) -> list:
        levels = self.detect_batch_raw(imgs)
        over = np.zeros(len(imgs), bool)
        if levels:
            over = self._to_host(torch.stack([res.overflow
                                              for res, _ in levels]).any(0))
        if over.any():
            bad = [idxs[i] for i in np.nonzero(over)[0]]
            raise RuntimeError(
                f"wave-engine capacity overflow on image(s) {bad}; raise "
                "capacity_fracs (see Detector.calibrated)")
        host = [(self._to_host(res.valid), self._to_host(res.ys),
                 self._to_host(res.xs), scale) for res, scale in levels]
        out = []
        for i in range(len(imgs)):
            rects = [self._decode_rects(ys[i][val[i]], xs[i][val[i]], scale)
                     for val, ys, xs, scale in host]
            out.append(np.concatenate(rects, axis=0) if rects
                       else np.zeros((0, 4), np.int32))
        return out

    # ---------------------------------------------------------- calibration
    def calibrated(self, image, safety: float = 2.0,
                   tune_tail: bool = False,
                   tail_sizes: tuple | None = None,
                   tune_head: bool = False) -> "Detector":
        """Profile-guided detector, as ``repro``'s ``Detector.calibrated``.

        Runs ``detect_raw(image)`` with the current capacities, measures the
        survivors at each compaction boundary and returns a
        ``Detector(self.cascade, cfg, device=self.device)`` whose
        ``capacity_fracs`` are the worst level's fractions and whose
        ``batch_capacity_fracs`` are the fractions summed over levels, each
        shaped by :func:`calibrate_capacities` with ``safety``.

        ``tune_tail=True`` races the packed-tail backends on the profiled
        image's levels, each weighted by its measured density
        (``packed_tail.measure_rungs``, at ``tail_sizes`` if given) and
        persists ``tail_rungs`` with ``tail_backend="auto"``.
        ``tune_head=True`` races the fused and split heads per level and
        the tiles (``autotune.measure_head``) and the lane blocks
        (``autotune.measure_lane_block``, at the tail crossover or 2048)
        and persists ``head_rungs`` with ``head_mode="auto"``,
        ``head_tile`` and ``lane_block``.  The races run on this detector's
        device.  The result's ``cal_profile`` has the reference's keys:
        ``densities``, ``n_windows``, ``level_densities``, ``levels``, and
        ``tail``, ``head``, ``head_tiles``, ``lane``, ``lane_block`` when
        tuned.
        """
        image = np.asarray(image, np.float32)
        h, w = image.shape
        hp, wp = self._bucket_hw(h, w)
        bplan = self.batch_plan(hp, wp)       # per-level window counts
        levels = self.detect_raw(image)
        comp_stages = [seg.s0 for seg in bplan.segments if not seg.dense]
        if not comp_stages:  # dense mode: single final compaction
            comp_stages = [self.n_stages]
        fracs = np.zeros(len(comp_stages))          # worst level, per comp
        surv_tot = np.zeros(len(comp_stages))       # summed over levels
        level_density: list[float] = []             # first compaction, per lv
        win_tot = 0
        for lp, (res, _scale) in zip(bplan.levels, levels):
            nwin = max(lp.n_windows, 1)
            win_tot += nwin
            cnt = self._to_host(res.alive_counts).astype(np.float64)
            for k, s0 in enumerate(comp_stages):
                survivors = cnt[s0 - 1] if s0 > 0 else float(nwin)
                fracs[k] = max(fracs[k], survivors / nwin)
                surv_tot[k] += survivors
                if k == 0:
                    level_density.append(survivors / nwin)
        densities = (surv_tot / max(win_tot, 1)).tolist()
        fracs = calibrate_capacities(fracs, 1, safety)
        batch_fracs = calibrate_capacities(surv_tot, win_tot, safety)
        cfg = self.config._replace(capacity_fracs=fracs,
                                   batch_capacity_fracs=batch_fracs)
        profile: dict = {
            "densities": densities, "n_windows": int(win_tot),
            "level_densities": level_density,
            "levels": [(lp.height, lp.width, lp.n_windows)
                       for lp in bplan.levels],
        }
        if tune_tail or tune_head:
            # the profiled image at every pyramid level of the plan, each
            # weighted by its expected packed-window share
            padded = torch.zeros((hp, wp), dtype=torch.float32,
                                 device=self.device)
            padded[:h, :w] = self._to_device(image)
            workload = [(downscale_nearest(padded, lp.height, lp.width),
                         d * lp.n_windows)
                        for lp, d in zip(bplan.levels, level_density)]
        if tune_tail:
            kw = {} if tail_sizes is None else {"sizes": tuple(tail_sizes)}
            tail = packed_tail.measure_rungs(self.cascade, workload=workload,
                                             **kw)
            cfg = cfg._replace(tail_backend="auto", tail_rungs=tail["rungs"])
            profile["tail"] = tail
        if tune_head:
            n_dense = bplan.dense_prefix
            if n_dense > 0:
                head = kautotune.measure_head(self.cascade, workload,
                                              n_dense=n_dense)
                cfg = cfg._replace(head_mode="auto",
                                   head_rungs=head["rungs"],
                                   head_tile=head["head_tiles"])
                profile["head"] = head
                profile["head_tiles"] = head["head_tiles"]
            lane_size = (profile["tail"]["crossover"]
                         if tune_tail and profile["tail"]["crossover"] > 0
                         else 2048)
            lane = kautotune.measure_lane_block(self.cascade, workload,
                                                size=lane_size)
            cfg = cfg._replace(lane_block=lane["lane_block"])
            profile["lane"] = lane
            profile["lane_block"] = lane["lane_block"]
        det = Detector(self.cascade, cfg, device=self.device)
        det.cal_profile = profile
        return det

    # ------------------------------------------------------------- analysis
    def work_profile(self, image) -> dict:
        """Windows and weak evaluations per level (ideal early exit vs the
        dense sweep), as the reference's ``work_profile``."""
        levels = self.detect_raw(image)
        sizes = self.cascade.stage_sizes().astype(np.int64)
        img = np.asarray(image)
        hp, wp = self._bucket_hw(img.shape[0], img.shape[1])
        bplan = self.batch_plan(hp, wp)   # per-level window counts
        total_windows = 0
        weak_early = 0   # ideal per-stage early exit (sequential semantics)
        weak_dense = 0   # delayed rejection
        per_level = []
        for lp, (res, scale) in zip(bplan.levels, levels):
            nwin = lp.n_windows
            counts = self._to_host(res.alive_counts).astype(np.int64)
            alive_before = np.concatenate([[nwin], counts[:-1]])
            we = int((alive_before * sizes).sum())
            wd = int(nwin * sizes.sum())
            weak_early += we
            weak_dense += wd
            total_windows += nwin
            per_level.append({
                "scale": scale, "windows": nwin,
                "alive_counts": counts, "weak_evals_early": we,
                "weak_evals_dense": wd,
            })
        return {
            "total_windows": total_windows,
            "weak_evals_early_exit": weak_early,
            "weak_evals_dense": weak_dense,
            "per_level": per_level,
        }
