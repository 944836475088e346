"""Packed incremental cascade evaluation over changed windows, in PyTorch.

The port of ``repro.stream.engine``.  The incremental tail is the batched
detector's shared-compaction tail with the dense head cut off: the initial
alive set is "every window whose tile content changed", and those windows,
from every frame of a stack and every pyramid level, are compacted into one
packed list and run through *all* cascade stages by the shared packed-tail
evaluator (:func:`repro_torch.kernels.packed_tail.stage_sums`; under
``tail_backend="pallas"`` kernel C) with the compaction's live count.  The
per-level SATs come from kernel S (:func:`repro_torch.kernels
.integral_image.sat_tables`), cut from the padded frame by
``downscale_indices`` exactly as ``Detector``'s head does, so a recomputed
window sees the SAT bits ``detect`` sees.  Its 1/sigma is
:func:`_packed_inv_sigma`, ``window_inv_sigma``'s arithmetic through the
packed lookup, and where ``detect``'s dense prefix runs on kernels A or B
(``use_pallas`` and step 1) the tail evaluates those stages in the dense
kernels' order (``s_dense``), so every recomputed window reaches exactly
the decision ``detect`` reaches.

Two executors, both over plans from :mod:`repro_torch.plan`:

- the host-planned batched executor (:meth:`StreamEngine.incremental`):
  the host built the masks, so it knows the changed count and the active
  level subset before dispatch; fully cached levels build no SAT;
- the device-resident step (:meth:`StreamEngine.stream_step`): tile change
  scoring, per-level window mapping, the cached/incremental/full decision,
  the SATs, the packed tail and the state update, all enqueued without a
  host sync.  Where the reference branches on device scalars
  (``lax.cond``), the step enqueues the work unconditionally and lets
  device masks decide: the tail runs with the live count ``n_rec`` when
  the frame commits and 0 otherwise, every level's SAT is built, and the
  state update is a ``torch.where`` on the commit flag.

Executors are built once (``program_builds``) per level subset (host path)
or per stream plan (device step) and upload their index tables then; the
packed capacity rung is a call argument, since an eager executor's tables
do not depend on it.  The device step writes its output state into a
buffer the caller gives it (a ping-pong pair in :class:`VideoDetector`),
so a steady stream allocates no new state and a re-dispatch always finds
the state it reads intact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cascade import WINDOW
from repro_torch.core.engine import Detector, nonzero_static
from repro_torch.core.integral import div_rn, inv_sigma_of
from repro_torch.core.pyramid import downscale_indices
from repro_torch.kernels import packed_tail
from repro_torch.kernels.integral_image import sat_tables
from repro_torch.kernels.tile_change import (range_any,
                                             tile_change_mask_kernel)
from repro_torch.plan import (STREAM_CAP_BASE, LevelSubset,  # noqa: F401
                              StreamGeometry, compile_plan,
                              compile_stream_plan, dense_on_kernels,
                              stream_budget,
                              stream_capacity_rung)

__all__ = ["StreamGeometry", "StreamEngine", "LevelSubset", "StreamState",
           "StreamStepOut"]

_AREA = float(WINDOW * WINDOW)


def _packed_inv_sigma(pair_flat: torch.Tensor, img: torch.Tensor,
                      base: torch.Tensor, stride: torch.Tensor,
                      ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """1/sigma for packed windows living on different images and levels.

    ``pair_flat`` is (B, 2, sum_l (h_l+1)*(w_l+1)): the (ii2, iic) pair of
    every level, flattened and concatenated.  The arithmetic of
    :func:`repro_torch.core.integral.window_inv_sigma` (corners ``d - b -
    c + a``, correctly rounded division and root), so the bits equal those
    of the dense heads' 1/sigma; only the lookup goes through the packed
    ``(img, base + y * stride + x)`` indexing.
    """
    img, base, stride = img.long(), base.long(), stride.long()
    ys, xs = ys.long(), xs.long()

    def rect(tab):
        t = pair_flat[:, tab]
        y1, x1 = ys + WINDOW, xs + WINDOW
        return (t[img, base + y1 * stride + x1]
                - t[img, base + ys * stride + x1]
                - t[img, base + y1 * stride + xs]
                + t[img, base + ys * stride + xs])

    mean = div_rn(rect(1), _AREA)
    return inv_sigma_of(div_rn(rect(0), _AREA) - mean * mean)


class StreamState(NamedTuple):
    """One stream's device-resident temporal state.

    Every field lives on the device across frames; the only per-frame
    host-to-device transfer is the new frame, and the only device-to-host
    transfers are the :class:`StreamStepOut` scalars and the decoded
    survivor slot list.
    """
    ref: torch.Tensor        # (hp, wp) f32 reference pixels, zero-padded
    bitmap: torch.Tensor     # (n_slots,) bool cached survivor decisions
    drift: torch.Tensor      # (ty, tx) f32 peak change score of tiles whose
    #                          cached decisions were *not* refreshed (pure
    #                          diagnostic: scoring is always against the
    #                          reference frame)
    frame_idx: torch.Tensor  # () i32 stream frame counter
    last_full: torch.Tensor  # () i32 frame index of the last full refresh


class StreamStepOut(NamedTuple):
    """Per-frame result of the device step (device tensors; the host
    fetches ``flags``, and the slot list only on incremental commits).
    The six scalars are views of ``flags``, so one transfer fetches
    them all."""
    mode: torch.Tensor           # () i32: 0 cached, 1 incremental, 2 full
    tiles_changed: torch.Tensor  # () i32 changed tiles after halo dilation
    n_rec: torch.Tensor          # () i32 windows to recompute
    levels_active: torch.Tensor  # () i32 levels with any changed window
    retry: torch.Tensor          # () i32, 1: packed rung overflow, nothing
    #                              committed; re-dispatch at a larger rung
    n_surv: torch.Tensor         # () i32 survivors in the committed bitmap
    slots: torch.Tensor          # (decode_cap,) i32 ascending survivor slots
    #                              (fill value n_slots past n_surv)
    flags: torch.Tensor          # (6,) i32: the six scalars above, in order


class StreamEngine:
    """Incremental evaluators over a :class:`Detector`'s cascade, on the
    detector's device."""

    def __init__(self, detector: Detector, max_changed_frac: float = 0.5):
        self.detector = detector
        self.device = detector.device
        self.max_changed_frac = max_changed_frac
        self._geos: dict[tuple[int, int], StreamGeometry] = {}
        self._fns: dict[tuple, object] = {}
        # head-work accounting: per-level SAT builds the subset executors
        # ran vs the all-level layout's total (tests assert fully cached
        # levels build no SAT from these)
        self.sat_level_builds = 0
        self.sat_level_total = 0
        self.dispatches = 0
        self.program_builds = 0          # executor builds (plan-cache probe)

    @property
    def sat_level_frac(self) -> float:
        """Fraction of pyramid levels whose SAT was built, over all
        incremental dispatches (1.0 = every level every time)."""
        return self.sat_level_builds / max(self.sat_level_total, 1)

    def geometry(self, hp: int, wp: int) -> StreamGeometry:
        key = (hp, wp)
        if key not in self._geos:
            self._geos[key] = StreamGeometry(self.detector, hp, wp)
        return self._geos[key]

    def cap_budget(self, geo: StreamGeometry, batch: int) -> int:
        """Most changed windows a flush may evaluate incrementally; beyond
        it a full refresh is cheaper anyway (the caller's fallback)."""
        return stream_budget(geo.n_slots, batch, self.max_changed_frac)

    def _cap_for(self, n_sub_slots: int, batch: int, n_changed: int) -> int:
        """Smallest ladder rung holding ``n_changed`` packed windows, capped
        at the active subset's own slot count (the plan layer's ladder)."""
        return stream_capacity_rung(n_sub_slots, batch, n_changed)

    def _s_dense(self, hp: int, wp: int) -> int:
        """Stages the tail must evaluate in the dense kernels' order: the
        dense prefix where ``detect`` runs it on kernels A and B
        (:func:`repro_torch.plan.dense_on_kernels`), else none (the plain
        oracle has the tail's order)."""
        cfg = self.detector.config
        if not dense_on_kernels(cfg, cfg.step):
            return 0
        return compile_plan(cfg, self.detector.n_stages, hp, wp).dense_prefix

    def _tables(self, layout):
        dev = self.device

        def on_dev(a):
            return torch.as_tensor(a, dtype=torch.int64, device=dev)

        return (on_dev(layout.lvl_of_slot), on_dev(layout.y_of_slot),
                on_dev(layout.x_of_slot), on_dev(layout.sat_base_of_lvl),
                on_dev(layout.sat_stride_of_lvl))

    def _level_maps(self, hp: int, wp: int, levels):
        """Per level: the device index maps that cut it from the padded
        frame (``downscale_indices``, as ``Detector``'s head)."""
        dev = self.device
        return [(torch.as_tensor(downscale_indices(hp, lp.height),
                                 device=dev)[:, None],
                 torch.as_tensor(downscale_indices(wp, lp.width),
                                 device=dev)[None, :]) for lp in levels]

    @staticmethod
    def _sats(stack: torch.Tensor, maps):
        """Kernel S over each level of a (B, hp, wp) stack: the flat SATs
        (B, S) and the flat (ii2, iic) pairs (B, 2, S)."""
        b = stack.shape[0]
        sat_parts, pair_parts = [], []
        for ys_idx, xs_idx in maps:
            ii, ii2, iic = sat_tables(stack[:, ys_idx, xs_idx])
            sat_parts.append(ii.reshape(b, -1))
            pair_parts.append(torch.stack([ii2, iic], 1).reshape(b, 2, -1))
        return torch.cat(sat_parts, 1), torch.cat(pair_parts, 2)

    def _survivors(self, seg, lane_block, s_dense, ii_flat, pair_flat,
                   tables, idx, n_live, n_slots, n_out):
        """Packed tail over the compacted list ``idx`` (-1 fill; the first
        ``n_live`` lanes live): the surviving flat indices scattered onto
        an (n_out,) bool grid."""
        lvl_of_slot, y_of_slot, x_of_slot, sat_base, sat_stride = tables
        det = self.detector
        thr = det.cascade.stage_threshold
        lanes = torch.arange(idx.shape[0], device=idx.device)
        sel = idx.clamp(min=0)
        valid = (idx >= 0) & (lanes < n_live)
        slot = sel % n_slots
        b_sel = sel // n_slots
        lvl_sel = lvl_of_slot[slot]
        y_sel, x_sel = y_of_slot[slot], x_of_slot[slot]
        base_sel, stride_sel = sat_base[lvl_sel], sat_stride[lvl_sel]
        inv_sel = _packed_inv_sigma(pair_flat, b_sel, base_sel, stride_sel,
                                    y_sel, x_sel)
        ss_run = packed_tail.stage_sums(
            det.cascade, seg.s0, seg.s1, ii_flat, b_sel, base_sel,
            stride_sel, y_sel, x_sel, inv_sel, backend=seg.backend,
            n_live=n_live, lane_block=lane_block, s_dense=s_dense)
        for j, s in enumerate(range(seg.s0, seg.s1)):
            valid = valid & (ss_run[j] >= thr[s])
        # dead and padding lanes target index n_out, which is cut off
        out = torch.zeros(n_out + 1, dtype=torch.bool, device=idx.device)
        out[torch.where(valid, sel, n_out)] = True
        return out[:n_out]

    # ------------------------------------------------------------- build
    def _build_fn(self, plan):
        """Executor of the host-planned incremental tail over the plan's
        active levels: SATs (kernel S) for those levels only, one
        compaction of the stack's changed windows, the packed all-stage
        tail.  The rung plan (capacity, backend, lane block) is a call
        argument."""
        hp, wp = plan.hp, plan.wp
        batch = plan.batch
        n_slots = plan.n_slots
        self.program_builds += 1
        tables = self._tables(plan.layout)
        maps = self._level_maps(hp, wp, plan.levels)
        s_dense = self._s_dense(hp, wp)

        def frame_fn(stack: torch.Tensor, mask_flat: torch.Tensor, rung_plan):
            # stack: (B, hp, wp) f32 frames; mask_flat: (B, n_slots) bool
            # windows to recompute (limit-masked on host), over the active
            # subset's slots only
            seg = rung_plan.segments[0]
            ii_flat, pair_flat = self._sats(stack, maps)
            recomputed = mask_flat.sum(1).to(torch.int32)
            idx, cnt = nonzero_static(mask_flat.reshape(-1), seg.capacity)
            survivors = self._survivors(
                seg, rung_plan.lane_block, s_dense, ii_flat, pair_flat,
                tables, idx, cnt.clamp(max=seg.capacity), n_slots,
                batch * n_slots)
            return (survivors.reshape(batch, n_slots), recomputed,
                    cnt > seg.capacity)

        return frame_fn

    def _fn(self, hp: int, wp: int, batch: int, cap: int,
            levels: tuple[int, ...]):
        """``(executor, rung plan)`` for one (bucket, batch, rung, subset);
        the executor is built once per (bucket, batch, subset)."""
        det = self.detector
        plan = compile_plan(det.config, det.n_stages, hp, wp, batch=batch,
                            levels=levels, capacity=cap)
        key = ("incremental", hp, wp, batch, levels)
        if key not in self._fns:
            self._fns[key] = self._build_fn(plan)
        return self._fns[key], plan

    # ----------------------------------------------- device-resident state
    def stream_plan(self, hp: int, wp: int, h: int, w: int, tile: int,
                    halo: int, decode_cap: int | None = None):
        """The compiled :class:`repro_torch.plan.StreamStatePlan` for one
        (bucket, true frame shape, tile, halo)."""
        det = self.detector
        return compile_stream_plan(det.config, det.n_stages, hp, wp, h, w,
                                   tile, halo, decode_cap=decode_cap)

    def alloc_state(self, splan) -> StreamState:
        """A zeroed :class:`StreamState` buffer on the detector's device."""
        dev = self.device
        return StreamState(
            torch.zeros((splan.hp, splan.wp), dtype=torch.float32,
                        device=dev),
            torch.zeros(splan.n_slots, dtype=torch.bool, device=dev),
            torch.zeros((splan.ty, splan.tx), dtype=torch.float32,
                        device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))

    def init_state(self, splan, frame: np.ndarray, bitmap: np.ndarray,
                   frame_idx: int, last_full: int,
                   out: StreamState | None = None) -> StreamState:
        """Upload a stream's temporal state (after a host full refresh),
        into ``out`` when given (its buffers are reused), else new ones."""
        ref = np.zeros((splan.hp, splan.wp), np.float32)
        ref[:splan.h, :splan.w] = frame
        # repro: ignore[HOST_SYNC] keyframe upload: host bitmap seeds the device state
        bm = np.asarray(bitmap, bool)  # repro_torch: ignore[HOST_SYNC] keyframe upload
        st = self.alloc_state(splan) if out is None else out
        st.ref.copy_(torch.from_numpy(ref))
        st.bitmap.copy_(torch.from_numpy(bm))
        st.drift.zero_()
        st.frame_idx.fill_(frame_idx)
        st.last_full.fill_(last_full)
        return st

    def refresh_state(self, splan):
        """The fast-path twin of :meth:`init_state` for device streams whose
        full-refresh frame is already on the device (it was the step's
        input): the new state reuses the stale state's buffers, so the
        only host-to-device traffic is the survivor bitmap and two
        counters."""

        def refresh(state: StreamState, frame: torch.Tensor,
                    bitmap: np.ndarray, frame_idx: int,
                    last_full: int) -> StreamState:
            state.ref.copy_(frame)
            state.bitmap.copy_(torch.from_numpy(bitmap))
            state.drift.zero_()
            state.frame_idx.fill_(frame_idx)
            state.last_full.fill_(last_full)
            return state

        return refresh

    def provisional_refresh(self, splan):
        """Re-seed only the verdict-bearing half of the state (reference
        pixels and counters), leaving the survivor bitmap stale.  The
        step's mode decision never reads the bitmap, so a successor frame
        can dispatch against this *before* the full refresh's host detect
        produces the real bitmap; a committed verdict is then re-run
        against the trued-up state (see ``VideoDetector.poll``)."""

        def refresh(state: StreamState, frame: torch.Tensor, frame_idx: int,
                    last_full: int) -> StreamState:
            state.ref.copy_(frame)
            state.drift.zero_()
            state.frame_idx.fill_(frame_idx)
            state.last_full.fill_(last_full)
            return state

        return refresh

    def stream_step(self, splan, rung: int, exact: bool,
                    full_refresh_frac: float):
        """The device step for (plan, rung, exactness, refresh policy):
        ``fn(cascade, state, frame, threshold, kf_interval, out)`` returns
        ``(new_state, StreamStepOut)`` with ``new_state`` written into
        ``out``.  The executor is built once per (plan, exactness, refresh
        limits); the rung only sizes the packed list."""
        # the host float compares `n > frac * total` are reproduced on
        # device as integer compares against floor(frac * total): for
        # integer n and real c >= 0, n > c iff n > floor(c)
        tile_lim = int(full_refresh_frac * (splan.ty * splan.tx))
        win_lim = int(full_refresh_frac * max(splan.n_live, 1))
        budget = stream_budget(splan.n_slots, 1, self.max_changed_frac)
        key = ("stream_state", splan.key, exact, tile_lim, win_lim, budget)
        if key not in self._fns:
            self._fns[key] = self._build_stream_fn(splan, exact, tile_lim,
                                                   win_lim, budget)
        step = self._fns[key]

        def fn(cascade, state, frame, threshold, kf_interval, out):
            return step(state, frame, threshold, kf_interval, rung, out)

        return fn

    def _build_stream_fn(self, splan, exact: bool, tile_lim: int,
                         win_lim: int, budget: int):
        """The device step of one stream plan: tile change scoring,
        window mapping over every level at once, the mode decision, the
        SATs of every level (kernel S), the packed all-stage tail at the
        rung (kernel C under the ``pallas`` backend, live count ``n_rec``
        when the frame commits and 0 when it does not) and the state
        update, with no host sync."""
        det = self.detector
        dev = self.device
        hp, wp, h, w = splan.hp, splan.wp, splan.h, splan.w
        tile, halo = splan.tile, splan.halo
        base = compile_plan(det.config, det.n_stages, hp, wp, batch=1)
        n_slots = base.n_slots
        self.program_builds += 1
        tables = self._tables(base.layout)
        maps = self._level_maps(hp, wp, base.levels)
        s_dense = self._s_dense(hp, wp)
        # per-slot closed tile brackets of every level, flattened
        brackets = [np.concatenate(parts) if parts else np.zeros(0, np.int64)
                    for parts in zip(*(
                        (np.repeat(ty0, len(tx0)), np.repeat(ty1, len(tx0)),
                         np.tile(tx0, len(ty0)), np.tile(tx1, len(ty0)))
                        for ty0, ty1, tx0, tx1 in splan.level_tile_ranges))]
        ty0_s, ty1_s, tx0_s, tx1_s = (torch.as_tensor(a.astype(np.int64),
                                                      device=dev)
                                      for a in brackets)
        valid_s = torch.as_tensor(splan.limit_mask, device=dev)
        offs = np.cumsum([0] + [lp.n_windows for lp in base.levels])
        lvl_end = torch.as_tensor(offs[1:] - 1, device=dev)
        lvl_start = torch.as_tensor(offs[:-1], device=dev)
        # pixel -> tile maps of the padded frame, and the true frame's area
        row_tile = torch.clamp(torch.arange(hp, device=dev) // tile,
                               max=splan.ty - 1)[:, None]
        col_tile = torch.clamp(torch.arange(wp, device=dev) // tile,
                               max=splan.tx - 1)[None, :]
        inside = ((torch.arange(hp, device=dev) < h)[:, None]
                  & (torch.arange(wp, device=dev) < w)[None, :])
        decode_cap = splan.decode_cap

        def step(state: StreamState, frame: torch.Tensor, threshold: float,
                 kf_interval: int, rung: int, out: StreamState
                 ) -> tuple[StreamState, StreamStepOut]:
            # frame: (hp, wp) f32, zero-padded like the reference pixels
            rung_plan = compile_plan(det.config, det.n_stages, hp, wp,
                                     batch=1, capacity=rung)
            seg = rung_plan.segments[0]
            cap = seg.capacity
            changed, scores = tile_change_mask_kernel(
                state.ref[:h, :w], frame[:h, :w], threshold, tile=tile,
                halo=halo, exact=exact)
            n_tiles = changed.sum()
            # the maps are read only when the tile count leaves the frame
            # incremental: otherwise n_rec and levels_active report 0
            mask_flat = (range_any(changed, ty0_s, ty1_s, tx0_s, tx1_s)
                         & valid_s & (n_tiles <= tile_lim))
            csum = torch.cumsum(mask_flat, 0)
            n_rec = csum[-1]
            lvl_count = csum[lvl_end] - torch.where(
                lvl_start > 0, csum[(lvl_start - 1).clamp(min=0)], 0)
            levels_active = (lvl_count > 0).sum()
            full_needed = ((n_tiles > tile_lim) | (n_rec > win_lim)
                           | (n_rec > budget))
            if kf_interval > 0:
                full_needed = full_needed | (
                    state.frame_idx - state.last_full >= kf_interval)
            retry = (n_rec > cap) & ~full_needed
            commit = ~full_needed & ~retry
            mode = torch.where(full_needed, 2, (n_tiles > 0).long())
            # the tail: every level's SAT, the changed windows compacted at
            # the rung, live only when the frame commits
            n_live = torch.where(commit, n_rec, 0)
            ii_flat, pair_flat = self._sats(frame[None], maps)
            idx, _cnt = nonzero_static(mask_flat, cap)
            survivors = self._survivors(seg, rung_plan.lane_block, s_dense,
                                        ii_flat, pair_flat, tables, idx,
                                        n_live, n_slots, n_slots)
            new_bitmap = (state.bitmap & ~mask_flat) | survivors
            torch.where(commit, new_bitmap, state.bitmap, out=out.bitmap)
            pix = changed[row_tile, col_tile] & inside & commit
            torch.where(pix, frame, state.ref, out=out.ref)
            new_drift = torch.where(changed, 0.0,
                                    torch.maximum(state.drift, scores))
            torch.where(commit, new_drift, state.drift, out=out.drift)
            torch.add(state.frame_idx, commit.to(torch.int32),
                      out=out.frame_idx)
            out.last_full.copy_(state.last_full)
            slot_idx, n_surv = nonzero_static(out.bitmap, decode_cap)
            slots = torch.where(slot_idx < 0, n_slots, slot_idx).to(
                torch.int32)
            n_surv = torch.where(commit, n_surv, 0)
            flags = torch.stack([mode, n_tiles, n_rec, levels_active,
                                 retry.long(), n_surv]).to(torch.int32)
            return out, StreamStepOut(*flags, slots, flags)

        return step

    # -------------------------------------------------------------- run
    def incremental(self, frames: list[np.ndarray],
                    masks_per_frame: list[list[np.ndarray]],
                    hp: int, wp: int,
                    active: tuple[int, ...] | None = None
                    ) -> tuple[list[np.ndarray], np.ndarray, bool]:
        """Evaluate changed windows of a same-bucket stack of frames.

        ``masks_per_frame[i]`` is one flat bool mask per pyramid level for
        frame ``i``.  The dispatch runs a *level-subset* executor for the
        set of levels with any changed window across the stack; ``active``
        optionally widens that set.  Returns ``(survivor bitmaps per frame
        (flat n_slots), recomputed-window counts, overflow)``; on overflow
        (more changed windows than ``cap_budget``) nothing is dispatched
        and the caller must fall back to a full refresh.
        """
        geo = self.geometry(hp, wp)
        batch = len(frames)
        n_levels = len(geo.plan)
        mask_flat = np.stack([np.concatenate(masks_per_frame[i])
                              for i in range(batch)])
        counts = mask_flat.sum(axis=1).astype(np.int32)
        n_changed = int(counts.sum())
        if n_changed > self.cap_budget(geo, batch):
            return [], counts, True
        # active level subset = union over the stack of levels with any
        # changed window (plus the caller's widening hint)
        changed_lv = {li for li in range(n_levels)
                      if mask_flat[:, geo.slot_offsets[li]:
                                   geo.slot_offsets[li + 1]].any()}
        if active is not None:
            changed_lv |= set(active)
        levels = tuple(sorted(changed_lv))
        self.dispatches += 1
        self.sat_level_builds += len(levels)
        self.sat_level_total += n_levels
        if not levels:          # nothing changed anywhere: no executor at all
            return ([np.zeros(geo.n_slots, bool) for _ in range(batch)],
                    counts, False)
        sub = geo.subset(levels)
        mask_sub = mask_flat[:, sub.slot_indices]
        cap = self._cap_for(sub.n_slots, batch, n_changed)
        stack = np.zeros((batch, hp, wp), np.float32)
        for i, f in enumerate(frames):
            fh, fw = f.shape
            stack[i, :fh, :fw] = f
        fn, rung_plan = self._fn(hp, wp, batch, cap, levels)
        dev = self.device
        out, recomputed, overflow = fn(
            torch.from_numpy(stack).to(dev),
            torch.from_numpy(mask_sub).to(dev),
            rung_plan)
        # host-path contract: the host-resident caches merge survivor
        # bitmaps here (the device-resident path avoids this sync)
        # repro_torch: ignore[HOST_SYNC] host-path contract: survivor bitmaps
        sub_bitmaps = out.cpu().numpy()
        bitmaps = []
        for i in range(batch):  # scatter subset survivors into full layout
            full = np.zeros(geo.n_slots, bool)
            full[sub.slot_indices] = sub_bitmaps[i]
            bitmaps.append(full)
        # host-path contract: recompute counts and the overflow flag gate
        # the caller's full-refresh fallback
        # repro_torch: ignore[HOST_SYNC] host-path contract: counts and overflow flag
        return bitmaps, recomputed.cpu().numpy(), bool(overflow.cpu())
