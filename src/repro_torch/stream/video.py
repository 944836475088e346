"""Streaming video detection with temporal tile-reuse, in PyTorch.

The port of ``repro.stream.video``: the same configuration, statistics,
plans, modes and fallbacks, on the port's :class:`repro_torch.core
.Detector` and its device (a stream runs on the CPU only when its detector
was built with ``device="cpu"``).

:class:`VideoDetector` wraps a calibrated :class:`repro_torch.core.Detector`
for one video stream.  Per frame it:

1. scores each tile of the frame against the stream's *reference frame*
   (the pixels the cached decisions were computed on — not simply the
   previous frame, so sub-threshold drift never compounds silently);
2. maps changed tiles (plus a dilated halo) to the exact set of detection
   windows whose receptive field they overlap, per pyramid level; the
   levels with any changed window form the frame's *active level subset*
   (``FramePlan.active_levels``);
3. re-evaluates only those windows through the packed incremental engine
   (:class:`repro_torch.stream.StreamEngine`), a level-subset executor:
   fully-cached levels build no SAT at all.  Survivors merge
   into the cached per-level bitmaps; everything else is reused.

Exactness: with ``threshold <= 0`` a tile is "changed" iff any pixel
differs, so every window whose own pixels changed is recomputed, and it
reaches exactly the decision ``Detector.detect`` reaches on that frame.
A cached window's pixels did not change, but its decision is ``detect``'s
only as far as it is a function of those pixels alone: a float32 SAT
entry rounds a sum over every pixel above and left of it, so at large
frame sizes (480x640) a change elsewhere can move a cached window's
corner values and flip a stump near its threshold.  The output then
differs from per-frame ``detect`` by those windows until the next full
frame (the reference's mapping has the same property).  With a positive
threshold, cached decisions may lag the true frame by at most the
per-tile score threshold; a periodic keyframe (``keyframe_interval``)
re-detects the whole frame and bounds the staleness window.

Fallbacks keep the fast path honest: if the changed-window fraction
exceeds ``full_refresh_frac``, or the packed list overflows its static
capacity, the frame is re-detected in full (same result, no drift).

The plan/commit split (``plan_frame`` / ``commit_*``) exists so the
serving layer can batch work *across* streams: many sessions' changed
windows share one packed compaction, and many sessions' keyframes share
one ``detect_batch`` flush.  ``process`` composes the two for the
single-stream case.

Device-resident streams (``StreamConfig.device_state``) keep their state
in a ping-pong pair of :class:`StreamState` buffers: a step reads one and
writes the other, so a steady stream allocates no new state, and a
re-dispatch (rung retry, provisional true-up) always finds the state it
reads intact.  Frames go up through two pinned host buffers, each reused
only after a CUDA event shows its last copy finished; one CUDA stream
keeps the steps in order.  A steady frame's only syncs are ``poll``'s
fetch of the six step scalars and ``commit_token``'s fetch of the
survivor slots.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import Detector
from repro_torch.core import nms
from repro_torch.plan import stream_capacity_rung
from .engine import StreamEngine, StreamGeometry, StreamState
from .tiles import (tile_grid_shape, tile_change_scores, dilate_tiles,
                    changed_window_mask)

__all__ = ["StreamConfig", "FrameStats", "FramePlan", "VideoDetector",
           "level_windows_from_raw"]

_MODES = ("cached", "incremental", "full")


def level_windows_from_raw(levels, index: int | None = None
                           ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Surviving (ys, xs) per pyramid level from a raw detector pass.

    ``levels`` is ``Detector.detect_raw`` output (``index=None``) or the
    batched ``detect_batch_raw`` output (``index`` = image position); the
    single decode/overflow policy for every keyframe path, single-stream
    and service-batched alike."""
    if not levels:
        return []
    pick = (lambda t: t) if index is None else (lambda t: t[index])
    # keyframe decode: the raw survivor arrays are this path's output (one
    # transfer for the overflow flags, one per level for the survivors)
    # repro_torch: ignore[HOST_SYNC] keyframe decode: the overflow flags
    over = torch.stack([pick(res.overflow) for res, _s in levels]).cpu()
    if bool(over.any()):
        raise RuntimeError(
            "wave-engine capacity overflow on stream keyframe; raise "
            "capacity_fracs (see Detector.calibrated)")
    wins = []
    for res, _scale in levels:
        # repro_torch: ignore[HOST_SYNC] keyframe decode: the level's survivors
        ys, xs, val = torch.stack([pick(res.ys), pick(res.xs),
                                   pick(res.valid).long()]).cpu().numpy()
        val = val.astype(bool)
        wins.append((ys[val], xs[val]))
    return wins


class StreamConfig(NamedTuple):
    tile: int = 32                 # tile edge, image coords
    threshold: float = 0.0         # mean-sq change per pixel; <=0 = exact
    halo: int = 1                  # dilation rings around changed tiles
    keyframe_interval: int = 64    # full re-detect cadence; 0 = never
    max_changed_frac: float = 0.5  # incremental budget as a window fraction
    full_refresh_frac: float = 0.5  # changed-window frac forcing full detect
    # ---- graceful-degradation knobs (fleet serving under overload).
    # degraded(level) stretches the keyframe cadence and raises the change
    # threshold; it never touches tile/halo, so the conservative
    # changed-tile -> window mapping (every window whose receptive field
    # overlaps a changed tile is recomputed) is preserved at every level.
    degrade_keyframe_mult: float = 2.0   # keyframe_interval x this / level
    degrade_threshold_add: float = 0.0   # change-score added per level (0 =
    #                                      keyframe stretch only, keeps
    #                                      threshold-0 streams exact)
    max_degrade_level: int = 3
    # ---- device-resident state.  True moves the reference frame, survivor
    # bitmap and frame counters onto the device: per frame, change scoring,
    # window mapping, the cached/incremental/full decision AND the
    # incremental tail all run in one device step with no host sync; the
    # host uploads the new frame and fetches a handful of scalars plus the
    # survivor slot list.  Frames go through submit/retire (process
    # composes them); at threshold<=0 the output stays bit-identical to
    # the host-planned path, and every recomputed window takes per-frame
    # Detector.detect's decision (cached ones: see the module docstring).
    device_state: bool = False

    def degraded(self, level: int) -> "StreamConfig":
        """The stretched config at degradation ``level`` (0 = this config).

        Level is clamped to ``max_degrade_level``.  Each level multiplies
        the keyframe interval by ``degrade_keyframe_mult`` (0 = never stays
        never) and adds ``degrade_threshold_add`` to the change threshold;
        with the default additive step of 0, a threshold-0 (exact) stream
        keeps its change test and window mapping at every level, and so
        its agreement with per-frame detection (module docstring) — only
        its full-refresh cadence stretches."""
        level = max(0, min(int(level), self.max_degrade_level))
        if level == 0:
            return self
        kf = self.keyframe_interval
        if kf > 0:
            kf = max(int(round(kf * self.degrade_keyframe_mult ** level)), kf)
        thr = self.threshold + self.degrade_threshold_add * level
        return self._replace(keyframe_interval=kf, threshold=thr)


class FrameStats(NamedTuple):
    frame_idx: int
    mode: str                      # 'full' | 'incremental' | 'cached'
    tiles_total: int
    tiles_changed: int             # after halo dilation
    windows_total: int             # live (limit-valid) windows, all levels
    windows_recomputed: int
    levels_total: int = 0          # pyramid levels in the bucket's plan
    levels_active: int = 0         # levels whose SAT/head ran this frame

    @property
    def tile_skip_frac(self) -> float:
        return 1.0 - self.tiles_changed / max(self.tiles_total, 1)

    @property
    def window_skip_frac(self) -> float:
        return 1.0 - self.windows_recomputed / max(self.windows_total, 1)

    @property
    def level_skip_frac(self) -> float:
        """Fraction of pyramid levels whose dense-wave/SAT head was skipped
        (fully cached) this frame."""
        return 1.0 - self.levels_active / max(self.levels_total, 1)


class FramePlan(NamedTuple):
    mode: str                      # 'full' | 'incremental' | 'cached'
    masks: list | None             # per-level flat recompute masks
    changed_tiles: np.ndarray | None   # dilated tile mask
    tiles_changed: int
    windows_to_recompute: int
    active_levels: tuple[int, ...] | None = None   # levels with changed
    #                                windows ('incremental' plans only; the
    #                                incremental engine builds SATs for
    #                                exactly this subset)


class _DevToken:
    """One in-flight frame of a device-resident stream.

    Created by :meth:`VideoDetector.submit`, resolved by ``poll`` and
    finished by ``commit_token``/``discard_token`` (``retire`` composes
    them).  ``out`` holds the step's device tensors while the frame is in
    flight; fetching them is the only host sync of a steady-state frame.
    """
    __slots__ = ("frame", "dev_frame", "out", "out_state", "version",
                 "dispatched", "flags")

    def __init__(self, frame: np.ndarray):
        self.frame = frame          # (h, w) f32 host pixels (for fallbacks)
        self.dev_frame = None       # (hp, wp) device copy, set on dispatch
        self.out = None             # StreamStepOut device tensors
        self.out_state = None       # the dispatch's output StreamState
        self.version = -1           # state version the dispatch consumed
        self.dispatched = False
        self.flags = None           # fetched scalar tuple, set by poll


class VideoDetector:
    """One stream's temporal state over a shared :class:`Detector`."""

    def __init__(self, detector: Detector, config: StreamConfig = StreamConfig(),
                 engine: StreamEngine | None = None, *,
                 decode_cap: int | None = None):
        self.detector = detector
        self.config = config
        self.engine = engine or StreamEngine(detector,
                                             config.max_changed_frac)
        self._shape: tuple[int, int] | None = None
        self._geo: StreamGeometry | None = None
        self._limits: list[tuple[int, int]] = []
        self._n_live = 0
        self._tile_grid: tuple[int, int] = (0, 0)
        self._tiles_total = 0
        self._scales: np.ndarray | None = None
        self._ref: np.ndarray | None = None         # reference pixels
        self._bitmap: np.ndarray | None = None      # flat survivor cache
        self._rects: np.ndarray | None = None       # cached grouped output
        self._frame_idx = 0
        self._last_full = -1
        # ---- device-resident state (config.device_state)
        self._decode_cap = decode_cap     # override for the slot-list size
        self._splan = None                # StreamStatePlan, built at open
        self._dev_state = None            # the chain head: one of _bufs
        self._bufs: tuple[StreamState, StreamState] | None = None
        self._pinned: list | None = None  # two pinned host frame buffers
        self._pin_events: list = [None, None]   # their last copies
        self._pin_next = 0
        self._dev_rung = 0                # sticky packed-tail capacity rung
        self._pending: deque[_DevToken] = deque()   # in-flight frames, FIFO
        self._state_version = 0           # bumped on re-upload/retry commits
        self._prov = False                # device bitmap is provisional
        self._last_mode = "full"          # last committed frame's mode
        self.xfer_bytes = 0               # host<->device traffic accounting

    # ------------------------------------------------------------ plumbing
    @property
    def frame_idx(self) -> int:
        return self._frame_idx

    @property
    def bucket_hw(self) -> tuple[int, int] | None:
        return None if self._geo is None else (self._geo.hp, self._geo.wp)

    def _init_stream(self, frame: np.ndarray) -> None:
        h, w = frame.shape
        self._shape = (h, w)
        hp, wp = self.detector._bucket_hw(h, w)
        self._geo = self.engine.geometry(hp, wp)
        self._limits = self._geo.limits(h, w)
        self._n_live = 0
        for (ny, nx), (y_lim, x_lim) in zip(self._geo.level_windows,
                                            self._limits):
            n_y = min(int(y_lim) // self._geo.step + 1, ny) if y_lim >= 0 else 0
            n_x = min(int(x_lim) // self._geo.step + 1, nx) if x_lim >= 0 else 0
            self._n_live += n_y * n_x
        # per-frame constants, computed once at open (not per _finish call)
        ty, tx = tile_grid_shape(h, w, self.config.tile)
        self._tile_grid = (ty, tx)
        self._tiles_total = ty * tx
        # repro: ignore[HOST_SYNC] host constant from plan metadata, no device round-trip
        self._scales = (np.asarray([lv.scale for lv in self._geo.plan])  # repro_torch: ignore[HOST_SYNC] plan metadata, no device round-trip
                        if self._geo.plan else np.zeros(0))
        if self.config.device_state and self._geo.n_slots > 0:
            self._splan = self.engine.stream_plan(
                hp, wp, h, w, self.config.tile, self.config.halo,
                decode_cap=self._decode_cap)
            self._dev_rung = stream_capacity_rung(self._splan.n_slots, 1, 0)

    def _check_frame(self, frame) -> np.ndarray:
        # repro: ignore[HOST_SYNC] frame intake: callers hand in host pixels
        frame = np.asarray(frame, np.float32)  # repro_torch: ignore[HOST_SYNC] frame intake
        if frame.ndim != 2:
            raise ValueError(f"expected grayscale (H, W) frame, got "
                             f"shape {frame.shape}")
        if self._shape is None:
            self._init_stream(frame)
        elif frame.shape != self._shape:
            raise ValueError(f"stream frame shape changed: {self._shape} -> "
                             f"{frame.shape}; open a new stream instead")
        return frame

    # ------------------------------------------------------------ planning
    def plan_frame(self, frame) -> tuple[np.ndarray, FramePlan]:
        """Decide how to process ``frame``; returns (frame_f32, plan)."""
        frame = self._check_frame(frame)
        cfg = self.config
        geo = self._geo
        if self._splan is not None:
            raise RuntimeError(
                "device-resident stream: planning happens on device — use "
                "submit/poll/commit_token (or process) instead of "
                "plan_frame")
        if self._ref is None:
            return frame, FramePlan("full", None, None, 0, 0)
        if geo.n_slots == 0:       # frame smaller than the detection window
            return frame, FramePlan("cached", None, None, 0, 0)
        due = (cfg.keyframe_interval > 0 and
               self._frame_idx - self._last_full >= cfg.keyframe_interval)
        if due:
            return frame, FramePlan("full", None, None, 0, 0)
        exact = cfg.threshold <= 0
        scores, changed_any = tile_change_scores(self._ref, frame, cfg.tile,
                                                 exact=exact)
        changed = changed_any if exact else (scores > cfg.threshold)
        changed = dilate_tiles(changed, cfg.halo)
        n_changed = int(changed.sum())
        if n_changed == 0:
            return frame, FramePlan("cached", None, changed, 0, 0)
        # tile fraction under-estimates the window fraction (receptive
        # fields cover multiple tiles), so this is a safe early exit that
        # skips per-level mask building when a refresh is certain anyway
        if n_changed > cfg.full_refresh_frac * changed.size:
            return frame, FramePlan("full", None, changed, n_changed, 0)
        masks = [changed_window_mask(changed, cfg.tile, geo.hp, geo.wp,
                                     lv, geo.step, y_lim, x_lim)
                 for lv, (y_lim, x_lim) in zip(geo.plan, self._limits)]
        n_rec = int(sum(int(m.sum()) for m in masks))
        if n_rec > cfg.full_refresh_frac * max(self._n_live, 1):
            return frame, FramePlan("full", None, changed, n_changed, n_rec)
        active = tuple(li for li, m in enumerate(masks) if m.any())
        return frame, FramePlan("incremental", masks, changed,
                                n_changed, n_rec, active)

    # ------------------------------------------------------------- commits
    def _decode_slots(self, idxs: np.ndarray) -> np.ndarray:
        """Grouped rects from a list of surviving flat slot indices.

        The single decode path for host bitmaps and device slot lists; the
        returned array is marked read-only so cached frames can hand the
        same object back without a per-frame copy."""
        geo = self._geo
        if len(idxs) == 0:
            rects = np.zeros((0, 4), np.int32)
        else:
            rects = Detector._decode_rects(
                geo.y_of_slot[idxs], geo.x_of_slot[idxs],
                self._scales[geo.lvl_of_slot[idxs]])
        rects = nms.group_rectangles(rects,
                                     self.detector.config.min_neighbors)
        rects.setflags(write=False)
        return rects

    def _decode(self) -> np.ndarray:
        return self._decode_slots(np.nonzero(self._bitmap)[0])

    def _finish(self, frame: np.ndarray, mode: str, tiles_changed: int,
                recomputed: int, levels_active: int
                ) -> tuple[np.ndarray, FrameStats]:
        self._rects = self._decode() if mode != "cached" else self._rects
        stats = FrameStats(self._frame_idx, mode, self._tiles_total,
                           tiles_changed, self._n_live, recomputed,
                           len(self._geo.plan), levels_active)
        self._frame_idx += 1
        self._last_mode = mode
        # read-only (see _decode_slots): cached frames return the same
        # array, copy-free — callers must not mutate it
        return self._rects, stats

    def commit_full(self, frame: np.ndarray,
                    level_windows: list[tuple[np.ndarray, np.ndarray]] | None
                    = None, *, dev_frame=None
                    ) -> tuple[np.ndarray, FrameStats]:
        """Full re-detect: refresh every cached decision from ``frame``.

        ``level_windows`` (surviving (ys, xs) per pyramid level, as produced
        by the detector's raw paths) lets the serving layer batch many
        streams' keyframes through ``detect_batch_raw`` and feed each
        session its slice; when omitted the detector runs directly.
        ``dev_frame`` is the frame's already-device-resident padded copy
        (a retired token's step input): with it, the state re-seed skips
        re-uploading the reference pixels.
        """
        geo = self._geo
        prov = (self._splan is not None and dev_frame is not None
                and level_windows is None and self._dev_state is not None
                and bool(self._pending))
        if prov:
            # pipelined stream with a queued successor: re-seed only the
            # verdict-bearing state (reference pixels + counters, both
            # final before the detect) and dispatch the successor NOW, so
            # its step overlaps the whole host-side refresh below.  Its
            # bitmap input is stale — poll trues it up from the host
            # mirrors if (and only if) the successor's verdict commits.
            fi = self._frame_idx            # _finish increments it below
            self._dev_state = self.engine.provisional_refresh(self._splan)(
                self._dev_state, dev_frame, fi + 1, fi)
            self.xfer_bytes += 8
            self._state_version += 1
            self._prov = True
            self._dispatch_token(self._pending[0])
        if level_windows is None:
            level_windows = level_windows_from_raw(
                self.detector.detect_raw(frame))
        # full-detect traffic: frame up, surviving window coords back down
        self.xfer_bytes += frame.nbytes + sum(
            ys.nbytes + xs.nbytes for ys, xs in level_windows)
        bitmap = np.zeros(geo.n_slots, bool)
        for li, (ys, xs) in enumerate(level_windows):
            if len(ys) == 0:
                continue
            ny, nx = geo.level_windows[li]
            slots = (geo.slot_offsets[li] + (ys // geo.step) * nx
                     + xs // geo.step)
            bitmap[slots] = True
        self._bitmap = bitmap
        self._ref = frame.copy()
        self._last_full = self._frame_idx
        out = self._finish(frame, "full", self._tiles_total, self._n_live,
                           len(geo.plan))
        if self._splan is not None and not prov:
            self._upload_state(frame, dev_frame)
        return out

    def _upload_state(self, frame: np.ndarray, dev_frame=None) -> None:
        """Re-seed the device state from the host mirrors after a full
        refresh, then drop the mirrors: between full frames the reference
        pixels and survivor bitmap live only on the device.  The state is
        written into the chain head's buffers (the first of the pair when
        the stream opens).  When the frame is already on the device
        (``dev_frame``, a retired token's step input) only the survivor
        bitmap and counters cross the bus."""
        splan = self._splan
        if dev_frame is not None and self._dev_state is not None:
            self._dev_state = self.engine.refresh_state(splan)(
                self._dev_state, dev_frame, self._bitmap, self._frame_idx,
                self._last_full)
            self.xfer_bytes += self._bitmap.nbytes + 8
        else:
            if self._bufs is None:
                self._bufs = (self.engine.alloc_state(splan),
                              self.engine.alloc_state(splan))
            self._dev_state = self.engine.init_state(
                splan, frame, self._bitmap, self._frame_idx,
                self._last_full,
                out=self._bufs[0] if self._dev_state is None
                else self._dev_state)
            self.xfer_bytes += (splan.hp * splan.wp * 4
                                + self._bitmap.nbytes
                                + splan.ty * splan.tx * 4 + 8)
        self._ref = None
        self._bitmap = None
        self._prov = False
        # in-flight successors were planned against the pre-refresh state;
        # versioning makes poll re-dispatch them against this one
        self._state_version += 1

    def commit_incremental(self, frame: np.ndarray, plan: FramePlan,
                           survivors_flat: np.ndarray
                           ) -> tuple[np.ndarray, FrameStats]:
        """Merge recomputed survivors into the cache; update the reference
        pixels under every recomputed tile."""
        mask_flat = np.concatenate(plan.masks)
        self._bitmap = (self._bitmap & ~mask_flat) | survivors_flat
        h, w = self._shape
        tile = self.config.tile
        pix = np.repeat(np.repeat(plan.changed_tiles, tile, axis=0),
                        tile, axis=1)[:h, :w]
        self._ref = np.where(pix, frame, self._ref)
        return self._finish(frame, "incremental", plan.tiles_changed,
                            plan.windows_to_recompute,
                            len(plan.active_levels or ()))

    def commit_cached(self, frame: np.ndarray,
                      plan: FramePlan) -> tuple[np.ndarray, FrameStats]:
        return self._finish(frame, "cached", plan.tiles_changed, 0, 0)

    # ------------------------------------------- device-resident fast path
    def submit(self, frame) -> _DevToken:
        """Queue ``frame`` on the device-resident stream and return its
        token.  When the stream is steady (state exists, last frame wasn't
        a full refresh) the plan-and-eval step is dispatched *immediately*:
        CUDA launches are asynchronous, so frame N+1's change scoring and
        SAT pass overlap the host-side decode of frame N
        (double-buffering).  Tokens must be retired in submit order."""
        if not self.config.device_state:
            raise RuntimeError(
                "submit/retire need StreamConfig.device_state=True; use "
                "process/plan_frame on host-planned streams")
        frame = self._check_frame(frame)
        tok = _DevToken(frame)
        self._pending.append(tok)
        # dispatch immediately when this token is next in line (launches
        # are asynchronous, so its step runs while the host does other
        # work); queued-behind tokens are dispatched by retire/poll the
        # moment their predecessor's state is confirmed
        if (self._splan is not None and self._dev_state is not None
                and len(self._pending) == 1):
            self._dispatch_token(tok)
        return tok

    def _upload_frame(self, frame: np.ndarray) -> torch.Tensor:
        """``frame`` zero-padded to the bucket, on the device.  On the card
        it goes up from one of two pinned host buffers with a non-blocking
        copy; a buffer is rewritten only after the CUDA event recorded
        behind its last copy has completed, so a step never reads a frame
        overwritten in flight."""
        splan = self._splan
        dev = self.detector.device
        if dev.type != "cuda":
            padded = np.zeros((splan.hp, splan.wp), np.float32)
            padded[:splan.h, :splan.w] = frame
            return torch.from_numpy(padded).to(dev)
        if self._pinned is None:
            self._pinned = [torch.zeros((splan.hp, splan.wp),
                                        dtype=torch.float32).pin_memory()
                            for _ in range(2)]
        i = self._pin_next
        self._pin_next ^= 1
        if self._pin_events[i] is not None:
            # repro_torch: ignore[HOST_SYNC] frame intake: a wait the reference does not make (ROADMAP §3, P12)
            self._pin_events[i].synchronize()
        # the padding stays zero: a stream's frame shape is fixed
        # repro_torch: ignore[HOST_SYNC] frame intake: a view of the pinned host buffer, no transfer
        self._pinned[i].numpy()[:splan.h, :splan.w] = frame
        dev_frame = torch.empty((splan.hp, splan.wp), dtype=torch.float32,
                                device=dev)
        dev_frame.copy_(self._pinned[i], non_blocking=True)
        self._pin_events[i] = torch.cuda.Event()
        self._pin_events[i].record()
        return dev_frame

    def _dispatch_token(self, tok: _DevToken) -> None:
        """Run the device step for ``tok``'s frame against the confirmed
        chain head, writing the other buffer of the pair, which becomes
        the head.  Only called when every predecessor
        of ``tok`` is resolved (queue head, or dispatched by retire/poll
        right after the predecessor's state was confirmed), so the head is
        always the correct input; if the stream later retries or
        full-refreshes under this token's feet, the version check in
        ``poll`` re-dispatches it against the corrected state."""
        cfg = self.config
        splan = self._splan
        fn = self.engine.stream_step(splan, self._dev_rung,
                                     cfg.threshold <= 0,
                                     cfg.full_refresh_frac)
        if tok.dev_frame is None:    # a re-dispatch reuses the upload
            tok.dev_frame = self._upload_frame(tok.frame)
            self.xfer_bytes += splan.hp * splan.wp * 4
        head = self._dev_state
        spare = self._bufs[1] if head is self._bufs[0] else self._bufs[0]
        new_state, tok.out = fn(
            self.detector.cascade, head, tok.dev_frame,
            float(cfg.threshold), int(cfg.keyframe_interval), spare)
        tok.out_state = new_state
        self._dev_state = new_state
        tok.version = self._state_version
        tok.dispatched = True
        tok.flags = None

    def _fetch_flags(self, tok: _DevToken) -> tuple:
        # contract sync: the step's scalar verdict (mode, tiles_changed,
        # n_rec, levels_active, retry, n_surv) is what poll exists to
        # fetch, in one transfer
        # repro_torch: ignore[HOST_SYNC] contract sync: the step's scalar verdict
        tok.flags = tuple(tok.out.flags.tolist())
        self.xfer_bytes += 6 * 4
        return tok.flags

    def poll(self, tok: _DevToken) -> str:
        """Resolve ``tok``'s frame mode: ``'cached'`` / ``'incremental'``
        (finish via :meth:`commit_token`) or ``'full'`` (the device did
        not commit; take ``discard_token`` and run :meth:`commit_full`).
        Blocks on the device step; re-dispatches stale or deferred
        tokens, and transparently regrows the packed capacity rung when
        the step reports overflow (``retry``)."""
        if not self._pending or tok is not self._pending[0]:
            raise RuntimeError("device tokens must be polled/retired in "
                               "submit order")
        if self._dev_state is None:
            # stream-opening keyframe, post-reset, or a degenerate stream
            # with no windows (n_slots == 0): host semantics apply
            return "cached" if self._splan is None \
                and self._ref is not None else "full"
        if not tok.dispatched or tok.version != self._state_version:
            self._dispatch_token(tok)
        flags = self._fetch_flags(tok)
        retried = False
        while True:
            if bool(flags[4]):   # rung overflow: nothing was committed
                self._dev_rung = stream_capacity_rung(
                    self._splan.n_slots, 1, int(flags[2]))
                retried = True
                self._dispatch_token(tok)
                flags = self._fetch_flags(tok)
                continue
            if self._prov and _MODES[int(flags[0])] != "full":
                # the bitmap the provisional dispatch carried mattered
                # after all (the verdict commits): true the device state
                # up from the host mirrors and re-run the step
                self._upload_state(self._ref)
                self._dispatch_token(tok)
                flags = self._fetch_flags(tok)
                continue
            break
        # accept: the token's output becomes the confirmed chain head
        self._dev_state = tok.out_state
        mode = _MODES[int(flags[0])]
        if retried and mode != "full":
            # the retry committed against state an already-dispatched
            # successor didn't see; version it so poll re-dispatches them
            self._state_version += 1
            tok.version = self._state_version
        return mode

    def commit_token(self, tok: _DevToken) -> tuple[np.ndarray, FrameStats]:
        """Finish a polled ``'cached'``/``'incremental'`` token: fetch the
        decoded survivor slots (incremental only), group rects, and mirror
        the host path's engine counters."""
        if self._splan is None:        # degenerate stream: host cached path
            self._pending.popleft()
            return self._finish(tok.frame, "cached", 0, 0, 0)
        n_tiles, n_rec, lvls, n_surv = (int(tok.flags[i]) for i in
                                        (1, 2, 3, 5))
        mode = _MODES[int(tok.flags[0])]
        self._pending.popleft()
        if mode == "incremental":
            if n_surv > self._splan.decode_cap:
                # survivor count overflows the static slot list (decode
                # only — the committed device bitmap is fine).  Recover
                # deterministically via a host full refresh: identical
                # rects at threshold 0, counted as a full frame.
                return self.commit_full(tok.frame, dev_frame=tok.dev_frame)
            self.engine.dispatches += 1
            self.engine.sat_level_builds += lvls
            self.engine.sat_level_total += len(self._geo.plan)
            # contract sync: the decoded survivor slots are the frame's
            # output; only the n_surv live ones cross the bus
            # repro_torch: ignore[HOST_SYNC] slot decode: the frame's survivor slots
            slots = tok.out.slots[:n_surv].cpu().numpy()
            self.xfer_bytes += n_surv * 4
            self._rects = self._decode_slots(slots)
        stats = FrameStats(self._frame_idx, mode, self._tiles_total,
                           n_tiles, self._n_live, n_rec,
                           len(self._geo.plan), lvls)
        self._frame_idx += 1
        self._last_mode = mode
        return self._rects, stats

    def discard_token(self, tok: _DevToken) -> np.ndarray:
        """Pop a polled ``'full'`` token and hand back its frame; the
        caller finishes it through :meth:`commit_full` (possibly batched
        with other streams' keyframes by the serving layer)."""
        if not self._pending or tok is not self._pending[0]:
            raise RuntimeError("device tokens must be polled/retired in "
                               "submit order")
        self._pending.popleft()
        return tok.frame

    def retire(self, tok: _DevToken) -> tuple[np.ndarray, FrameStats]:
        """Block on ``tok`` and finish its frame (single-stream path)."""
        mode = self.poll(tok)
        # double-buffer: poll just confirmed the chain head, so a queued
        # successor can dispatch *now* and run its device step while this
        # frame's host-side decode/NMS (or full re-detect) happens below.
        # Skip when this frame goes full — its commit replaces the state
        # and the dispatch would be thrown away.
        if mode != "full" and len(self._pending) > 1 \
                and self._splan is not None:
            nxt = self._pending[1]
            if not nxt.dispatched or nxt.version != self._state_version:
                self._dispatch_token(nxt)
        if mode == "full":
            out = self.commit_full(self.discard_token(tok),
                                   dev_frame=tok.dev_frame)
        else:
            out = self.commit_token(tok)
        # a successor deferred by a full-refresh streak (or invalidated by
        # a decode-overflow fallback) chains off the state the commit just
        # re-uploaded; dispatching it here still overlaps the caller's
        # next host phase
        if self._pending and self._splan is not None \
                and self._dev_state is not None:
            head = self._pending[0]
            if not head.dispatched or head.version != self._state_version:
                self._dispatch_token(head)
        return out

    def reconfigure(self, config: StreamConfig) -> None:
        """Swap the stream's threshold/keyframe policy mid-stream without
        dropping temporal state — the serving layer's degradation path
        (``config.degraded(level)``).  ``tile`` and ``halo`` must not
        change: the cached bitmaps stay valid under any threshold/cadence,
        but the change-detection granularity is part of the stream's
        conservative-mapping contract and is fixed at open time."""
        if (config.tile, config.halo) != (self.config.tile, self.config.halo):
            raise ValueError(
                f"tile/halo are fixed per stream: "
                f"{(self.config.tile, self.config.halo)} -> "
                f"{(config.tile, config.halo)}; open a new stream instead")
        if config.device_state != self.config.device_state:
            raise ValueError(
                "device_state is fixed per stream (the temporal state "
                "lives on one side); open a new stream instead")
        self.config = config

    # -------------------------------------------------------------- public
    def process(self, frame) -> tuple[np.ndarray, FrameStats]:
        """Detect faces in the next frame of this stream.

        Returns ``(rects, stats)`` with rects exactly as
        ``Detector.detect`` would format them (the array is read-only and
        shared across cached frames — copy before mutating).
        """
        if self.config.device_state:
            return self.retire(self.submit(frame))
        frame, plan = self.plan_frame(frame)
        return self.commit_planned(frame, plan)

    def commit_planned(self, frame: np.ndarray, plan: FramePlan
                       ) -> tuple[np.ndarray, FrameStats]:
        """Execute a host-planned frame: the commit half of ``process``
        (benchmarks time the plan/commit phases through this split)."""
        if plan.mode == "cached":
            return self.commit_cached(frame, plan)
        if plan.mode == "full":
            return self.commit_full(frame)
        geo = self._geo
        bitmaps, _rec, overflow = self.engine.incremental(
            [frame], [plan.masks], geo.hp, geo.wp,
            active=plan.active_levels)
        # frame stack up; recompute masks up, survivor bitmap back down
        self.xfer_bytes += geo.hp * geo.wp * 4 + 2 * geo.n_slots
        if overflow:   # too many changed windows for the packed capacity
            return self.commit_full(frame)
        return self.commit_incremental(frame, plan, bitmaps[0])

    def reset(self) -> None:
        """Drop all temporal state (next frame is a keyframe)."""
        self._ref = None
        self._bitmap = None
        self._rects = None
        self._last_full = -1
        self._dev_state = None
        self._pending.clear()
        self._state_version += 1
        self._prov = False
        self._last_mode = "full"
