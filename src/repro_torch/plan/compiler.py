"""The cascade plan compiler, copied from ``repro.plan.compiler``.

Pure numpy.  The port keeps its own copy because importing ``repro.plan``
pulls in jax; plans and their keys must stay equal to the reference's.
Every IR construction below carries a ``PLAN_GEOMETRY`` suppression: this
module is the port's only plan producer, as ``src/repro/plan/`` is the
reference's.

One place that derives execution facts.

``compile_plan`` / ``compile_level_plan`` turn (EngineConfig, cascade
stage count, bucket shape, batch, optional active-level subset, optional
capacity rung) into the typed IR of :mod:`repro_torch.plan.ir`.  Everything the
engines used to re-derive independently lives here, once:

- pyramid levels and per-level window grids / limits
  (:func:`compile_plan`, :func:`window_limits`);
- the dense-prefix / compacted-tail segmentation of the cascade
  (:func:`segment_spans`);
- compaction capacity ladders — per-level (:func:`level_capacities`),
  shared across a batch (:func:`shared_capacities`), and the streaming
  power-of-two rungs (:func:`stream_capacity_rung`, :func:`stream_budget`);
- the per-segment / per-rung packed-tail backend decision from the
  measured ``EngineConfig.tail_rungs`` crossover ladder
  (:func:`select_backend`);
- the per-level dense-head execution mode — fused head (kernels S + A)
  vs split head (S, plain 1/sigma, kernel B per stage) — from the
  measured ``EngineConfig.head_rungs`` crossover ladder
  (:func:`select_head_mode`), plus resolution of the autotuned
  ``head_tile`` / ``lane_block`` shapes the executors hand the kernels.

Plans are cached (``functools.lru_cache``) on their full identity, so a
plan object — and its ``key`` — is stable across calls: executors key
their jit caches on ``plan.key`` and rebuild a program only when a
genuinely new plan appears.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from repro_torch.core.cascade import WINDOW
from repro_torch.core.pyramid import pyramid_plan
from repro_torch.kernels.packed_tail import BACKENDS

from .ir import (CascadePlan, LevelPlan, LevelWavePlan, SegmentPlan,
                 SlotLayout, StreamStatePlan)

__all__ = ["CAP_FLOOR", "BATCH_CAP_FLOOR", "STREAM_CAP_BASE",
           "STREAM_DECODE_CAP",
           "segment_spans", "n_compactions", "level_capacities",
           "shared_capacities", "select_backend", "select_head_mode",
           "dense_on_kernels", "validate_config",
           "window_limits", "compile_level_plan", "compile_plan",
           "compile_stream_plan",
           "stream_capacity_rung", "stream_budget", "segment_work_units"]

# static-shape floor of every compaction capacity: keeps `nonzero(size=...)`
# shapes sane for tiny levels, and is exactly the per-(image, level) lane
# waste that the batched engine's shared compaction amortizes.
CAP_FLOOR = 256
BATCH_CAP_FLOOR = 128

# smallest rung of the streaming packed-list capacity ladder: the host
# knows the exact changed-window count before dispatch, so stream programs
# compile a few power-of-two capacities and pick the smallest that fits.
STREAM_CAP_BASE = 512

# static length of the decoded-survivor slot list a device-resident stream
# step ships back per frame (the only steady-state device->host transfer
# besides the plan scalars); overflow falls back to a host full refresh
STREAM_DECODE_CAP = 2048


# ------------------------------------------------------------ segmentation
def segment_spans(n_stages: int, config) -> tuple[tuple[int, int, bool], ...]:
    """[(s0, s1, dense?)] covering all stages in order — the one
    segmentation of the cascade into dense waves and compacted tail runs."""
    if config.mode == "dense":
        return ((0, n_stages, True),)
    segs: list[tuple[int, int, bool]] = []
    s = 0
    for ds in config.dense_segments:
        if s >= n_stages:
            break
        s1 = min(s + ds, n_stages)
        segs.append((s, s1, True))
        s = s1
    while s < n_stages:
        s1 = min(s + config.compact_every, n_stages)
        segs.append((s, s1, False))
        s = s1
    return tuple(segs)


def n_compactions(spans) -> int:
    """Compactions a segment plan performs (>= 1: dense mode compacts once
    at the end to produce its survivor list)."""
    return max(sum(1 for (_s0, _s1, d) in spans if not d), 1)


# -------------------------------------------------------- capacity ladders
def level_capacities(n_windows: int, n_comp: int, fracs) -> tuple[int, ...]:
    """Per-compaction survivor capacities of one level's wave program, as
    fractions of that level's window count (conservative halving schedule
    when ``fracs`` runs out — profile-guided schedules are tighter)."""
    caps = []
    for i in range(n_comp):
        if i < len(fracs):
            f = fracs[i]
        else:
            # conservative default: halve per compaction with an 8% floor
            # (first compaction keeps everything — can never overflow)
            f = max(0.5 ** i, 0.08)
        cap = max(int(math.ceil(n_windows * min(f, 1.0))), CAP_FLOOR)
        caps.append(min(cap, n_windows))  # never more lanes than windows
    return tuple(caps)


def shared_capacities(n_slots: int, batch: int, n_comp: int,
                      config) -> tuple[int, ...]:
    """Per-compaction capacities of the batched engine's *shared* window
    list (one entry per compaction; at least one).  Mirrors
    :func:`level_capacities` but over the whole batch's windows, so the
    static floor is paid once per flush instead of per (image, level)."""
    bf = config.batch_capacity_fracs or config.capacity_fracs
    total = n_slots * batch
    caps: list[int] = []
    for k in range(n_comp):
        if k < len(bf):
            f = float(bf[k])
        else:
            f = max(0.5 ** k, 0.08)
        cap = max(int(math.ceil(total * min(f, 1.0))), BATCH_CAP_FLOOR)
        cap = min(cap, caps[-1] if caps else total)
        caps.append(cap)
    return tuple(caps)


def stream_capacity_rung(n_sub_slots: int, batch: int, n_changed: int) -> int:
    """Smallest power-of-two ladder rung holding ``n_changed`` packed
    windows, capped at the active subset's own slot count."""
    total = max(n_sub_slots * batch, 1)
    cap = STREAM_CAP_BASE
    while cap < n_changed:
        cap *= 2
    return min(cap, total)


def stream_budget(n_slots: int, batch: int, max_changed_frac: float) -> int:
    """Most changed windows an incremental flush may evaluate; beyond it a
    full refresh is cheaper anyway (the caller's fallback)."""
    total = max(n_slots * batch, 1)
    return min(max(int(math.ceil(total * max_changed_frac)), 1), total)


# ------------------------------------------------------------- work model
def segment_work_units(plan: CascadePlan) -> tuple[int, ...]:
    """Per-segment lanes × stage-depth cost vector of a compiled plan.

    The per-segment breakdown behind :attr:`CascadePlan.work_units`: dense
    segments cost ``n_slots * batch * depth``, compacted tails cost
    ``capacity * depth``.  Consumers that budget or place *parts* of a
    cascade (the energy governor's reporting, DAG cost models) read this;
    consumers that only need the total use ``plan.work_units``.
    """
    dense_lanes = plan.n_slots * plan.batch
    return tuple((dense_lanes if seg.dense
                  else min(seg.capacity, dense_lanes)) * seg.depth
                 for seg in plan.segments)


# -------------------------------------------------------- backend decision
def dense_on_kernels(config, step: int) -> bool:
    """Whether the dense prefix of a plan with this ``step`` runs on the
    dense kernels (A or B: ``use_pallas`` and step 1) rather than the plain
    oracle.  The executors pick their dense evaluator by it, and the
    stream's tail takes the dense kernels' arithmetic for those stages
    (``s_dense``) exactly when it holds."""
    return bool(getattr(config, "use_pallas", False)) and step == 1


def select_backend(config, n_windows: int) -> str:
    """Packed-tail backend for a list of ``n_windows`` lanes.

    ``config.tail_backend`` forces a specific backend; ``"auto"`` walks the
    calibrated ``config.tail_rungs`` ladder — ((max_windows, backend), ...)
    ascending — and picks the smallest rung holding the list (the last rung
    backend beyond the ladder).  An empty ladder falls back to ``bulk``.
    """
    b = getattr(config, "tail_backend", "auto")
    if b != "auto":
        return b
    rungs = getattr(config, "tail_rungs", ())
    if not rungs:
        return "bulk"
    for max_windows, backend in rungs:
        if n_windows <= max_windows:
            return backend
    return rungs[-1][1]


def select_head_mode(config, n_windows: int) -> str:
    """Dense-head execution mode for a level of ``n_windows`` windows.

    ``"fused"`` runs :func:`repro_torch.kernels.ops.fused_head`: kernel S
    (the SATs), then kernel A (1/sigma and every dense stage's sums), two
    launches; ``"split"`` runs kernel S, the plain-torch 1/sigma grid and
    one kernel B launch per dense stage.  Only stride-1 kernel heads
    (``use_pallas``) have the fused option — strided / plain configs
    always split.  ``config.head_mode`` forces a mode; ``"auto"`` walks
    the calibrated ``config.head_rungs`` ladder — ((max_windows, mode),
    ...) ascending — picking the smallest rung holding the level (the
    last rung's mode beyond the ladder).  An empty ladder defaults to
    ``fused``, as in the reference, so plans stay equal to its own; the
    measured flush times of both heads are in ``PERF.md``.
    """
    if not dense_on_kernels(config, config.step):
        return "split"
    m = getattr(config, "head_mode", "auto")
    if m != "auto":
        return m
    rungs = getattr(config, "head_rungs", ())
    if not rungs:
        return "fused"
    for max_windows, mode in rungs:
        if n_windows <= max_windows:
            return mode
    return rungs[-1][1]


def _resolve_tile(t) -> tuple[int, ...]:
    """Tuned tile shape -> concrete (ty, tx); () means package default."""
    if t:
        return tuple(int(v) for v in t)
    from repro_torch.kernels.autotune import DEFAULT_TILE
    return DEFAULT_TILE


# ------------------------------------------------------------- validation
def validate_config(n_stages: int, config) -> None:
    """Fail fast on malformed capacity schedules / tail policy instead of
    a downstream shape error deep inside a jitted program."""
    n_comp = n_compactions(segment_spans(n_stages, config))
    for name, fracs in (("capacity_fracs", config.capacity_fracs),
                        ("batch_capacity_fracs",
                         config.batch_capacity_fracs)):
        if not fracs:
            continue                 # () = auto schedule
        if len(fracs) != n_comp:
            raise ValueError(
                f"EngineConfig.{name} has {len(fracs)} entries but the "
                f"segment plan performs {n_comp} compaction(s) "
                f"(mode={config.mode!r}, "
                f"dense_segments={config.dense_segments}"
                f", compact_every={config.compact_every}, "
                f"n_stages={n_stages})")
        bad = [f for f in fracs if not (0.0 < float(f) <= 1.0)]
        if bad:
            raise ValueError(
                f"EngineConfig.{name} entries must lie in (0, 1], "
                f"got {bad} in {tuple(fracs)}")
    if config.tail_backend not in BACKENDS + ("auto",):
        raise ValueError(
            f"EngineConfig.tail_backend must be one of "
            f"{BACKENDS + ('auto',)}, got {config.tail_backend!r}")
    hm = getattr(config, "head_mode", "auto")
    if hm not in ("auto", "fused", "split"):
        raise ValueError(
            f"EngineConfig.head_mode must be 'auto', 'fused' or 'split', "
            f"got {hm!r}")
    for name in ("head_tile", "lane_block"):
        t = getattr(config, name, ())
        if t and (len(t) != 2 or any(int(v) <= 0 for v in t)):
            raise ValueError(
                f"EngineConfig.{name} must be () or a (ty, tx) pair of "
                f"positive ints, got {tuple(t)!r}")


# --------------------------------------------------------------- geometry
def window_limits(h_valid, w_valid, level_h: int, level_w: int,
                  pad_h: int, pad_w: int):
    """Inclusive max window origin (y_lim, x_lim) at one pyramid level so
    the window samples only valid (unpadded) source pixels.

    ``downscale_nearest`` maps level row ``r`` to source row
    ``(r * pad_h) // level_h``; a window rooted at ``y`` is valid iff its
    last sampled row is ``< h_valid``, i.e. ``y <= (h_valid*level_h - 1)
    // pad_h - (WINDOW - 1)``.  Works identically on host ints and traced
    int32 arrays.
    """
    y_lim = (h_valid * level_h - 1) // pad_h - (WINDOW - 1)
    x_lim = (w_valid * level_w - 1) // pad_w - (WINDOW - 1)
    return y_lim, x_lim


# --------------------------------------------------------------- compile
@lru_cache(maxsize=512)
def _pyramid_levels(hp: int, wp: int, scale_factor: float,
                    step: int) -> tuple[LevelPlan, ...]:
    """The bucket's full pyramid as LevelPlans — shared by every plan
    variant over the same bucket geometry."""
    levels_all, off = [], 0
    for li, lv in enumerate(pyramid_plan(hp, wp, scale_factor)):
        ny = (lv.height - WINDOW) // step + 1
        nx = (lv.width - WINDOW) // step + 1
        # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
        levels_all.append(LevelPlan(li, lv.height, lv.width, lv.scale,
                                    ny, nx, off))
        off += ny * nx
    return tuple(levels_all)


@lru_cache(maxsize=512)
def _slot_layout(hp: int, wp: int, scale_factor: float, step: int,
                 active: tuple[int, ...]) -> SlotLayout:
    """One SlotLayout per (bucket geometry, active subset): every plan
    variant over it — any batch size, any capacity rung — shares the same
    index arrays instead of rebuilding and separately retaining them."""
    # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
    return SlotLayout(_pyramid_levels(hp, wp, scale_factor, step), active,
                      step)


@lru_cache(maxsize=4096)
def compile_level_plan(config, n_stages: int, h: int, w: int
                       ) -> LevelWavePlan:
    """Plan of the single-image wave program for one level shape."""
    step = config.step
    ny = (h - WINDOW) // step + 1
    nx = (w - WINDOW) // step + 1
    spans = segment_spans(n_stages, config)
    caps = level_capacities(ny * nx, n_compactions(spans),
                            config.capacity_fracs)
    segments, ki = [], 0
    for (s0, s1, dense) in spans:
        if dense:
            # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
            segments.append(SegmentPlan(s0, s1, True))
        else:
            # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
            segments.append(SegmentPlan(
                s0, s1, False, caps[min(ki, len(caps) - 1)]))
            ki += 1
    n_dense = sum(s1 - s0 for (s0, s1, d) in spans if d)
    hm = select_head_mode(config, ny * nx) if n_dense else "split"
    key = ("level", h, w, n_stages, config)
    # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
    return LevelWavePlan(key, h, w, step, ny, nx, tuple(segments), caps,
                         hm, _resolve_tile(getattr(config, "head_tile", ())))


@lru_cache(maxsize=4096)
def compile_plan(config, n_stages: int, hp: int, wp: int, batch: int = 1,
                 levels: tuple[int, ...] | None = None,
                 capacity: int | None = None) -> CascadePlan:
    """Compile the full plan for one (bucket, batch, subset, rung).

    ``levels=None`` activates every pyramid level of the bucket.
    ``capacity=None`` plans the batched engine's dense-prefix + shared
    compacted tail (capacities from :func:`shared_capacities`, one tail
    backend per segment capacity); a given ``capacity`` instead plans the
    streaming shape — one packed segment over *all* stages at that rung,
    with the rung's backend.
    """
    step = config.step
    levels_all = _pyramid_levels(hp, wp, config.scale_factor, step)
    off = sum(lp.n_windows for lp in levels_all)
    active = (tuple(range(len(levels_all))) if levels is None
              else tuple(levels))
    layout = _slot_layout(hp, wp, config.scale_factor, step, active)

    if capacity is None:
        spans = segment_spans(n_stages, config)
        caps = shared_capacities(off, batch, n_compactions(spans), config)
        segments, ki = [], 0
        for (s0, s1, dense) in spans:
            if dense:
                # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
                segments.append(SegmentPlan(s0, s1, True))
            else:
                c = caps[min(ki, len(caps) - 1)]
                # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
                segments.append(SegmentPlan(s0, s1, False, c,
                                            select_backend(config, c)))
                ki += 1
        segments = tuple(segments)
    else:
        caps = (capacity,)
        # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
        segments = (SegmentPlan(0, n_stages, False, capacity,
                                select_backend(config, capacity)),)

    dense_prefix_n = sum(seg.s1 - seg.s0 for seg in segments if seg.dense)
    head_modes = tuple(
        select_head_mode(config, levels_all[li].n_windows)
        if dense_prefix_n else "split"
        for li in active)
    key = ("cascade", hp, wp, batch, levels, capacity, n_stages, config)
    # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
    return CascadePlan(key, hp, wp, batch, step, levels_all, active,
                       segments, caps, layout, head_modes,
                       _resolve_tile(getattr(config, "head_tile", ())),
                       _resolve_tile(getattr(config, "lane_block", ())))


@lru_cache(maxsize=1024)
def compile_stream_plan(config, n_stages: int, hp: int, wp: int, h: int,
                        w: int, tile: int, halo: int,
                        decode_cap: int | None = None) -> StreamStatePlan:
    """Compile the device-resident stream step's geometry for one
    (bucket, true frame shape, tile, halo).

    Precomputes everything the on-device frame planner gathers through:
    the tile grid over the true (h, w) frame, each level's closed
    tile-range brackets (``tile_range`` of the host
    reference's ``repro.stream.tiles.changed_window_mask``, vectorized over window
    origins), the flat window-limit mask over the bucket's full slot
    layout, and the live-window count (the host ``VideoDetector``'s
    ``_n_live``).  ``decode_cap`` sizes the static decoded-survivor list
    (default :data:`STREAM_DECODE_CAP`, clipped to the slot count).
    """
    step = config.step
    levels_all = _pyramid_levels(hp, wp, config.scale_factor, step)
    ty, tx = -(-h // tile), -(-w // tile)
    ranges, valid_parts, n_live = [], [], 0
    for lp in levels_all:
        oy = np.arange(lp.ny, dtype=np.int64) * step
        ox = np.arange(lp.nx, dtype=np.int64) * step
        ty0 = np.clip(((oy * hp) // lp.height) // tile, 0, ty - 1)
        ty1 = np.clip((((oy + WINDOW - 1) * hp) // lp.height) // tile,
                      0, ty - 1)
        tx0 = np.clip(((ox * wp) // lp.width) // tile, 0, tx - 1)
        tx1 = np.clip((((ox + WINDOW - 1) * wp) // lp.width) // tile,
                      0, tx - 1)
        ranges.append((ty0.astype(np.int32), ty1.astype(np.int32),
                       tx0.astype(np.int32), tx1.astype(np.int32)))
        y_lim, x_lim = window_limits(h, w, lp.height, lp.width, hp, wp)
        valid = (oy <= y_lim)[:, None] & (ox <= x_lim)[None, :]
        valid_parts.append(valid.reshape(-1))
        n_y = min(int(y_lim) // step + 1, lp.ny) if y_lim >= 0 else 0
        n_x = min(int(x_lim) // step + 1, lp.nx) if x_lim >= 0 else 0
        n_live += n_y * n_x
    n_slots = sum(lp.n_windows for lp in levels_all)
    limit_mask = (np.concatenate(valid_parts) if valid_parts
                  else np.zeros(0, bool))
    cap = decode_cap if decode_cap is not None else STREAM_DECODE_CAP
    cap = max(1, min(cap, max(n_slots, 1)))
    key = ("stream_state", hp, wp, h, w, tile, halo, cap, n_stages, config)
    # repro: ignore[PLAN_GEOMETRY] the port's one IR producer
    return StreamStatePlan(key, hp, wp, h, w, tile, halo, ty, tx,
                           tuple(ranges), limit_mask, n_live, n_slots, cap)
