"""Fleet-scale multi-tenant stream scheduling over one DetectorService.

The port of ``repro.serve.fleet``, over the port's
:class:`~repro_torch.serve.DetectorService` and stream sessions: the same
admission arithmetic, ladder and flush order.  Its lock is never held
while it takes the service's: ``stats()`` reads ``fleet_stats()`` outside
the service's lock, and a degradation only swaps a session's stream
config (``VideoDetector.reconfigure``), which the service's flusher reads
when it plans that session's next frame.

The paper optimizes one detector on one big.LITTLE board; this module is
the same budgeting discipline at fleet scale: many tenants' video streams
share a pod fleet whose capacity is *known* (calibrated work-units/s), each
stream's cost is *predicted* (its plan's ``work_units`` × the session's
observed recompute-fraction EMA), and the scheduler keeps modeled demand
inside the modeled budget the way the paper keeps the cascade inside its
frequency/energy envelope — by explicit, ordered degradation instead of
uncontrolled queueing.

Three mechanisms:

- **Admission control** — ``admit()`` accepts a stream only if its modeled
  steady-state demand (``plan.work_units × fps × prior``) fits in the
  remaining headroom of the calibrated capacity; otherwise the stream is
  rejected *up front* (counted in :class:`~repro_torch.serve.stats.FleetStats`)
  rather than admitted into latency collapse.

- **Tiered degradation ladder** — ``rebalance()`` compares live modeled
  demand (recompute-fraction EMAs feed back per frame) against the budget.
  Overload degrades sessions *worst tier first* (``best_effort``, then
  ``standard``; ``realtime`` never), one ladder level at a time, by
  stretching keyframe intervals and raising change thresholds
  (:meth:`repro_torch.stream.StreamConfig.degraded`) — frames keep flowing, each
  just costs less.  Load shedding (dropping frames) is the *last* resort,
  only after every degradable session sits at its ladder cap.  Recovery
  restores levels with hysteresis (``restore_margin``) so the fleet does
  not flap around the threshold.

- **Tier-ordered flushing + plan-key co-batching** — ``flush()`` runs one
  service flush per SLO tier, realtime first, so each tier's flush plans
  against *its* deadline (the governor's binding SLO) instead of every
  frame inheriting the strictest tenant's.  Within a flush, sessions
  sharing a plan key (shape bucket) already funnel through one shared
  compaction in the service; the fleet surfaces the live key-group count
  (``plan_groups``) as the co-batching observability hook.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.stream import StreamConfig
from .detector_service import (DetectorService, Request, FrameRequest,
                               SLO_TIERS)
from .stats import FleetStats

__all__ = ["FleetConfig", "FleetSession", "FleetScheduler"]


@dataclass(frozen=True)
class FleetConfig:
    """Fleet admission/degradation policy knobs.

    ``headroom`` is the fraction of calibrated capacity the fleet plans to;
    ``restore_margin`` adds hysteresis (restore only while demand stays
    under ``restore_margin × headroom × capacity``, so a restored level
    that pushes demand back over the degrade line is never chosen).
    ``admission_prior`` is the recompute fraction assumed for a stream that
    has not run yet (1.0 = worst case: every frame a full detect).
    ``degrade_demand_scale`` is the modeled per-level demand multiplier the
    ladder planner uses *until a session's own EMA confirms it* — stretching
    keyframes by 2x roughly halves steady-state refresh work, so the
    default mirrors ``StreamConfig.degrade_keyframe_mult``'s inverse."""
    headroom: float = 0.85
    restore_margin: float = 0.7
    admission_prior: float = 1.0
    degrade_demand_scale: float = 0.6
    min_work_frac: float = 0.02      # floor of any session's modeled frac

    def __post_init__(self):
        if not 0.0 < self.headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got "
                             f"{self.headroom}")
        if not 0.0 < self.restore_margin <= 1.0:
            raise ValueError(f"restore_margin must be in (0, 1], got "
                             f"{self.restore_margin}")
        if not 0.0 < self.degrade_demand_scale <= 1.0:
            raise ValueError(f"degrade_demand_scale must be in (0, 1], got "
                             f"{self.degrade_demand_scale}")
        if not 0.0 < self.admission_prior <= 1.0:
            raise ValueError(f"admission_prior must be in (0, 1], got "
                             f"{self.admission_prior}")


class FleetSession:
    """One admitted tenant stream: the service session plus the fleet's
    demand model and degradation state for it."""

    def __init__(self, fleet: "FleetScheduler", session, tenant: str,
                 base_units: int, fps: float, base_config: StreamConfig):
        self.fleet = fleet
        self.session = session            # the underlying StreamSession
        self.tenant = tenant
        self.base_units = base_units      # full-detect plan work units
        self.fps = fps
        self.base_config = base_config    # level-0 (undegraded) config
        self.degrade_level = 0
        # Demand anchor: the (recompute-frac, ladder-level) pair of the
        # most recent *observation*.  Between observations the planner
        # extrapolates frac × scale^(level - anchor_level), so degrading a
        # session immediately lowers its modeled demand (the point of
        # degrading) instead of waiting frames for the EMA to catch up —
        # and once real FrameStats arrive at the new level, the anchor
        # snaps to measured truth.
        self._anchor_frac = fleet.config.admission_prior
        self._anchor_level = 0
        self._anchor_frames = 0           # session.frames_done at anchor
        self._plan_key = None             # bound by FleetScheduler.admit

    @property
    def tier(self) -> str:
        return self.session.tier

    @property
    def plan_key(self):
        """Shape-bucket co-batching key (known at admission time, before
        the first frame binds the session's VideoDetector)."""
        return self._plan_key

    def _refresh_anchor(self) -> None:
        if self.session.frames_done > self._anchor_frames:
            self._anchor_frac = self.session.work_frac
            self._anchor_level = self.degrade_level
            self._anchor_frames = self.session.frames_done

    def demand_units_per_s(self, level: int | None = None) -> float:
        """Modeled steady-state demand at ``level`` (default: current)."""
        self._refresh_anchor()
        if level is None:
            level = self.degrade_level
        scale = self.fleet.config.degrade_demand_scale
        frac = self._anchor_frac * scale ** (level - self._anchor_level)
        frac = min(max(frac, self.fleet.config.min_work_frac), 1.0)
        return self.base_units * self.fps * frac

    def _set_level(self, level: int) -> None:
        self.degrade_level = level
        self.session.video.reconfigure(self.base_config.degraded(level))

    def submit_frame(self, frame) -> Request:
        return self.fleet.submit_frame(self, frame)

    def note_work_frac(self, frac: float) -> None:
        """Simulation/benchmark hook: install an externally modeled
        recompute fraction as if frames had reported it."""
        self.session.work_frac = float(frac)
        self._anchor_frac = float(frac)
        self._anchor_level = self.degrade_level
        self._anchor_frames = self.session.frames_done

    def close(self) -> None:
        self.fleet.release(self)


class FleetScheduler:
    """Admission + tiered degradation + tier-ordered flushing over one
    :class:`DetectorService` (see module docstring).

    The capacity budget defaults to the sum of the service's calibrated
    per-pod rates, so the service must be warmed (``warmup()``) or seeded
    (``seed_rates()``) before the fleet can admit anything."""

    def __init__(self, service: DetectorService,
                 config: FleetConfig = FleetConfig(),
                 capacity_units_per_s: float | None = None):
        self.service = service
        self.config = config
        if capacity_units_per_s is None:
            if not service._rates_in_units:
                raise ValueError(
                    "fleet capacity unknown: warmup() or seed_rates() the "
                    "service first, or pass capacity_units_per_s")
            capacity_units_per_s = float(service._rates.sum())
        if capacity_units_per_s <= 0:
            raise ValueError(f"capacity must be positive, got "
                             f"{capacity_units_per_s}")
        self.capacity_units_per_s = capacity_units_per_s
        self._lock = threading.Lock()
        self._sessions: list[FleetSession] = []
        self._admitted = 0
        self._rejected = 0
        self._degrade_events = 0
        self._restore_events = 0
        self._frames_submitted = 0
        self._frames_dropped = 0
        service._fleet = self            # stats().fleet hook

    # -------------------------------------------------------- admission
    @property
    def budget_units_per_s(self) -> float:
        return self.config.headroom * self.capacity_units_per_s

    def demand_units_per_s(self) -> float:
        with self._lock:
            return self._demand_locked()

    def _demand_locked(self) -> float:
        return sum(s.demand_units_per_s() for s in self._sessions)

    def admit(self, shape, fps: float, tier: str = "standard",
              tenant: str = "-", stream_config: StreamConfig | None = None
              ) -> FleetSession | None:
        """Admit a stream of ``shape`` frames at ``fps`` into ``tier``, or
        reject it (returns None, counted) if its modeled steady-state
        demand does not fit the remaining capacity headroom.  The demand
        prior assumes ``admission_prior`` of a full detect per frame —
        pessimistic by design; the session's own recompute EMA earns the
        fleet its capacity back within frames."""
        if fps <= 0:
            raise ValueError(f"fps must be positive, got {fps}")
        base_units = self.service._work_units(shape)
        prior = self.config.admission_prior
        new_demand = base_units * float(fps) * prior
        with self._lock:
            if self._demand_locked() + new_demand > self.budget_units_per_s:
                self._rejected += 1
                return None
            self._admitted += 1
        sess = self.service.open_stream(stream_config, tier=tier)
        fs = FleetSession(self, sess, tenant, base_units, float(fps),
                          sess.video.config)
        det = self.service.detector
        fs._plan_key = det._bucket_hw(int(shape[0]), int(shape[1]))
        with self._lock:
            self._sessions.append(fs)
        return fs

    def release(self, fs: FleetSession) -> None:
        with self._lock:
            if fs in self._sessions:
                self._sessions.remove(fs)
        fs.session.close()

    # ---------------------------------------------------------- frames
    def submit_frame(self, fs: FleetSession, frame) -> Request:
        """Enqueue one frame — or shed it, completing immediately with an
        empty result and ``dropped=True``, iff overload persists after the
        degradation ladder is fully exhausted (best-effort tier only;
        higher tiers are never shed while the service stands)."""
        with self._lock:
            self._frames_submitted += 1
            shed = self._should_shed_locked(fs)
            if shed:
                self._frames_dropped += 1
        if shed:
            req = FrameRequest(req_id=self.service._next_id_inc(),
                               session=fs.session, tier=fs.tier,
                               dropped=True,
                               t_submit=time.perf_counter())
            req.rects = np.zeros((0, 4), np.int32)
            req.t_done = req.t_submit
            req.done.set()
            return req
        return fs.session.submit_frame(frame)

    def _should_shed_locked(self, fs: FleetSession) -> bool:
        if fs.tier != "best_effort":
            return False
        ladder_left = any(
            s.degrade_level < s.base_config.max_degrade_level
            for s in self._sessions if s.tier != "realtime")
        if ladder_left:
            return False
        return self._demand_locked() > self.capacity_units_per_s

    # ------------------------------------------------------- rebalance
    def rebalance(self) -> dict:
        """One control-loop step: degrade while modeled demand exceeds the
        budget (worst tier first, least-degraded sessions first so pain is
        spread before anyone hits the ladder cap), restore with hysteresis
        when it falls well below.  Returns the step's event counts."""
        degraded = restored = 0
        with self._lock:
            budget = self.budget_units_per_s
            demand = self._demand_locked()
            # ---- degrade: best_effort fully before touching standard
            for tier in ("best_effort", "standard"):
                while demand > budget:
                    cands = [s for s in self._sessions if s.tier == tier
                             and s.degrade_level
                             < s.base_config.max_degrade_level]
                    if not cands:
                        break
                    s = min(cands, key=lambda s: (s.degrade_level,
                                                  -s.demand_units_per_s()))
                    before = s.demand_units_per_s()
                    s._set_level(s.degrade_level + 1)
                    demand += s.demand_units_per_s() - before
                    degraded += 1
                if demand <= budget:
                    break
            # ---- restore (reverse order): standard first, deepest first,
            # only while the *resulting* demand keeps clear of the line
            if demand <= self.config.restore_margin * budget:
                for tier in ("standard", "best_effort"):
                    for s in sorted(
                            (s for s in self._sessions if s.tier == tier
                             and s.degrade_level > 0),
                            key=lambda s: -s.degrade_level):
                        before = s.demand_units_per_s()
                        after = s.demand_units_per_s(s.degrade_level - 1)
                        if (demand - before + after
                                > self.config.restore_margin * budget):
                            continue
                        s._set_level(s.degrade_level - 1)
                        demand += after - before
                        restored += 1
            self._degrade_events += degraded
            self._restore_events += restored
        return {"degraded": degraded, "restored": restored,
                "demand_units_per_s": demand}

    # ----------------------------------------------------------- flush
    def flush(self) -> int:
        """Tier-ordered flushing: one service flush per SLO tier, realtime
        first, so every flush plans against its own tier's deadline."""
        n = 0
        for tier in SLO_TIERS:
            n += self.service.flush(tier=tier)
        return n

    # ----------------------------------------------------------- stats
    def fleet_stats(self) -> FleetStats:
        with self._lock:
            by_tier: dict[str, int] = {}
            degraded: dict[str, int] = {}
            keys = set()
            for s in self._sessions:
                by_tier[s.tier] = by_tier.get(s.tier, 0) + 1
                if s.degrade_level > 0:
                    degraded[s.tier] = degraded.get(s.tier, 0) + 1
                keys.add(s.plan_key)
            return FleetStats(
                sessions=len(self._sessions),
                admitted=self._admitted,
                rejected=self._rejected,
                by_tier=by_tier,
                degraded_by_tier=degraded,
                degrade_events=self._degrade_events,
                restore_events=self._restore_events,
                frames_submitted=self._frames_submitted,
                frames_dropped=self._frames_dropped,
                demand_units_per_s=self._demand_locked(),
                capacity_units_per_s=self.capacity_units_per_s,
                plan_groups=len(keys),
            )
