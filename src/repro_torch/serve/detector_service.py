"""Micro-batching detection front-end over the batched cascade engine.

The port of ``repro.serve.detector_service`` onto the port's
:class:`repro_torch.core.Detector`, :class:`repro_torch.stream
.VideoDetector` and :class:`repro_torch.stream.StreamEngine`: the same
configuration, queue, sharding, governor, energy ledger and stats.  The
service runs on its detector's device (the card, unless the detector was
built with ``device="cpu"``); it never moves work to another device.  A
flush's one-shot images go through ``detect_batch`` (kernels S, A or B,
and C on the card); its device-state stream sessions run the
device-resident step (kernels S and C) and are submitted before the host
plans the host-planned sessions, so their steps overlap that planning.
Kernels launch on the calling thread's current CUDA stream, which is the
device's default stream in the caller and in the ``start()`` flusher
alike.

Request flow (the serving-scale shape of the paper's pipeline)::

    submit(image) -> request queue -> shape buckets -> pod shards
        -> Detector.detect_batch -> per-request rect decode -> Request

Requests are queued, grouped into shape buckets (``EngineConfig.
pad_multiple``), chopped into sub-batches from ``batch_sizes`` (so the
program cache stays bounded), and each flush's work is split across *pods*
by the rate-weighted partitioner of :mod:`repro_torch.scheduling.hetero` —
the pod-scale analogue of the paper's big.LITTLE allocation: fast pods
take shares proportional to their measured rates, and the plan is revised
via ``replan_on_straggle`` when measured throughput drifts.  On a single host
the pods are simulated (each pod's wall time is scaled by its nominal
speed), but the shares, imbalance, and replan decisions are exactly what a
real asymmetric fleet would execute.

The service is configured by one typed, validated
:class:`ServiceConfig` (``DetectorService(detector, ServiceConfig(...))``);
legacy keyword construction (``DetectorService(detector, pods=..., ...)``)
still works for one release behind a :class:`DeprecationWarning`.  Every
queued item — one-shot image or stream frame — is a :class:`Request`:
shared completion event, ``result(timeout)``, ``latency_s``, and an SLO
``tier`` (:data:`SLO_TIERS`).  ``stats()`` returns a typed, versioned
:class:`repro_torch.serve.stats.ServiceStats` (dict-key access is a
deprecated shim over ``as_dict()``).

SLO tiers
---------
Each request carries a tier (``realtime`` / ``standard`` / ``best_effort``)
whose SLO comes from ``ServiceConfig.tier_slos`` (falling back to the
global ``slo_ms``).  A flush plans against the *binding* (minimum) SLO of
the tiers it carries (:func:`repro_torch.scheduling.dvfs.binding_slo`), and
the energy ledger tracks attainment per tier.  ``flush(tier=...)`` flushes
one tier only — the reference's fleet scheduler uses that to run realtime
rounds before best-effort ones.

Stream sessions (video workload)
--------------------------------
``open_stream()`` adds stateful video sessions alongside one-shot requests:
each session owns a :class:`repro_torch.stream.VideoDetector` (temporal
tile-reuse cache), and ``submit_frame`` enqueues frames into the same
queue.  A flush processes streams in per-session-ordered *rounds* sharded across pods like
any other work; within a round the changed-tile work items of concurrent
sessions that share a *plan key* (their shape bucket, hence their compiled
:class:`repro_torch.plan.CascadePlan` family) are funneled through the shared
packed incremental engine — one compaction for every co-keyed stream's
changed windows — and sessions that need a full refresh (first frame,
keyframe, over-budget change) are batched through
``Detector.detect_batch_raw``.  This is the content-dependent,
variable-size task stream the asymmetric-scheduling literature targets:
mostly-static streams produce tiny work items, busy streams produce big
ones, and the rate-weighted split keeps the pods balanced either way.
"""

from __future__ import annotations

import threading
import time
import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.kernels import native
from repro_torch.scheduling.dvfs import (GovernorDecision, binding_slo,
                                         evaluate_operating_points,
                                         select_operating_points)
from repro_torch.scheduling.energy import (EnergyAccount, parked_point,
                                           pod_operating_points)
from repro_torch.scheduling.hetero import (HeteroPodPlan,
                                           rate_weighted_split,
                                           replan_on_straggle,
                                           update_rates_ema)
from repro_torch.stream import (StreamConfig, StreamEngine, VideoDetector,
                                level_windows_from_raw)
from .stats import (SCHEMA_VERSION, DecisionStats, EnergyPodStats,
                    EnergyStats, PodStats, ServiceStats, StreamStats,
                    TailStats)

__all__ = ["PodSpec", "ServiceConfig", "Request", "DetectionRequest",
           "FrameRequest", "StreamSession", "DetectorService", "SLO_TIERS",
           "GOVERNORS"]

#: SLO tiers in strict priority order: the fleet scheduler flushes
#: ``realtime`` rounds first and degrades ``best_effort`` sessions first.
SLO_TIERS = ("realtime", "standard", "best_effort")

GOVERNORS = (None, "energy", "max", "little")


@dataclass(frozen=True)
class PodSpec:
    """A simulated processor pod (big.LITTLE cluster at fleet scale).

    ``cluster`` keys the pod into the calibrated power model's DVFS
    ladders (``repro_torch.scheduling.energy.pod_operating_points``): ``"big"``
    pods sweep the A15 frequencies, ``"LITTLE"`` pods the A7 ladder.  It
    only matters when the service runs with a governor."""
    name: str
    speed: float = 1.0   # relative nominal throughput (big=1.0, LITTLE<1)
    cluster: str = "big"


@dataclass(frozen=True)
class ServiceConfig:
    """Typed, validated construction surface of :class:`DetectorService`
    (replaces the historical keyword sprawl; validated like
    ``Detector._validate_config``).

    ``tier_slos`` maps an SLO tier name to its latency SLO in ms; tiers not
    listed fall back to the global ``slo_ms``, so an untier-ed service
    behaves exactly as before."""
    pods: tuple[PodSpec, ...] = (PodSpec("pod0", 1.0),)
    max_batch: int = 8
    batch_sizes: tuple[int, ...] = (1, 2, 4, 8)
    max_delay_ms: float = 5.0
    strategy: str = "packed"
    replan_threshold: float = 0.25
    rate_ema: float = 0.5
    stream_config: StreamConfig = StreamConfig()
    # ---- energy/DVFS governor (paper §7.4 at serving scale).
    # "energy": pick per-pod operating points + placement each flush to
    #   meet the latency SLO at minimum modeled energy;
    # "max"/"little": the static extremes (always top frequency on all
    #   pods / LITTLE pods only), kept as governed policies so their
    #   modeled energy is accounted identically and comparable.
    governor: str | None = None
    slo_ms: float = 50.0
    wake_j: float = 0.02   # per-flush pod activation cost (J): what tips
    #                        tiny (cached-stream) flushes toward
    #                        LITTLE-only placement
    tier_slos: dict = field(default_factory=dict)

    def __post_init__(self):
        pods = tuple(self.pods)
        object.__setattr__(self, "pods", pods)
        if not pods or any(p.speed <= 0 for p in pods):
            raise ValueError(f"pods must be non-empty with positive speeds, "
                             f"got {pods!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        sizes = tuple(sorted(set(int(b) for b in self.batch_sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive ints, got "
                             f"{self.batch_sizes!r}")
        object.__setattr__(self, "batch_sizes", sizes)
        if self.strategy not in ("packed", "vmap"):
            raise ValueError(f"strategy must be 'packed' or 'vmap', got "
                             f"{self.strategy!r}")
        if not 0.0 <= self.rate_ema <= 1.0:
            raise ValueError(f"rate_ema must be in [0, 1], got "
                             f"{self.rate_ema}")
        if self.governor not in GOVERNORS:
            raise ValueError(f"governor must be one of {GOVERNORS}, "
                             f"got {self.governor!r}")
        if self.slo_ms <= 0 or self.wake_j < 0:
            raise ValueError(f"need slo_ms > 0 and wake_j >= 0, got "
                             f"slo_ms={self.slo_ms}, wake_j={self.wake_j}")
        bad = set(self.tier_slos) - set(SLO_TIERS)
        if bad:
            raise ValueError(f"unknown SLO tiers {sorted(bad)}; "
                             f"tiers are {SLO_TIERS}")
        if any(v <= 0 for v in self.tier_slos.values()):
            raise ValueError(f"tier SLOs must be positive, got "
                             f"{self.tier_slos!r}")
        object.__setattr__(self, "tier_slos", dict(self.tier_slos))

    def tier_slo_ms(self, tier: str) -> float:
        """The SLO (ms) of one tier; unlisted tiers use the global
        ``slo_ms``."""
        return self.tier_slos.get(tier, self.slo_ms)


@dataclass
class Request:
    """One queued work item (one-shot image or stream frame) + its
    completion state.  ``session`` is None for one-shot requests; stream
    frames carry their :class:`StreamSession` (there is ONE completion and
    sharding path — nothing downstream switches on the request's class)."""
    req_id: int
    image: np.ndarray | None = None
    tier: str = "standard"
    session: "StreamSession | None" = None
    done: threading.Event = field(default_factory=threading.Event)
    rects: np.ndarray | None = None
    stats: object | None = None          # stream.FrameStats (frames)
    error: Exception | None = None
    dropped: bool = False                # shed by the fleet under overload
    t_submit: float = 0.0
    t_done: float = 0.0

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.req_id} not finished")
        if self.error is not None:
            raise self.error
        return self.rects

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class DetectionRequest(Request):
    """One queued one-shot image (a :class:`Request` with no session)."""


@dataclass
class FrameRequest(Request):
    """One queued video frame of a stream session."""

    @property
    def frame(self) -> np.ndarray | None:   # legacy alias for ``image``
        return self.image


class StreamSession:
    """A video stream's handle on the service: ordered frame futures over
    one :class:`repro_torch.stream.VideoDetector` (opened via
    ``open_stream``)."""

    def __init__(self, service: "DetectorService", stream_id: int,
                 config: StreamConfig, tier: str = "standard"):
        self.service = service
        self.stream_id = stream_id
        self.tier = tier
        self.video = VideoDetector(service.detector, config,
                                   engine=service.stream_engine)
        self.closed = False
        # EMA of the fraction of the bucket plan's work this session's
        # frames actually recompute (1.0 until the first frame lands):
        # the service's per-frame cost predictor, so a mostly-cached
        # stream weighs — and is budgeted by the governor — as the tiny
        # work item it really is, not as a full per-frame detect.
        self.work_frac = 1.0
        self.frames_done = 0

    @property
    def plan_key(self) -> tuple[int, int] | None:
        """The session's co-batching key: its shape bucket, i.e. the prefix
        of every compiled ``CascadePlan.key`` its frames execute.  Sessions
        sharing it share one compaction per round (None until the first
        frame binds the bucket)."""
        return self.video.bucket_hw

    def submit_frame(self, frame) -> Request:
        if self.closed:
            raise RuntimeError(f"stream {self.stream_id} is closed")
        return self.service._submit_frame(self, frame)

    def detect_frames(self, frames) -> list[np.ndarray]:
        """Synchronous convenience: submit all frames, flush, gather."""
        reqs = [self.submit_frame(f) for f in frames]
        self.service.flush()
        return [r.result() for r in reqs]

    def close(self) -> None:
        self.closed = True
        self.service._close_stream(self)


class DetectorService:
    """Queue -> bucket -> pod-shard -> ``detect_batch`` micro-batcher.

    Deterministic by default: callers ``submit()`` then ``flush()`` (or use
    ``detect_many``).  ``start()`` runs a background flusher thread that
    fires when ``max_batch`` requests are queued or ``max_delay_ms`` passed.
    """

    GOVERNORS = GOVERNORS

    def __init__(self, detector, config: ServiceConfig | None = None,
                 **legacy_kwargs):
        if config is not None and legacy_kwargs:
            raise TypeError("pass a ServiceConfig or legacy keywords, "
                            f"not both (got {sorted(legacy_kwargs)})")
        if config is None:
            if legacy_kwargs:
                warnings.warn(
                    "DetectorService(detector, pods=..., ...) keyword "
                    "construction is deprecated; pass "
                    "DetectorService(detector, ServiceConfig(...))",
                    DeprecationWarning, stacklevel=2)
            config = ServiceConfig(**legacy_kwargs)
        self.detector = detector
        self.config = config
        # convenience aliases (read-only views of the config)
        self.pods = config.pods
        self.max_batch = config.max_batch
        self.batch_sizes = config.batch_sizes
        self.max_delay_ms = config.max_delay_ms
        self.strategy = config.strategy
        self.replan_threshold = config.replan_threshold
        self.rate_ema = config.rate_ema
        self.stream_config = config.stream_config
        self.governor = config.governor
        self.slo_ms = config.slo_ms
        self.wake_j = config.wake_j
        self._pod_ladders = tuple(pod_operating_points(p.cluster)
                                  for p in self.pods)
        self._energy_acct = (EnergyAccount(len(self.pods))
                             if config.governor else None)
        self._last_decision: GovernorDecision | None = None
        self._stream_engine: StreamEngine | None = None
        self._streams: dict[int, StreamSession] = {}
        self._next_stream_id = 0
        self._frame_modes = {"full": 0, "incremental": 0, "cached": 0}
        self._frames_done = 0
        self._windows_skipped = 0
        self._windows_total = 0
        self._levels_active = 0
        self._levels_total = 0
        self._fleet = None                   # a fleet scheduler's hook

        self._lock = threading.Lock()        # queue + accounting state
        self._flush_lock = threading.Lock()  # serializes whole flushes
        self._queue: list[Request] = []
        self._next_id = 0
        # nominal relative speeds until the first real observation (or
        # warmup) rescales them into absolute window-units/s — mixing the
        # two scales in the EMA would starve never-observed pods
        self._rates = np.asarray([p.speed for p in self.pods], np.float64)
        self._rates_in_units = False
        self._pod_shares = np.zeros(len(self.pods), np.int64)
        self._pod_sim_time = np.zeros(len(self.pods), np.float64)
        self._latencies: list[float] = []
        self._n_done = 0
        self._n_replans = 0
        self._last_plan: HeteroPodPlan | None = None
        self._t0: float | None = None       # first submit (throughput clock)
        self._t_last: float = 0.0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._tail_chosen: list[tuple[int, str]] = []  # set by warmup()

    # ------------------------------------------------------------- intake
    def submit(self, image, tier: str = "standard") -> Request:
        self._check_tier(tier)
        req = DetectionRequest(req_id=self._next_id_inc(),
                               image=np.asarray(image, np.float32),
                               tier=tier, t_submit=time.perf_counter())
        with self._lock:
            if self._t0 is None:
                self._t0 = req.t_submit
            self._queue.append(req)
        return req

    @staticmethod
    def _check_tier(tier: str) -> None:
        if tier not in SLO_TIERS:
            raise ValueError(f"tier must be one of {SLO_TIERS}, got {tier!r}")

    def _next_id_inc(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
        return i

    def detect_many(self, images) -> list[np.ndarray]:
        """Synchronous convenience: submit all, flush, return in order."""
        reqs = [self.submit(im) for im in images]
        self.flush()
        return [r.result() for r in reqs]

    # ------------------------------------------------------------- streams
    @property
    def stream_engine(self) -> StreamEngine:
        """Shared packed incremental engine: every session's changed-tile
        work items go through its one compaction per flush."""
        with self._lock:
            if self._stream_engine is None:
                self._stream_engine = StreamEngine(
                    self.detector, self.stream_config.max_changed_frac)
            return self._stream_engine

    def open_stream(self, config: StreamConfig | None = None,
                    tier: str = "standard") -> StreamSession:
        """Open a video stream session.  Open streams *after* ``warmup()``
        — warmup swaps in a calibrated detector, and sessions bind the
        detector (and shared stream engine) at open time.

        ``config`` tunes the session's tile/threshold/keyframe policy; the
        incremental *budget* (``max_changed_frac``) is a property of the
        shared engine and always comes from the service-level
        ``stream_config`` (a per-session value here is ignored).  ``tier``
        sets the session's SLO class (every frame inherits it)."""
        self._check_tier(tier)
        with self._lock:
            sid = self._next_stream_id
            self._next_stream_id += 1
        sess = StreamSession(self, sid, config or self.stream_config, tier)
        with self._lock:
            self._streams[sid] = sess
        return sess

    def _close_stream(self, sess: StreamSession) -> None:
        with self._lock:
            self._streams.pop(sess.stream_id, None)

    def _submit_frame(self, sess: StreamSession, frame) -> Request:
        req = FrameRequest(req_id=self._next_id_inc(), session=sess,
                           image=np.asarray(frame, np.float32),
                           tier=sess.tier, t_submit=time.perf_counter())
        with self._lock:
            if self._t0 is None:
                self._t0 = req.t_submit
            self._queue.append(req)
        return req

    # ------------------------------------------------------------ warm-up
    def warmup(self, probe_image, safety: float = 2.0,
               tune_tail: bool = False) -> None:
        """Calibrate engine capacities on a probe image (profile-guided
        ``capacity_fracs``, the prerequisite for the packed tail's speedup)
        and measure a baseline per-pod rate.  ``tune_tail=True`` also races
        the packed-tail backends and persists the kernel-vs-gather
        crossover ladder in the detector config, which every session's
        stream engine and every batch flush then inherits."""
        self.detector = self.detector.calibrated(probe_image, safety,
                                                 tune_tail=tune_tail)
        self.detector.detect(probe_image)        # build
        t0 = time.perf_counter()
        self.detector.detect(probe_image)        # measure warm

        per_img = max(time.perf_counter() - t0, 1e-6)
        probe_units = self._work_units(np.asarray(probe_image).shape)
        base = probe_units / per_img             # window-units per second
        with self._lock:
            self._rates = np.asarray([p.speed * base for p in self.pods])
            self._rates_in_units = True
            # the tail backends the plan layer chose for this detector at
            # the probe bucket / largest sub-batch that actually executes
            det = self.detector
            hp, wp = det._bucket_hw(*np.asarray(probe_image).shape)
            batch = max((b for b in self.batch_sizes if b <= self.max_batch),
                        default=1)
            bplan = det.batch_plan(hp, wp, batch)
            self._tail_chosen = [(seg.capacity, seg.backend)
                                 for seg in bplan.tail_segments]

    # -------------------------------------------------------------- flush
    def flush(self, tier: str | None = None) -> int:
        """Process every queued request; returns the number completed.
        ``tier`` restricts the flush to one SLO tier (other requests stay
        queued) — the fleet scheduler's tier-ordered rounds.  Safe to call
        from the background flusher and callers concurrently: flushes
        serialize, and a request that fails (even with an unexpected
        exception) completes with ``error`` set rather than dropping
        silently or killing the flusher thread.

        One-shot images shard across pods directly.  Stream frames are
        processed in *rounds* of one frame per session (preserving each
        session's frame order), each round sharded across pods at session
        granularity.  The flush plans against the binding (minimum) SLO of
        the tiers it carries."""
        if tier is not None:
            self._check_tier(tier)
        with self._flush_lock:
            with self._lock:
                if tier is None:
                    batch, self._queue = self._queue, []
                else:
                    batch = [r for r in self._queue if r.tier == tier]
                    self._queue = [r for r in self._queue if r.tier != tier]
            if not batch:
                return 0
            images = [r for r in batch if r.session is None]
            frames = [r for r in batch if r.session is not None]
            if images:
                self._shard_across_pods(
                    images, self._run_shard,
                    [self._request_units(r) for r in images],
                    tiers=self._tiers_present(images))
            while frames:
                round_, rest, seen = [], [], set()
                for fr in frames:
                    if fr.session.stream_id in seen:
                        rest.append(fr)
                    else:
                        seen.add(fr.session.stream_id)
                        round_.append(fr)
                frames = rest
                self._shard_across_pods(
                    round_, self._run_stream_shard,
                    [self._request_units(fr) for fr in round_],
                    tiers=self._tiers_present(round_))
            return len(batch)

    def _tiers_present(self, items: list[Request]) -> dict[str, float]:
        """tier -> SLO (s) for the tiers carried by this flush (the
        governor plans against their binding minimum; the ledger tracks
        attainment per tier)."""
        return {t: self.config.tier_slo_ms(t) / 1e3
                for t in {r.tier for r in items}}

    def _work_units(self, shape) -> int:
        """Plan-derived cost weight of one work item: lanes × stage depth
        summed over the compiled :class:`repro_torch.plan.CascadePlan`'s
        segments
        (``plan.work_units``) of its shape bucket — so a 4x-larger image
        counts as ~4x the work when splitting a flush across pods, and a
        deep compacted tail counts more than its window count alone.  The
        same units feed the energy governor's makespan/energy predictions
        and the calibrated power model."""
        det = self.detector
        hp, wp = det._bucket_hw(int(shape[0]), int(shape[1]))
        return max(det.batch_plan(hp, wp).work_units, 1)

    def _request_units(self, r: Request) -> int:
        """Predicted cost of one request.  One-shot images cost their full
        bucket plan; a stream frame costs the plan scaled by its session's
        observed recompute fraction (EMA over its ``FrameStats``) —
        idle/cached sessions therefore weigh a small fraction of a full
        detect, which is what lets the governor degrade them to LITTLE
        placements, while sessions in full-refresh churn weigh ~1.0 and
        trigger race-to-idle instead."""
        full = self._work_units(r.image.shape)
        if r.session is None:
            return full
        return max(int(full * min(r.session.work_frac, 1.0)), 1)

    def _shard_across_pods(self, items: list, run_fn,
                           weights: list[int],
                           tiers: dict[str, float] | None = None) -> None:
        """Rate-weighted pod loop shared by one-shot and stream work.

        Shares are planned in *plan work units* (``_request_units`` per
        item), then contiguous runs of items are cut at the unit
        boundaries, so pods of unequal speed get balanced work even when a
        flush mixes image sizes.  Observed rates are tracked in units/s at
        each pod's *nominal* (top-frequency) operating point; the governor
        — when one is active — scales them by its chosen per-pod DVFS
        points, parks pods by giving them rate 0, and the modeled energy of
        the flush is charged to the
        :class:`~repro_torch.scheduling.energy.EnergyAccount`.  ``tiers`` maps
        the SLO tiers present to their deadlines (s): the governor plans
        against the binding minimum."""
        total_units = int(sum(weights))
        slo_s = (binding_slo(tiers.values()) if tiers
                 else self.slo_ms / 1e3)
        decision = self._decide(total_units, slo_s)
        plan = self._plan(total_units,
                          decision.rates if decision is not None else None)
        shards: list[list] = []
        unit_sums: list[float] = []
        i = 0
        for share in plan.shares:
            start, acc = i, 0.0
            while i < len(items) and acc + weights[i] / 2 <= share:
                acc += weights[i]
                i += 1
            shards.append(items[start:i])
            unit_sums.append(acc)
        if i < len(items):   # rounding leftovers go to the fastest pod,
            pi = int(np.argmax(plan.rates))     # as in rate_weighted_split
            unit_sums[pi] += sum(weights[i:])
            shards[pi] += items[i:]
        observed = np.zeros(len(self.pods), np.float64)
        busy_s = [0.0] * len(self.pods)
        for pi, shard in enumerate(shards):
            if not shard:
                continue
            builds0 = self._program_build_count()
            t0 = time.perf_counter()
            run_fn(shard)
            wall = max(time.perf_counter() - t0, 1e-9)
            sim = wall / max(self.pods[pi].speed, 1e-9)
            if decision is not None:
                # governed: busy time for the energy/SLO ledger comes from
                # the rate model (units at the chosen point's effective
                # rate), not the host wall — the ledger is *modeled* energy
                # and wall noise must not make two services with identical
                # placements charge different joules.
                if decision.rates[pi] > 0:
                    busy_s[pi] = unit_sums[pi] / decision.rates[pi]
            else:
                busy_s[pi] = sim
            if self._program_build_count() == builds0:
                observed[pi] = unit_sums[pi] / sim
            # else: the wall included the first-touch build of a new
            # executor or kernel library (nvcc) — a one-off cost that would
            # poison the nominal-rate EMA and trigger a spurious straggle
            # replan.  Discard the observation; the next flush of this
            # shape measures warm.
            with self._lock:
                self._pod_shares[pi] += len(shard)
                self._pod_sim_time[pi] += busy_s[pi]
        if self._energy_acct is not None and decision is not None:
            with self._lock:
                self._energy_acct.charge_shard(decision.ops, busy_s,
                                               unit_sums, slo_s=slo_s,
                                               wake_J=self.wake_j,
                                               tier_slos=tiers)
                self._last_decision = decision
        self._update_rates(observed)

    def _program_build_count(self) -> int:
        """Executor builds so far (detector + shared stream engine) plus
        kernel libraries built or loaded in this process: the probe for
        'this wall time included a one-off build'."""
        n = self.detector.program_builds + native.library_loads()
        with self._lock:
            if self._stream_engine is not None:
                n += self._stream_engine.program_builds
        return n

    def _decide(self, total_units: int,
                slo_s: float | None = None) -> GovernorDecision | None:
        """Pick this flush's per-pod operating points under the configured
        governor (None = ungoverned: every pod at nominal speed).  ``slo_s``
        is the flush's binding deadline (defaults to the global SLO)."""
        if self.governor is None:
            return None
        if slo_s is None:
            slo_s = self.slo_ms / 1e3
        with self._lock:
            rates = self._rates.copy()
            in_units = self._rates_in_units
        if not in_units:
            # No calibrated units/s yet (pre-warmup): makespan and joule
            # predictions would be charged against *relative* pod speeds —
            # meaningless absolute numbers.  Run this flush ungoverned
            # (nominal split at top frequency, nothing charged); the first
            # warm observation or warmup()/seed_rates() turns the
            # governor on.
            return None
        tops = tuple(lad[0] for lad in self._pod_ladders)
        if self.governor == "little":
            ops = tuple(lad[0] if p.cluster == "LITTLE" else parked_point(lad)
                        for p, lad in zip(self.pods, self._pod_ladders))
            if all(op.speed_scale == 0.0 for op in ops):
                ops = tops               # no LITTLE pods: degenerate to max
        elif self.governor == "max":
            ops = tops
        else:
            return select_operating_points(total_units, rates,
                                           self._pod_ladders,
                                           slo_s, self.wake_j)
        d = evaluate_operating_points(total_units, rates, ops,
                                      slo_s, self.wake_j)
        if d is None:                    # all rates zero: nominal split
            return None
        return d

    def seed_rates(self, rates) -> None:
        """Install calibrated per-pod rates (work-units/s at each pod's
        nominal operating point) directly — the benchmark/test shortcut for
        sharing one ``warmup()`` measurement across several services."""
        rates = np.asarray(rates, np.float64)
        if rates.shape != (len(self.pods),) or (rates < 0).any():
            raise ValueError(f"need {len(self.pods)} non-negative rates, "
                             f"got {rates!r}")
        with self._lock:
            self._rates = rates
            self._rates_in_units = True

    def _plan(self, n: int, rates=None) -> HeteroPodPlan:
        with self._lock:
            plan = rate_weighted_split(
                n, self._rates if rates is None else rates,
                [p.name for p in self.pods])
            self._last_plan = plan
        return plan

    def _update_rates(self, observed: np.ndarray) -> None:
        if not (observed > 0).any():
            return
        with self._lock:
            if not self._rates_in_units:
                # first real observation without a warmup(): rescale the
                # nominal relative seeds into observed units/s, preserving
                # their ratios, so pods that have not run yet stay on a
                # comparable scale instead of being rounded to zero share
                m = observed > 0
                k = float(np.mean(observed[m]
                                  / np.maximum(self._rates[m], 1e-12)))
                self._rates = self._rates * k
                self._rates_in_units = True
            self._rates = update_rates_ema(self._rates, observed,
                                           self.rate_ema)
            if self.governor is not None:
                # a governor re-decides placement every flush, and the
                # plan's rates are effective (DVFS-scaled) while _rates are
                # nominal — drift between the two scales is by design, not
                # straggle, so the replan bookkeeping is meaningless here
                return
            new = replan_on_straggle(self._last_plan, self._rates,
                                     self.replan_threshold) \
                if self._last_plan is not None else None
            if new is not None:
                self._n_replans += 1
                self._last_plan = new

    def _run_shard(self, shard: list[Request]) -> None:
        for chunk in self._chunks(shard):
            images = [r.image for r in chunk]
            try:
                rects = self.detector.detect_batch(images,
                                                   strategy=self.strategy)
            except Exception:                      # noqa: BLE001
                # overflow (or any pathological input) somewhere in the
                # batch: isolate per image so one bad request completes
                # with an error instead of failing its whole flush
                rects = []
                for r in chunk:
                    try:
                        rects.append(self.detector.detect(r.image))
                    except Exception as e:         # noqa: BLE001
                        rects.append(e)
            for r, out in zip(chunk, rects):
                self._complete(r, out)

    def _complete(self, req: Request, out, stats=None) -> None:
        """Finish one request with rects or an Exception — the single
        completion path for one-shot images and stream frames alike (the
        only difference is the session-EMA update frames feed back)."""
        req.t_done = time.perf_counter()
        if isinstance(out, Exception):
            req.error = out
        else:
            req.rects = out
        req.stats = stats
        with self._lock:
            self._t_last = req.t_done
            self._latencies.append(req.latency_s)
            self._n_done += 1
            if req.session is not None:
                self._frames_done += 1
                req.session.frames_done += 1
                if stats is not None:
                    self._frame_modes[stats.mode] += 1
                    self._windows_total += stats.windows_total
                    self._windows_skipped += (stats.windows_total
                                              - stats.windows_recomputed)
                    self._levels_total += stats.levels_total
                    self._levels_active += stats.levels_active
                    frac = (stats.windows_recomputed
                            / max(stats.windows_total, 1))
                    sess = req.session
                    sess.work_frac = 0.5 * sess.work_frac + 0.5 * frac
        req.done.set()

    # ---------------------------------------------------------- stream run
    def _run_stream_shard(self, shard: list[Request]) -> None:
        """Process one round of frames (<= 1 per session).

        Plans every session's frame, then batches the work *across*
        sessions: incremental frames of sessions sharing a plan key go
        through one shared-compaction call on the packed engine (grouped by
        the key, chopped to ``batch_sizes``), and frames needing a full
        refresh go through ``detect_batch_raw`` together.  Any failure or
        overflow degrades per frame, never the whole round.
        """
        incr: list[tuple[Request, np.ndarray, object]] = []
        full: list[tuple[Request, np.ndarray]] = []
        dev: list[tuple[Request, object]] = []
        for fr in shard:
            video = fr.session.video
            if video.config.device_state:
                # submit first: CUDA launches are asynchronous, so every
                # device session's plan-and-eval step runs while the host
                # plans and packs the host-resident sessions below
                try:
                    dev.append((fr, video.submit(fr.image)))
                except Exception as e:         # noqa: BLE001
                    self._complete(fr, e)
                continue
            try:
                frame, plan = video.plan_frame(fr.image)
            except Exception as e:             # noqa: BLE001
                self._complete(fr, e)
                continue
            if plan.mode == "cached":
                rects, stats = video.commit_cached(frame, plan)
                self._complete(fr, rects, stats)
            elif plan.mode == "full":
                full.append((fr, frame, None))
            else:
                incr.append((fr, frame, plan))

        # ---- changed-tile work items: all sessions sharing a plan key
        # funnel through ONE compaction per chunk (cross-tenant batching)
        buckets: dict[tuple[int, int], list] = {}
        for item in incr:
            buckets.setdefault(item[0].session.plan_key, []).append(item)
        for (hp, wp), items in buckets.items():
            for chunk in self._chunks(items):
                frames = [frame for (_fr, frame, _plan) in chunk]
                masks = [plan.masks for (_fr, _frame, plan) in chunk]
                # union of the sessions' active level sets: the chunk shares
                # one level-subset program, and fully-cached levels across
                # every stream in the chunk build no SAT at all
                active = tuple(sorted({
                    li for (_fr, _frame, plan) in chunk
                    for li in (plan.active_levels or ())}))
                try:
                    bitmaps, _rec, overflow = self.stream_engine.incremental(
                        frames, masks, hp, wp, active=active)
                except Exception as e:         # noqa: BLE001
                    for fr, _frame, _plan in chunk:
                        self._complete(fr, e)
                    continue
                if overflow:   # shared capacity blown: full-refresh chunk
                    full.extend((fr, frame, None)
                                for (fr, frame, _plan) in chunk)
                    continue
                for (fr, frame, plan), bm in zip(chunk, bitmaps):
                    rects, stats = fr.session.video.commit_incremental(
                        frame, plan, bm)
                    self._complete(fr, rects, stats)

        # ---- device-resident sessions, dispatched up-front: collect each
        # step's verdict; cached/incremental frames finish straight off the
        # device state, full-needed frames join the batched keyframe flush
        for fr, tok in dev:
            video = fr.session.video
            try:
                mode = video.poll(tok)
                if mode == "full":
                    # carry the step's device frame so the session's state
                    # re-seed after the batched detect skips re-uploading it
                    full.append((fr, video.discard_token(tok),
                                 tok.dev_frame))
                else:
                    rects, stats = video.commit_token(tok)
                    self._complete(fr, rects, stats)
            except Exception as e:             # noqa: BLE001
                self._complete(fr, e)

        # ---- keyframes / refreshes, batched through the raw batch path
        buckets = {}
        for item in full:
            buckets.setdefault(item[0].session.plan_key, []).append(item)
        for _hw, items in buckets.items():
            for chunk in self._chunks(items):
                self._run_full_chunk(chunk)

    def _run_full_chunk(self, chunk: list[tuple]) -> None:
        levels = None
        if len(chunk) > 1:
            try:
                levels = self.detector.detect_batch_raw(
                    [frame for _fr, frame, _dev in chunk])
            except Exception:                  # noqa: BLE001
                levels = None                  # isolate per frame below
        for i, (fr, frame, dev_frame) in enumerate(chunk):
            try:
                wins = (level_windows_from_raw(levels, i)
                        if levels is not None else None)
                rects, stats = fr.session.video.commit_full(
                    frame, wins, dev_frame=dev_frame)
                self._complete(fr, rects, stats)
            except Exception as e:             # noqa: BLE001
                self._complete(fr, e)

    def _chunks(self, shard: list) -> list[list]:
        """Chop a shard into sub-batches drawn from ``batch_sizes`` (largest
        first) so only a bounded set of batch shapes ever builds."""
        out, i = [], 0
        sizes = [b for b in self.batch_sizes if b <= self.max_batch]
        if not sizes:
            sizes = [1]
        while i < len(shard):
            left = len(shard) - i
            size = max((b for b in sizes if b <= left), default=sizes[0])
            out.append(shard[i:i + size])
            i += size
        return out

    # ---------------------------------------------------------- threading
    def start(self) -> None:
        """Background flusher: fires on ``max_batch`` queued or
        ``max_delay_ms`` since the oldest queued request."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                with self._lock:
                    n = len(self._queue)
                    oldest = self._queue[0].t_submit if n else None
                due = (n >= self.max_batch
                       or (oldest is not None and
                           (time.perf_counter() - oldest) * 1e3
                           >= self.max_delay_ms))
                if due:
                    self.flush()
                else:
                    self._stop.wait(self.max_delay_ms / 1e3 / 4)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.flush()

    # -------------------------------------------------------------- stats
    def stats(self) -> ServiceStats:
        """Typed, versioned service statistics (:class:`ServiceStats`).
        Dict-key access (``stats()["energy"]``) still works through the
        deprecation shim over ``as_dict()``."""
        with self._lock:
            lat = np.asarray(self._latencies) * 1e3
            elapsed = (max(self._t_last - self._t0, 1e-9)
                       if self._t0 is not None else 1e-9)
            n_done = self._n_done
            pod_shares = self._pod_shares.copy()
            pod_sim = self._pod_sim_time.copy()
            rates = self._rates.copy()
            n_replans = self._n_replans
            last_plan = self._last_plan
            stream = StreamStats(
                sessions=len(self._streams),
                frames_done=self._frames_done,
                frame_modes=dict(self._frame_modes),
                window_skip_frac=(self._windows_skipped
                                  / max(self._windows_total, 1)),
                level_skip_frac=(1.0 - self._levels_active
                                 / max(self._levels_total, 1)),
            )
            energy = self._energy_stats_locked(n_done)
        total_sim = pod_sim.sum()
        pods = tuple(
            PodStats(name=p.name, speed=p.speed, cluster=p.cluster,
                     rate=float(rates[i]), images=int(pod_shares[i]),
                     sim_time_s=float(pod_sim[i]))
            for i, p in enumerate(self.pods))
        cfg = self.detector.config
        fleet = self._fleet.fleet_stats() if self._fleet is not None else None
        return ServiceStats(
            schema_version=SCHEMA_VERSION,
            n_done=n_done,
            imgs_per_s=n_done / elapsed,
            tail=TailStats(backend=cfg.tail_backend,
                           rungs=tuple(tuple(r) for r in cfg.tail_rungs),
                           # (capacity, backend) the plan layer chose per
                           # tail segment of the warmed probe bucket
                           chosen=tuple(tuple(c)
                                        for c in self._tail_chosen)),
            latency_ms_p50=float(np.percentile(lat, 50)) if len(lat) else 0.0,
            latency_ms_p95=float(np.percentile(lat, 95)) if len(lat) else 0.0,
            latency_ms_p99=float(np.percentile(lat, 99)) if len(lat) else 0.0,
            pods=pods,
            makespan_imbalance=(float(pod_sim.max()
                                      / (total_sim / len(self.pods)))
                                if total_sim > 0 else 1.0),
            replans=n_replans,
            last_plan=(dict(zip(last_plan.pod_names, last_plan.shares))
                       if last_plan else {}),
            stream=stream,
            energy=energy,
            fleet=fleet,
        )

    def _energy_stats_locked(self, n_done: int) -> EnergyStats | None:
        """The ``stats().energy`` section (caller holds ``_lock``):
        modeled joules, J/detection, per-tier SLO compliance, and the
        per-pod operating points the governor chose from plan work units.
        None when the service runs ungoverned."""
        if self._energy_acct is None:
            return None
        acct = self._energy_acct
        d = self._last_decision
        return EnergyStats(
            governor=self.governor,
            slo_ms=self.slo_ms,
            total_J=acct.total_J,
            active_J=sum(acct.active_J),
            idle_J=sum(acct.idle_J),
            flushes=acct.flushes,
            slo_met_frac=(acct.slo_met / acct.flushes
                          if acct.flushes else 1.0),
            slo_met_by_tier=acct.slo_met_by_tier(),
            J_per_detection=acct.total_J / max(n_done, 1),
            sim_makespan_p95_ms=(
                float(np.percentile(np.asarray(acct.makespans) * 1e3, 95))
                if acct.makespans else 0.0),
            pods=tuple(
                EnergyPodStats(name=p.name, cluster=p.cluster,
                               op=acct.op_names[i],
                               active_J=acct.active_J[i],
                               idle_J=acct.idle_J[i], busy_s=acct.busy_s[i],
                               work_units=acct.work_units[i])
                for i, p in enumerate(self.pods)),
            last_decision=(DecisionStats(
                ops=tuple(op.name for op in d.ops),
                work_units=d.work_units,
                predicted_makespan_ms=d.makespan * 1e3,
                predicted_energy_J=d.energy,
                feasible=d.feasible) if d is not None else None),
        )
