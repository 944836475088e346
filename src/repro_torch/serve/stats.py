"""Typed, versioned ``DetectorService.stats()`` schema.

The port of ``repro.serve.stats``: the same records, field names and
``as_dict()`` view (``SCHEMA_VERSION`` 1), so a port service's stats
compare key for key with the reference's.

The service's observability surface used to be an ad-hoc nested dict
(``stats()["tail"]["chosen"]``, ``stats()["stream"]["level_skip_frac"]``,
``stats()["energy"]`` ...).  This module makes every field a documented
dataclass attribute with a ``schema_version`` stamp, while keeping the old
dict-key access working through a deprecation shim:

- typed (current):   ``svc.stats().energy.J_per_detection``
- dict (deprecated): ``svc.stats()["energy"]["J_per_detection"]`` — the
  top-level ``__getitem__`` warns once and serves the ``as_dict()`` view,
  so chained nested-key access keeps working unchanged.

``as_dict()`` is the benchmark/JSON contract: plain dicts/lists/floats
only, stable key names (the pre-redesign dict schema plus the
``schema_version`` and ``fleet`` additions).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

__all__ = ["SCHEMA_VERSION", "PodStats", "TailStats", "StreamStats",
           "EnergyPodStats", "DecisionStats", "EnergyStats", "FleetStats",
           "ServiceStats"]

#: Bumped whenever a field is renamed/removed (additions don't bump it).
SCHEMA_VERSION = 1


@dataclass(frozen=True)
class PodStats:
    """One pod's share of the service's work (``stats().pods[i]``)."""
    name: str
    speed: float
    cluster: str
    rate: float                 # tracked nominal rate, work-units/s
    images: int                 # requests/frames run on this pod
    sim_time_s: float           # accumulated simulated busy time

    def as_dict(self) -> dict:
        return {"name": self.name, "speed": self.speed,
                "cluster": self.cluster, "rate": self.rate,
                "images": self.images, "sim_time_s": self.sim_time_s}


@dataclass(frozen=True)
class TailStats:
    """Packed-tail backend policy in force (plan-layer choices)."""
    backend: str                            # EngineConfig.tail_backend
    rungs: tuple = ()                       # measured crossover ladder
    chosen: tuple = ()                      # (capacity, backend) per segment
    #                                         of the warmed probe bucket

    def as_dict(self) -> dict:
        return {"backend": self.backend,
                "rungs": [list(r) for r in self.rungs],
                "chosen": [list(c) for c in self.chosen]}


@dataclass(frozen=True)
class StreamStats:
    """Aggregate stream-session accounting (``stats().stream``)."""
    sessions: int
    frames_done: int
    frame_modes: dict = field(default_factory=dict)
    window_skip_frac: float = 0.0
    level_skip_frac: float = 0.0

    def as_dict(self) -> dict:
        return {"sessions": self.sessions, "frames_done": self.frames_done,
                "frame_modes": dict(self.frame_modes),
                "window_skip_frac": self.window_skip_frac,
                "level_skip_frac": self.level_skip_frac}


@dataclass(frozen=True)
class EnergyPodStats:
    """One pod's slice of the energy ledger (``stats().energy.pods[i]``)."""
    name: str
    cluster: str
    op: str                     # last operating point chosen by the governor
    active_J: float
    idle_J: float
    busy_s: float
    work_units: float

    def as_dict(self) -> dict:
        return {"name": self.name, "cluster": self.cluster, "op": self.op,
                "active_J": self.active_J, "idle_J": self.idle_J,
                "busy_s": self.busy_s, "work_units": self.work_units}


@dataclass(frozen=True)
class DecisionStats:
    """The governor's most recent per-flush placement decision."""
    ops: tuple                  # operating-point names, one per pod
    work_units: float
    predicted_makespan_ms: float
    predicted_energy_J: float
    feasible: bool

    def as_dict(self) -> dict:
        return {"ops": list(self.ops), "work_units": self.work_units,
                "predicted_makespan_ms": self.predicted_makespan_ms,
                "predicted_energy_J": self.predicted_energy_J,
                "feasible": self.feasible}


@dataclass(frozen=True)
class EnergyStats:
    """Modeled-energy ledger summary (``stats().energy``; None when the
    service runs ungoverned)."""
    governor: str
    slo_ms: float
    total_J: float
    active_J: float
    idle_J: float
    flushes: int
    slo_met_frac: float
    slo_met_by_tier: dict = field(default_factory=dict)  # tier -> met frac
    J_per_detection: float = 0.0
    sim_makespan_p95_ms: float = 0.0
    pods: tuple = ()                         # EnergyPodStats per pod
    last_decision: "DecisionStats | None" = None

    def as_dict(self) -> dict:
        return {"governor": self.governor, "slo_ms": self.slo_ms,
                "total_J": self.total_J, "active_J": self.active_J,
                "idle_J": self.idle_J, "flushes": self.flushes,
                "slo_met_frac": self.slo_met_frac,
                "slo_met_by_tier": dict(self.slo_met_by_tier),
                "J_per_detection": self.J_per_detection,
                "sim_makespan_p95_ms": self.sim_makespan_p95_ms,
                "pods": [p.as_dict() for p in self.pods],
                "last_decision": (self.last_decision.as_dict()
                                  if self.last_decision else {})}


@dataclass(frozen=True)
class FleetStats:
    """Multi-tenant fleet state (``stats().fleet``; None without a fleet
    scheduler attached, which the port does not have yet)."""
    sessions: int                            # live admitted sessions
    admitted: int                            # admission accepts, lifetime
    rejected: int                            # admission rejects, lifetime
    by_tier: dict = field(default_factory=dict)       # tier -> live count
    degraded_by_tier: dict = field(default_factory=dict)  # tier -> n>level 0
    degrade_events: int = 0
    restore_events: int = 0
    frames_submitted: int = 0
    frames_dropped: int = 0                  # shed AFTER ladder exhaustion
    demand_units_per_s: float = 0.0          # modeled offered load
    capacity_units_per_s: float = 0.0        # calibrated pod budget
    plan_groups: int = 0                     # distinct plan keys live

    def as_dict(self) -> dict:
        return {"sessions": self.sessions, "admitted": self.admitted,
                "rejected": self.rejected, "by_tier": dict(self.by_tier),
                "degraded_by_tier": dict(self.degraded_by_tier),
                "degrade_events": self.degrade_events,
                "restore_events": self.restore_events,
                "frames_submitted": self.frames_submitted,
                "frames_dropped": self.frames_dropped,
                "demand_units_per_s": self.demand_units_per_s,
                "capacity_units_per_s": self.capacity_units_per_s,
                "plan_groups": self.plan_groups}


@dataclass(frozen=True)
class ServiceStats:
    """The full ``DetectorService.stats()`` payload, schema-versioned."""
    schema_version: int
    n_done: int
    imgs_per_s: float
    latency_ms_p50: float
    latency_ms_p95: float
    latency_ms_p99: float
    tail: TailStats
    pods: tuple = ()                         # PodStats per pod
    makespan_imbalance: float = 1.0
    replans: int = 0
    last_plan: dict = field(default_factory=dict)     # pod name -> share
    stream: StreamStats = field(default_factory=lambda: StreamStats(0, 0))
    energy: "EnergyStats | None" = None
    fleet: "FleetStats | None" = None

    def as_dict(self) -> dict:
        """The stable dict/JSON view (the pre-redesign schema + the
        ``schema_version`` / ``fleet`` additions).  An ungoverned service
        keeps the historical ``{"governor": None}`` energy stanza."""
        return {
            "schema_version": self.schema_version,
            "n_done": self.n_done,
            "imgs_per_s": self.imgs_per_s,
            "tail": self.tail.as_dict(),
            "latency_ms_p50": self.latency_ms_p50,
            "latency_ms_p95": self.latency_ms_p95,
            "latency_ms_p99": self.latency_ms_p99,
            "pods": [p.as_dict() for p in self.pods],
            "makespan_imbalance": self.makespan_imbalance,
            "replans": self.replans,
            "last_plan": dict(self.last_plan),
            "stream": self.stream.as_dict(),
            "energy": (self.energy.as_dict() if self.energy is not None
                       else {"governor": None}),
            "fleet": self.fleet.as_dict() if self.fleet is not None else None,
        }

    def __getitem__(self, key: str):
        """Deprecated dict-key access shim: ``stats()["energy"]`` etc.
        Serves the ``as_dict()`` view so nested key chains keep working."""
        warnings.warn(
            "dict-key access to DetectorService.stats() is deprecated; use "
            f"the typed field (stats().{key}) or stats().as_dict()",
            DeprecationWarning, stacklevel=2)
        return self.as_dict()[key]
