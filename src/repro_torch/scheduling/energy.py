"""Calibrated power/performance models of the paper's platforms.

The port of ``repro.scheduling.energy``: the same model, the same tables,
value for value, so the port's modelled joules equal the reference's.
Every watt here is **modelled**, calibrated so that the paper's measured
operating points are reproduced:

- Raspberry Pi 3B+  : 2.5 W sequential, 5.5 W parallel(4)          (§6)
- Odroid XU4        : 3.0 W sequential (1 big @ 2.0 GHz),
                      6.85 W parallel (4 big @ 2.0 + 4 LITTLE @ 1.4) (§6)
- DVFS points       : big cluster {2000, 1500, 1000, 800} MHz,
                      LITTLE fixed 1400 MHz                        (§7.4)

Dynamic power follows P = C · f · V(f)^2 per active core with published
Exynos 5422 / BCM2837 voltage steps; static/idle power is a per-board
constant.  Performance: work-units/second per core ∝ f x IPC(class); IPC
ratios big:LITTLE calibrated from [23]'s observation that LITTLE cores add
little (A7 ≈ 0.45 x A15 IPC; A53 ≈ 0.55 x A15 IPC).

``tpu_v5e_pod`` is the reference's modelled TPU pod (chips as cores),
kept as data so that the port's decisions equal the reference's; it is
for *relative* scheduling decisions only and says nothing of the card the
port runs on.  No model here describes that card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["CorePowerModel", "odroid_xu4", "rpi3b", "tpu_v5e_pod",
           "EXYNOS_BIG_FREQS", "EXYNOS_LITTLE_FREQS", "PodOperatingPoint",
           "pod_operating_points", "parked_point", "EnergyAccount"]

# Exynos 5422 published DVFS voltage steps (V) per frequency (GHz).
_A15_VOLTS = {2.0: 1.3625, 1.8: 1.2625, 1.5: 1.075, 1.2: 1.0125,
              1.0: 0.975, 0.8: 0.9125}
_A7_VOLTS = {1.4: 1.2750, 1.2: 1.1125, 1.0: 1.0375, 0.8: 0.9625}
_A53_VOLTS = {1.4: 1.2500, 1.2: 1.1500, 1.0: 1.0500}

EXYNOS_BIG_FREQS = (2.0, 1.5, 1.0, 0.8)      # the paper's sweep (GHz)
EXYNOS_LITTLE_FREQS = (1.4, 1.0, 0.8)

# Reference throughput: 1.0 work-unit/s ≡ one A15 core at 2.0 GHz.
_IPC = {"A15": 1.0, "A7": 0.45, "A53": 0.55, "TPUv5e": 1.0, "TPUv4": 0.62}


@dataclass(frozen=True)
class CorePowerModel:
    """One cluster: n identical cores at a common frequency (cluster DVFS)."""
    name: str
    cls: str                  # IPC class key
    n: int
    freq: float               # GHz (or power-state scalar for TPU)
    volts: float
    cap: float                # effective switched capacitance (W / (GHz·V²))

    @property
    def rate(self) -> float:
        """Work-units/second for ONE core of this cluster."""
        return _IPC[self.cls] * self.freq / 2.0

    @property
    def active_power(self) -> float:
        """Dynamic watts for ONE active core."""
        return self.cap * self.freq * self.volts ** 2

    def at_freq(self, freq: float, volt_table: dict | None = None
                ) -> "CorePowerModel":
        table = volt_table or (_A15_VOLTS if self.cls == "A15" else
                               _A7_VOLTS if self.cls == "A7" else
                               _A53_VOLTS)
        if freq not in table:
            raise ValueError(f"no voltage step for {freq} GHz on {self.name}")
        return replace(self, freq=freq, volts=table[freq])


@dataclass(frozen=True)
class Platform:
    name: str
    clusters: tuple[CorePowerModel, ...]
    idle_power: float          # board static draw (W)

    def cluster(self, name: str) -> CorePowerModel:
        for c in self.clusters:
            if c.name == name:
                return c
        raise KeyError(name)

    def with_freqs(self, **freqs: float) -> "Platform":
        new = tuple(c.at_freq(freqs[c.name]) if c.name in freqs else c
                    for c in self.clusters)
        return replace(self, clusters=new)


def odroid_xu4(f_big: float = 2.0, f_little: float = 1.4) -> Platform:
    """Calibration: seq(1 big @2.0) = idle + 1.4 = 3.0 W;
    par(4 big @2.0 + 4 LITTLE @1.4) = idle + 4·1.4 + 4·0.26 ≈ 6.85 W."""
    big = CorePowerModel("big", "A15", 4, 2.0, _A15_VOLTS[2.0],
                         cap=1.40 / (2.0 * _A15_VOLTS[2.0] ** 2))
    little = CorePowerModel("LITTLE", "A7", 4, 1.4, _A7_VOLTS[1.4],
                            cap=0.26 / (1.4 * _A7_VOLTS[1.4] ** 2))
    p = Platform("odroid-xu4", (big, little), idle_power=1.59)
    return p.with_freqs(big=f_big, LITTLE=f_little)


def rpi3b(f: float = 1.4) -> Platform:
    """Calibration: seq = 1.5 + 1.0 = 2.5 W; par(4) = 1.5 + 4·1.0 = 5.5 W."""
    core = CorePowerModel("cortex-a53", "A53", 4, 1.4, _A53_VOLTS[1.4],
                          cap=1.00 / (1.4 * _A53_VOLTS[1.4] ** 2))
    p = Platform("rpi3b+", (core,), idle_power=1.50)
    if f != 1.4:
        p = p.with_freqs(**{"cortex-a53": f})
    return p


# ---------------------------------------------------- serving pod DVFS state
@dataclass(frozen=True)
class PodOperatingPoint:
    """One DVFS state of a serving pod (a whole cluster acting as one unit).

    ``speed_scale`` multiplies the pod's *nominal* (top-frequency) measured
    rate — it is a pure frequency ratio, so a pod's calibrated work-units/s
    baseline stays the single source of absolute throughput.  ``idle_power``
    is the pod's share of board static draw, paid whether or not the pod
    runs work this flush (parking a pod saves its active power only)."""
    name: str
    freq: float            # GHz (0.0 = parked)
    speed_scale: float     # throughput multiplier vs the pod's top rung
    active_power: float    # W while the whole pod is busy at this point
    idle_power: float      # W drawn regardless of placement


def parked_point(ladder: tuple[PodOperatingPoint, ...]) -> PodOperatingPoint:
    """The 'no work placed here' pseudo-point of a pod's ladder: zero rate,
    zero active power, but still drawing its static share."""
    return PodOperatingPoint("parked", 0.0, 0.0, 0.0, ladder[0].idle_power)


def pod_operating_points(cluster: str = "big",
                         idle_power: float | None = None
                         ) -> tuple[PodOperatingPoint, ...]:
    """DVFS ladder of one serving pod, derived from the calibrated Exynos
    cluster models: ``cluster='big'`` sweeps the paper's A15 frequencies
    (§7.4), ``'LITTLE'`` the A7 ladder.  Descending frequency; the first
    entry is the top rung (``speed_scale == 1.0``).  ``idle_power`` defaults
    to an even split of the board's static draw across its clusters."""
    plat = odroid_xu4()
    cm = plat.cluster("big" if cluster == "big" else "LITTLE")
    freqs = EXYNOS_BIG_FREQS if cluster == "big" else EXYNOS_LITTLE_FREQS
    idle = (plat.idle_power / len(plat.clusters)
            if idle_power is None else idle_power)
    return tuple(
        PodOperatingPoint(f"{cluster}@{f:.1f}GHz", f, f / freqs[0],
                          cm.at_freq(f).active_power * cm.n, idle)
        for f in freqs)


class EnergyAccount:
    """Per-pod modeled-energy integrator for the serving governor.

    Charged once per sharded flush (:meth:`charge_shard`): each pod pays
    its operating point's active power over its busy (simulated) seconds,
    and every pod — parked or not — pays its idle power over the flush
    *makespan* (the slowest pod's busy time).  That idle term is what makes
    race-to-idle real in the model: a slow LITTLE-only placement stretches
    the window during which the whole board's static draw is attributed to
    the flush."""

    def __init__(self, n_pods: int):
        self.active_J = [0.0] * n_pods
        self.idle_J = [0.0] * n_pods
        self.busy_s = [0.0] * n_pods
        self.work_units = [0.0] * n_pods
        self.op_names = ["-"] * n_pods
        self.flushes = 0
        self.slo_met = 0
        self.makespans: list[float] = []      # per-flush sim makespan (s)
        # per-SLO-tier attainment: tier -> [flushes containing the tier,
        # flushes where the makespan met *that tier's* SLO]
        self.tier_flushes: dict[str, int] = {}
        self.tier_met: dict[str, int] = {}

    def charge_shard(self, ops, busy_s, units, slo_s: float | None = None,
                     wake_J: float = 0.0,
                     tier_slos: "dict[str, float] | None" = None) -> float:
        """Account one sharded flush; returns its simulated makespan.
        ``wake_J`` charges each pod that actually ran work the fixed
        cluster-wake/DVFS-transition cost the governor planned with.
        ``tier_slos`` maps each SLO tier present in the flush to its own
        deadline (s), so attainment is also tracked per tier — a flush can
        meet its best-effort deadline while missing the realtime one."""
        makespan = max(busy_s, default=0.0)
        for i, op in enumerate(ops):
            self.active_J[i] += (op.active_power * busy_s[i]
                                 + (wake_J if busy_s[i] > 0 else 0.0))
            self.idle_J[i] += op.idle_power * makespan
            self.busy_s[i] += busy_s[i]
            self.work_units[i] += units[i]
            self.op_names[i] = op.name
        self.flushes += 1
        self.makespans.append(makespan)
        if slo_s is not None and makespan <= slo_s:
            self.slo_met += 1
        for tier, tslo in (tier_slos or {}).items():
            self.tier_flushes[tier] = self.tier_flushes.get(tier, 0) + 1
            if makespan <= tslo:
                self.tier_met[tier] = self.tier_met.get(tier, 0) + 1
        return makespan

    @property
    def total_J(self) -> float:
        return sum(self.active_J) + sum(self.idle_J)

    def slo_met_by_tier(self) -> dict:
        """Per-tier SLO attainment over the flushes that carried the tier."""
        return {t: self.tier_met.get(t, 0) / n
                for t, n in self.tier_flushes.items() if n}

    def summary(self) -> dict:
        return {
            "total_J": self.total_J,
            "active_J": sum(self.active_J),
            "idle_J": sum(self.idle_J),
            "flushes": self.flushes,
            "slo_met_frac": (self.slo_met / self.flushes
                             if self.flushes else 1.0),
        }


def tpu_v5e_pod(n_chips: int = 256, power_state: float = 1.0) -> Platform:
    """The reference's modelled pod: chips as 'cores', power states as
    frequencies.  Only *relative* numbers matter for scheduling
    decisions."""
    chip = CorePowerModel("v5e", "TPUv5e", n_chips, power_state, 1.0,
                          cap=155.0)
    return Platform(f"tpu-v5e-{n_chips}", (chip,),
                    idle_power=45.0 * n_chips)
