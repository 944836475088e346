"""DVFS operating-point optimizer (paper §7.2, §7.4, Figs 21–24, Table I).

The port of ``repro.scheduling.dvfs``, unchanged.

Sweeps cluster frequencies × detector parameters (step, scaleFactor) on the
discrete-event simulator + calibrated power model, then selects the point
that minimizes energy subject to an accuracy constraint — the paper's
methodology: "optimal values ... to tolerate an error constraint less than
10 % of the total faces with the best detection time and the lowest
possible energy consumption" (Table I).

The accuracy term comes from the ``autotune`` sweep (error vs step/scale on
synthetic corpora — Fig. 20); time/energy come from the simulator.  The
paper only scales the big cluster ("modifying the frequency of the LITTLE
cluster has not a meaningful impact on the energy consumption, but a big
impact on the execution time" §7.4) — we default to the same sweep.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import itertools

from .dag import build_detection_dag, WorkModel
from .energy import (Platform, PodOperatingPoint, odroid_xu4, parked_point,
                     EXYNOS_BIG_FREQS)
from .botlev import BotlevScheduler
from .executor import simulate, SimResult

__all__ = ["DVFSPoint", "dvfs_sweep", "optimal_operating_point",
           "GovernorDecision", "binding_slo", "evaluate_operating_points",
           "select_operating_points"]


@dataclass(frozen=True)
class DVFSPoint:
    f_big: float               # GHz
    f_little: float            # GHz
    step: int
    scale_factor: float
    makespan: float            # s (modeled)
    energy: float              # J (modeled)
    avg_power: float           # W (modeled)
    error_frac: float          # total detection error / n_faces (autotune)

    @property
    def edp(self) -> float:    # energy-delay product (tie-break metric)
        return self.energy * self.makespan


def dvfs_sweep(stage_sizes: Sequence[int],
               error_model: Callable[[int, float], float],
               height: int = 480, width: int = 640, n_images: int = 10,
               f_bigs: Sequence[float] = EXYNOS_BIG_FREQS,
               f_littles: Sequence[float] = (1.4,),
               steps: Sequence[int] = (1, 2, 3, 4),
               scale_factors: Sequence[float] = (1.1, 1.2, 1.3, 1.5),
               platform_fn: Callable[..., Platform] = odroid_xu4,
               scheduler_fn: Callable[[], object] = BotlevScheduler,
               work_model: WorkModel | None = None) -> list[DVFSPoint]:
    """Full grid: {f_big} × {f_LITTLE} × {step} × {scaleFactor}.

    ``error_model(step, scale) -> error_frac`` is measured once per
    (step, scale) by the autotune sweep and reused across frequencies
    (frequency does not change accuracy).
    """
    points: list[DVFSPoint] = []
    for step in steps:
        for sf in scale_factors:
            dag = build_detection_dag(height, width, stage_sizes, step=step,
                                      scale_factor=sf, n_images=n_images,
                                      work_model=work_model)
            err = float(error_model(step, sf))
            for fb in f_bigs:
                for fl in f_littles:
                    plat = platform_fn(f_big=fb, f_little=fl)
                    res: SimResult = simulate(dag, plat, scheduler_fn())
                    points.append(DVFSPoint(fb, fl, step, sf, res.makespan,
                                            res.energy, res.avg_power, err))
    return points


# ------------------------------------------------- serving energy governor
@dataclass(frozen=True)
class GovernorDecision:
    """One flush's chosen per-pod DVFS placement and its model predictions.

    ``rates`` are effective work-units/s (each pod's calibrated nominal
    rate × its point's ``speed_scale``); parked pods carry rate 0 and
    therefore receive share 0 from the rate-weighted splitter."""
    ops: tuple[PodOperatingPoint, ...]
    rates: tuple[float, ...]
    work_units: float
    makespan: float            # predicted flush makespan (s, modeled)
    energy: float              # predicted flush energy (J, modeled)
    feasible: bool             # predicted makespan meets the latency SLO

    @property
    def power(self) -> float:
        return self.energy / max(self.makespan, 1e-12)


def binding_slo(slo_s: "float | Sequence[float]") -> float:
    """Collapse a tiered SLO input to the flush's *binding* deadline.

    A flush can mix requests from several SLO tiers (realtime / standard /
    best_effort); the governor must plan against the tightest deadline
    present, so a sequence of per-tier SLOs reduces to its minimum.  A
    plain float passes through; an empty sequence means no deadline."""
    if isinstance(slo_s, (int, float)):
        return float(slo_s)
    vals = [float(s) for s in slo_s]
    return min(vals) if vals else float("inf")


def evaluate_operating_points(work_units: float,
                              base_rates: Sequence[float],
                              ops: Sequence[PodOperatingPoint],
                              slo_s: "float | Sequence[float]" = float("inf"),
                              wake_J: float = 0.0
                              ) -> GovernorDecision | None:
    """Predict makespan/energy of one fixed per-pod placement under the
    rate-weighted split (busy pods finish together at ``work / Σ rates``).

    ``wake_J`` is a fixed per-flush cost per *active* pod (cluster wake +
    DVFS transition).  It is what makes placement work-dependent: running
    energy is linear in ``work_units`` so the cheapest frequency mix would
    otherwise be the same for a cached-stream trickle as for a keyframe
    burst, but a fixed activation cost tips tiny flushes toward fewer
    (LITTLE) pods while leaving big flushes to the frequency tradeoff.
    ``slo_s`` may be a sequence of per-tier SLOs — the binding (minimum)
    one is the deadline (:func:`binding_slo`).
    Returns None when no pod takes work (all parked / zero base rate)."""
    slo_s = binding_slo(slo_s)
    rates = tuple(float(r) * op.speed_scale
                  for r, op in zip(base_rates, ops))
    total_rate = sum(rates)
    if total_rate <= 0:
        return None
    t = float(work_units) / total_rate
    n_active = sum(1 for r in rates if r > 0)
    power = (sum(op.idle_power for op in ops)
             + sum(op.active_power
                   for op, r in zip(ops, rates) if r > 0))
    return GovernorDecision(tuple(ops), rates, float(work_units), t,
                            power * t + wake_J * n_active, t <= slo_s)


def select_operating_points(work_units: float,
                            base_rates: Sequence[float],
                            ladders: Sequence[tuple[PodOperatingPoint, ...]],
                            slo_s: "float | Sequence[float]",
                            wake_J: float = 0.0,
                            max_configs: int = 20000) -> GovernorDecision:
    """Pick per-pod operating points (including parking) that minimize
    modeled energy subject to the latency SLO — the paper's Table-I
    selection transplanted to the serving loop.  ``slo_s`` accepts a
    sequence of per-tier SLOs (the binding minimum is used), so a flush
    mixing realtime and best-effort work plans for the realtime deadline.

    Exhausts the cartesian product of per-pod ladders (+ parked) when it is
    small; beyond ``max_configs`` each ladder is thinned to its top/bottom
    rungs + parked (the extremes dominate the Pareto set under the affine
    power model).  If no placement meets the SLO the fastest one wins —
    race-to-idle is the correct degradation for bursts."""
    slo_s = binding_slo(slo_s)
    cands = []
    n = 1
    for lad in ladders:
        n *= len(lad) + 1
    for lad in ladders:
        thin = lad if n <= max_configs else (lad[0], lad[-1])
        cands.append(tuple(thin) + (parked_point(lad),))
    best = best_any = None

    def key(d: GovernorDecision):
        return (round(d.energy, 9), d.makespan)

    for combo in itertools.product(*cands):
        d = evaluate_operating_points(work_units, base_rates, combo, slo_s,
                                      wake_J)
        if d is None:
            continue
        if best_any is None or (d.makespan, d.energy) < (best_any.makespan,
                                                         best_any.energy):
            best_any = d
        if d.feasible and (best is None or key(d) < key(best)):
            best = d
    if best is None and best_any is None:
        raise ValueError("no pod has a positive rate")
    return best if best is not None else best_any


def optimal_operating_point(points: Sequence[DVFSPoint],
                            max_error: float = 0.10) -> DVFSPoint:
    """Paper Table I selection: among points meeting the error constraint,
    minimize energy; break ties by makespan (the paper's 'best detection
    time and lowest possible energy')."""
    feas = [p for p in points if p.error_frac <= max_error]
    if not feas:
        # constraint infeasible on this corpus — degrade gracefully to the
        # lowest-error point (the paper would widen the sweep instead)
        best_err = min(p.error_frac for p in points)
        feas = [p for p in points if p.error_frac <= best_err + 1e-9]
    return min(feas, key=lambda p: (round(p.energy, 6), p.makespan))
