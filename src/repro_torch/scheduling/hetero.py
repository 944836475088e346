"""Heterogeneous-pod work partitioner — the paper's asymmetry insight at
pod scale.

The port of ``repro.scheduling.hetero``, unchanged, including its
rounding: ``rate_weighted_split(19, [1.0, 1.0], quantum=2)`` gives
(11, 8), since the largest-remainder unit and the ``n % quantum``
leftover both go to pod 0 (the reference does the same).

big.LITTLE's lesson transfers to fleets of mixed-generation accelerators:
a symmetric (static, equal) split of data-parallel work across pods of
unequal throughput makes the fast pods wait for the slow ones at every
synchronization point — exactly the paper's `schedule(static)` pathology
(§6).  The fixes are the same two the paper applies:

- **rate-weighted static split** (the analogue of calibrated static
  blocks): shard sizes ∝ measured pod rates, re-planned when rates drift
  (straggler mitigation);
- **criticality-aware dynamic assignment** (the analogue of Botlev): the
  detection/serving task DAG is scheduled with fast pods pinned to the
  critical path via
  :class:`~repro_torch.scheduling.botlev.BotlevScheduler` on a pod-level
  ``Platform``.

In the port the partitioner's consumer is the batched detection serving
front-end (:class:`repro_torch.serve.DetectorService` shards each
micro-batch flush across pods by measured rates and replans on straggle).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .energy import Platform, CorePowerModel

__all__ = ["HeteroPodPlan", "rate_weighted_split", "mixed_pod_platform",
           "replan_on_straggle", "update_rates_ema"]


@dataclass(frozen=True)
class HeteroPodPlan:
    """Work shares per pod; shares sum to the total unit count exactly."""
    pod_names: tuple[str, ...]
    rates: tuple[float, ...]          # relative throughput (work-units/s)
    shares: tuple[int, ...]           # integer work items per pod
    quantum: int = 1                  # per-pod share granularity the plan
    #                                   was built with (e.g. the microbatch
    #                                   size that must divide device count);
    #                                   re-plans must preserve it

    @property
    def imbalance(self) -> float:
        """max finish / ideal finish under the rate model (1.0 = perfect).

        A zero-rate pod holding a positive share never finishes: that is
        infinite imbalance, not a pod to silently drop from the max."""
        if any(s > 0 and r <= 0 for s, r in zip(self.shares, self.rates)):
            return float("inf")
        t = [s / r for s, r in zip(self.shares, self.rates) if r > 0]
        if not t:
            return 1.0                        # no work placed anywhere
        ideal = sum(self.shares) / sum(r for r in self.rates if r > 0)
        return max(t) / ideal if ideal > 0 else 1.0


def rate_weighted_split(n_items: int, rates: Sequence[float],
                        names: Sequence[str] | None = None,
                        quantum: int = 1) -> HeteroPodPlan:
    """Split ``n_items`` across pods ∝ rates, in multiples of ``quantum``
    (e.g. the per-pod microbatch must divide the device count).  Largest-
    remainder rounding keeps the sum exact."""
    rates = np.asarray(rates, np.float64)
    if (rates <= 0).all():
        raise ValueError("all pod rates are zero")
    rates = np.clip(rates, 0.0, None)
    names = tuple(names) if names is not None else tuple(
        f"pod{i}" for i in range(len(rates)))
    n_q = n_items // quantum
    exact = rates / rates.sum() * n_q
    base = np.floor(exact).astype(int)
    rem = n_q - base.sum()
    # largest remainder, ties to the faster pod
    order = np.lexsort((-rates, -(exact - base)))
    for i in order[:rem]:
        base[i] += 1
    shares = tuple(int(b) * quantum for b in base)
    # any leftover (n_items % quantum) goes to the fastest pod
    left = n_items - sum(shares)
    if left:
        fast = int(np.argmax(rates))
        shares = tuple(s + left if i == fast else s
                       for i, s in enumerate(shares))
    return HeteroPodPlan(names, tuple(float(r) for r in rates), shares,
                         quantum)


def mixed_pod_platform(pod_specs: Sequence[tuple[str, str, int, float]],
                       idle_per_chip: float = 45.0) -> Platform:
    """Pod-level ``Platform`` for the DES: each pod is one 'cluster'.

    ``pod_specs``: (name, ipc_class, n_chips, power_state) — ipc_class keys
    into the energy model's class table ('TPUv5e' fast, 'TPUv4' slow), so a
    mixed-generation fleet is exactly a big.LITTLE platform at pod scale.
    """
    clusters = []
    n_total = 0
    for name, cls, n, state in pod_specs:
        clusters.append(CorePowerModel(name, cls, n, state, 1.0, cap=155.0))
        n_total += n
    return Platform("mixed-pods", tuple(clusters),
                    idle_power=idle_per_chip * n_total)


def update_rates_ema(rates: Sequence[float], observed: Sequence[float],
                     alpha: float = 0.5) -> np.ndarray:
    """Exponential-moving-average rate tracker for the serving loop: pods
    with no observation this flush (share 0 / idle) keep their old rate."""
    rates = np.asarray(rates, np.float64).copy()
    observed = np.asarray(observed, np.float64)
    m = observed > 0
    rates[m] = (1 - alpha) * rates[m] + alpha * observed[m]
    return rates


def replan_on_straggle(plan: HeteroPodPlan, measured_rates: Sequence[float],
                       threshold: float = 0.15) -> HeteroPodPlan | None:
    """Re-plan when measured rates drift from the plan's assumptions by more
    than ``threshold`` (relative).  Returns the new plan, or None if the
    current plan is still within tolerance — callers re-plan at step
    boundaries only (cheap, no checkpoint needed).  The re-plan keeps the
    original plan's ``quantum``, so a share constraint (per-pod microbatch
    dividing the device count) survives straggler mitigation."""
    old = np.asarray(plan.rates)
    new = np.asarray(measured_rates, np.float64)
    drift = np.abs(new - old) / np.maximum(old, 1e-12)
    if (drift < threshold).all():
        return None
    return rate_weighted_split(sum(plan.shares), new, plan.pod_names,
                               quantum=plan.quantum)
