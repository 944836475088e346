"""Fault tolerance & straggler mitigation for long multi-pod runs (numpy,
the reference's).

The paper's asymmetry lesson operationalized at fleet scale:

- **StragglerDetector** — per-pod step-time EWMA; a pod whose rate drifts
  below the fleet by more than a threshold (thermal throttle, flaky HBM,
  failing host) triggers a re-plan of the rate-weighted data split
  (scheduling/hetero.py) at the next step boundary — the Botlev move of
  keeping critical work off slow executors.
- **run_with_restarts** — checkpoint/restart driver: survivable failures
  restore the latest atomic checkpoint and continue; the resumable data
  pipeline guarantees bit-identical batches after restart.
- **ElasticPlan** — pod loss/gain: rebuild the mesh from the surviving
  pod set and restore (checkpoints are mesh-agnostic), shrinking the
  global batch by the lost pod's share or re-planning shares.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..scheduling.hetero import rate_weighted_split, HeteroPodPlan

__all__ = ["StragglerDetector", "run_with_restarts", "ElasticPlan"]


@dataclass
class StragglerDetector:
    n_pods: int
    ewma: float = 0.9
    threshold: float = 0.25          # relative slowdown that triggers replan
    _rates: np.ndarray | None = None

    def update(self, pod_step_seconds) -> np.ndarray:
        r = 1.0 / np.maximum(np.asarray(pod_step_seconds, np.float64), 1e-9)
        if self._rates is None:
            self._rates = r
        else:
            self._rates = self.ewma * self._rates + (1 - self.ewma) * r
        return self._rates

    def stragglers(self) -> list[int]:
        if self._rates is None:
            return []
        med = float(np.median(self._rates))
        return [i for i, r in enumerate(self._rates)
                if r < (1 - self.threshold) * med]

    def replan(self, plan: HeteroPodPlan, quantum: int | None = None
               ) -> HeteroPodPlan | None:
        """New rate-weighted split if any pod straggles, else None.  The
        re-plan inherits the old plan's ``quantum`` unless overridden."""
        if not self.stragglers() or self._rates is None:
            return None
        return rate_weighted_split(
            sum(plan.shares), self._rates, plan.pod_names,
            plan.quantum if quantum is None else quantum)


@dataclass
class ElasticPlan:
    """Track the live pod set; rebuild shares when membership changes."""
    pod_names: tuple
    rates: tuple
    live: set = field(default_factory=set)

    def __post_init__(self):
        self.live = set(range(len(self.pod_names)))

    def fail(self, pod: int):
        self.live.discard(pod)

    def join(self, pod: int):
        self.live.add(pod)

    def plan(self, n_items: int, quantum: int = 1) -> HeteroPodPlan:
        idx = sorted(self.live)
        if not idx:
            raise RuntimeError("no live pods")
        return rate_weighted_split(
            n_items, [self.rates[i] for i in idx],
            [self.pod_names[i] for i in idx], quantum)


def run_with_restarts(train_loop, *, max_restarts: int = 3,
                      survivable=(RuntimeError,), on_restart=None,
                      sleep_s: float = 0.0):
    """Drive ``train_loop(restart_count) -> result`` with restart-on-failure.

    ``train_loop`` is expected to restore from the latest checkpoint
    itself (see launch/train.py); this wrapper only bounds retries and
    re-raises non-survivable exceptions.
    """
    for attempt in range(max_restarts + 1):
        try:
            return train_loop(attempt)
        except survivable as e:                       # noqa: PERF203
            if attempt == max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            if sleep_s:
                time.sleep(sleep_s)
    raise AssertionError("unreachable")
