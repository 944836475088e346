"""Baseline schedulers (paper §6): sequential, omp-static, dynamic-greedy.

The port of ``repro.scheduling.policies``, unchanged."""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["SequentialScheduler", "StaticBlockScheduler", "FIFOScheduler"]


class SequentialScheduler:
    """Everything on one core of the named cluster (the paper's sequential
    baseline runs on one big core)."""

    def __init__(self, cluster: str = "big", core_index: int = 0):
        self.cluster = cluster
        self.core_index = core_index
        self._q = deque()
        self._cid = None

    def prepare(self, dag, platform, cores):
        matching = [c.cid for c in cores if c.cluster == self.cluster]
        if not matching:   # fall back to first core (RPi has one cluster)
            matching = [cores[0].cid]
        self._cid = matching[min(self.core_index, len(matching) - 1)]

    def ready(self, tid, t):
        self._q.append(tid)

    def pick(self, core, t):
        if core.cid != self._cid or not self._q:
            return None
        return self._q.popleft()


class StaticBlockScheduler:
    """``#pragma omp for schedule(static)``: tasks pre-assigned to cores in
    contiguous id blocks, asymmetry-blind (the paper's first parallel
    version, §6)."""

    def __init__(self):
        self._assignment = {}
        self._queues = {}

    def prepare(self, dag, platform, cores):
        n = len(dag)
        k = len(cores)
        bounds = np.linspace(0, n, k + 1).astype(int)
        self._queues = {c.cid: deque() for c in cores}
        self._ready = set()
        for ci, c in enumerate(cores):
            for tid in range(bounds[ci], bounds[ci + 1]):
                self._assignment[tid] = c.cid

    def ready(self, tid, t):
        self._ready.add(tid)

    def pick(self, core, t):
        q = [tid for tid in self._ready if self._assignment[tid] == core.cid]
        if not q:
            return None
        tid = min(q)          # program order within the block
        self._ready.discard(tid)
        return tid


class FIFOScheduler:
    """``schedule(dynamic)`` / plain Nanox: global ready FIFO, any free core
    takes the head — asymmetry-blind but load-balanced."""

    def __init__(self):
        self._q = deque()

    def prepare(self, dag, platform, cores):
        pass

    def ready(self, tid, t):
        self._q.append(tid)

    def pick(self, core, t):
        if not self._q:
            return None
        return self._q.popleft()
