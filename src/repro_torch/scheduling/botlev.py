"""Botlev — bottom-level criticality-aware scheduler for asymmetric cores.

The port of ``repro.scheduling.botlev``, unchanged.

Faithful re-implementation of the scheduler the paper applies (§7.1;
Chronaki et al., ICS'15 [27]):

- each task gets a priority = its *bottom level* (longest downstream path,
  costed on the fast class) computed at DAG build;
- criticality is tracked dynamically: the entry task with the largest
  bottom level is critical; when a critical task finishes, the ready child
  with the largest bottom level inherits criticality (the running estimate
  of the critical path);
- two ready queues: big cores pop the critical queue (highest priority
  first) and, when it is empty, *steal* from the non-critical queue's high
  end; LITTLE cores pop the non-critical queue (lowest priority first so
  cheap leaves don't starve the tail) and optionally steal critical work
  (``little_steals=False`` by default — matching [27]'s finding that slow
  cores must not grab critical-path tasks).
"""

from __future__ import annotations

import heapq

__all__ = ["BotlevScheduler"]


class BotlevScheduler:
    def __init__(self, fast_cluster: str = "big", little_steals: bool = False):
        self.fast_cluster = fast_cluster
        self.little_steals = little_steals

    def prepare(self, dag, platform, cores):
        self._blevel = dag.bottom_levels(rate=1.0)
        self._succ = dag.successors()
        self._crit_q: list[tuple[float, int]] = []     # max-heap (neg blevel)
        self._other_q: list[tuple[float, int]] = []    # min-heap (blevel)
        self._other_set: set[int] = set()
        self._crit_set: set[int] = set()
        self._critical: set[int] = set()
        # entry criticality: largest bottom level among entry tasks
        entries = [t.id for t in dag.tasks if not t.deps]
        if entries:
            e = max(entries, key=lambda i: self._blevel[i])
            self._critical.add(e)
        self._fast_cids = {c.cid for c in cores
                           if c.cluster == self.fast_cluster}
        if not self._fast_cids:                        # symmetric platform
            self._fast_cids = {c.cid for c in cores}

    # -- criticality propagation: called by the executor via ready()
    def ready(self, tid, t):
        if tid in self._critical:
            heapq.heappush(self._crit_q, (-self._blevel[tid], tid))
            self._crit_set.add(tid)
        else:
            heapq.heappush(self._other_q, (self._blevel[tid], tid))
            self._other_set.add(tid)

    def _mark_children(self, finished_tid):
        """Propagate criticality to the highest-blevel child."""
        kids = self._succ[finished_tid]
        if finished_tid in self._critical and kids:
            best = max(kids, key=lambda i: self._blevel[i])
            self._critical.add(best)

    def _pop_crit(self):
        while self._crit_q:
            _, tid = heapq.heappop(self._crit_q)
            if tid in self._crit_set:
                self._crit_set.discard(tid)
                self._mark_children(tid)
                return tid
        return None

    def _pop_other(self, high_end: bool):
        if not self._other_set:
            return None
        if high_end:
            tid = max(self._other_set, key=lambda i: self._blevel[i])
        else:
            while self._other_q:
                _, cand = heapq.heappop(self._other_q)
                if cand in self._other_set:
                    tid = cand
                    break
            else:
                return None
        self._other_set.discard(tid)
        self._mark_children(tid)
        return tid

    def pick(self, core, t):
        if core.cid in self._fast_cids:
            tid = self._pop_crit()
            if tid is None:
                tid = self._pop_other(high_end=True)   # steal biggest
            return tid
        tid = self._pop_other(high_end=False)
        if tid is None and self.little_steals:
            tid = self._pop_crit()
        return tid
