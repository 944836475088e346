"""HEFT (Heterogeneous Earliest Finish Time) — classic static baseline [28].

Plans offline with exact per-class rates (zero communication costs — shared
memory, as the paper's Botlev setup assumes), then the DES replays the
assignment: each core runs its planned tasks in planned order.  Because the
DES adds contention + per-task overhead, the replay is an honest evaluation
of a static plan under dynamic conditions (exactly why the paper prefers a
dynamic criticality scheduler).

The port of ``repro.scheduling.heft``, unchanged."""

from __future__ import annotations

import numpy as np

__all__ = ["HEFTScheduler"]


class HEFTScheduler:
    def prepare(self, dag, platform, cores):
        n = len(dag)
        rates = np.array([c.rate for c in cores])
        mean_rate = rates.mean()
        succ = dag.successors()

        # upward rank on mean cost
        rank = np.zeros(n)
        for task in reversed(dag.tasks):
            smax = max((rank[s] for s in succ[task.id]), default=0.0)
            rank[task.id] = task.work / mean_rate + smax

        order = np.argsort(-rank)
        core_free = np.zeros(len(cores))
        finish = np.zeros(n)
        assignment = {}
        plan: list[list[int]] = [[] for _ in cores]
        for tid in order:
            task = dag.tasks[int(tid)]
            est = max((finish[d] for d in task.deps), default=0.0)
            # earliest finish time over cores
            eft = core_free.clip(min=est) + task.work / (rates * 1.0)
            c = int(np.argmin(eft))
            start = max(core_free[c], est)
            finish[tid] = start + task.work / rates[c]
            core_free[c] = finish[tid]
            assignment[int(tid)] = c
            plan[c].append(int(tid))

        self._plan = plan                  # per-core ordered task list
        self._next_idx = [0] * len(cores)
        self._ready: set[int] = set()

    def ready(self, tid, t):
        self._ready.add(tid)

    def pick(self, core, t):
        i = self._next_idx[core.cid]
        plan = self._plan[core.cid]
        if i < len(plan) and plan[i] in self._ready:
            self._ready.discard(plan[i])
            self._next_idx[core.cid] += 1
            return plan[i]
        return None
