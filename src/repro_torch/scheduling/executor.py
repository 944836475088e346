"""Discrete-event simulator of asymmetric multicore platforms.

The port of ``repro.scheduling.executor``, unchanged: plain Python.

Executes a :class:`~repro_torch.scheduling.dag.TaskDAG` under a pluggable
scheduler on a :class:`~repro_torch.scheduling.energy.Platform`, producing
makespan, modeled energy (J) and a schedule trace.

Model
-----
- Each core advances the task it runs at ``core.rate x REF_RATE x
  contention(n_active)`` work-units/second.  ``contention`` captures the
  shared-resource (memory-bandwidth) saturation the paper observes: RPi
  3B+ gains only ~2x from 4 cores and the Odroid ~2.9x from 4+4 (§6) —
  calibrated via ``Platform``-level ``contention_alpha``:
  ``contention(n) = 1 / (1 + alpha * (n - 1))``.
- Per-task start overhead (OmpSs/Nanox task bookkeeping) is a constant.
- Energy integrates idle power over the makespan plus per-core active
  power over busy intervals — the same additive model used to calibrate
  the paper's watt measurements (energy.py).

The simulator recomputes completion horizons at every event so occupancy-
dependent rates stay exact (piecewise-constant between events).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .dag import TaskDAG
from .energy import Platform

__all__ = ["simulate", "SimResult", "Core", "REF_RATE", "CONTENTION_ALPHA"]

# Absolute calibration: one A15 @ 2.0 GHz executes ~2.1e6 work units/s
# (13.86M evalWeakClassifier calls in 6.50 s, paper Fig. 13 left).
REF_RATE = 2.1e6

# Shared-resource saturation per platform (see module docstring).
CONTENTION_ALPHA = {"odroid-xu4": 0.12, "rpi3b+": 1.0 / 3.0}


@dataclass
class Core:
    cid: int
    cluster: str
    rate: float            # work-units/s at REF_RATE scale, contention-free
    active_power: float    # W while busy
    task: int | None = None
    remaining: float = 0.0  # work units left of current task
    busy: float = 0.0       # accumulated busy seconds


@dataclass
class SimResult:
    makespan: float
    energy: float
    avg_power: float
    busy_seconds: dict
    n_tasks: int
    trace: list = field(default_factory=list)
    scheduler: str = ""
    platform: str = ""

    @property
    def cpu_utilization(self) -> float:
        total = sum(self.busy_seconds.values())
        return total / (self.makespan * len(self.busy_seconds) + 1e-12)


def _contention(platform: Platform, n_active: int, alpha: float | None) -> float:
    if alpha is None:
        alpha = CONTENTION_ALPHA.get(platform.name.split("/")[0], 0.0)
    if n_active <= 1:
        return 1.0
    return 1.0 / (1.0 + alpha * (n_active - 1))


def simulate(dag: TaskDAG, platform: Platform, scheduler,
             overhead_s: float = 2.5e-4, ref_rate: float = REF_RATE,
             contention_alpha: float | None = None,
             keep_trace: bool = False) -> SimResult:
    """Run ``dag`` on ``platform`` under ``scheduler``.

    Scheduler protocol:
      - ``prepare(dag, platform, cores)`` once before the run;
      - ``ready(task_id, t)`` when a task's dependencies complete;
      - ``pick(core, t) -> task_id | None`` when ``core`` goes idle.
    """
    n = len(dag)
    succ = dag.successors()
    indeg = dag.indegrees().copy()

    cores: list[Core] = []
    for cl in platform.clusters:
        for _ in range(cl.n):
            cores.append(Core(len(cores), cl.name, cl.rate,
                              cl.active_power))
    scheduler.prepare(dag, platform, cores)

    t = 0.0
    done = 0
    energy = 0.0
    trace: list = []
    start_t: dict[int, float] = {}

    for task in dag.tasks:
        if indeg[task.id] == 0:
            scheduler.ready(task.id, t)

    # overhead is charged as extra work at the core's own rate
    def task_work(tid: int, core: Core) -> float:
        return dag.tasks[tid].work + overhead_s * core.rate * ref_rate

    while done < n:
        # 1) fill idle cores
        started = True
        while started:
            started = False
            for c in cores:
                if c.task is None:
                    tid = scheduler.pick(c, t)
                    if tid is not None:
                        c.task = tid
                        c.remaining = task_work(tid, c)
                        start_t[tid] = t
                        started = True

        active = [c for c in cores if c.task is not None]
        if not active:
            raise RuntimeError("deadlock: no runnable task but DAG not done")

        # 2) advance to next completion under current contention
        lam = _contention(platform, len(active), contention_alpha)
        speeds = {c.cid: c.rate * ref_rate * lam for c in active}
        dt = min(c.remaining / speeds[c.cid] for c in active)
        t += dt
        # energy: idle + active dynamic power over dt
        energy += dt * (platform.idle_power +
                        sum(c.active_power for c in active))
        finished: list[Core] = []
        for c in active:
            c.remaining -= dt * speeds[c.cid]
            c.busy += dt
            if c.remaining <= 1e-9:
                finished.append(c)

        # 3) retire finished tasks, release children
        for c in finished:
            tid = c.task
            assert tid is not None
            if keep_trace:
                trace.append((tid, dag.tasks[tid].name, c.cluster, c.cid,
                              start_t[tid], t))
            c.task = None
            done += 1
            for s in succ[tid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    scheduler.ready(s, t)

    busy = {}
    for c in cores:
        busy[f"{c.cluster}[{c.cid}]"] = c.busy
    return SimResult(
        makespan=t, energy=energy, avg_power=energy / max(t, 1e-12),
        busy_seconds=busy, n_tasks=n, trace=trace,
        scheduler=type(scheduler).__name__, platform=platform.name)
