"""Detection-task DAG (paper Fig. 19) + calibrated work model.

The port of ``repro.scheduling.dag``, over the port's ``WINDOW`` and
``pyramid_plan``.

Nodes mirror the paper's decomposition of the Viola-Jones pipeline:

    downscale(level) → integral(level) → { stage_seg(level, tile, seg) } → reduce

- one ``downscale``/``integral`` chain per pyramid level;
- detection windows of a level are grouped into *tiles* (the OmpSs
  ``schedule(static)`` blocks / the engine's wave tiles); each tile runs the
  cascade's stage *segments* in sequence (the early-exit dependency the
  paper describes: a segment only runs on the tile's survivors);
- a final ``reduce`` gathers detections (the paper's shared ``stage_sum``
  privatization makes this a cheap join).

Work model (abstract units; 1 unit ≈ one weak-classifier evaluation ≈ 18
parameter fetches + ~20 ALU ops, the paper's dominant primitive):

    downscale : PIX_DOWNSCALE per output pixel
    integral  : PIX_INTEGRAL  per pixel (two passes)
    variance  : VAR_WINDOW    per window (int_sqrt path, Fig. 13 ≈ 11–13 %)
    stage_seg : survivors(seg) x stage sizes in the segment

Survivor counts come either from a measured engine profile
(``Detector.work_profile``) or from a geometric rejection model
(`survival_rate` per stage, default 0.5 — the classic cascade design point).
With the defaults, the per-phase share of total work reproduces the
paper's Fig. 13 profile within a few percent (integral ≈ 2 %, variance
≈ 12 %, weak-classifier evaluation ≈ 85 %).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.cascade import WINDOW
from repro_torch.core.pyramid import pyramid_plan

__all__ = ["Task", "TaskDAG", "build_detection_dag", "WorkModel"]

PIX_DOWNSCALE = 0.08
PIX_INTEGRAL = 0.30
VAR_WINDOW = 7.0


@dataclass(frozen=True)
class Task:
    id: int
    name: str
    work: float                     # abstract work units
    deps: tuple[int, ...] = ()
    kind: str = "generic"
    level: int = -1
    tile: int = -1
    seg: int = -1


@dataclass
class TaskDAG:
    tasks: list[Task] = field(default_factory=list)

    def add(self, name: str, work: float, deps: Sequence[int] = (),
            kind: str = "generic", level: int = -1, tile: int = -1,
            seg: int = -1) -> int:
        tid = len(self.tasks)
        self.tasks.append(Task(tid, name, float(work), tuple(deps), kind,
                               level, tile, seg))
        return tid

    def __len__(self) -> int:
        return len(self.tasks)

    @property
    def total_work(self) -> float:
        return sum(t.work for t in self.tasks)

    def successors(self) -> list[list[int]]:
        succ: list[list[int]] = [[] for _ in self.tasks]
        for t in self.tasks:
            for d in t.deps:
                succ[d].append(t.id)
        return succ

    def indegrees(self) -> np.ndarray:
        deg = np.zeros(len(self.tasks), np.int64)
        for t in self.tasks:
            deg[t.id] = len(t.deps)
        return deg

    def bottom_levels(self, rate: float = 1.0) -> np.ndarray:
        """b(t) = cost(t) + max_{c in succ(t)} b(c), costs on the *fast*
        class (the Botlev convention).  Reverse-topological dynamic
        program; the DAG is built topologically ordered."""
        succ = self.successors()
        b = np.zeros(len(self.tasks))
        for t in reversed(self.tasks):
            smax = max((b[c] for c in succ[t.id]), default=0.0)
            b[t.id] = t.work / rate + smax
        return b

    def critical_path_work(self) -> float:
        return float(self.bottom_levels(rate=1.0).max()) if self.tasks else 0.0

    def validate(self) -> None:
        for t in self.tasks:
            for d in t.deps:
                assert 0 <= d < t.id, "DAG must be topologically ordered"


@dataclass
class WorkModel:
    """Per-stage survivor fractions used to cost stage segments."""
    stage_sizes: np.ndarray            # (n_stages,)
    survival: np.ndarray               # (n_stages,) fraction alive AFTER s

    @staticmethod
    def geometric(stage_sizes, rate: float = 0.5) -> "WorkModel":
        sizes = np.asarray(stage_sizes, np.float64)
        surv = np.power(rate, np.arange(1, len(sizes) + 1))
        return WorkModel(sizes, surv)

    @staticmethod
    def from_profile(stage_sizes, alive_counts, n_windows) -> "WorkModel":
        sizes = np.asarray(stage_sizes, np.float64)
        surv = np.asarray(alive_counts, np.float64) / max(n_windows, 1)
        return WorkModel(sizes, surv)

    def segment_work(self, n_windows: float, s0: int, s1: int) -> float:
        """Weak evals of stages [s0, s1) given per-stage survival."""
        alive = np.concatenate([[1.0], self.survival])
        return float(sum(n_windows * alive[s] * self.stage_sizes[s]
                         for s in range(s0, s1)))


def build_detection_dag(height: int, width: int,
                        stage_sizes: Sequence[int],
                        step: int = 1, scale_factor: float = 1.2,
                        tile_windows: int = 4096,
                        segments: Sequence[tuple[int, int]] | None = None,
                        work_model: WorkModel | None = None,
                        n_images: int = 1) -> TaskDAG:
    """DAG for detecting over ``n_images`` images of (height, width).

    ``segments``: [(s0, s1)] stage grouping; default = one segment per
    stage for the first 3 stages, then groups of 3 (the engine default).
    """
    sizes = np.asarray(stage_sizes, np.float64)
    n_stages = len(sizes)
    if work_model is None:
        work_model = WorkModel.geometric(sizes)
    if segments is None:
        segments = [(0, 1), (1, 2), (2, 3)] if n_stages >= 3 else []
        s = segments[-1][1] if segments else 0
        while s < n_stages:
            s1 = min(s + 3, n_stages)
            segments.append((s, s1))
            s = s1
        segments = [(a, b) for (a, b) in segments if a < b and a < n_stages]

    dag = TaskDAG()
    plan = pyramid_plan(height, width, scale_factor)
    for img in range(n_images):
        img_final: list[int] = []
        for li, lv in enumerate(plan):
            pix = lv.height * lv.width
            t_down = dag.add(f"i{img}.down[{li}]", pix * PIX_DOWNSCALE,
                             deps=(), kind="downscale", level=li)
            t_int = dag.add(f"i{img}.integral[{li}]", pix * PIX_INTEGRAL * 2,
                            deps=(t_down,), kind="integral", level=li)
            ny = (lv.height - WINDOW) // step + 1
            nx = (lv.width - WINDOW) // step + 1
            n_win = ny * nx
            n_tiles = max(1, int(np.ceil(n_win / tile_windows)))
            per_tile = n_win / n_tiles
            for ti in range(n_tiles):
                prev = dag.add(
                    f"i{img}.var[{li}.{ti}]", per_tile * VAR_WINDOW,
                    deps=(t_int,), kind="variance", level=li, tile=ti)
                for si, (s0, s1) in enumerate(segments):
                    wk = work_model.segment_work(per_tile, s0, s1)
                    prev = dag.add(
                        f"i{img}.seg[{li}.{ti}.{si}]", max(wk, 1.0),
                        deps=(prev,), kind="stage_seg", level=li, tile=ti,
                        seg=si)
                img_final.append(prev)
        dag.add(f"i{img}.reduce", 50.0, deps=tuple(img_final), kind="reduce")
    dag.validate()
    return dag
