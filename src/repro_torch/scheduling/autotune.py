"""step / scaleFactor accuracy sweep (paper §7.3, Fig. 20).

The port of ``repro.scheduling.autotune``, over the port's ``Detector``.
``accuracy_sweep`` runs its detectors on ``device`` (the card unless the
caller names one; ``device="cpu"`` runs the kernels' plain versions).

Measures total detection error (false positives + false negatives) of the
detector over a synthetic corpus as a function of the window stride
(``step``) and pyramid ratio (``scaleFactor``), producing the error model
consumed by the DVFS optimizer (Table I's error constraint).

Matching criterion: a detection matches a ground-truth face if IoU ≥ 0.4
(one-to-one, greedy by IoU) — the usual box-matching rule; the paper counts
per-image FP/FN the same way against its labelled databases.

Naming note: this is the *accuracy* autotuner.  Kernel block-shape
autotuning (head tiles, packed-tail lane blocks) lives in
:mod:`repro_torch.kernels.autotune`, next to the kernels it tunes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core import Detector, EngineConfig
from repro_torch.core.cascade import Cascade
from repro_torch.core.nms import iou_matrix
from repro_torch.core.training.data import render_scene

__all__ = ["SweepCell", "match_detections", "accuracy_sweep", "error_table"]


@dataclass(frozen=True)
class SweepCell:
    step: int
    scale_factor: float
    n_faces: int
    true_pos: int
    false_pos: int
    false_neg: int

    @property
    def total_error(self) -> int:
        return self.false_pos + self.false_neg

    @property
    def error_frac(self) -> float:
        return self.total_error / max(self.n_faces, 1)

    @property
    def precision(self) -> float:
        return self.true_pos / max(self.true_pos + self.false_pos, 1)

    @property
    def recall(self) -> float:
        return self.true_pos / max(self.true_pos + self.false_neg, 1)


def match_detections(det: np.ndarray, gt: np.ndarray,
                     iou_thresh: float = 0.4) -> tuple[int, int, int]:
    """Greedy one-to-one IoU matching → (TP, FP, FN)."""
    det = np.asarray(det, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if len(det) == 0:
        return 0, 0, len(gt)
    if len(gt) == 0:
        return 0, len(det), 0
    iou = iou_matrix(det, gt)
    used_d: set[int] = set()
    used_g: set[int] = set()
    # greedy: best IoU pair first
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                       iou.shape))[0]
    tp = 0
    for di, gi in order:
        if iou[di, gi] < iou_thresh:
            break
        if di in used_d or gi in used_g:
            continue
        used_d.add(int(di))
        used_g.add(int(gi))
        tp += 1
    return tp, len(det) - tp, len(gt) - tp


def accuracy_sweep(cascade: Cascade,
                   steps: Sequence[int] = (1, 2, 3, 4),
                   scale_factors: Sequence[float] = (1.1, 1.2, 1.3, 1.5),
                   n_images: int = 8, height: int = 160, width: int = 160,
                   faces_per_image: tuple[int, int] = (1, 3),
                   seed: int = 0, mode: str = "wave",
                   min_neighbors: int = 2, device=None) -> list[SweepCell]:
    """Fig. 20 reproduction on the procedural corpus (the paper's
    Base-450/750 databases are not redistributable).  ``device`` is each
    detector's device: ``None`` is the card, and raises without one."""
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(n_images):
        nf = int(rng.integers(faces_per_image[0], faces_per_image[1] + 1))
        scenes.append(render_scene(rng, height, width, n_faces=nf))

    cells: list[SweepCell] = []
    for step in steps:
        for sf in scale_factors:
            det = Detector(cascade, EngineConfig(
                mode=mode, step=step, scale_factor=sf,
                min_neighbors=min_neighbors), device=device)
            tp = fp = fn = nf_total = 0
            for img, gt in scenes:
                boxes = det.detect(img)
                t, f, n = match_detections(boxes, gt)
                tp += t
                fp += f
                fn += n
                nf_total += len(gt)
            cells.append(SweepCell(step, sf, nf_total, tp, fp, fn))
    return cells


def error_table(cells: Sequence[SweepCell]):
    """(step, scale) -> error_frac lookup (the DVFS sweep's error_model)."""
    table = {(c.step, round(c.scale_factor, 4)): c.error_frac for c in cells}

    def error_model(step: int, scale_factor: float) -> float:
        key = (step, round(scale_factor, 4))
        if key in table:
            return table[key]
        # nearest measured cell (sweeps may use finer grids)
        ks = min(table, key=lambda k: (abs(k[0] - step),
                                       abs(k[1] - scale_factor)))
        return table[ks]

    return error_model
