"""Frozen copy of the port's random stump-cascade generator.

Origin: ``repro_torch.core.cascade.paper_shaped_cascade`` (itself the
numpy draws of ``repro.core.cascade.paper_shaped_cascade``), copied so that
a later change to the port cannot move the benchmark's weights.  The same
seed and stage sizes give the same arrays, draw for draw; the arrays are
returned as numpy in the cascade's field layout, so the port receives them
through its public constructor and the reference reads them directly.
"""

from __future__ import annotations

import numpy as np

WINDOW = 24
MAX_RECTS = 3
FIELDS = ("rect_xywh", "rect_w", "wc_threshold", "left_val", "right_val",
          "stage_offsets", "stage_threshold")


def stump_cascade(seed: int, stage_sizes) -> dict:
    """Random stumps of 2 or 3 rectangles inside the 24x24 window, with
    the generator's own per-stage thresholds (midway between the stage's
    summed vote values, plus a margin); ``calibrate.py`` sets a
    configuration's polarities and thresholds from it."""
    sizes = list(stage_sizes)
    rng = np.random.default_rng(seed)
    n = int(np.sum(sizes))
    x = rng.integers(0, WINDOW - 6, size=n)
    y = rng.integers(0, WINDOW - 6, size=n)
    w = rng.integers(2, np.maximum(3, (WINDOW - x) // 2), size=n)
    h = rng.integers(2, np.maximum(3, WINDOW - y), size=n)
    three = rng.random(n) < 0.25
    horiz = rng.random(n) < 0.5

    rect_xywh = np.zeros((n, MAX_RECTS, 4), np.int32)
    rect_w = np.zeros((n, MAX_RECTS), np.float32)
    for i in range(n):
        k = 3 if three[i] else 2
        if horiz[i]:
            ww = max(min(w[i], (WINDOW - x[i]) // k), 1)
            for r in range(k):
                rect_xywh[i, r] = (x[i] + r * ww, y[i], ww, h[i])
        else:
            hh = max(min(h[i], (WINDOW - y[i]) // k), 1)
            for r in range(k):
                rect_xywh[i, r] = (x[i], y[i] + r * hh, w[i], hh)
        if k == 2:
            rect_w[i, :2] = (1.0, -1.0)
        else:
            rect_w[i, :3] = (1.0, -2.0, 1.0)

    wc_threshold = rng.normal(0.0, 0.02, n).astype(np.float32)
    left_val = rng.uniform(-1.0, 0.2, n).astype(np.float32)
    right_val = rng.uniform(-0.2, 1.0, n).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    stage_threshold = np.zeros(len(sizes), np.float32)
    for s, sz in enumerate(sizes):
        mid = (left_val[offsets[s]:offsets[s + 1]].sum()
               + right_val[offsets[s]:offsets[s + 1]].sum()) / 2.0
        stage_threshold[s] = mid + 0.1 * np.sqrt(sz)
    return dict(zip(FIELDS, (rect_xywh, rect_w, wc_threshold, left_val,
                             right_val, offsets, stage_threshold)))
