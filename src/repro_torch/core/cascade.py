"""Cascade-classifier parameters as a small dataclass of tensors.

The fields and their meaning are those of ``repro.core.cascade.Cascade``:

- ``rect_xywh[k, r]`` = (x, y, w, h) of rectangle ``r`` of weak classifier
  ``k`` relative to the 24x24 window (int32; up to 3 rects);
- ``rect_w[k, r]`` = rectangle weight (float32; 0 for unused rects);
- ``wc_threshold[k]``, ``left_val[k]``, ``right_val[k]`` = stump threshold
  (normalized feature units) and the votes for feature < / >= threshold;
- ``stage_offsets[s]`` = first weak classifier of stage ``s`` (length
  n_stages + 1);
- ``stage_threshold[s]`` = strong-classifier threshold of stage ``s``.

``bounds`` keeps ``stage_offsets`` on the host as a tuple, so kernels and
executors slice stage runs without reading the device.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["WINDOW", "MAX_RECTS", "FIELDS", "Cascade", "make_cascade",
           "from_numpy", "save_cascade", "load_cascade",
           "paper_shaped_cascade", "PAPER_STAGE_SIZES"]

WINDOW = 24  # minimum detection window (paper: 24x24 px)
MAX_RECTS = 3

FIELDS = ("rect_xywh", "rect_w", "wc_threshold", "left_val", "right_val",
          "stage_offsets", "stage_threshold")
_DTYPES = {"rect_xywh": torch.int32, "stage_offsets": torch.int32}


@dataclass(frozen=True)
class Cascade:
    rect_xywh: torch.Tensor        # (n_wc, 3, 4) int32
    rect_w: torch.Tensor           # (n_wc, 3) float32
    wc_threshold: torch.Tensor     # (n_wc,) float32
    left_val: torch.Tensor         # (n_wc,) float32
    right_val: torch.Tensor        # (n_wc,) float32
    stage_offsets: torch.Tensor    # (n_stages + 1,) int32
    stage_threshold: torch.Tensor  # (n_stages,) float32
    bounds: tuple                  # stage_offsets on the host

    @property
    def n_weak(self) -> int:
        return int(self.rect_xywh.shape[0])

    @property
    def n_stages(self) -> int:
        return int(self.stage_threshold.shape[0])

    def stage_sizes(self) -> np.ndarray:
        off = np.asarray(self.bounds)
        return off[1:] - off[:-1]

    def to(self, device) -> "Cascade":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in FIELDS})

    def numpy(self) -> dict:
        """The fields as numpy arrays (the reference's layout)."""
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}

    def validate(self) -> None:
        rx = self.rect_xywh.cpu().numpy()
        if rx.size and (rx.min() < 0
                        or (rx[..., 0] + rx[..., 2]).max() > WINDOW
                        or (rx[..., 1] + rx[..., 3]).max() > WINDOW):
            raise ValueError("cascade rectangles must lie inside the "
                             f"{WINDOW}x{WINDOW} window")
        off = np.asarray(self.bounds)
        if off[0] != 0 or off[-1] != self.n_weak or (off[1:] < off[:-1]).any():
            raise ValueError(f"malformed stage_offsets {off.tolist()}")


def make_cascade(rect_xywh, rect_w, wc_threshold, left_val, right_val,
                 stage_offsets, stage_threshold, device="cpu") -> Cascade:
    arrays = dict(zip(FIELDS, (rect_xywh, rect_w, wc_threshold, left_val,
                               right_val, stage_offsets, stage_threshold)))
    return from_numpy(arrays, device)


def from_numpy(arrays: dict, device="cpu") -> Cascade:
    """The reference's ``Cascade`` fields, as numpy arrays, on ``device``."""
    tensors = {f: torch.as_tensor(np.array(arrays[f]),
                                  dtype=_DTYPES.get(f, torch.float32)
                                  ).to(device)
               for f in FIELDS}
    bounds = tuple(int(v) for v in np.asarray(arrays["stage_offsets"]))
    c = Cascade(bounds=bounds, **tensors)
    c.validate()
    return c


def save_cascade(path: str, cascade: Cascade, meta: dict | None = None
                 ) -> None:
    """Write ``cascade`` in the reference's npz layout: the seven fields
    as numpy arrays and ``__meta__``, ``meta`` as JSON, which
    ``repro.core.cascade.load_cascade`` and :func:`load_cascade` read."""
    np.savez(path, __meta__=json.dumps(meta or {}), **cascade.numpy())


def load_cascade(path: str, device="cpu") -> tuple[Cascade, dict]:
    """Read a cascade saved by ``repro.core.cascade.save_cascade`` (npz with
    a JSON header); returns ``(cascade, meta)``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {f: z[f] for f in FIELDS}
    return from_numpy(arrays, device), meta


# Per-stage weak-classifier counts for the classic 25-stage frontal-face
# cascade (OpenCV haarcascade_frontalface_default profile, total 2913).
PAPER_STAGE_SIZES = [
    9, 16, 27, 32, 52, 53, 62, 72, 83, 91, 99, 115, 127, 135, 136,
    137, 159, 155, 169, 196, 197, 181, 199, 211, 200,
]


def paper_shaped_cascade(seed: int = 0, stage_sizes: list[int] | None = None,
                         device="cpu") -> Cascade:
    """Random cascade with the paper's 25-stage/2913-WC shape; the same
    seed gives the reference's arrays exactly (same numpy draws)."""
    sizes = stage_sizes if stage_sizes is not None else PAPER_STAGE_SIZES
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
    # stage thresholds giving random windows roughly the published
    # per-stage rejection profile (see the reference module)
    stage_threshold = np.zeros(len(sizes), np.float32)
    for s, sz in enumerate(sizes):
        mid = (left_val[offsets[s]:offsets[s + 1]].sum()
               + right_val[offsets[s]:offsets[s + 1]].sum()) / 2.0
        stage_threshold[s] = mid + 0.1 * np.sqrt(sz)
    return make_cascade(rect_xywh, rect_w, wc_threshold, left_val, right_val,
                        offsets, stage_threshold, device=device)
