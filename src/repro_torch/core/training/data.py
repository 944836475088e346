"""Procedural face / non-face corpus, copied from
``repro.core.training.data``.

A parametric face (an elliptical head with darker eye and mouth bands and
a nose ridge) over textured backgrounds: scenes for detection
(``render_scene``) and 24x24 training windows for AdaBoost
(``window_dataset``: faces, background crops and near-face decoys).  The
same ``numpy.random.Generator`` state gives the reference's pixels
exactly and leaves the generator in the same state.  Everything is numpy
on the host: data generation is not a device workload.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..cascade import WINDOW

__all__ = ["make_face", "make_background", "make_decoy", "render_scene",
           "FaceCorpus", "sample_negative", "window_dataset"]


def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float
                  ) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def make_face(rng: np.random.Generator, size: int = WINDOW,
              brightness: float | None = None) -> np.ndarray:
    """One synthetic face patch (size x size), float32 in [0, 255].

    Geometry is jittered (head centre/aspect, eye spacing, mouth position)
    and illumination varies (brightness, contrast, lighting gradient,
    noise, occasional partial occlusion) so no single Haar feature is
    separating — AdaBoost must combine many, as on real data.
    """
    s = size / 24.0
    if brightness is None:
        brightness = rng.uniform(100, 210)
    cx = (12 + rng.uniform(-1.8, 1.8)) * s
    cy = (12.5 + rng.uniform(-1.8, 1.8)) * s
    skin = brightness + rng.normal(0, 7, (size, size))
    img = np.full((size, size), brightness * rng.uniform(0.3, 0.9))
    img += rng.normal(0, 9, (size, size))

    head = _ellipse_mask(size, size, cy, cx,
                         rng.uniform(9.5, 11.8) * s, rng.uniform(7, 9.8) * s)
    img[head] = skin[head]

    eye_y = cy - rng.uniform(2.6, 4.4) * s
    eye_dx = rng.uniform(3.2, 5.0) * s
    eye_r = rng.uniform(1.1, 2.0) * s
    dark = brightness * rng.uniform(0.25, 0.55)
    for side in (-1, 1):
        eye = _ellipse_mask(size, size, eye_y + rng.uniform(-0.5, 0.5) * s,
                            cx + side * eye_dx, eye_r * 0.75, eye_r)
        img[eye] = dark + rng.normal(0, 5, img[eye].shape)
    # eyebrow band
    if rng.random() < 0.8:
        brow = _ellipse_mask(size, size, eye_y - rng.uniform(1.6, 2.8) * s,
                             cx, 0.9 * s, rng.uniform(5, 7) * s)
        img[brow] = np.minimum(img[brow], brightness * rng.uniform(0.4, 0.75))
    # nose ridge (bright) + shadow
    nose = _ellipse_mask(size, size, cy + rng.uniform(0, 1.5) * s, cx,
                         rng.uniform(2.4, 3.8) * s, rng.uniform(0.8, 1.4) * s)
    img[nose] = np.maximum(img[nose], brightness * rng.uniform(0.98, 1.18))
    # mouth
    mouth = _ellipse_mask(size, size, cy + rng.uniform(4.8, 6.8) * s, cx,
                          rng.uniform(0.7, 1.5) * s, rng.uniform(2.6, 4.8) * s)
    img[mouth] = brightness * rng.uniform(0.28, 0.6)
    # lighting gradient + contrast jitter
    yy, xx = np.mgrid[0:size, 0:size]
    gy, gx = rng.normal(0, 18, 2)
    img = img + gy * (yy / size - 0.5) + gx * (xx / size - 0.5)
    img = (img - img.mean()) * rng.uniform(0.7, 1.25) + img.mean()
    # occasional partial occlusion (hair/hand): a flat band over one corner
    if rng.random() < 0.25:
        ob = int(rng.integers(2, max(3, int(5 * s))))
        tone = brightness * rng.uniform(0.2, 0.9)
        if rng.random() < 0.5:
            img[:ob] = tone
        else:
            img[:, :ob] = tone
    img += rng.normal(0, 4, (size, size))
    return np.clip(img, 0, 255).astype(np.float32)


def make_decoy(rng: np.random.Generator, size: int = WINDOW) -> np.ndarray:
    """A *near*-face distractor: face-like statistics with wrong geometry
    (single eye / eyes below mouth / vertical eye pair).  Keeps stage-1+
    training honest, mirroring hard negatives in real corpora."""
    s = size / 24.0
    brightness = rng.uniform(100, 210)
    img = make_background(rng, size, size, tone=brightness * rng.uniform(0.4, 0.8))
    head = _ellipse_mask(size, size, 12.5 * s, 12 * s,
                         rng.uniform(9.5, 11.8) * s, rng.uniform(7, 9.8) * s)
    img[head] = brightness + rng.normal(0, 7, (size, size))[head]
    dark = brightness * rng.uniform(0.25, 0.55)
    kind = rng.integers(0, 3)
    if kind == 0:      # single central eye
        e = _ellipse_mask(size, size, 9 * s, 12 * s, 1.6 * s, 1.6 * s)
        img[e] = dark
    elif kind == 1:    # eyes below "mouth" (inverted)
        for side in (-1, 1):
            e = _ellipse_mask(size, size, 16 * s, (12 + side * 4.2) * s,
                              1.3 * s, 1.6 * s)
            img[e] = dark
        m = _ellipse_mask(size, size, 7 * s, 12 * s, 1.1 * s, 3.8 * s)
        img[m] = dark
    else:              # vertically-stacked eye pair
        for dy in (-1, 1):
            e = _ellipse_mask(size, size, (12 + dy * 3.4) * s, 9 * s,
                              1.4 * s, 1.6 * s)
            img[e] = dark
    img += rng.normal(0, 4, (size, size))
    return np.clip(img, 0, 255).astype(np.float32)


def make_background(rng: np.random.Generator, h: int, w: int,
                    tone: float | None = None) -> np.ndarray:
    """Textured non-face background: mixture of gradients, blobs, stripes."""
    if tone is None:
        tone = rng.uniform(40, 215)
    img = np.full((h, w), tone, np.float32)
    # low-frequency gradient
    gy, gx = rng.normal(0, 30, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    img += gy * (yy / max(h, 1) - 0.5) + gx * (xx / max(w, 1) - 0.5)
    # random rectangles / blobs / stripes
    for _ in range(rng.integers(4, 14)):
        kind = rng.integers(0, 3)
        amp = rng.uniform(-60, 60)
        if kind == 0:
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            hh = int(rng.integers(2, max(h // 2, 3)))
            ww = int(rng.integers(2, max(w // 2, 3)))
            img[y0:y0 + hh, x0:x0 + ww] += amp
        elif kind == 1:
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(2, h / 3 + 3), rng.uniform(2, w / 3 + 3)
            img[_ellipse_mask(h, w, cy, cx, ry, rx)] += amp
        else:
            period = rng.integers(3, 17)
            phase = rng.integers(0, period)
            if rng.random() < 0.5:
                img[:, (xx[0] + phase) % period < period // 2] += amp
            else:
                img[(yy[:, 0] + phase) % period < period // 2] += amp
    img += rng.normal(0, 5, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def render_scene(rng: np.random.Generator, h: int = 240, w: int = 320,
                 n_faces: int = 1, face_sizes=(24, 72),
                 tone: float | None = None):
    """A scene with ``n_faces`` planted faces.  Returns (img, boxes[x,y,w,h])."""
    img = make_background(rng, h, w, tone)
    boxes = []
    tries = 0
    while len(boxes) < n_faces and tries < 200:
        tries += 1
        fs = int(rng.integers(face_sizes[0], face_sizes[1] + 1))
        if fs > min(h, w):
            continue
        y0 = int(rng.integers(0, h - fs + 1))
        x0 = int(rng.integers(0, w - fs + 1))
        # avoid overlap with existing faces
        ok = all(not (x0 < b[0] + b[2] and b[0] < x0 + fs and
                      y0 < b[1] + b[3] and b[1] < y0 + fs) for b in boxes)
        if not ok:
            continue
        img[y0:y0 + fs, x0:x0 + fs] = make_face(rng, fs)
        boxes.append((x0, y0, fs, fs))
    return img, np.asarray(boxes, np.int32).reshape(-1, 4)


class FaceCorpus(NamedTuple):
    """24x24 training windows + labels."""
    windows: np.ndarray   # (N, 24, 24) float32
    labels: np.ndarray    # (N,) int32 — 1 face / 0 non-face


def sample_negative(rng: np.random.Generator, decoy_frac: float = 0.35
                    ) -> np.ndarray:
    """One negative window: textured background crop or near-face decoy."""
    if rng.random() < decoy_frac:
        return make_decoy(rng)
    bg = make_background(rng, WINDOW * 2, WINDOW * 2)
    y0 = rng.integers(0, bg.shape[0] - WINDOW + 1)
    x0 = rng.integers(0, bg.shape[1] - WINDOW + 1)
    return bg[y0:y0 + WINDOW, x0:x0 + WINDOW].copy()


def window_dataset(rng: np.random.Generator, n_pos: int, n_neg: int,
                   decoy_frac: float = 0.35) -> FaceCorpus:
    """``n_pos`` faces then ``n_neg`` negatives, labelled 1 / 0."""
    pos = np.stack([make_face(rng) for _ in range(n_pos)])
    neg = np.stack([sample_negative(rng, decoy_frac) for _ in range(n_neg)])
    windows = np.concatenate([pos, neg]).astype(np.float32)
    labels = np.concatenate([np.ones(n_pos, np.int32),
                             np.zeros(n_neg, np.int32)])
    return FaceCorpus(windows, labels)
