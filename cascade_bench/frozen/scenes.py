"""Frozen copy of the port's scene renderer.

Origin: ``repro_torch.core.training.data.render_scene`` and the helpers it
calls (``make_background``, ``make_face``, ``_ellipse_mask``), which copy
``repro.core.training.data``.  Copied so that a later change to the port
cannot move the benchmark's images: the same ``numpy.random.Generator``
state gives the same pixels.  Images are float32 in [0, 255] with
fractional values, as a camera pipeline's normalised frames are.
"""

from __future__ import annotations

import numpy as np

WINDOW = 24


def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float
                  ) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def make_face(rng: np.random.Generator, size: int = WINDOW,
              brightness: float | None = None) -> np.ndarray:
    """One synthetic face patch (size x size), float32 in [0, 255]."""
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
    if rng.random() < 0.8:
        brow = _ellipse_mask(size, size, eye_y - rng.uniform(1.6, 2.8) * s,
                             cx, 0.9 * s, rng.uniform(5, 7) * s)
        img[brow] = np.minimum(img[brow], brightness * rng.uniform(0.4, 0.75))
    nose = _ellipse_mask(size, size, cy + rng.uniform(0, 1.5) * s, cx,
                         rng.uniform(2.4, 3.8) * s, rng.uniform(0.8, 1.4) * s)
    img[nose] = np.maximum(img[nose], brightness * rng.uniform(0.98, 1.18))
    mouth = _ellipse_mask(size, size, cy + rng.uniform(4.8, 6.8) * s, cx,
                          rng.uniform(0.7, 1.5) * s, rng.uniform(2.6, 4.8) * s)
    img[mouth] = brightness * rng.uniform(0.28, 0.6)
    yy, xx = np.mgrid[0:size, 0:size]
    gy, gx = rng.normal(0, 18, 2)
    img = img + gy * (yy / size - 0.5) + gx * (xx / size - 0.5)
    img = (img - img.mean()) * rng.uniform(0.7, 1.25) + img.mean()
    if rng.random() < 0.25:
        ob = int(rng.integers(2, max(3, int(5 * s))))
        tone = brightness * rng.uniform(0.2, 0.9)
        if rng.random() < 0.5:
            img[:ob] = tone
        else:
            img[:, :ob] = tone
    img += rng.normal(0, 4, (size, size))
    return np.clip(img, 0, 255).astype(np.float32)


def make_background(rng: np.random.Generator, h: int, w: int,
                    tone: float | None = None) -> np.ndarray:
    """Textured non-face background: gradients, blobs, stripes."""
    if tone is None:
        tone = rng.uniform(40, 215)
    img = np.full((h, w), tone, np.float32)
    gy, gx = rng.normal(0, 30, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    img += gy * (yy / max(h, 1) - 0.5) + gx * (xx / max(w, 1) - 0.5)
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
        ok = all(not (x0 < b[0] + b[2] and b[0] < x0 + fs and
                      y0 < b[1] + b[3] and b[1] < y0 + fs) for b in boxes)
        if not ok:
            continue
        img[y0:y0 + fs, x0:x0 + fs] = make_face(rng, fs)
        boxes.append((x0, y0, fs, fs))
    return img, np.asarray(boxes, np.int32).reshape(-1, 4)
