"""Synthetic video corpus for the streaming workload, copied from
``repro.stream.synthetic``: the same generator state gives the reference's
frames exactly.

Four scenarios spanning the temporal-locality spectrum the tile-reuse
engine must cover (frames are grayscale float32, like the image corpus in
:mod:`repro_torch.core.training.data`, which renders the scenes):

- ``static_cctv``   — a fixed scene with a small non-face object patrolling
  it: the mostly-static surveillance case where tile-reuse wins big;
- ``intermittent_cctv`` — the same scene, but the object pauses between
  moves (one move every ``move_every`` frames): long fully-idle stretches
  where the stream engine's cached path and the level-subset head build no
  SATs at all — the realistic surveillance duty cycle;
- ``moving_face``   — a face translating over a static background: changed
  tiles track the face, ground-truth boxes move with it;
- ``lighting_drift`` — a static scene under slow global illumination drift:
  every tile changes a little every frame; positive thresholds skip the
  drift (bounded by keyframes), threshold 0 recomputes everything;
- ``camera_pan``    — a crop window panning over a larger scene: the
  adversarial case, all tiles change every frame (streaming must not be
  much slower than per-frame detection).

``make_video`` returns ``[(frame, gt_boxes), ...]`` per frame.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.training.data import (make_background, make_face,
                                               render_scene)

__all__ = ["make_video", "SCENARIOS"]

SCENARIOS = ("static_cctv", "intermittent_cctv", "moving_face",
             "lighting_drift", "camera_pan")


def _empty_boxes() -> np.ndarray:
    return np.zeros((0, 4), np.int32)


def _static_cctv(rng, n_frames, h, w, n_faces):
    img, gt = render_scene(rng, h, w, n_faces=n_faces)
    obj = int(max(6, min(h, w) // 12))
    tone = float(rng.uniform(10, 60))
    x0 = int(rng.integers(0, max(w - obj, 1)))
    y0 = h - obj - 2
    step = max(2, w // max(n_frames, 1) // 2)
    frames = []
    for t in range(n_frames):
        f = img.copy()
        x = (x0 + t * step) % max(w - obj, 1)
        f[y0:y0 + obj, x:x + obj] = tone
        frames.append((f, gt.copy()))
    return frames


def _intermittent_cctv(rng, n_frames, h, w, n_faces, move_every=4):
    """``static_cctv`` with a duty cycle: the object advances only every
    ``move_every``-th frame, so most frames are bit-identical to their
    predecessor (the fully-cached streaming case)."""
    img, gt = render_scene(rng, h, w, n_faces=n_faces)
    obj = int(max(6, min(h, w) // 12))
    tone = float(rng.uniform(10, 60))
    x0 = int(rng.integers(0, max(w - obj, 1)))
    y0 = h - obj - 2
    step = max(2, w // max(n_frames, 1))
    frames = []
    for t in range(n_frames):
        f = img.copy()
        x = (x0 + (t // move_every) * step) % max(w - obj, 1)
        f[y0:y0 + obj, x:x + obj] = tone
        frames.append((f, gt.copy()))
    return frames


def _moving_face(rng, n_frames, h, w, n_faces):
    bg = make_background(rng, h, w)
    fs = int(rng.integers(28, max(min(h, w) // 2, 30)))
    face = make_face(rng, fs)
    y = int(rng.integers(0, h - fs + 1))
    x = 0
    dx = max(1, (w - fs) // max(n_frames - 1, 1))
    frames = []
    for _t in range(n_frames):
        f = bg.copy()
        f[y:y + fs, x:x + fs] = face
        frames.append((f, np.asarray([[x, y, fs, fs]], np.int32)))
        x = min(x + dx, w - fs)
    return frames


def _lighting_drift(rng, n_frames, h, w, n_faces, per_frame=0.6):
    img, gt = render_scene(rng, h, w, n_faces=n_faces)
    frames = []
    for t in range(n_frames):
        f = np.clip(img + per_frame * t, 0, 255).astype(np.float32)
        frames.append((f, gt.copy()))
    return frames


def _camera_pan(rng, n_frames, h, w, n_faces):
    speed = max(2, w // max(n_frames, 1))
    big_w = w + speed * n_frames
    scene, gt = render_scene(rng, h, big_w, n_faces=max(n_faces, 2))
    frames = []
    for t in range(n_frames):
        x0 = t * speed
        f = scene[:, x0:x0 + w].copy()
        vis = []
        for bx, by, bw_, bh in gt:
            nx = bx - x0
            if nx >= 0 and nx + bw_ <= w:
                vis.append((nx, by, bw_, bh))
        frames.append((f, np.asarray(vis, np.int32).reshape(-1, 4)))
    return frames


def make_video(kind: str, n_frames: int = 16, h: int = 128, w: int = 128,
               seed: int = 0, n_faces: int = 1
               ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Render one synthetic video; see module docstring for ``kind``s."""
    rng = np.random.default_rng(seed)
    if kind == "static_cctv":
        return _static_cctv(rng, n_frames, h, w, n_faces)
    if kind == "intermittent_cctv":
        return _intermittent_cctv(rng, n_frames, h, w, n_faces)
    if kind == "moving_face":
        return _moving_face(rng, n_frames, h, w, n_faces)
    if kind == "lighting_drift":
        return _lighting_drift(rng, n_frames, h, w, n_faces)
    if kind == "camera_pan":
        return _camera_pan(rng, n_frames, h, w, n_faces)
    raise ValueError(f"unknown video kind {kind!r}; one of {SCENARIOS}")
