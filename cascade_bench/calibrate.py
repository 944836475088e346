#!/usr/bin/env python3
"""Vote polarities and stage thresholds of a random stump cascade, set from
OpenCV traincascade's default per-stage rates.

    python3 cascade_bench/calibrate.py cascade_bench/configs/<config>.json

writes the configuration's ``.npz`` (its ``cascade.npz``) beside it and
prints its SHA-256, which the configuration records.  The stumps' geometry,
rectangle weights, feature thresholds and the pair of vote values of each
stump are the frozen generator's (``frozen/stumps.py``); two things are set
from a seeded calibration pool, as a trainer sets them:

- each stump's polarity (Viola and Jones, CVPR 2001, section 3: the weak
  classifier ``h = 1 if p f < p theta``): the stump's two vote values are
  swapped where that gives the faces the higher vote with fewer errors,
  positives and negatives weighted alike;
- each stage's threshold, with ``opencv_traincascade``'s defaults
  ``-minHitRate 0.995`` and ``-maxFalseAlarmRate 0.5``: the stage sum that
  keeps 99.5 % of the positives, raised to the negatives' median where it
  would pass more than half of them (a trainer adds stumps until a stage
  rejects half; these stages keep the published stump counts, so the
  threshold is raised instead).

Positives are faces of the frozen renderer (``make_face``) at the traffic's
sizes, sampled down to the 24x24 window as a pyramid level samples them.
Negatives are windows drawn uniformly over every pyramid level of
background images of the frozen renderer (``make_background``, no faces).
Each stage is calibrated on the positives and negatives that passed the
stages before it, as traincascade calibrates on its bootstrapped
negatives; a fixed pool runs out after some stages (traincascade draws
new negatives, which for the last stages would take some 10^9 windows),
and where fewer than ``min_negatives`` survive, the hit rate alone sets
the threshold.  The arithmetic is float64 numpy; the
thresholds are stored as float32, the type the cascade is served in.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cascade_bench.frozen.scenes import make_background, make_face  # noqa: E402
from cascade_bench.frozen.stumps import FIELDS, WINDOW, stump_cascade  # noqa: E402

MIN_HIT_RATE = 0.995
MAX_FALSE_ALARM_RATE = 0.5


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def positives(cal: dict) -> np.ndarray:
    """(n, 24, 24) faces sampled down to the window."""
    rng = _rng(cal["seed"], 1)
    lo, hi = cal["face_sizes"]
    out = np.empty((cal["positives"], WINDOW, WINDOW), np.float64)
    for i in range(cal["positives"]):
        fs = int(rng.integers(lo, hi + 1))
        face = make_face(rng, fs)
        idx = (np.arange(WINDOW) * fs) // WINDOW
        out[i] = face[idx][:, idx]
    return out


def negatives(cal: dict) -> np.ndarray:
    """(n, 24, 24) float32 windows drawn uniformly over every pyramid level
    (nearest-neighbour, ``scale_factor``) of face-free backgrounds, the
    same number from each image."""
    rng = _rng(cal["seed"], 2)
    h, w = cal["h"], cal["w"]
    lv, s = [], 1.0
    while int(h / s) >= WINDOW and int(w / s) >= WINDOW:
        lv.append((int(h / s), int(w / s)))
        s *= cal["scale_factor"]
    per_level = np.asarray([(lh - WINDOW + 1) * (lw - WINDOW + 1)
                            for lh, lw in lv], np.int64)
    starts = np.concatenate([[0], np.cumsum(per_level)])
    each = cal["negatives"] // cal["images"]
    out = np.empty((each * cal["images"], WINDOW, WINDOW), np.float32)
    span = np.arange(WINDOW)
    for i in range(cal["images"]):
        img = make_background(rng, h, w)
        pick = rng.choice(int(starts[-1]), each, replace=False)
        li = np.searchsorted(starts, pick, side="right") - 1
        for lvl, (lh, lw) in enumerate(lv):
            sel = np.nonzero(li == lvl)[0]
            y, x = np.divmod(pick[sel] - starts[lvl], lw - WINDOW + 1)
            iy = ((y[:, None] + span) * h) // lh
            ix = ((x[:, None] + span) * w) // lw
            out[i * each + sel] = img[iy[:, :, None], ix[:, None, :]]
    return out


def _pixel_weights(arrays: dict, stumps) -> np.ndarray:
    """(576, len(stumps)): each stump's feature as a weight per pixel."""
    out = np.zeros((WINDOW * WINDOW, len(stumps)), np.float64)
    for c, k in enumerate(stumps):
        m = np.zeros((WINDOW, WINDOW), np.float64)
        for (x, y, w, h), wt in zip(arrays["rect_xywh"][k],
                                    arrays["rect_w"][k]):
            if wt != 0:
                m[y:y + h, x:x + w] += float(wt)
        out[:, c] = m.reshape(-1)
    return out


def features(windows: np.ndarray, arrays: dict, stumps,
             block: int = 8192) -> np.ndarray:
    """(n, len(stumps)) features as the cascade normalises them: the
    weighted rectangle sums times 1/sigma over the window's area."""
    weights = _pixel_weights(arrays, stumps)
    out = np.empty((len(windows), len(stumps)), np.float64)
    for i in range(0, len(windows), block):
        flat = windows[i:i + block].reshape(-1, WINDOW * WINDOW)
        flat = flat.astype(np.float64)
        mean = flat.mean(1)
        var = np.maximum((flat * flat).mean(1) - mean * mean, 1.0)
        inv = 1.0 / np.sqrt(var)
        out[i:i + block] = (flat @ weights) * (inv / (WINDOW * WINDOW))[:, None]
    return out


def calibrate(arrays: dict, cal: dict, stages: int | None = None) -> dict:
    """The arrays with polarities and thresholds set, stage by stage, each
    stage on the positives and negatives that passed the stages before it;
    ``stages`` stops after that many (the rest keep the generator's
    values)."""
    out = {f: np.array(arrays[f], copy=True) for f in FIELDS}
    off = np.asarray(arrays["stage_offsets"], np.int64)
    n_stages = len(off) - 1 if stages is None else stages
    pos, neg = positives(cal), negatives(cal)
    for s in range(n_stages):
        ks = np.arange(off[s], off[s + 1])
        theta = out["wc_threshold"][ks].astype(np.float64)
        fp = features(pos, out, ks) < theta          # True: the left vote
        fn = features(neg, out, ks) < theta
        # errors of "face on the right" and "face on the left", positives
        # and negatives weighted alike
        neg_left = fn.mean(0) if len(fn) else np.full(len(ks), 0.5)
        right_err = fp.mean(0) + 1.0 - neg_left
        left_err = 1.0 - fp.mean(0) + neg_left
        lo, hi = out["left_val"][ks], out["right_val"][ks]
        low, high = np.minimum(lo, hi), np.maximum(lo, hi)
        face_left = left_err < right_err
        out["left_val"][ks] = np.where(face_left, high, low)
        out["right_val"][ks] = np.where(face_left, low, high)
        lv = out["left_val"][ks].astype(np.float64)
        rv = out["right_val"][ks].astype(np.float64)
        sp = np.where(fp, lv, rv).sum(1)
        sn = np.where(fn, lv, rv).sum(1)
        thr = np.quantile(sp, 1.0 - MIN_HIT_RATE, method="lower")
        if len(sn) >= cal["min_negatives"]:
            thr = max(thr, np.quantile(sn, 1.0 - MAX_FALSE_ALARM_RATE,
                                       method="higher"))
        out["stage_threshold"][s] = np.float32(thr)
        pos = pos[sp >= out["stage_threshold"][s]]
        neg = neg[sn >= out["stage_threshold"][s]]
    return out


def npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f: arrays[f] for f in FIELDS})
    return buf.getvalue()


def from_config(config: dict, stages=None) -> dict:
    spec = config["cascade"]
    arrays = stump_cascade(spec["seed"], spec["stage_sizes"])
    return calibrate(arrays, spec["calibration"], stages)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print(__doc__.splitlines()[2].strip(), file=sys.stderr)
        return 2
    path = Path(args[0])
    config = json.loads(path.read_text())
    data = npz_bytes(from_config(config))
    (path.parent / config["cascade"]["npz"]).write_bytes(data)
    print(hashlib.sha256(data).hexdigest())
    return 0


if __name__ == "__main__":
    sys.exit(main())
