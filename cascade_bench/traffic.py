"""The one traffic generator: a closed loop of flushes over a scene pool.

A traffic mix is a JSON file of parameters::

    {"groups": [{"h": 480, "w": 640, "per_flush": 16, "pool": 32,
                 "face_sizes": [24, 72]}, ...],
     "faces_per_scene": 3}

Each group renders ``pool`` scenes of ``h`` x ``w`` once, at set-up, from
the run's seed (:func:`cascade_bench.frozen.scenes.render_scene`, the
faces' sizes drawn from ``face_sizes``).  Every flush takes ``per_flush``
scenes of every group, walking each group's pool in a seeded permutation
that is drawn anew each time the pool is used up, so every scene is
detected equally often; a flush's scenes are then put in a seeded order.
Every flush therefore holds the same shapes and counts, and every seed the
same mix, in another order.  The next flush is sent when the previous one
has returned its rects (a closed loop: one client that waits for each
reply).
"""

from __future__ import annotations

import numpy as np

from cascade_bench.frozen.scenes import render_scene

SCHEDULE = 4096   # flushes planned at set-up; the loop cycles through them


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


def pool(traffic: dict, seed: int) -> list:
    """The scenes: ``[(group, index, image), ...]``, group by group."""
    out = []
    for g, grp in enumerate(traffic["groups"]):
        rng = _rng(seed, 1, g)
        for i in range(grp["pool"]):
            img, _boxes = render_scene(rng, grp["h"], grp["w"],
                                       n_faces=traffic["faces_per_scene"],
                                       face_sizes=tuple(grp["face_sizes"]))
            out.append((g, i, img))
    return out


def schedule(traffic: dict, seed: int, n: int = SCHEDULE) -> list:
    """``n`` flushes, each a list of indices into :func:`pool`'s list."""
    rng = _rng(seed, 2)
    starts = np.cumsum([0] + [grp["pool"] for grp in traffic["groups"]])
    streams = []
    for g, grp in enumerate(traffic["groups"]):
        need = n * grp["per_flush"]
        perms = [rng.permutation(grp["pool"])
                 for _ in range(-(-need // grp["pool"]))]
        streams.append(np.concatenate(perms)[:need] + starts[g])
    flushes = []
    for k in range(n):
        ids = np.concatenate([s[k * grp["per_flush"]:(k + 1) * grp["per_flush"]]
                              for s, grp in zip(streams, traffic["groups"])])
        flushes.append(rng.permutation(ids).tolist())
    return flushes
