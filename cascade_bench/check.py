"""The comparison that decides ``correct``.

Every answer of the window (one image's rects from one flush) is held
against the plain reference's rects for that image: the number compared
is the count of rects in the multiset symmetric difference, summed over
all answers (``rect_mismatch``), with the answers that never came
(``answers_missing``).  Both sides compute in the order the configuration
states (see the reference's docstring), so a sound run reads 0 and the
limits are 0: an exact comparison.
"""

from __future__ import annotations

import numpy as np

LIMITS = {"rect_mismatch": 0, "answers_missing": 0}


def _keys(rects: np.ndarray) -> np.ndarray:
    r = np.asarray(rects, np.int64).reshape(-1, 4)
    return ((r[:, 0] << 48) | (r[:, 1] << 32) | (r[:, 2] << 16)) | r[:, 3]


def mismatch(got, want) -> int:
    """Rects in one multiset and not the other (a malformed answer counts
    as every rect of the reference and one more)."""
    try:
        g = np.asarray(got)
        if g.ndim != 2 or g.shape[1] != 4 or (g.size and g.min() < 0):
            raise ValueError("not an (N, 4) array of rects")
        ga = _keys(g)
    except (TypeError, ValueError):
        return len(want) + 1
    gu, gc = np.unique(ga, return_counts=True)
    wu, wc = np.unique(_keys(want), return_counts=True)
    allk = np.union1d(gu, wu)
    gcount = np.zeros(len(allk), np.int64)
    wcount = np.zeros(len(allk), np.int64)
    gcount[np.searchsorted(allk, gu)] = gc
    wcount[np.searchsorted(allk, wu)] = wc
    return int(np.abs(gcount - wcount).sum())


def compare(answers: list, expected: list) -> dict:
    """``answers``: ``[(pool_ids, rects_per_image or None), ...]`` per
    flush (``None`` for a flush that returned nothing); ``expected``: the
    reference's rects per pool index.  Identical answers for one pool
    index are compared once."""
    seen: dict = {}
    bad = missing = 0
    for ids, out in answers:
        if out is None or len(out) != len(ids):
            missing += len(ids)
            continue
        for i, got in zip(ids, out):
            first = seen.get(i)
            if first is not None and isinstance(got, np.ndarray) and \
                    got.shape == first[0].shape and np.array_equal(got,
                                                                   first[0]):
                bad += first[1]
                continue
            n = mismatch(got, expected[i])
            if first is None and isinstance(got, np.ndarray):
                seen[i] = (got, n)
            bad += n
    return {"rect_mismatch": bad, "answers_missing": missing}


def report(values: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for the result line."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(values: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in values.items())
