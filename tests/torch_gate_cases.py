"""Inputs for the tail's gates and counts (kernel E, ``ops.tail_gate_counts``)
as the batched tail hands them over: a segment's (k, cap) stage sums, 0 past
the live count; a live prefix of valid lanes and invalid lanes past it; each
lane's image index, 0 past the live count.  Imports only numpy and torch, so
the card's tests use it where jax is not installed (importable as ``from
torch_gate_cases import ...``, as ``helpers``)."""

import numpy as np
import torch

GATE_STAGES = (1, 3)
GATE_IMAGES = (1, 3, 16, 65)          # 65: more images than a block's bins
GATE_LIVE = ("0", "1", "mid", "cap-1", "cap", "over")
GATE_ORDERS = ("sorted", "shuffled", "dead")
N_STAGES = 6
S0 = 2


def live_count(live: str, cap: int) -> int:
    return {"0": 0, "1": 1, "mid": cap // 2, "cap-1": cap - 1, "cap": cap,
            "over": cap + 37}[live]


def gate_case(k: int, n_img: int, live: str, order: str, cap: int = 1000,
              seed: int = 0, device="cpu") -> dict:
    """One segment's inputs: ``order`` "sorted" gives non-decreasing image
    indices along the live prefix (the compactions' order), "shuffled" a
    permutation of them, "dead" sorted with about 30 % of the live lanes
    invalid and at image 0.  Some sums equal their threshold exactly.
    ``counts`` (N_STAGES, n_img) already holds counts; the segment's rows
    are ``S0 .. S0 + k``."""
    n = live_count(live, cap)
    rng = np.random.default_rng([seed, k, n_img, cap, n, len(order)])
    m = min(n, cap)
    b = np.sort(rng.integers(0, n_img, m))
    valid = np.zeros(cap, bool)
    valid[:m] = True
    if order == "shuffled":
        rng.shuffle(b)
    elif order == "dead":
        dead = rng.random(m) < 0.3
        valid[:m][dead] = False
        b[dead] = 0
    b_sel = np.zeros(cap, np.int64)
    b_sel[:m] = b
    thr = rng.normal(0.0, 1.0, N_STAGES).astype(np.float32)
    ss = rng.normal(0.5, 1.0, (k, cap)).astype(np.float32)
    ties = rng.random((k, cap)) < 0.05
    ss[ties] = np.broadcast_to(thr[S0:S0 + k, None], (k, cap))[ties]
    ss[:, m:] = 0.0
    counts = rng.integers(0, 100, (N_STAGES, n_img)).astype(np.int32)

    def t(a):
        return torch.from_numpy(a).to(device)

    return dict(ss=t(ss), thr=t(thr), valid=t(valid), b_sel=t(b_sel),
                n_live=torch.tensor(n, dtype=torch.int64, device=device),
                counts=t(counts))


def inline_formula(case: dict, k: int):
    """The batched tail's gates and counts before kernel E, written out:
    per stage, gate the mask, then ``index_add_`` it into a zeroed per-image
    count over every lane.  Returns ``(valid, counts)``, inputs untouched."""
    valid, counts = case["valid"], case["counts"].clone()
    batch = counts.shape[1]
    for j, s in enumerate(range(S0, S0 + k)):
        valid = valid & (case["ss"][j] >= case["thr"][s])
        per_img = torch.zeros(batch, dtype=torch.int32, device=valid.device)
        per_img.index_add_(0, case["b_sel"], valid.to(torch.int32))
        counts[s] += per_img
    return valid, counts


def run_gates(fn, case: dict, k: int):
    """``fn`` (a ``tail_gate_counts`` or its twin) on copies of the case's
    mask and counts, on the segment's rows; returns ``(returned mask,
    valid, counts)``."""
    valid, counts = case["valid"].clone(), case["counts"].clone()
    out = fn(case["ss"], case["thr"][S0:S0 + k], valid, case["b_sel"],
             case["n_live"], counts[S0:S0 + k])
    return out, valid, counts
