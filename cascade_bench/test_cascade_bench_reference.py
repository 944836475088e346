"""The plain reference against a dense brute-force evaluation (every window,
every stage, numpy scalars) at a tiny size, the count functions against a
brute-force count, and the port against the reference on the CPU."""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from cascade_bench import check, counts, program
from cascade_bench import bench as benchlib
from cascade_bench.frozen.scenes import render_scene
from cascade_bench.frozen.stumps import stump_cascade

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REF = benchlib.reference(REPO, "stump_cascade")
F32 = np.float32
ENGINE = {"mode": "wave", "step": 1, "scale_factor": 1.3, "use_pallas": True,
          "pad_multiple": 32, "tail_backend": "pallas",
          "dense_segments": [1, 1], "compact_every": 1}


def _sat(x):
    cols = np.cumsum(x.astype(np.float64), axis=0).astype(np.float32)
    ii = np.cumsum(cols.astype(np.float64), axis=1).astype(np.float32)
    return np.pad(ii, ((1, 0), (1, 0)))


def brute(img, arrays, engine):
    """Every valid window through every stage, one window at a time, in
    the arithmetic the configuration states; with the work it did."""
    h, w = img.shape
    m = engine["pad_multiple"]
    hp, wp = max(-(-h // m) * m, 24), max(-(-w // m) * m, 24)
    pad = np.zeros((hp, wp), np.float32)
    pad[:h, :w] = img
    off = arrays["stage_offsets"]
    n_st = len(off) - 1
    n_dense = min(sum(engine["dense_segments"]), n_st)
    rx, wt = arrays["rect_xywh"], arrays["rect_w"]
    stump_ops = 5 * (wt != 0).sum(1) + 4
    out = dict(rects=[], entering=np.zeros(n_st, np.int64), windows=0,
               pixels=0, sat_entries=0, head_ops=0.0, tail_ops=0.0)
    s = 1.0
    while math.floor(hp / s) >= 24 and math.floor(wp / s) >= 24:
        lh, lw = math.floor(hp / s), math.floor(wp / s)
        rows = sum((r * hp) // lh < h for r in range(lh))
        cols = sum((c * wp) // lw < w for c in range(lw))
        out["pixels"] += rows * cols
        out["sat_entries"] += (rows + 1) * (cols + 1)
        out["head_ops"] += counts.SAT_OPS * rows * cols
        lv = pad[(np.arange(lh) * hp) // lh][:, (np.arange(lw) * wp) // lw]
        cen = lv - F32(128)
        ii, ii2, iic = _sat(lv), _sat(cen * cen), _sat(cen)
        for y in range(lh - 23):
            for x in range(lw - 23):
                if y > (h * lh - 1) // hp - 23 or x > (w * lw - 1) // wp - 23:
                    continue
                out["windows"] += 1
                out["head_ops"] += counts.INV_SIGMA_OPS

                def wsum(t):
                    return ((t[y + 24, x + 24] - t[y, x + 24]) - t[y + 24, x]
                            ) + t[y, x]
                mean = wsum(iic) / F32(576)
                var = max(wsum(ii2) / F32(576) - mean * mean, F32(1))
                inv = F32(1) / F32(np.sqrt(np.float64(var)))
                alive = True
                for st in range(n_st):
                    dense = st < n_dense
                    if alive:
                        out["entering"][st] += 1
                        ops = float(stump_ops[off[st]:off[st + 1]].sum() + 1)
                        out["head_ops" if dense else "tail_ops"] += ops
                    acc = F32(0)
                    for k in range(off[st], off[st + 1]):
                        feat = F32(0)
                        for r in range(3):
                            x0, y0, rw, rh = (int(v) for v in rx[k, r])
                            a = ii[y + y0, x + x0]
                            b = ii[y + y0, x + x0 + rw]
                            c = ii[y + y0 + rh, x + x0]
                            d = ii[y + y0 + rh, x + x0 + rw]
                            area = (d - b) - (c - a) if dense else \
                                ((d - b) - c) + a
                            feat = feat + wt[k, r] * area
                        f = feat * inv
                        f = f * F32(1 / 576) if dense else f / F32(576)
                        acc = acc + (arrays["left_val"][k]
                                     if f < arrays["wc_threshold"][k]
                                     else arrays["right_val"][k])
                    alive = alive and bool(acc >= arrays["stage_threshold"][st])
                if alive:
                    sz = round(24 * s)
                    out["rects"].append((round(x * s), round(y * s), sz, sz))
        s *= engine["scale_factor"]
    out["rects"] = np.asarray(out["rects"], np.int32).reshape(-1, 4)
    return out


def scenes(seed, shapes, face_sizes=(24, 32)):
    rng = np.random.default_rng(seed)
    return [render_scene(rng, h, w, n_faces=1, face_sizes=face_sizes)[0]
            for h, w in shapes]


ARRAYS = stump_cascade(5, [2, 3, 4])


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_equals_a_dense_brute_force(seed):
    imgs = scenes(seed, [(40, 52), (33, 70)])
    got = REF.detect(imgs, ARRAYS, ENGINE, torch.device("cpu"))
    total = 0
    for img, g in zip(imgs, got):
        want = brute(img, ARRAYS, ENGINE)
        assert check.mismatch(g["rects"], want["rects"]) == 0
        assert g["entering"].tolist() == want["entering"].tolist()
        for key in ("windows", "pixels", "sat_entries"):
            assert g[key] == want[key], key
        total += len(want["rects"])
    assert total > 0, "the check has rects to compare"


def test_counts_equal_a_brute_force_count():
    img = scenes(2, [(44, 60)])[0]
    ref = REF.detect([img], ARRAYS, ENGINE, torch.device("cpu"))[0]
    want = brute(img, ARRAYS, ENGINE)
    n_dense = REF.dense_prefix(ENGINE, 3)
    work = counts.image_work(ref, counts.stage_ops(ARRAYS), n_dense)
    assert work["head_ops"] == pytest.approx(want["head_ops"])
    assert work["tail_ops"] == pytest.approx(want["tail_ops"])
    assert work["head_bytes"] == 4 * 44 * 60 + 5 * want["windows"] \
        + 4 * want["sat_entries"]
    assert work["tail_bytes"] == 4 * want["sat_entries"] \
        + 8 * want["entering"][n_dense] + 16 * len(want["rects"])
    head_only = counts.image_work(ref, counts.stage_ops(ARRAYS), 3)
    assert head_only["tail_ops"] == 0 and head_only["tail_bytes"] == 0
    assert counts.least_s(67e12, 0, {"fp32_flops_per_s": 67e12,
                                     "bytes_per_s": 3.35e12}) == 1.0


@pytest.mark.parametrize("config", ["synthface-v2-3x73", "vj-default-25x2913"])
def test_port_on_the_cpu_equals_the_reference(config):
    import json
    cfg = json.loads((REPO / "cascade_bench" / "configs"
                      / f"{config}.json").read_text())
    arrays = program.cascade_arrays(cfg, REPO / "cascade_bench" / "configs")
    imgs = scenes(3, [(64, 90), (50, 70)], face_sizes=(24, 40))
    det = program.detector(arrays, cfg["engine"], torch.device("cpu"))
    got = program.flush(det, imgs)
    want = REF.detect(imgs, arrays, cfg["engine"], torch.device("cpu"))
    values = check.compare([([0, 1], got)], [w["rects"] for w in want])
    assert values == {"rect_mismatch": 0, "answers_missing": 0}
    assert sum(len(w["rects"]) for w in want) > 0
