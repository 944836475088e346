"""AdaBoost training of an attentional cascade (paper section 3, Fig. 3).

The port of ``repro.core.training.adaboost``, the same procedure:

- weak classifiers are decision stumps over normalized Haar-feature values
  (polarity p, threshold theta — Eq. 2);
- each boosting round selects the (feature, theta, p) minimizing the
  weighted error via the sorted-cumulative-weights scan;
- weights update ``w <- w * beta^(1-e)`` with ``beta = eps/(1-eps)`` and the
  vote weight is ``alpha = log(1/beta)`` (Fig. 3);
- stage ``s`` trains on all positives plus the negatives that survive
  stages ``< s`` (hard negatives mined from fresh procedural windows), and
  each stage's threshold is lowered from ``0.5 * sum(alpha)`` until the
  stage detection rate target is met (the DR/FPR product of Eq. 4).

The reference's two jitted inner loops (``_feature_values_jit`` and
``_best_stump``, jnp, not Pallas) are plain PyTorch here, on the device the
caller names (the card unless it asks for the CPU).  The host keeps what
the reference keeps there: the weights, the votes and the stage scores in
float64 numpy, and each round's ``eps`` and predictions come back to it.

Pinned orders, so that the card and the CPU choose the same stumps with
the same bits: window SATs are the port's ``integral_image`` (float64
sums, rounded per entry); window sums and sums of squares accumulate in
float64; 1/sigma takes its root in float64 (``inv_sigma_of``); divisions
go through ``div_rn``; a feature adds its three rectangle terms in order;
the sorted cumulative weights accumulate in float64 and round per entry
to float32, after which the error arithmetic is float32 as in the
reference; sorts are stable, as ``jnp.argsort`` is.  Against the
reference the feature values agree within its float32 rounding (its
variance is a float32 difference of means), not bit for bit, and where two
split points tie in exact arithmetic (common with equal class counts:
the weights take few distinct values) the two packages' float32 sums may
break the tie differently.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ...device import resolve_device
from ..cascade import WINDOW, MAX_RECTS, make_cascade
from ..integral import div_rn, integral_image, inv_sigma_of
from .data import window_dataset, sample_negative

__all__ = ["TrainConfig", "train_cascade", "feature_pool", "feature_values"]

_AREA = float(WINDOW * WINDOW)


class TrainConfig(NamedTuple):
    n_stages: int = 8
    stage_fpr: float = 0.45        # per-stage false-positive target (f_i)
    stage_dr: float = 0.995        # per-stage detection-rate floor (d_i)
    max_weak_per_stage: int = 40
    feature_stride: int = 3        # position stride of the feature pool
    size_stride: int = 3           # size stride of the feature pool
    max_features: int = 3000       # random subsample cap of the pool
    n_pos: int = 1000
    n_neg: int = 1000
    seed: int = 0
    verbose: bool = False


# ---------------------------------------------------------------- features
def feature_pool(cfg: TrainConfig) -> tuple[np.ndarray, np.ndarray]:
    """Enumerate 2/3-rect Haar features (Fig. 2) on a strided grid.

    Returns (rect_xywh (F,3,4) int32, rect_w (F,3) float32).
    """
    rects, weights = [], []
    ps, ss = cfg.feature_stride, cfg.size_stride
    for y in range(0, WINDOW - 2, ps):
        for x in range(0, WINDOW - 2, ps):
            for h in range(2, WINDOW - y + 1, ss):
                for w in range(2, WINDOW - x + 1, ss):
                    # 2-rect horizontal (left/right)
                    if x + 2 * w <= WINDOW:
                        rects.append([(x, y, w, h), (x + w, y, w, h),
                                      (0, 0, 0, 0)])
                        weights.append((1.0, -1.0, 0.0))
                    # 2-rect vertical (top/bottom)
                    if y + 2 * h <= WINDOW:
                        rects.append([(x, y, w, h), (x, y + h, w, h),
                                      (0, 0, 0, 0)])
                        weights.append((1.0, -1.0, 0.0))
                    # 3-rect horizontal
                    if x + 3 * w <= WINDOW:
                        rects.append([(x, y, w, h), (x + w, y, w, h),
                                      (x + 2 * w, y, w, h)])
                        weights.append((1.0, -2.0, 1.0))
                    # 3-rect vertical
                    if y + 3 * h <= WINDOW:
                        rects.append([(x, y, w, h), (x, y + h, w, h),
                                      (x, y + 2 * h, w, h)])
                        weights.append((1.0, -2.0, 1.0))
    rect_xywh = np.asarray(rects, np.int32)
    rect_w = np.asarray(weights, np.float32)
    if len(rect_xywh) > cfg.max_features:
        rng = np.random.default_rng(cfg.seed + 1)
        keep = rng.choice(len(rect_xywh), cfg.max_features, replace=False)
        keep.sort()
        rect_xywh, rect_w = rect_xywh[keep], rect_w[keep]
    return rect_xywh, rect_w


def _feature_values(windows: torch.Tensor, rect_xywh: torch.Tensor,
                    rect_w: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Normalized feature values on ``windows``' device: (N, F) =
    f(window, feature) / (sigma * area), float32."""
    n = windows.shape[0]
    wdim = WINDOW + 1
    iif = integral_image(windows).reshape(n, -1)            # (N, 25*25)

    s1 = windows.double().sum((1, 2))
    s2 = (windows * windows).double().sum((1, 2))
    mean = div_rn(s1, _AREA)
    inv_sigma = inv_sigma_of((div_rn(s2, _AREA) - mean * mean).float())

    x0 = rect_xywh[..., 0].long()
    y0 = rect_xywh[..., 1].long()
    x1 = x0 + rect_xywh[..., 2]
    y1 = y0 + rect_xywh[..., 3]

    def corner(yy, xx):                                    # (F, 3) -> (N,F,3)
        idx = yy * wdim + xx
        return iif[:, idx.reshape(-1)].reshape(n, *idx.shape)

    outs = []
    for c0 in range(0, rect_xywh.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        s = (corner(y1[sl], x1[sl]) - corner(y0[sl], x1[sl])
             - corner(y1[sl], x0[sl]) + corner(y0[sl], x0[sl]))
        t = s * rect_w[sl][None]
        outs.append(t[..., 0] + t[..., 1] + t[..., 2])
    vals = torch.cat(outs, dim=1)
    return div_rn(vals * inv_sigma[:, None], _AREA)


def feature_values(windows: np.ndarray, rect_xywh: np.ndarray,
                   rect_w: np.ndarray, device=None) -> np.ndarray:
    """(N, F) normalized feature values of ``windows`` (N, 24, 24),
    computed on ``device`` (the card unless ``"cpu"`` is named)."""
    dev = resolve_device(device)
    return _feature_values(
        torch.as_tensor(np.asarray(windows, np.float32), device=dev),
        torch.as_tensor(rect_xywh, device=dev),
        torch.as_tensor(rect_w, device=dev)).cpu().numpy()


# ---------------------------------------------------------------- boosting
def _best_stump(vals_sorted: torch.Tensor, order: torch.Tensor,
                w: torch.Tensor, y: torch.Tensor):
    """Best (feature, threshold, polarity) under weights ``w``.

    vals_sorted: (N, F) feature values sorted along N (stable).
    order:       (N, F) the sort's indices.
    Returns 0-dim tensors (eps, feat_idx, theta, polarity) and pred_all
    (N,) bool, all on the inputs' device.
    """
    n, n_feat = vals_sorted.shape
    ws = w[order]                       # weights in sorted order  (N, F)
    ys = y[order]                       # labels  in sorted order  (N, F)
    zero = torch.zeros((), dtype=ws.dtype, device=ws.device)
    wpos = torch.where(ys == 1, ws, zero)
    wneg = torch.where(ys == 0, ws, zero)
    spos = torch.cumsum(wpos.double(), 0).float()  # pos weight at or below i
    sneg = torch.cumsum(wneg.double(), 0).float()
    tpos = spos[-1]
    tneg = sneg[-1]
    # threshold between i and i+1 → classify "face" for values <= v_i
    eps_p = sneg + (tpos - spos)        # polarity +1: f < theta → face
    eps_m = spos + (tneg - sneg)        # polarity -1: f > theta → face
    eps = torch.minimum(eps_p, eps_m).reshape(-1)
    flat = torch.argmin(eps)            # first minimum, row-major (i, f)
    i, f = flat // n_feat, flat % n_feat
    pol = torch.where(eps_p.reshape(-1)[flat] <= eps_m.reshape(-1)[flat],
                      1, -1)
    # midpoint threshold (guard the upper edge)
    flat_vals = vals_sorted.reshape(-1)
    v_i = flat_vals[flat]
    v_n = flat_vals[torch.clamp(i + 1, max=n - 1) * n_feat + f]
    theta = torch.where(i + 1 < n, 0.5 * (v_i + v_n), v_i + 1e-6)
    # feature f's values back in the original order
    col = vals_sorted.index_select(1, f.reshape(1)).reshape(-1)
    src = order.index_select(1, f.reshape(1)).reshape(-1)
    orig_vals = torch.empty_like(col).scatter_(0, src, col)
    pred = torch.where(pol == 1, orig_vals < theta, orig_vals > theta)
    return eps[flat], f, theta, pol, pred


class _Stump(NamedTuple):
    feat: int
    theta: float
    polarity: int
    alpha: float


def _boost_stage(vals: np.ndarray, y: np.ndarray, cfg: TrainConfig,
                 stage_id: int, device: torch.device):
    """Train one stage on ``device``; returns (stumps, stage_threshold)."""
    n = len(y)
    n_pos = int(y.sum())
    n_neg = n - n_pos
    w = np.where(y == 1, 0.5 / max(n_pos, 1), 0.5 / max(n_neg, 1))

    vals_sorted, order = torch.sort(torch.as_tensor(vals, device=device),
                                    dim=0, stable=True)
    y_dev = torch.as_tensor(y, device=device)

    stumps: list[_Stump] = []
    scores = np.zeros(n, np.float64)     # running sum alpha_t * h_t
    alpha_sum = 0.0
    for t in range(cfg.max_weak_per_stage):
        w = w / w.sum()
        eps, f, theta, pol, pred = _best_stump(
            vals_sorted, order,
            torch.as_tensor(w, dtype=torch.float32, device=device), y_dev)
        # one transfer for the scalars (float64 holds each exactly), one
        # for the predictions
        eps, f, theta, pol = torch.stack(
            [eps.double(), f.double(), theta.double(), pol.double()]).cpu()
        eps = float(np.clip(np.float32(eps), 1e-10, 1 - 1e-10))
        pred = pred.cpu().numpy()
        beta = eps / (1.0 - eps)
        alpha = float(np.log(1.0 / beta))
        e = (pred != (y == 1)).astype(np.float64)   # 0 correct / 1 wrong
        w = w * np.power(beta, 1.0 - e)
        stumps.append(_Stump(int(f), float(theta), int(pol), alpha))
        scores += alpha * pred
        alpha_sum += alpha

        # stage threshold: lower from alpha_sum/2 until DR target met
        pos_scores = scores[y == 1]
        thr = 0.5 * alpha_sum
        if len(pos_scores):
            q = np.quantile(pos_scores, 1.0 - cfg.stage_dr)
            thr = min(thr, q - 1e-9)
        neg_scores = scores[y == 0]
        fpr = float((neg_scores >= thr).mean()) if len(neg_scores) else 0.0
        dr = float((pos_scores >= thr).mean()) if len(pos_scores) else 1.0
        if cfg.verbose:
            print(f"  stage {stage_id} t={t} eps={eps:.3f} fpr={fpr:.3f} "
                  f"dr={dr:.3f}")
        if fpr <= cfg.stage_fpr and dr >= cfg.stage_dr:
            break
    return stumps, float(thr)


def _stage_scores(stumps, thr, vals):
    s = np.zeros(vals.shape[0], np.float64)
    for st in stumps:
        v = vals[:, st.feat]
        pred = (v < st.theta) if st.polarity == 1 else (v > st.theta)
        s += st.alpha * pred
    return s >= thr


def train_cascade(cfg: TrainConfig = TrainConfig(), device=None):
    """Train an attentional cascade on the procedural corpus, on
    ``device`` (the card unless ``"cpu"`` is named).

    Returns (cascade, info): the port's ``Cascade`` on that device, and
    info with the per-stage DR/FPR history (the reference's keys).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    rect_xywh, rect_w = feature_pool(cfg)
    corpus = window_dataset(rng, cfg.n_pos, cfg.n_neg)
    pos_windows = corpus.windows[corpus.labels == 1]
    neg_windows = corpus.windows[corpus.labels == 0]

    def values(windows):
        return feature_values(windows, rect_xywh, rect_w, dev)

    pos_vals = values(pos_windows)

    all_stumps: list[list[_Stump]] = []
    stage_thresholds: list[float] = []
    info = {"stages": [], "pool_size": len(rect_xywh)}

    def mine_negatives(n_needed: int) -> np.ndarray:
        """Fresh negatives (backgrounds + decoys) passing all stages so far."""
        got = []
        attempts = 0
        while sum(len(g) for g in got) < n_needed and attempts < 60:
            attempts += 1
            batch = np.stack([sample_negative(rng)
                              for _ in range(max(n_needed * 2, 256))])
            v = values(batch)
            keep = np.ones(len(batch), bool)
            for st, th in zip(all_stumps, stage_thresholds):
                keep &= _stage_scores(st, th, v)
                if not keep.any():
                    break
            if keep.any():
                got.append(batch[keep])
        if not got:
            return np.zeros((0, WINDOW, WINDOW), np.float32)
        return np.concatenate(got)[:n_needed]

    cur_neg = neg_windows
    t0 = time.time()
    for s in range(cfg.n_stages):
        if len(cur_neg) < max(8, cfg.n_neg // 10):
            if cfg.verbose:
                print(f"stage {s}: not enough hard negatives — stop early")
            break
        y = np.concatenate([np.ones(len(pos_windows), np.int32),
                            np.zeros(len(cur_neg), np.int32)])
        neg_vals = values(cur_neg)
        vals = np.concatenate([pos_vals, neg_vals])
        stumps, thr = _boost_stage(vals, y, cfg, s, dev)
        all_stumps.append(stumps)
        stage_thresholds.append(thr)
        pass_pos = _stage_scores(stumps, thr, pos_vals)
        pass_neg = _stage_scores(stumps, thr, neg_vals)
        info["stages"].append({
            "n_weak": len(stumps),
            "dr": float(pass_pos.mean()),
            "fpr": float(pass_neg.mean()),
        })
        if cfg.verbose:
            print(f"stage {s}: weak={len(stumps)} dr={pass_pos.mean():.3f} "
                  f"fpr={pass_neg.mean():.3f} ({time.time()-t0:.1f}s)")
        # every positive stays (the DR product of Eq. 4); the negatives
        # that pass are kept and topped up with freshly mined ones.  After
        # the last stage nothing reads them: the reference mines anyway
        # (minutes at scripts/train_pretrained.py's widths), the port does
        # not; the cascade and info are the same either way
        cur_neg = cur_neg[pass_neg]
        if len(cur_neg) < cfg.n_neg and s + 1 < cfg.n_stages:
            extra = mine_negatives(cfg.n_neg - len(cur_neg))
            if len(extra):
                cur_neg = np.concatenate([cur_neg, extra])

    # -------- pack stumps into the flat Cascade arrays
    n_wc = sum(len(st) for st in all_stumps)
    rx = np.zeros((n_wc, MAX_RECTS, 4), np.int32)
    rw = np.zeros((n_wc, MAX_RECTS), np.float32)
    th = np.zeros(n_wc, np.float32)
    lv = np.zeros(n_wc, np.float32)
    rv = np.zeros(n_wc, np.float32)
    offs = [0]
    k = 0
    for stumps in all_stumps:
        for st in stumps:
            rx[k] = rect_xywh[st.feat]
            rw[k] = rect_w[st.feat]
            if st.polarity == 1:
                # f < theta → vote alpha
                th[k], lv[k], rv[k] = st.theta, st.alpha, 0.0
            else:
                # f > theta → vote alpha  ⇔  f < theta → 0
                th[k], lv[k], rv[k] = st.theta, 0.0, st.alpha
            k += 1
        offs.append(k)
    cascade = make_cascade(rx, rw, th, lv, rv, np.asarray(offs, np.int32),
                           np.asarray(stage_thresholds, np.float32),
                           device=dev)
    info["train_seconds"] = time.time() - t0
    info["overall_dr"] = float(np.prod([s["dr"] for s in info["stages"]])) \
        if info["stages"] else 0.0
    info["overall_fpr"] = float(np.prod([s["fpr"] for s in info["stages"]])) \
        if info["stages"] else 1.0
    return cascade, info
