"""Plain reference of multi-scale detection with a cascade of Haar stumps.

Plain PyTorch in float32 (or the lower precision a control asks for), no
kernels, no batching across buckets, no capacities: every image is padded
to its shape bucket, every pyramid level is built by nearest-neighbour
resampling, every valid 24x24 window is evaluated stage by stage, and the
windows that pass every stage are decoded to rects.  It imports nothing of
the program and takes nothing the program made: it works out the bucket,
the pyramid, the window limits, the SATs and 1/sigma from the images and
the cascade arrays the benchmark hands to both sides.

Its arithmetic is the one the configuration states, in the order the
engine documents for each stage, so that both sides round alike and the
comparison is exact.  It also counts, in float32, the decisions that lie
within rounding of their thresholds (the band): a stump whose feature is
within the rounding by which another corner, rectangle or scale order
could move it (``RECT_ULPS`` ulps of the largest corner per rectangle,
``FEAT_ULPS`` of the weighted sum, ``SCALE_ULPS`` of the feature), or a
stage sum within ``VOTE_ULPS`` ulps per vote of its threshold.  Per image
it returns how many stage evaluations lie in the band (``band_evals``) and
the rects whose outcome a band decision could change (``band_rects``: the
accepted windows that passed one, and the windows rejected by one).  The
band is reported, not left out of the comparison: at 480x640 a SAT entry
has an ulp of 8 and most accepted windows pass some decision in the band,
so the comparison holds the port to the orders stated here.

- SATs: a column cumulative sum then a row cumulative sum, each
  accumulated in float64 and rounded to float32 per entry, of the image,
  of (image - 128)^2 and of (image - 128), each rounded to float32 first;
- 1/sigma of a window: corners d - b - c + a on the two centred tables,
  mean = s1 / 576, var = s2 / 576 - mean^2, 1 / sqrt(max(var, 1)), the
  root correctly rounded, the divisions IEEE;
- the dense prefix (the first ``sum(dense_segments)`` stages in ``wave``
  mode, every stage in ``dense`` mode), when the engine runs it on its
  dense head (``use_pallas`` and step 1): corners (d - b) - (c - a) and
  feat * inv * float32(1/576);
- every other stage: corners d - b - c + a and feat * inv / 576;
- in both: the three rectangles of a stump added in order (a weight of 0
  adds a signed zero, which changes no sum), votes added in ascending
  stump order, a window passing stage s when its sum is >= the threshold;
- rects: origin and size times the level's scale (the product of
  ``scale_factor`` in float64), rounded half to even.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

WINDOW = 24
CENTRE = 128.0
AREA = float(WINDOW * WINDOW)
# elements of one gathered (windows x stumps x rects) block
BLOCK_ELEMS = 1 << 24
# The rounding band (see the module's docstring): ulps of the largest
# corner by which a rectangle's sum may differ between the two documented
# corner orders, ulps of the weighted sum for adding the rectangles in
# another order, ulps of a feature between ``* (1/576)`` and ``/ 576``,
# and ulps of the largest vote sum per vote for adding votes in another
# order
RECT_ULPS = 4
FEAT_ULPS = 3
SCALE_ULPS = 2
VOTE_ULPS = 1


def bucket(h: int, w: int, pad_multiple: int) -> tuple[int, int]:
    """The padded shape an image is detected in."""
    if pad_multiple <= 0:
        return h, w
    m = pad_multiple
    return (max(-(-h // m) * m, WINDOW), max(-(-w // m) * m, WINDOW))


def levels(hp: int, wp: int, scale_factor: float) -> list:
    """Pyramid levels ``(height, width, scale)`` of a padded shape."""
    out, s = [], 1.0
    while True:
        h, w = int(math.floor(hp / s)), int(math.floor(wp / s))
        if h < WINDOW or w < WINDOW:
            return out
        out.append((h, w, s))
        s *= scale_factor


def dense_prefix(engine: dict, n_stages: int) -> int:
    """Stages evaluated in the dense head's order."""
    if not (engine["use_pallas"] and engine["step"] == 1):
        return 0
    if engine["mode"] == "dense":
        return n_stages
    return min(int(sum(engine["dense_segments"])), n_stages)


def _sat(x: torch.Tensor) -> torch.Tensor:
    cols = torch.cumsum(x.double(), dim=-2).float()
    return F.pad(torch.cumsum(cols.double(), dim=-1).float(), (1, 0, 1, 0))


def _window_sum(t, ys, xs):
    """d - b - c + a over the 24x24 windows at origins ys x xs."""
    y1, x1 = ys + WINDOW, xs + WINDOW
    return (t[:, y1][:, :, x1] - t[:, ys][:, :, x1] - t[:, y1][:, :, xs]
            + t[:, ys][:, :, xs])


class _Cascade:
    """The cascade arrays on the device, per stage, in ``dtype``."""

    def __init__(self, arrays: dict, device, dtype):
        off = np.asarray(arrays["stage_offsets"], np.int64)
        rx = np.asarray(arrays["rect_xywh"], np.int64)
        self.stages = []
        for s in range(len(off) - 1):
            k0, k1 = off[s], off[s + 1]
            r = torch.as_tensor(rx[k0:k1], device=device)

            def f32(name):
                return torch.as_tensor(np.asarray(arrays[name][k0:k1],
                                                  np.float32),
                                       device=device).to(dtype)
            self.stages.append(dict(
                x=r[..., 0], y=r[..., 1], w=r[..., 2], h=r[..., 3],
                wt=f32("rect_w"), theta=f32("wc_threshold"),
                left=f32("left_val"), right=f32("right_val")))
        self.threshold = torch.as_tensor(
            np.asarray(arrays["stage_threshold"], np.float32),
            device=device).to(dtype)
        self.n_stages = len(self.stages)


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """The float32 unit in the last place of ``x``."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 24)


def _stage_sums(st: dict, sat, p, stride, inv, dense: bool, dtype,
                band: bool = False):
    """One stage's vote sums over a window list (flat SAT origin ``p``,
    row ``stride``, 1/sigma ``inv``); with ``band``, also whether each
    window has a stump whose feature lies within the band's rounding of
    its threshold, and each sum's own allowance (``RECT_ULPS`` ...)."""
    n, k = p.shape[0], st["x"].shape[0]
    dev = p.device
    acc = torch.zeros(n, dtype=dtype, device=dev)
    near = torch.zeros(n, dtype=torch.bool, device=dev)
    slack = torch.zeros(n, dtype=dtype, device=dev)
    inv_area = torch.tensor(1.0 / AREA, dtype=torch.float32).to(dtype).to(dev)
    area_t = torch.tensor(AREA, dtype=dtype, device=dev)
    nb = max(BLOCK_ELEMS // (k * 3), 1)
    for i0 in range(0, n, nb):
        pb = p[i0:i0 + nb, None, None]
        sb = stride[i0:i0 + nb, None, None]
        ia = pb + st["y"] * sb + st["x"]
        ib = ia + st["w"]
        ic = ia + st["h"] * sb
        idd = ic + st["w"]
        a, b, c, d = (sat[i].to(dtype) for i in (ia, ib, ic, idd))
        area = (d - b) - (c - a) if dense else d - b - c + a
        feat = torch.zeros(area.shape[:2], dtype=dtype, device=dev)
        for r in range(area.shape[2]):
            feat = feat + st["wt"][:, r] * area[..., r]
        f = feat * inv[i0:i0 + nb, None]
        f = f * inv_area if dense else f / area_t
        vote = torch.where(f < st["theta"], st["left"], st["right"])
        part = torch.zeros(vote.shape[0], dtype=dtype, device=dev)
        for j in range(k):
            part = part + vote[:, j]
        acc[i0:i0 + nb] = part
        if band:
            corner = torch.maximum(torch.maximum(a.abs(), b.abs()),
                                   torch.maximum(c.abs(), d.abs()))
            w = st["wt"].abs()
            e_feat = ((w * RECT_ULPS * _ulp(corner)).sum(-1)
                      + FEAT_ULPS * _ulp((w * area.abs()).sum(-1)))
            e_f = (e_feat * inv[i0:i0 + nb, None] / area_t
                   + SCALE_ULPS * _ulp(f))
            near[i0:i0 + nb] = ((f - st["theta"]).abs() <= e_f).any(-1)
            slack[i0:i0 + nb] = VOTE_ULPS * k * _ulp(vote.abs().sum(-1))
    if band:
        return acc, near, slack
    return acc


def _chunk(images: list, hp: int, wp: int, casc: _Cascade, engine: dict,
           device, dtype) -> list:
    """Detection over a chunk of images that share a bucket."""
    b = len(images)
    step = engine["step"]
    stack = torch.zeros((b, hp, wp), dtype=torch.float32, device=device)
    hw = np.asarray([im.shape for im in images], np.int64)
    for i, im in enumerate(images):
        stack[i, :im.shape[0], :im.shape[1]] = torch.from_numpy(im)
    n_dense = dense_prefix(engine, casc.n_stages)
    area_t = torch.tensor(AREA, dtype=dtype, device=device)
    sats, win = [], {k: [] for k in ("p", "stride", "inv", "img", "lvl",
                                     "y", "x")}
    sat_entries = np.zeros(b, np.int64)
    pixels = np.zeros(b, np.int64)
    scales, off = [], 0
    for li, (lh, lw, scale) in enumerate(levels(hp, wp,
                                                engine["scale_factor"])):
        scales.append(scale)
        iy = (torch.arange(lh, device=device) * hp) // lh
        ix = (torch.arange(lw, device=device) * wp) // lw
        lv = stack[:, iy][:, :, ix]
        cen = lv - CENTRE
        ii, ii2, iic = _sat(lv), _sat(cen * cen), _sat(cen)
        ys = torch.arange((lh - WINDOW) // step + 1, device=device) * step
        xs = torch.arange((lw - WINDOW) // step + 1, device=device) * step
        s2 = _window_sum(ii2.to(dtype), ys, xs)
        mean = _window_sum(iic.to(dtype), ys, xs) / area_t
        var = torch.clamp(s2 / area_t - mean * mean, min=1.0)
        inv = torch.reciprocal(torch.sqrt(var.double()).to(dtype))
        # windows whose every sampled source pixel lies inside the image
        rows = (np.arange(lh)[None, :] * hp) // lh < hw[:, :1]
        cols = (np.arange(lw)[None, :] * wp) // lw < hw[:, 1:]
        pixels += rows.sum(1) * cols.sum(1)
        sat_entries += (rows.sum(1) + 1) * (cols.sum(1) + 1)
        y_lim = torch.as_tensor((hw[:, 0] * lh - 1) // hp - (WINDOW - 1),
                                device=device)
        x_lim = torch.as_tensor((hw[:, 1] * lw - 1) // wp - (WINDOW - 1),
                                device=device)
        ok = ((ys[None, :, None] <= y_lim[:, None, None])
              & (xs[None, None, :] <= x_lim[:, None, None]))
        bi, yi, xi = torch.nonzero(ok, as_tuple=True)
        y, x = ys[yi], xs[xi]
        size = (lh + 1) * (lw + 1)
        win["p"].append(off + bi * size + y * (lw + 1) + x)
        win["stride"].append(torch.full_like(y, lw + 1))
        win["inv"].append(inv[bi, yi, xi])
        win["img"].append(bi)
        win["lvl"].append(torch.full_like(y, li))
        win["y"].append(y)
        win["x"].append(x)
        sats.append(ii.reshape(-1))
        off += b * size
    sat = torch.cat(sats)
    w = {k: torch.cat(v) for k, v in win.items()}
    band = dtype == torch.float32
    w["band"] = torch.zeros_like(w["y"], dtype=torch.bool)
    windows = torch.bincount(w["img"], minlength=b).cpu().numpy()
    entering = np.zeros((b, casc.n_stages), np.int64)
    band_evals = np.zeros(b, np.int64)
    left = []      # windows rejected at a stage whose decision is in the band
    for s, st in enumerate(casc.stages):
        entering[:, s] = torch.bincount(w["img"], minlength=b).cpu().numpy()
        if band:
            ss, near, slack = _stage_sums(st, sat, w["p"], w["stride"],
                                          w["inv"], s < n_dense, dtype, True)
            near |= (ss - casc.threshold[s]).abs() <= slack
            band_evals += torch.bincount(w["img"][near],
                                         minlength=b).cpu().numpy()
        else:
            ss = _stage_sums(st, sat, w["p"], w["stride"], w["inv"],
                             s < n_dense, dtype)
            near = torch.zeros_like(ss, dtype=torch.bool)
        keep = ss >= casc.threshold[s]
        out = near & ~keep
        left.append({k: w[k][out] for k in ("img", "lvl", "y", "x")})
        w["band"] = w["band"] | near
        w = {k: v[keep] for k, v in w.items()}
    left.append({k: w[k][w["band"]] for k in ("img", "lvl", "y", "x")})
    img, rects = _rects(w, scales)
    bimg, brects = _rects({k: torch.cat([x[k] for x in left])
                           for k in left[0]}, scales)
    return [dict(rects=rects[img == i], band_rects=brects[bimg == i],
                 band_evals=int(band_evals[i]), entering=entering[i],
                 windows=int(windows[i]), pixels=int(pixels[i]),
                 image_pixels=int(hw[i, 0] * hw[i, 1]),
                 sat_entries=int(sat_entries[i]),
                 accepted=int((img == i).sum()))
            for i in range(b)]


def _rects(w: dict, scales: list):
    """Images and rects [x, y, w, h] of windows (``img``, ``lvl``, ``y``,
    ``x``): origin and size times the level's scale, half to even."""
    img = w["img"].cpu().numpy()
    scale = np.asarray(scales, np.float64)[w["lvl"].cpu().numpy()]
    ys = w["y"].cpu().numpy().astype(np.float64)
    xs = w["x"].cpu().numpy().astype(np.float64)
    size = np.rint(WINDOW * scale)
    rects = np.stack([np.rint(xs * scale), np.rint(ys * scale), size, size],
                     axis=1).astype(np.int32).reshape(-1, 4)
    return img, rects


def detect(images: list, arrays: dict, engine: dict, device,
           dtype=torch.float32, max_windows: int = 1 << 23) -> list:
    """Per image: ``rects`` (N, 4) int32 [x, y, w, h] (ungrouped),
    ``entering`` (n_stages,) windows that enter each stage, ``windows``
    (valid windows), ``pixels`` (valid level pixels over the pyramid),
    ``sat_entries``, ``image_pixels`` and ``accepted``.  Images of one
    bucket go through in chunks of at most ``max_windows`` windows."""
    casc = _Cascade(arrays, device, dtype)
    out: list = [None] * len(images)
    groups: dict = {}
    for i, im in enumerate(images):
        groups.setdefault(bucket(*im.shape, engine["pad_multiple"]),
                          []).append(i)
    for (hp, wp), idx in groups.items():
        per_image = sum((lh - WINDOW) // engine["step"] + 1
                        for lh, _, _ in levels(hp, wp,
                                                engine["scale_factor"])) * wp
        n = max(1, min(len(idx), max_windows // max(per_image, 1)))
        for j in range(0, len(idx), n):
            part = idx[j:j + n]
            for i, r in zip(part, _chunk([images[i] for i in part], hp, wp,
                                         casc, engine, device, dtype)):
                out[i] = r
    return out
