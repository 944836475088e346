"""The packed-tail evaluator: compacted cascade stages, three backends.

Every tail of the port runs one computation: a run of cascade stages over
a packed window list whose lanes live on different images and pyramid
levels, addressed through flat per-level SAT offsets
(``ii_flat[img, base + y * stride + x]``).  Three backends give the same
bits (corners ``d - b - c + a``, ``feat * inv / 576``, votes in ascending
k), as in ``repro.kernels.packed_tail``:

``gather``
    one weak classifier at a time: the exactness referee, kernel C's plain
    version :func:`repro_torch.kernels.packed_window.stage_sums_plain`;
``bulk``
    one gather per rectangle corner across all ``K`` weak classifiers of a
    stage, shape (K, 3, cap) (plain torch);
``pallas``
    the hand-written blocked kernel backend: kernel C,
    :func:`repro_torch.kernels.packed_window.stage_sums`, each CUDA thread
    looping the whole stage run over the lanes the plan's ``lane_block``
    gives it.  The label is the reference's, so configs and plans stay
    equal to its own.

Out-of-range flat SAT indices clamp into the table, as
``jnp.take(mode="clip")`` does; valid lanes never produce one.

:func:`measure_rungs` races the three backends at capacity-ladder sizes on
a real multi-level packed workload (:func:`_build_workload`, whose sampler
draws the reference's lanes from the same seed) and returns the
reference's schema; ``Detector.calibrated(tune_tail=True)`` persists its
ladder in ``EngineConfig.tail_rungs``.  On the card the ``gather``
backend is kernel C's plain version, one weak classifier at a time (about
90 small launches per classifier), so a size costs about a second per
call at the paper cascade's 2913 classifiers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cascade import Cascade, WINDOW
from repro_torch.core.integral import div_rn, integral_images, window_inv_sigma

from .autotune import _best_ms

__all__ = ["BACKENDS", "DEFAULT_RUNG_SIZES", "stage_sums", "select_backend",
           "measure_rungs"]

_AREA = float(WINDOW * WINDOW)

BACKENDS = ("gather", "bulk", "pallas")

# capacity-ladder sizes at which measure_rungs races the backends (the
# reference's: they bracket BATCH_CAP_FLOOR=128 .. the stream rungs)
DEFAULT_RUNG_SIZES = (128, 512, 2048, 8192)


def _lookup(ii_flat: torch.Tensor, img: torch.Tensor,
            flat: torch.Tensor) -> torch.Tensor:
    """``ii_flat[img, flat]`` read at the flat index ``img * S + flat``,
    clamped into the whole table (as ``jnp.take(mode="clip")`` and kernel
    C do)."""
    table = ii_flat.reshape(-1)
    return table[torch.clamp(img * ii_flat.shape[1] + flat, 0,
                             table.numel() - 1)]


def _bulk_stage_sum(cascade: Cascade, ii_flat, img, base, stride, ys, xs,
                    inv_sigma, k0: int, k1: int,
                    dense: bool = False) -> torch.Tensor:
    """Stage sum with one (K, 3, cap) gather per rectangle corner; the
    same per-lane arithmetic as the ``gather`` backend (the dense heads'
    when ``dense``)."""
    rects = cascade.rect_xywh[k0:k1].long()
    w = cascade.rect_w[k0:k1]
    rx, ry = rects[:, :, 0, None], rects[:, :, 1, None]
    rw, rh = rects[:, :, 2, None], rects[:, :, 3, None]
    y0 = ys[None, None, :] + ry
    x0 = xs[None, None, :] + rx
    y1 = y0 + rh
    x1 = x0 + rw

    def g(y, x):
        return _lookup(ii_flat, img[None, None, :],
                       base[None, None, :] + y * stride[None, None, :] + x)

    a, b, c, d = g(y0, x0), g(y0, x1), g(y1, x0), g(y1, x1)  # (K, 3, cap)
    area = (d - b) - (c - a) if dense else d - b - c + a
    feat = torch.zeros((area.shape[0], area.shape[2]), dtype=torch.float32,
                       device=area.device)
    for r in range(rects.shape[1]):
        feat = feat + w[:, r, None] * area[:, r]
    f_norm = (feat * inv_sigma[None, :] * (1.0 / _AREA) if dense
              else div_rn(feat * inv_sigma[None, :], _AREA))
    votes = torch.where(f_norm < cascade.wc_threshold[k0:k1, None],
                        cascade.left_val[k0:k1, None],
                        cascade.right_val[k0:k1, None])
    acc = torch.zeros_like(inv_sigma)
    for k in range(k1 - k0):     # ascending-k adds, like the gather loop
        acc = acc + votes[k]
    return acc


def stage_sums(cascade: Cascade, s0: int, s1: int, ii_flat: torch.Tensor,
               img: torch.Tensor, base: torch.Tensor, stride: torch.Tensor,
               ys: torch.Tensor, xs: torch.Tensor, inv_sigma: torch.Tensor,
               *, backend: str = "bulk", n_live: torch.Tensor | None = None,
               lane_block=None, s_dense: int = 0) -> torch.Tensor:
    """(s1 - s0, cap) vote sums for stages ``[s0, s1)`` over a packed list.

    One call per tail segment: the caller applies stage thresholds between
    rows.  The lane arrays are integer tensors of one length ``cap``.
    ``n_live`` (0-dim int64 on the device, or ``None``: all lanes) is the
    compaction's live count: every backend gives 0 on lanes at or past it.
    ``lane_block`` is the plan's block shape; only kernel C uses it.
    Stages below ``s_dense`` take the dense heads' arithmetic (corners
    ``(d - b) - (c - a)``, ``feat * inv * (1/576)``): the stream's
    incremental tail passes the dense prefix's length when ``detect``
    evaluates that prefix with kernels A and B.
    """
    from . import packed_window
    if backend == "pallas":
        return packed_window.stage_sums(
            cascade, s0, s1, ii_flat, img.int(), base.int(), stride.int(),
            ys.int(), xs.int(), inv_sigma, n_live=n_live,
            lane_block=lane_block, s_dense=s_dense)
    if backend == "gather":
        return packed_window.stage_sums_plain(
            cascade, s0, s1, ii_flat, img.int(), base.int(), stride.int(),
            ys.int(), xs.int(), inv_sigma, n_live, s_dense)
    if backend != "bulk":
        raise ValueError(f"unknown packed-tail backend: {backend!r} "
                         f"(expected one of {BACKENDS})")
    lanes = [t.long() for t in (img, base, stride, ys, xs)]
    b = cascade.bounds
    if s1 <= s0:
        return torch.zeros((0, inv_sigma.shape[0]), dtype=torch.float32,
                           device=inv_sigma.device)
    return packed_window.zero_past_live(
        torch.stack([_bulk_stage_sum(cascade, ii_flat, *lanes, inv_sigma,
                                     b[s], b[s + 1], s < s_dense)
                     for s in range(s0, s1)]), n_live)


def select_backend(config, n_windows: int) -> str:
    """Backend for a packed list of ``n_windows`` lanes under ``config``;
    delegates to the plan layer's one decision function."""
    from repro_torch.plan import select_backend as _select
    return _select(config, n_windows)


def _build_workload(workload, rng: np.random.Generator, device):
    """Per-level SATs and a lane sampler for :func:`measure_rungs`.

    ``workload`` is a list of ``(image, weight)``: one grayscale image per
    pyramid level and that level's expected share of packed windows.
    Returns ``(ii_flat (1, S) on device, sample, n_windows)``, where
    ``sample(size)`` draws a level-sorted packed list of ``size`` lanes
    spread over the levels in proportion to the weights (largest
    remainder) and returns ``(img, base, stride, ys, xs, inv)`` on the
    device.  ``ys`` / ``xs`` are drawn from ``rng`` in the reference's
    order, so the same seed gives the reference's lanes.
    """
    sats, pairs, bases, strides, shapes = [], [], [], [], []
    base = 0
    for img, _weight in workload:
        img = torch.as_tensor(img, dtype=torch.float32, device=device)
        h, w = img.shape
        ii, pair = integral_images(img)
        sats.append(ii.reshape(-1))
        pairs.append(pair)
        bases.append(base)
        strides.append(w + 1)
        shapes.append((h, w))
        base += (h + 1) * (w + 1)
    ii_flat = torch.cat(sats)[None, :]
    weights = np.asarray([max(float(wt), 0.0) for _im, wt in workload])
    if weights.sum() <= 0:
        weights = np.asarray([(h - WINDOW + 1) * (w - WINDOW + 1)
                              for h, w in shapes], np.float64)
    weights = weights / weights.sum()
    hi_y = np.asarray([h - WINDOW + 1 for h, _w in shapes])
    hi_x = np.asarray([w - WINDOW + 1 for _h, w in shapes])

    def lanes(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def sample(size):
        exact = weights * size
        per = np.floor(exact).astype(int)
        for i in np.argsort(-(exact - per))[:size - per.sum()]:
            per[i] += 1
        lv = np.repeat(np.arange(len(shapes)), per)
        ys = rng.integers(0, hi_y[lv]).astype(np.int32)
        xs = rng.integers(0, hi_x[lv]).astype(np.int32)
        inv = [window_inv_sigma(
            pairs[v], torch.as_tensor(ys[lv == v], device=device).long(),
            torch.as_tensor(xs[lv == v], device=device).long(), WINDOW)
               for v in range(len(shapes)) if (lv == v).any()]
        inv = (torch.cat(inv) if inv
               else torch.zeros(0, dtype=torch.float32, device=device))
        return (lanes(np.zeros(len(lv))), lanes([bases[v] for v in lv]),
                lanes([strides[v] for v in lv]), lanes(ys), lanes(xs), inv)

    n_windows = int(sum((h - WINDOW + 1) * (w - WINDOW + 1)
                        for h, w in shapes))
    return ii_flat, sample, n_windows


def measure_rungs(cascade: Cascade, *, sizes: tuple = DEFAULT_RUNG_SIZES,
                  repeats: int = 3, inner: int = 10, seed: int = 0,
                  workload: list | None = None) -> dict:
    """Race the packed-tail backends at capacity-ladder sizes.

    Times each backend evaluating the whole cascade on a packed list of
    each size (best of ``repeats`` means over ``inner`` warm calls, the
    device drained before every clock read) on the cascade's device.
    ``workload`` is the profiled image's ``(level_image, weight)`` list
    (``Detector.calibrated`` passes it); without it one random 160x160
    level drawn from ``seed``.  Returns the reference's schema::

        {"sizes": [...], "n_windows": int, "levels": int,
         "ms": {backend: [...]},
         "rungs": ((max_windows, winner), ...), "crossover": int}

    ``crossover`` is the smallest size won by kernel C (``"pallas"``),
    -1 if it wins none.
    """
    rng = np.random.default_rng(seed)
    if workload is None:
        workload = [(rng.integers(0, 255, (160, 160)).astype(np.float32),
                     1.0)]
    device = cascade.rect_w.device
    ii_flat, sample, n_windows = _build_workload(workload, rng, device)
    n_stages = cascade.n_stages
    ms: dict[str, list] = {b: [] for b in BACKENDS}
    for size in sizes:
        lanes = sample(size)
        for bk in BACKENDS:
            ms[bk].append(_best_ms(
                lambda bk=bk: stage_sums(cascade, 0, n_stages, ii_flat,
                                         *lanes, backend=bk),
                device, repeats, inner))
    rungs = tuple((size, min(BACKENDS, key=lambda b: ms[b][i]))
                  for i, size in enumerate(sizes))
    crossover = next((size for size, bk in rungs if bk == "pallas"), -1)
    return {"sizes": list(sizes), "n_windows": n_windows,
            "levels": len(workload), "ms": ms,
            "rungs": rungs, "crossover": crossover}
