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
    :func:`repro_torch.kernels.packed_window.stage_sums`, one CUDA thread
    per lane looping the whole stage run.  The label is the reference's,
    so configs and plans stay equal to its own.

Out-of-range flat SAT indices clamp into the table, as
``jnp.take(mode="clip")`` does; valid lanes never produce one.  ``measure_rungs`` (the backend race) comes with the
calibration slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.cascade import Cascade, WINDOW
from repro_torch.core.integral import div_rn

__all__ = ["BACKENDS", "stage_sums", "select_backend"]

_AREA = float(WINDOW * WINDOW)

BACKENDS = ("gather", "bulk", "pallas")


def _lookup(ii_flat: torch.Tensor, img: torch.Tensor,
            flat: torch.Tensor) -> torch.Tensor:
    """``ii_flat[img, flat]`` read at the flat index ``img * S + flat``,
    clamped into the whole table (as ``jnp.take(mode="clip")`` and kernel
    C do)."""
    table = ii_flat.reshape(-1)
    return table[torch.clamp(img * ii_flat.shape[1] + flat, 0,
                             table.numel() - 1)]


def _bulk_stage_sum(cascade: Cascade, ii_flat, img, base, stride, ys, xs,
                    inv_sigma, k0: int, k1: int) -> torch.Tensor:
    """Stage sum with one (K, 3, cap) gather per rectangle corner; the
    same per-lane arithmetic as the ``gather`` backend."""
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

    area = g(y1, x1) - g(y0, x1) - g(y1, x0) + g(y0, x0)   # (K, 3, cap)
    feat = torch.zeros((area.shape[0], area.shape[2]), dtype=torch.float32,
                       device=area.device)
    for r in range(rects.shape[1]):
        feat = feat + w[:, r, None] * area[:, r]
    f_norm = div_rn(feat * inv_sigma[None, :], _AREA)
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
               *, backend: str = "bulk") -> torch.Tensor:
    """(s1 - s0, cap) vote sums for stages ``[s0, s1)`` over a packed list.

    One call per tail segment: the caller applies stage thresholds between
    rows.  The lane arrays are integer tensors of one length ``cap``.
    """
    if backend in ("pallas", "gather"):
        from . import packed_window
        fn = (packed_window.stage_sums if backend == "pallas"
              else packed_window.stage_sums_plain)
        return fn(cascade, s0, s1, ii_flat, img.int(), base.int(),
                  stride.int(), ys.int(), xs.int(), inv_sigma)
    if backend != "bulk":
        raise ValueError(f"unknown packed-tail backend: {backend!r} "
                         f"(expected one of {BACKENDS})")
    lanes = [t.long() for t in (img, base, stride, ys, xs)]
    b = cascade.bounds
    if s1 <= s0:
        return torch.zeros((0, inv_sigma.shape[0]), dtype=torch.float32,
                           device=inv_sigma.device)
    return torch.stack([_bulk_stage_sum(cascade, ii_flat, *lanes, inv_sigma,
                                        b[s], b[s + 1])
                        for s in range(s0, s1)])


def select_backend(config, n_windows: int) -> str:
    """Backend for a packed list of ``n_windows`` lanes under ``config``;
    delegates to the plan layer's one decision function."""
    from repro_torch.plan import select_backend as _select
    return _select(config, n_windows)
