"""Haar-feature / weak-classifier / stage evaluation: the plain oracle.

Evaluators work over a list (or grid) of window origins ``(ys, xs)`` on
one pyramid level; ``ii`` is the padded SAT of
:func:`repro_torch.core.integral.integral_image` and may carry leading
batch dims.  The ordering is the reference oracle's
(``repro.core.features``): corners ``d - b - c + a``, all three rectangles
added in order even where a weight is 0, ``feat * inv_sigma / 576``, and
weak votes added in ascending k.  Given equal SAT and 1/sigma inputs it
gives the reference's bits.
"""

from __future__ import annotations

import torch

from .cascade import Cascade, WINDOW
from .integral import div_rn, rect_sum, window_inv_sigma

__all__ = ["eval_weak_classifier", "stage_sum_windows", "eval_stage",
           "run_cascade_windows"]

_AREA = float(WINDOW * WINDOW)


def eval_weak_classifier(cascade: Cascade, k: int, ii: torch.Tensor, ys, xs,
                         inv_sigma: torch.Tensor) -> torch.Tensor:
    """Vote of weak classifier ``k`` on each window (paper Eq. 1-2)."""
    rects = cascade.rect_xywh[k]
    w = cascade.rect_w[k]
    feat = torch.zeros(inv_sigma.shape, dtype=torch.float32,
                       device=inv_sigma.device)
    for r in range(rects.shape[0]):
        rx, ry, rw, rh = rects[r, 0], rects[r, 1], rects[r, 2], rects[r, 3]
        feat = feat + w[r] * rect_sum(ii, ys + ry, xs + rx, rh, rw)
    f_norm = div_rn(feat * inv_sigma, _AREA)
    return torch.where(f_norm < cascade.wc_threshold[k],
                       cascade.left_val[k], cascade.right_val[k])


def stage_sum_windows(cascade: Cascade, ii: torch.Tensor, ys, xs,
                      inv_sigma: torch.Tensor, k0: int, k1: int
                      ) -> torch.Tensor:
    """Sum of weak votes for classifiers ``[k0, k1)`` over each window."""
    acc = torch.zeros(inv_sigma.shape, dtype=torch.float32,
                      device=inv_sigma.device)
    for k in range(k0, k1):
        acc = acc + eval_weak_classifier(cascade, k, ii, ys, xs, inv_sigma)
    return acc


def eval_stage(cascade: Cascade, s: int, ii: torch.Tensor, ys, xs,
               inv_sigma: torch.Tensor) -> torch.Tensor:
    """Boolean pass mask of stage ``s`` for each window."""
    k0, k1 = cascade.bounds[s], cascade.bounds[s + 1]
    ss = stage_sum_windows(cascade, ii, ys, xs, inv_sigma, k0, k1)
    return ss >= cascade.stage_threshold[s]


def run_cascade_windows(cascade: Cascade, ii: torch.Tensor, ii_pair, ys, xs):
    """Full cascade over a window list: ``(accept_mask, exit_stage)``,
    every stage evaluated for every window (the semantic reference)."""
    inv_sigma = window_inv_sigma(ii_pair, ys, xs, WINDOW)
    alive = torch.ones(inv_sigma.shape, dtype=torch.bool,
                       device=inv_sigma.device)
    exit_stage = torch.full(inv_sigma.shape, cascade.n_stages,
                            dtype=torch.int32, device=inv_sigma.device)
    for s in range(cascade.n_stages):
        passed = eval_stage(cascade, s, ii, ys, xs, inv_sigma)
        exit_stage = torch.where(alive & ~passed, s, exit_stage)
        alive = alive & passed
    return alive, exit_stage
