"""The work a flush needs: operations and bytes of its head and its tail.

Written for this benchmark (it replaces the lane counts of
``chip_smoke.bound_ms``, which count what the port launched): everything is
counted from what these inputs need, as the plain reference finds it, and
never from the lanes, padding, tiles or kernels the program uses.

Operations (float32, outside the tensor cores):

- a pyramid level's three SATs: per valid level pixel the centring, the
  square and one add per table and direction (8);
- a window's 1/sigma: two window sums (3 each), two divisions, a square,
  a subtraction, a max, a root and a reciprocal (13);
- a stump on a window: per rectangle of non-zero weight three corner adds,
  the weight's product and its add (5), then the products by 1/sigma and
  by 1/576, the comparison and the vote's add (4);
- a stage on a window: its stumps and the comparison with its threshold.

A stage is counted over the windows that enter it (the reference's
per-stage survivors), not over every window: the work these inputs need.

Bytes, each input byte read once and each output byte written once:

- head: the image (4 per pixel) in; out the alive mask (1 per window) and,
  when a tail follows, the SAT the tail reads (4 per entry) and 1/sigma
  (4 per window);
- tail: the SAT (4 per entry) and the windows entering it (an index and
  1/sigma, 8 each) in; the accepted rects (16 each) out.
"""

from __future__ import annotations

import numpy as np

SAT_OPS = 8
INV_SIGMA_OPS = 13


def stage_ops(arrays: dict) -> np.ndarray:
    """Operations of each stage on one window."""
    rects = (np.asarray(arrays["rect_w"]) != 0).sum(axis=1)
    per_stump = 5 * rects + 4
    off = np.asarray(arrays["stage_offsets"], np.int64)
    return np.asarray([per_stump[off[s]:off[s + 1]].sum() + 1
                       for s in range(len(off) - 1)], np.float64)


def image_work(ref: dict, ops: np.ndarray, n_dense: int) -> dict:
    """Head and tail operations and bytes of one image, from its
    reference result (``entering``, ``windows``, ``pixels``,
    ``sat_entries``, ``image_pixels``, ``accepted``)."""
    entering = np.asarray(ref["entering"], np.float64)
    has_tail = n_dense < len(ops)
    head_ops = (SAT_OPS * ref["pixels"] + INV_SIGMA_OPS * ref["windows"]
                + float(entering[:n_dense] @ ops[:n_dense]))
    head_bytes = 4 * ref["image_pixels"] + ref["windows"]
    tail_ops = tail_bytes = 0.0
    if has_tail:
        head_bytes += 4 * ref["sat_entries"] + 4 * ref["windows"]
        tail_ops = float(entering[n_dense:] @ ops[n_dense:])
        tail_bytes = (4 * ref["sat_entries"] + 8 * entering[n_dense]
                      + 16 * ref["accepted"])
    return dict(head_ops=head_ops, head_bytes=float(head_bytes),
                tail_ops=tail_ops, tail_bytes=float(tail_bytes))


def least_s(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of operations over
    the float32 peak and bytes over the memory bandwidth."""
    return max(ops / peaks["fp32_flops_per_s"],
               nbytes / peaks["bytes_per_s"])
