"""Detection grouping — the equivalent of OpenCV's ``groupRectangles``.

Raw cascade output fires on many neighbouring windows/scales around a true
face; detections are clustered by rectangle similarity (union-find over an
eps-overlap predicate) and clusters with fewer than ``min_neighbors + 1``
members are discarded (OpenCV keeps a cluster iff its size is strictly
greater than ``groupThreshold``).  Host-side numpy: runs on the (small) set of accepted windows
after the device pipeline.

The pairwise similarity predicate is evaluated as one vectorized (N, N)
matrix; union-find then only walks the similar pairs, so grouping stays fast
when a batch flush hands back thousands of raw windows.
``group_rectangles_batch`` groups many images' detections in a single pass
(pairs are masked to identical batch ids), producing results identical to
per-image ``group_rectangles`` calls.
"""

from __future__ import annotations

import numpy as np

__all__ = ["group_rectangles", "group_rectangles_batch", "iou_matrix"]


def _similarity_matrix(rects: np.ndarray, eps: float) -> np.ndarray:
    """(N, N) bool: OpenCV's SimilarRects predicate, vectorized.

    delta = eps * (min(w_i, w_j) + min(h_i, h_j)) / 2 and all four edge
    deltas must be within it.
    """
    x, y, w, h = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    delta = eps * (np.minimum(w[:, None], w[None, :])
                   + np.minimum(h[:, None], h[None, :])) * 0.5
    return ((np.abs(x[:, None] - x[None, :]) <= delta)
            & (np.abs(y[:, None] - y[None, :]) <= delta)
            & (np.abs((x + w)[:, None] - (x + w)[None, :]) <= delta)
            & (np.abs((y + h)[:, None] - (y + h)[None, :]) <= delta))


def _cluster_roots(sim: np.ndarray) -> np.ndarray:
    """Union-find over the upper-triangle similar pairs -> root per rect."""
    n = sim.shape[0]
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in np.argwhere(np.triu(sim, 1)):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri
    return np.array([find(i) for i in range(n)])


def _cluster_means(rects: np.ndarray, roots: np.ndarray,
                   min_neighbors: int) -> np.ndarray:
    """Mean rect per kept cluster (OpenCV ``groupRectangles`` semantics: a
    cluster survives iff it has *more than* ``min_neighbors`` members, i.e.
    ``>= min_neighbors + 1``; with ``min_neighbors == 0`` every cluster —
    including singletons — is kept)."""
    out = []
    for root in np.unique(roots):
        members = rects[roots == root]
        if len(members) >= min_neighbors + 1:
            out.append(members.mean(axis=0))
    if not out:
        return np.zeros((0, 4), np.int32)
    return np.rint(np.stack(out)).astype(np.int32)


def group_rectangles(rects: np.ndarray, min_neighbors: int = 3,
                     eps: float = 0.2) -> np.ndarray:
    """Cluster (N, 4) [x, y, w, h] rects; return (M, 4) cluster means.

    Mirrors OpenCV semantics: clusters of size < min_neighbors+1 are kept
    only if min_neighbors == 0.
    """
    rects = np.asarray(rects, np.float64).reshape(-1, 4)
    if len(rects) == 0:
        return np.zeros((0, 4), np.int32)
    roots = _cluster_roots(_similarity_matrix(rects, eps))
    return _cluster_means(rects, roots, min_neighbors)


def group_rectangles_batch(rects: np.ndarray, batch_idx: np.ndarray,
                           n_batches: int | None = None,
                           min_neighbors: int = 3,
                           eps: float = 0.2) -> list[np.ndarray]:
    """Group many images' rects in one pass.

    ``rects``: (N, 4) concatenated detections; ``batch_idx``: (N,) image id
    per rect.  Returns one (M_b, 4) grouped array per image ``0..n_batches-1``
    — identical to calling :func:`group_rectangles` per image (rect order
    within an image must match the per-image call).
    """
    rects = np.asarray(rects, np.float64).reshape(-1, 4)
    batch_idx = np.asarray(batch_idx, np.int64).reshape(-1)
    if n_batches is None:
        n_batches = int(batch_idx.max()) + 1 if len(batch_idx) else 0
    if len(rects) == 0:
        return [np.zeros((0, 4), np.int32) for _ in range(n_batches)]
    sim = _similarity_matrix(rects, eps)
    sim &= batch_idx[:, None] == batch_idx[None, :]
    roots = _cluster_roots(sim)
    return [_cluster_means(rects[batch_idx == b], roots[batch_idx == b],
                           min_neighbors)
            for b in range(n_batches)]


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU between (N,4) and (M,4) [x,y,w,h] boxes (for eval)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ax1, ay1 = a[:, 0], a[:, 1]
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx1, by1 = b[:, 0], b[:, 1]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    ix = np.maximum(0, np.minimum(ax2[:, None], bx2[None]) -
                    np.maximum(ax1[:, None], bx1[None]))
    iy = np.maximum(0, np.minimum(ay2[:, None], by2[None]) -
                    np.maximum(ay1[:, None], by1[None]))
    inter = ix * iy
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None]
    return inter / np.maximum(area_a + area_b - inter, 1e-9)
