"""Block-shape tables and the kernel racers, ported from
``repro.kernels.autotune``.

The tables are the reference's: the plan compiler resolves an empty
``EngineConfig.head_tile`` / ``lane_block`` to ``DEFAULT_TILE``, so the
port's plans carry the reference's tiles and stay equal to its plans.

Two racers, both run by ``Detector.calibrated(tune_head=True)`` on the
profiled image at every pyramid level:

- :func:`measure_head` races the head tiles on the fused head (kernel S
  then kernel A) by device time, then the fused head against the split
  head the engine runs (kernel S, plain-torch 1/sigma, kernel B once per
  dense stage) per level by wall time; it gives ``head_tile`` and the
  ``head_rungs`` ladder.
- :func:`measure_lane_block` races the packed tail's lane blocks on kernel
  C; it gives ``lane_block``.

Kernel C takes its launch shape from the lane block (``lane_block = (r,
c)``: ``c`` threads per block, ``r`` lanes per thread; see
``packed_window.block_shape``), and kernels A and B theirs from the head
tile (``head_tile = (ty, tx)``: a block over ``ty x tx`` window origins;
see ``haar_stage.head_block_shape``), so both races time a different
launch per candidate.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["DEFAULT_TILE", "HEAD_TILE_CANDIDATES", "LANE_BLOCK_CANDIDATES",
           "measure_head", "measure_lane_block"]

# repro: ignore[LANE_BLOCK] copy of the reference's tile, for equal plans
DEFAULT_TILE = (8, 128)

# repro: ignore[LANE_BLOCK] copy of the reference's table, for equal plans
HEAD_TILE_CANDIDATES = ((8, 128), (16, 128), (8, 256))

# repro: ignore[LANE_BLOCK] copy of the reference's table, for equal plans
LANE_BLOCK_CANDIDATES = ((8, 128), (16, 128), (8, 256))


def _best_ms(fn, device: torch.device, repeats: int, inner: int) -> float:
    """Best-of-``repeats`` mean wall time (ms) over ``inner`` warm calls of
    ``fn()``; on the card the device is drained before every clock read."""
    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()                                     # warm-up outside the clock
    best = float("inf")
    for _ in range(repeats):
        drain()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        drain()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best * 1e3


# cycles of the sleep kernel that holds the device while the host queues a
# device-timed run (~2 ms on an H100), and the most it is doubled to
_SLEEP_CYCLES = 1 << 22
_MAX_SLEEP_CYCLES = 1 << 26


def _device_ms(fn, device: torch.device, repeats: int, inner: int) -> float:
    """Best-of-``repeats`` mean device time (ms) of ``inner`` warm calls of
    ``fn()``.  On the card: CUDA events around the calls, queued behind a
    sleep kernel so that the device runs them back to back and the host's
    launch time between them does not count (the sleep is doubled until
    the host has queued every call before it ends).  On the CPU: wall
    time, :func:`_best_ms`."""
    if device.type != "cuda":
        return _best_ms(fn, device, repeats, inner)
    fn()                                     # warm-up outside the clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles, best = _SLEEP_CYCLES, float("inf")
    with torch.cuda.device(device):
        for _ in range(repeats):
            while True:
                torch.cuda.synchronize(device)
                torch.cuda._sleep(cycles)
                start.record()
                for _ in range(inner):
                    fn()
                end.record()
                queued_ahead = not start.query()
                end.synchronize()
                if queued_ahead or cycles >= _MAX_SLEEP_CYCLES:
                    break
                cycles *= 2
            best = min(best, start.elapsed_time(end) / inner)
    return best


def _tile_label(tile) -> str:
    return f"{tile[0]}x{tile[1]}"


def measure_head(cascade, workload, *, n_dense: int,
                 candidates=HEAD_TILE_CANDIDATES, repeats: int = 2,
                 inner: int = 3) -> dict:
    """Race the head tiles, then the fused head against the split head, per
    pyramid level.

    ``workload`` is the calibrated ``(level_image, weight)`` list;
    ``n_dense`` the plan's dense-prefix stage count.  On the cascade's
    device, per level it first times the fused head launched in each
    candidate tile by device time (:func:`_device_ms`: a tile changes only
    the kernels' work, which the host's launch time would hide); the tile
    with the least total wins.  Then per level it times the split head
    (kernel B in the default tile, as the reference's) and the fused head
    in the winning tile by wall time (:func:`_best_ms`: the two heads also
    differ in the host work they launch).
    Returns the reference's schema::

        {"levels": [(h, w, n_windows), ...],
         "ms": {"split": [...], "fused": [...]},     # fused = winner tile
         "tile_ms": {"8x128": [...], ...},           # fused, per candidate
         "head_tiles": (ty, tx),                     # total-time winner
         "rungs": ((n_windows, mode), ...),          # ascending by windows
         "crossover": int}                           # smallest fused win, -1
    """
    from repro_torch.core.cascade import WINDOW
    from repro_torch.core.integral import window_inv_sigma
    from . import ops

    n_dense = min(int(n_dense), cascade.n_stages)
    if n_dense < 1:
        raise ValueError("measure_head needs at least one dense stage")
    device = cascade.rect_w.device
    candidates = tuple(tuple(c) for c in candidates)
    imgs = [torch.as_tensor(img, dtype=torch.float32, device=device)
            for img, _weight in workload]
    levels = [(h, w, (h - WINDOW + 1) * (w - WINDOW + 1))
              for h, w in (img.shape for img in imgs)]

    def fused_head(img, tile):
        return lambda: ops.fused_head(cascade, 0, n_dense, img, tile=tile)

    tile_ms = {_tile_label(c): [_device_ms(fused_head(img, c), device,
                                           repeats, inner) for img in imgs]
               for c in candidates}
    totals = [sum(tile_ms[_tile_label(c)]) for c in candidates]
    winner = candidates[int(np.argmin(totals))]

    split_ms: list[float] = []
    fused_ms: list[float] = []
    for img in imgs:
        h, w = img.shape
        gy = torch.arange(h - WINDOW + 1, device=device)[:, None]
        gx = torch.arange(w - WINDOW + 1, device=device)[None, :]

        def split_head(img=img, gy=gy, gx=gx):
            ii, ii2, iic = ops.sat_tables(img[None])
            inv = window_inv_sigma((ii2, iic), gy, gx, WINDOW)
            return [ops.dense_stage_sums_batch(cascade, s, ii, inv)
                    for s in range(n_dense)]

        split_ms.append(_best_ms(split_head, device, repeats, inner))
        fused_ms.append(_best_ms(fused_head(img, winner), device, repeats,
                                 inner))

    order = np.argsort([nwin for (_h, _w, nwin) in levels], kind="stable")
    rungs = tuple(
        (levels[i][2], "fused" if fused_ms[i] <= split_ms[i] else "split")
        for i in order)
    crossover = next((nw for nw, mode in rungs if mode == "fused"), -1)
    return {"levels": levels,
            "ms": {"split": split_ms, "fused": fused_ms},
            "tile_ms": tile_ms, "head_tiles": winner,
            "rungs": rungs, "crossover": crossover}


def measure_lane_block(cascade, workload=None, *, size: int = 2048,
                       candidates=LANE_BLOCK_CANDIDATES, repeats: int = 3,
                       inner: int = 5, seed: int = 0) -> dict:
    """Race packed-tail lane blocks at one packed-list size.

    Draws ``size`` lanes with ``packed_tail._build_workload``'s sampler and
    times kernel C (the ``"pallas"`` backend) evaluating the whole cascade
    launched in each candidate block.  ``size`` should be the calibrated
    tail crossover.  Returns
    ``{"size", "n_windows", "candidates", "ms", "lane_block"}``.
    """
    from . import packed_tail

    rng = np.random.default_rng(seed)
    if workload is None:
        workload = [(rng.integers(0, 255, (160, 160)).astype(np.float32),
                     1.0)]
    device = cascade.rect_w.device
    ii_flat, sample, n_windows = packed_tail._build_workload(workload, rng,
                                                             device)
    n_stages = cascade.n_stages
    candidates = tuple(tuple(c) for c in candidates)
    lanes = sample(int(size))
    ms = [_best_ms(lambda cand=cand: packed_tail.stage_sums(
        cascade, 0, n_stages, ii_flat, *lanes, backend="pallas",
        lane_block=cand), device, repeats, inner) for cand in candidates]
    winner = candidates[int(np.argmin(ms))]
    return {"size": int(size), "n_windows": int(n_windows),
            "candidates": [tuple(c) for c in candidates], "ms": ms,
            "lane_block": winner}
