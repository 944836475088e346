"""Tile and lane-block tables, copied from ``repro.kernels.autotune``.

Only the constants come across: the plan compiler resolves an empty
``EngineConfig.head_tile`` / ``lane_block`` to ``DEFAULT_TILE``, so the
port's plans carry the reference's tiles and stay equal to its plans.
The port's CUDA kernels choose their own thread-block shapes and ignore
these TPU tiles; a tile never changes a kernel's bits.  The racers
(``measure_head``, ``measure_lane_block``) come with the calibration
slice.
"""

from __future__ import annotations

__all__ = ["DEFAULT_TILE", "HEAD_TILE_CANDIDATES", "LANE_BLOCK_CANDIDATES"]

# repro: ignore[LANE_BLOCK] copy of the reference's tile, for equal plans
DEFAULT_TILE = (8, 128)

# repro: ignore[LANE_BLOCK] copy of the reference's table, for equal plans
HEAD_TILE_CANDIDATES = ((8, 128), (16, 128), (8, 256))

# repro: ignore[LANE_BLOCK] copy of the reference's table, for equal plans
LANE_BLOCK_CANDIDATES = ((8, 128), (16, 128), (8, 256))
