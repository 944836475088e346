"""Fixture: src/repro_torch/kernels/autotune.py is the single permitted
home of the tile / candidate-table literals."""

DEFAULT_TILE = (8, 128)
HEAD_TILE_CANDIDATES = ((8, 128), (16, 128), (8, 256))
