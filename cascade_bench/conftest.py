"""Test settings of the benchmark's own CPU tests (``pytest cascade_bench``).

The repo's ``tests/conftest.py`` does not reach this folder, so the card
marker is registered here too.  ``tiny_root`` is a throwaway checkout: a
copy of the benchmark's folder with a ``BENCHMARK.json`` that adds a tiny
cell (the trained cascade on a few small scenes in two shape buckets), so
a whole run fits a CPU test.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# the program under test, as tests/conftest.py puts it on the path
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

TINY_TRAFFIC = {
    "groups": [
        {"h": 60, "w": 80, "per_flush": 2, "pool": 3, "face_sizes": [24, 40]},
        {"h": 40, "w": 44, "per_flush": 1, "pool": 2, "face_sizes": [24, 30]},
    ],
    "faces_per_scene": 1,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no CPU "
        "mode); skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    """``(root, bench)`` of a throwaway checkout holding the tiny cell
    ``tiny.t``."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / HERE.name / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "synthface-v2-3x73", "source": "test",
                             "file": "cascade_bench/configs/"
                                     "synthface-v2-3x73.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.t", "config": "synthface-v2-3x73",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench
