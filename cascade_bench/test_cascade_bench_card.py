"""One short run of every cell on the card, as the benchmark's command runs
it (skips without a card)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "cascade_bench/run.py", "--workload", cell,
         "--seed", "4294967311", "--seconds", "2", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=360, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert "setup_s" in res["metrics"] or trace
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
