"""The benchmark's layout: every cell's parts are found by name, the file
keeps to the contract's shapes, and a new configuration, traffic mix and
metric come in as new files and entries alone."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest
import torch

from cascade_bench import bench as benchlib
from cascade_bench import run as runmod

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_file_keeps_the_contracts_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cascade_bench/run.py"]
    assert BENCH["paths"] == ["cascade_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("cascade_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_by_name(workload):
    cell = benchlib.cell(BENCH, REPO, workload)
    assert cell["traffic"]["groups"]
    assert benchlib.reference(REPO, cell["config"]["reference"]).detect
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(benchlib.metric_reader(REPO, m["name"]))
    assert {m["name"] for m in cell["end_to_end"]} == {
        m["name"] for m in BENCH["end_to_end"]}
    assert cell["per_layer"], "every cell reports a per-layer metric"


def test_a_new_config_traffic_and_metric_need_only_new_files(tiny_root):
    root, bench = tiny_root
    folder = root / benchlib.FOLDER
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    (folder / "configs" / "throwaway.json").write_text(json.dumps({
        "name": "throwaway", "cascade": {"generator": "stumps", "seed": 3,
                                         "stage_sizes": [2, 3, 4]},
        "engine": {"mode": "wave", "step": 1, "scale_factor": 1.3,
                   "use_pallas": True, "pad_multiple": 32,
                   "tail_backend": "pallas", "dense_segments": [1, 1],
                   "compact_every": 1},
        "reference": "stump_cascade", "reduced": []}))
    (folder / "traffic" / "one_small.json").write_text(json.dumps({
        "groups": [{"h": 48, "w": 64, "per_flush": 2, "pool": 2,
                    "face_sizes": [24, 30]}], "faces_per_scene": 1}))
    (folder / "metrics" / "flushes_done.py").write_text(
        "def read(run):\n    return len(run.flush_s)\n")
    bench["configs"].append({"name": "throwaway", "source": "x",
                             "file": "cascade_bench/configs/throwaway.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "throwaway.one_small",
                               "config": "throwaway",
                               "traffic": "one_small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "flushes_done", "unit": "flushes",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["throwaway.one_small"]})
    res = runmod.run_cell(root, bench, "throwaway.one_small", 5, 0.2, False,
                          device="cpu")
    assert res["correct"] and res["metrics"]["flushes_done"]["value"] >= 1
    assert set(res["metrics"]) >= {"images_per_s", "flush_p95_ms",
                                   "setup_s", "flushes_done"}
    after = {p: p.read_bytes() for p in before}
    assert after == before, "no file that was there changed"
    other = benchlib.cell(bench, root, "tiny.t")
    assert "flushes_done" not in {m["name"] for m in other["end_to_end"]}


def test_the_command_fails_without_a_card_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    rc = runmod.main(["--workload", "vj25.vga_b16", "--seed", "1",
                      "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == "" and "CUDA" in out.err
