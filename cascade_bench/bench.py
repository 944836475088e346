"""Finds a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix or one
metric lives in a file of its own, found by name:

- ``BENCHMARK.json`` ``configs[].file``: the configuration (JSON);
- ``cascade_bench/traffic/<traffic>.json``: the traffic mix (JSON), read by
  :mod:`cascade_bench.traffic`;
- ``cascade_bench/metrics/<metric>.py``: one reader per metric, a function
  ``read(run)`` that returns the number or ``None`` when the run holds
  nothing to read;
- ``cascade_bench/reference/<reference>.py``: the plain reference a
  configuration names.

So a later change adds a configuration, a traffic mix or a metric as new
files and new ``BENCHMARK.json`` entries, and edits no file here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

# the benchmark's folder, relative to a checkout's root
FOLDER = Path(__file__).resolve().parent.name


def load(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, root: Path, workload: str) -> dict:
    """The workload entry with its configuration and traffic loaded, and
    the metrics it reports with ``--trace 0`` (``end_to_end``) and with
    ``--trace 1`` (``per_layer``)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(by_name)}")
    w = by_name[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / FOLDER / "traffic" / f"{w['traffic']}.json").read_text())

    def reported(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return dict(workload=w, config=config,
                config_dir=(root / cfg_entry["file"]).parent, traffic=traffic,
                end_to_end=reported(bench["end_to_end"]),
                per_layer=reported(bench["per_layer"]))


def metric_reader(root: Path, name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    return _module(root / FOLDER / "metrics" / f"{name}.py",
                   f"cascade_bench_metric_{name.replace('.', '_')}").read


def reference(root: Path, name: str):
    """The module ``reference/<name>.py``."""
    return _module(root / FOLDER / "reference" / f"{name}.py",
                   f"cascade_bench_reference_{name}")
