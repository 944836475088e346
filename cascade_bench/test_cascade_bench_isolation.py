"""What the benchmark loads and what its yardstick is made of: no JAX and
no JAX package in a run, a reference that takes nothing of the program,
and frozen copies equal to the port's originals."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from cascade_bench.frozen.scenes import render_scene
from cascade_bench.frozen.stumps import FIELDS, stump_cascade

REPO = Path(__file__).resolve().parents[1]
HERE = REPO / "cascade_bench"

RUN_AND_LIST = r"""
import json, sys
from pathlib import Path
root, bench = Path(sys.argv[1]), json.loads(Path(sys.argv[2]).read_text())
import cascade_bench.run as run
from cascade_bench import bench as benchlib, check, control, counts, energy
from cascade_bench import program, tracing, traffic
import cascade_bench.frozen.scenes, cascade_bench.frozen.stumps
for p in (root / "cascade_bench" / "metrics").glob("*.py"):
    benchlib.metric_reader(root, p.stem)
benchlib.reference(root, "stump_cascade")
res = run.run_cell(root, bench, "tiny.t", 11, 0.1, False, device="cpu")
print(json.dumps({"correct": res["correct"],
                  "forbidden": run.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    root, bench = tiny_root
    spec = root / "bench.json"
    spec.write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", RUN_AND_LIST, str(root),
                          str(spec)], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"]
    assert res["forbidden"] == []
    # compared by whole top-level names: the port's begins with "repro"
    assert "repro_torch" in res["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(res["top"])


def test_forbidden_modules_compares_whole_top_level_names():
    from cascade_bench import run
    port = ["repro_torch", "repro_torch.core", "reprox", "jaxtyping"]
    assert run.forbidden_modules(port) == []
    assert run.forbidden_modules(port + ["jax.numpy", "repro.core"]) == [
        "jax", "repro"]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0] if not node.level
                     else ".")
    return tops


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert files
    for f in files:
        assert _imports(f) <= {"__future__", "math", "numpy", "torch"}, f


def test_only_program_py_imports_the_program():
    for f in HERE.rglob("*.py"):
        if f.name.startswith("test_") or f.name == "conftest.py":
            continue
        tops = _imports(f)
        assert not {"jax", "jaxlib", "flax", "repro"} & tops, f
        assert "repro_torch" not in tops or f.name == "program.py", f


def test_frozen_generator_equals_the_ports():
    from repro_torch.core.cascade import PAPER_STAGE_SIZES, paper_shaped_cascade
    cfg = json.loads((HERE / "configs" / "vj-default-25x2913.json").read_text())
    assert cfg["cascade"]["stage_sizes"] == PAPER_STAGE_SIZES
    mine = stump_cascade(0, PAPER_STAGE_SIZES)
    theirs = paper_shaped_cascade(0).numpy()
    for f in FIELDS:
        assert np.array_equal(mine[f], theirs[f]), f


def test_frozen_renderer_equals_the_ports():
    from repro_torch.core.training.data import render_scene as port_scene
    for h, w, faces in ((48, 64, (24, 30)), (96, 80, (24, 60))):
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        img_a, boxes_a = render_scene(a, h, w, n_faces=3, face_sizes=faces)
        img_b, boxes_b = port_scene(b, h, w, n_faces=3, face_sizes=faces)
        assert np.array_equal(img_a, img_b) and np.array_equal(boxes_a,
                                                               boxes_b)
        assert a.random() == b.random()        # same draws consumed


def test_frozen_trained_cascade_is_the_ports_file():
    cfg = json.loads((HERE / "configs" / "synthface-v2-3x73.json").read_text())
    mine = (HERE / "configs" / cfg["cascade"]["npz"]).read_bytes()
    theirs = (REPO / "src" / "repro_torch" / "configs" / "pretrained"
              / "synthetic_face_v2.npz").read_bytes()
    assert hashlib.sha256(mine).hexdigest() == cfg["cascade"]["sha256"]
    assert hashlib.sha256(theirs).hexdigest() == cfg["cascade"]["sha256"]
    with np.load(HERE / "configs" / cfg["cascade"]["npz"]) as z:
        sizes = np.diff(z["stage_offsets"]).tolist()
    assert sizes == cfg["cascade"]["stage_sizes"]
