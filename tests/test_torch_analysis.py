"""repro_torch.analysis, the port's static gate: each rule catches its
seeded fixture and leaves its clean twin alone, the path-neutral fixtures
of the reference's gate give the reference's findings, every ``ROOTS`` row
names a def of the port, the port's own tree is clean, the package imports
nothing but the standard library, and the CLI keeps the reference's flags
and exit codes.  Nothing here imports the code the gate analyses."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import rule_ids as ref_rule_ids
from repro.analysis import run_analysis as ref_run_analysis
from repro_torch.analysis import main, rule_ids, run_analysis
from repro_torch.analysis.project import default_paths
from repro_torch.analysis.rules.trace_safety import ROOTS, resolve_qualname

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "fixtures" / "torch_analysis"
REF_FIX = REPO / "tests" / "fixtures" / "analysis"


def run(*paths, select=None):
    res = run_analysis([str(p) for p in paths], select=select)
    return res, sorted({f.rule for f in res.findings})


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """The module's one scan of the port's tree: the gate as
    ``chip_smoke.py`` runs it, with no paths, from the repository root.
    Returns its exit code and its JSON report."""
    report = tmp_path_factory.mktemp("gate") / "analysis.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         str(report)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    return out.returncode, json.loads(report.read_text()), out.stdout


# ------------------------------------------------------------ per-rule
# the port's fixtures, and the reference's path-neutral ones (under
# fixtures/analysis, named "../analysis/...")
@pytest.mark.parametrize("fixture,rule,n", [
    ("host_sync_bad", "HOST_SYNC", 8),
    ("trace_concrete_bad", "TRACE_CONCRETE", 3),
    ("trace_branch_bad", "TRACE_BRANCH", 3),
    ("jit_cache_bad.py", "JIT_CACHE", 3),
    ("kernel_oracle_bad", "KERNEL_REF_TWIN", 1),
    ("kernel_oracle_bad", "KERNEL_REF_TEST", 1),
    ("../analysis/dead_store_bad.py", "DEAD_STORE", 1),
    ("../analysis/tail_backend_bad.py", "TAIL_BACKEND", 2),
    ("../analysis/plan_geometry_bad.py", "PLAN_GEOMETRY", 1),
    ("../analysis/lane_block_bad.py", "LANE_BLOCK", 1),
    ("../analysis/deprecated_bad.py", "DEPRECATED_SURFACE", 3),
    # the reference's autotune.py is not the port's single home
    ("../analysis/lane_block_scope_ok", "LANE_BLOCK", 2),
    ("../analysis/suppressed_bad.py", "LANE_BLOCK", 1),
])
def test_rule_catches_seeded_fixture(fixture, rule, n):
    res, rules = run(FIX / fixture, select=[rule])
    assert rules == [rule]
    assert len(res.findings) == n, [f.render() for f in res.findings]
    for f in res.findings:
        assert f.line > 0 and f.col > 0 and f.render()


@pytest.mark.parametrize("fixture", [
    "host_sync_ok", "trace_ok", "jit_cache_ok.py", "kernel_oracle_ok",
    "lane_block_scope_ok", "plan_geometry_ok", "../analysis/dead_store_ok.py",
    "../analysis/tail_backend_ok.py", "../analysis/deprecated_ok.py",
])
def test_clean_twin_stays_clean(fixture):
    res, rules = run(FIX / fixture)
    assert res.findings == [], rules


def test_host_sync_names_each_sync_once():
    res, _ = run(FIX / "host_sync_bad", select=["HOST_SYNC"])
    msgs = [f.message.split(" in the streaming")[0] for f in res.findings]
    assert msgs == [".cpu()", ".tolist()", ".cpu()", '.to("cpu")',
                    "torch.cuda.synchronize()", ".synchronize()", ".item()",
                    "np.asarray(...)"]
    # the hot path's justified syncs are recognised; helpers.py is outside
    res, _ = run(FIX / "host_sync_ok", select=["HOST_SYNC"])
    assert [f.rule for f in res.suppressed] == ["HOST_SYNC"] * 2


def test_trace_concrete_names_cpu_and_tolist():
    res, _ = run(FIX / "trace_concrete_bad", select=["TRACE_CONCRETE"])
    whats = sorted(f.message.split(" on a tensor")[0] for f in res.findings)
    assert whats == ["`.cpu()`", "`.tolist()`", "`float()`"]
    # the helper's finding: taint reached it through the root's call
    assert any("`_scale`" in f.message for f in res.findings)


def test_kernel_oracle_reads_port_paths():
    res, _ = run(FIX / "kernel_oracle_bad")
    msgs = " ".join(f.message for f in res.findings)
    assert "alpha_sum_ref" in msgs and "beta_sum_ref" in msgs
    # the launch counters ops re-exports from .native are not kernels, and
    # a pair named only outside tests/test_torch_*.py does not count
    assert "launches" not in msgs
    assert all(f.path == "src/repro_torch/kernels/ops.py"
               for f in res.findings)


def test_jit_cache_flags_a_function_level_kernel_handle():
    res, _ = run(FIX / "jit_cache_bad.py", select=["JIT_CACHE"])
    assert [f.line for f in res.findings] == [11, 16, 20]
    assert "native.Kernel" in res.findings[2].message


# -------------------------------------------------- against the reference
def _triples(findings):
    return sorted((f.line, f.col, f.rule) for f in findings)


@pytest.mark.parametrize("fixture", [
    "dead_store_bad.py", "dead_store_ok.py", "deprecated_bad.py",
    "deprecated_ok.py", "tail_backend_bad.py", "tail_backend_ok.py",
    "plan_geometry_bad.py", "lane_block_bad.py",
])
def test_path_neutral_fixture_equals_reference(fixture):
    ref = ref_run_analysis([str(REF_FIX / fixture)])
    got = run_analysis([str(REF_FIX / fixture)])
    assert _triples(got.findings) == _triples(ref.findings)
    assert _triples(got.suppressed) == _triples(ref.suppressed)


@pytest.mark.parametrize("fixture", ["suppressed_ok.py", "suppressed_bad.py"])
def test_suppressed_fixture_equals_reference_with_port_marker(fixture,
                                                              tmp_path):
    text = (REF_FIX / fixture).read_text()
    assert "# repro: ignore[" in text
    port = tmp_path / fixture
    port.write_text(text.replace("# repro: ignore[", "# repro_torch: ignore["))
    ref = ref_run_analysis([str(REF_FIX / fixture)])
    got = run_analysis([str(port)])
    assert _triples(got.findings) == _triples(ref.findings)
    assert _triples(got.suppressed) == _triples(ref.suppressed)
    assert got.suppressed, "the rewritten marker must still suppress"
    # each gate sees only its own marker
    assert run_analysis([str(REF_FIX / fixture)]).suppressed == []
    assert ref_run_analysis([str(port)]).suppressed == []


def test_star_and_unknown_rules_are_suppress_findings(tmp_path):
    p = tmp_path / "snippet.py"
    p.write_text("X = 1  # repro_torch: ignore[*] everything\n"
                 "Y = 2  # repro_torch: ignore[NO_SUCH_RULE] because\n"
                 '"""docs quote `# repro_torch: ignore[RULE]` verbatim."""\n')
    res, rules = run(p)
    assert rules == ["SUPPRESS"]
    msgs = [f.message for f in res.findings]
    assert len(msgs) == 2
    assert "`*`" in msgs[0] and "NO_SUCH_RULE" in msgs[1]


# ----------------------------------------------------------------- ROOTS
# the reference's jax.jit / pallas_call sites, each of which ROOTS
# accounts for with a row
REF_ROOT_SITES = {
    "core/engine.py": (321, 328, 567),
    "core/features.py": (78,),
    "core/training/adaboost.py": (96, 142),
    "kernels/ops.py": (48, 65, 135, 152, 339, 354),
    "kernels/integral_image.py": (93,),
    "kernels/autotune.py": (125, 133, 179),
    "kernels/packed_tail.py": (289,),
    "stream/engine.py": (223, 274, 296, 463),
    "serve/serve_step.py": (58, 59),
    "launch/train.py": (45,),
    "launch/cells.py": (152,),
    "launch/dryrun.py": (45,),
}


def test_every_reference_root_site_has_a_row():
    sites = {r.site for r in ROOTS}
    want = {f"src/repro/{f}:{line}" for f, lines in REF_ROOT_SITES.items()
            for line in lines}
    assert want <= sites, sorted(want - sites)
    for site in sites:
        path, line = site.split(":")
        text = (REPO / path).read_text().splitlines()
        seg = "\n".join(text[int(line) - 1:int(line) + 1])
        assert "jit" in seg or "pallas" in seg or seg.startswith("def "), site


@pytest.mark.parametrize("row", ROOTS, ids=lambda r: r.site)
def test_roots_row_resolves_to_a_port_def(row):
    assert row.targets and row.why
    params: set = set()
    for target in row.targets:
        module, qual = target.split(":")
        path = REPO / "src" / Path(*module.split("."))
        path = path.with_suffix(".py")
        defs = resolve_qualname(ast.parse(path.read_text()), qual)
        assert defs, target
        for fn in defs:
            a = fn.args
            names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
            assert names & set(row.traced), (target, names)
            params |= names
    assert set(row.traced) <= params, set(row.traced) - params


# ------------------------------------------------------------ the tree
def test_port_tree_is_clean(port_tree):
    rc, doc, stdout = port_tree
    assert rc == 0 and doc["findings"] == [], stdout
    assert doc["files"] > 100
    assert doc["suppressed"], "expected the port's justified suppressions"
    rels = {f["path"] for f in doc["suppressed"]}
    assert "src/repro_torch/stream/video.py" in rels


def test_port_tree_default_paths_cover_the_port():
    rels = {p.relative_to(REPO).as_posix() for p in default_paths(REPO)}
    assert "src/repro_torch" in rels and "chip_smoke.py" in rels
    assert "tests/test_torch_analysis.py" in rels
    assert any(r.startswith("examples/torch_") for r in rels)
    assert any(r.startswith("scripts/port_") for r in rels)
    assert not any(r.startswith("src/repro/") for r in rels)


def test_no_port_file_reads_the_reference_tree():
    for f in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = f.read_text()
        assert "repro/configs" not in text, f
        assert 'parents[2] / "repro"' not in text, f


def test_import_is_stdlib_only():
    code = ("import sys, repro_torch.analysis, repro_torch.analysis.cli\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'numpy', 'jax',\n"
            "                                    'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "[]"


# ----------------------------------------------------------------- CLI
def test_cli_exit_codes_and_baseline(tmp_path, capsys):
    bad = str(REF_FIX / "lane_block_bad.py")
    assert main([bad]) == 1
    assert main([str(REF_FIX / "dead_store_ok.py")]) == 0
    base = tmp_path / "baseline.json"
    assert main([bad, "--write-baseline", str(base)]) == 0
    assert json.loads(base.read_text())["findings"]
    assert main([bad, "--baseline", str(base)]) == 0
    assert main([bad, "--select", "NOPE"]) == 2
    assert main([bad, "--baseline", str(tmp_path / "missing.json")]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert listed == sorted(ref_rule_ids()) == list(rule_ids())
    assert len(listed) == 11


def test_cli_without_a_port_tree_is_a_usage_error(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis"],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 2, out.stdout + out.stderr
