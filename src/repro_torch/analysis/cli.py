"""``python -m repro_torch.analysis`` — the port's static-analysis gate.

Usage (from the repository root)::

    python -m repro_torch.analysis                 # the port's tree
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis src/repro_torch --select HOST_SYNC
    python -m repro_torch.analysis --json ANALYSIS.json
    python -m repro_torch.analysis --baseline ANALYSIS.old.json

With no paths it scans :data:`~repro_torch.analysis.project.DEFAULT_GLOBS`
under the working directory: ``src/repro_torch``, ``tests/test_torch_*.py``,
``examples/torch_*.py``, ``scripts/port_*.py`` and ``chip_smoke.py``.

Exit codes: 0 = clean (no unsuppressed, non-baselined findings),
1 = findings, 2 = usage error.  Stdlib-only by design: it imports neither
``torch`` nor the code it analyses.
"""

from __future__ import annotations

import argparse
import sys

from .core import RULES
from .engine import run_analysis
from .project import default_paths
from .report import apply_baseline, load_baseline, render_text, write_json

__all__ = ["main"]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static analysis: trace-safety, host "
                    "syncs, plan-IR contracts, kernel-twin coverage, "
                    "deprecation hygiene, dead stores.")
    p.add_argument("paths", nargs="*",
                   help="files and/or directories to analyse (default: "
                        "the port's tree under the working directory)")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--json", metavar="PATH", dest="json_out",
                   help="also write the machine-readable report here")
    p.add_argument("--baseline", metavar="PATH",
                   help="previous --json report; findings already in it "
                        "are ignored (adopt-with-debt mode)")
    p.add_argument("--write-baseline", metavar="PATH",
                   help="write the current findings as a baseline and "
                        "exit 0")
    p.add_argument("--show-suppressed", action="store_true",
                   help="also print suppressed findings")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _list_rules() -> str:
    from . import rules as _rules            # noqa: F401  (registers rules)
    width = max(len(r) for r in RULES)
    return "\n".join(f"{rid.ljust(width)}  {RULES[rid].summary}"
                     for rid in sorted(RULES))


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        print(_list_rules())
        return 0
    select = ([r.strip() for r in args.select.split(",") if r.strip()]
              if args.select else None)
    paths = args.paths or default_paths()
    if not paths:
        print("error: no paths given and no port tree under the working "
              "directory", file=sys.stderr)
        return 2
    try:
        result = run_analysis(paths, select=select)
    except ValueError as e:                  # unknown rule id
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        write_json(result, args.write_baseline)
        print(f"baseline written: {args.write_baseline} "
              f"({len(result.findings)} finding(s))")
        return 0
    dropped = 0
    if args.baseline:
        try:
            dropped = apply_baseline(result, load_baseline(args.baseline))
        except (OSError, ValueError) as e:
            print(f"error: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
    if args.json_out:
        write_json(result, args.json_out)
    print(render_text(result, show_suppressed=args.show_suppressed))
    if dropped:
        print(f"({dropped} baselined finding(s) ignored)")
    return 1 if result.findings else 0
