"""CLI for the port's repro-lint: ``python -m repro_torch.analysis``
(counterpart of ``repro/analysis/__main__.py``: the same flags, output and
exit codes).

Exit codes: 0 clean (or all findings baselined / not in --fail-on-new
mode), 1 new findings under ``--fail-on-new``, 2 usage/config error.

Typical invocations::

    PYTHONPATH=src python -m repro_torch.analysis                # report all
    PYTHONPATH=src python -m repro_torch.analysis --fail-on-new  # the gate
    PYTHONPATH=src python -m repro_torch.analysis --json         # machine
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch/kernels

Baseline workflow: a real finding that is understood-and-accepted gets an
entry in ``src/repro_torch/analysis/baseline.json`` with a mandatory
``reason``; the gate then only trips on *new* findings.  Stale entries (matching nothing)
are reported so the baseline shrinks as fixes land.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from .engine import (load_baseline, load_modules, run_passes,
                     split_against_baseline)
from .passes import REGISTRY


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: PyTorch-aware static analysis of the port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: <root>/src/"
                         "repro_torch)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from this file)")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: <root>/src/"
                         "repro_torch/analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file entirely")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 if any non-baselined finding exists")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable findings on stdout")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of pass names to run")
    args = ap.parse_args(argv)

    if args.root:
        root = pathlib.Path(args.root).resolve()
    else:
        # src/repro_torch/analysis/__main__.py -> repo root is 3 dirs up
        root = pathlib.Path(__file__).resolve().parents[3]
    paths = ([pathlib.Path(p) for p in args.paths] if args.paths
             else [root / "src" / "repro_torch"])
    for p in paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    passes = REGISTRY
    if args.passes:
        wanted = {w.strip() for w in args.passes.split(",")}
        unknown = wanted - {n for n, _ in REGISTRY}
        if unknown:
            print(f"error: unknown pass(es): {sorted(unknown)} "
                  f"(have: {[n for n, _ in REGISTRY]})", file=sys.stderr)
            return 2
        passes = [(n, f) for n, f in REGISTRY if n in wanted]

    ctx = load_modules(paths, root)
    findings = run_passes(ctx, passes)

    baseline_path = (pathlib.Path(args.baseline) if args.baseline
                     else root / "src" / "repro_torch" / "analysis"
                     / "baseline.json")
    entries = [] if args.no_baseline else load_baseline(baseline_path)
    new, suppressed, unused = split_against_baseline(findings, entries)

    if args.as_json:
        print(json.dumps({
            "new": [f.to_json() for f in new],
            "suppressed": [f.to_json() for f in suppressed],
            "stale_baseline_entries": unused,
            "modules_scanned": len(ctx.modules),
            "passes": [n for n, _ in passes],
        }, indent=2))
    else:
        for f in new:
            print(f.format())
        if suppressed:
            print(f"-- {len(suppressed)} finding(s) suppressed by "
                  f"{baseline_path.name}")
        for e in unused:
            print(f"-- stale baseline entry (matches nothing): "
                  f"[{e['rule']}] {e['path']}: {e.get('reason', '')}")
        print(f"repro-lint: {len(ctx.modules)} modules, "
              f"{len(passes)} passes, {len(new)} new / "
              f"{len(suppressed)} baselined finding(s)")

    if args.fail_on_new and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
