"""opslint CLI for the port: ``python -m repro_torch.analysis_static [paths...]``.

Exit status: 0 when clean (or when ``--fail-on-new`` finds nothing new
vs the baseline), 1 otherwise, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .core import Finding, load_baseline, load_project, save_baseline
from .engine import ALL_RULES, diff_against_baseline, run_project

DEFAULT_BASELINE = "opslint_torch_baseline.json"


def _emit(findings: List[Finding], fmt: str, stream=None) -> None:
    stream = stream or sys.stdout
    if fmt == "json":
        payload = {"findings": [f.to_json() for f in findings],
                   "count": len(findings)}
        print(json.dumps(payload, indent=2), file=stream)
    else:
        for f in findings:
            print(f.format_text(), file=stream)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="opslint",
        description="Static analysis for the PyTorch/CUDA port of the "
                    "OpSparse SpGEMM engine: sync-free steady paths, "
                    "donation discipline, lock order, host-int width, "
                    "kernel budgets.",
    )
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to lint "
                             "(default: src/repro_torch)")
    parser.add_argument("--baseline", default=None,
                        help="baseline JSON; with --fail-on-new, only "
                             "findings absent from it fail the run "
                             f"(default: {DEFAULT_BASELINE} if present)")
    parser.add_argument("--fail-on-new", action="store_true",
                        help="exit 1 only on findings not in the baseline")
    parser.add_argument("--write-baseline", metavar="PATH", default=None,
                        help="write the current findings as a new baseline "
                             "and exit 0")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        dest="fmt", help="output format (default: text)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run "
                             "(default: all)")
    parser.add_argument("--root", default=None,
                        help="project root for relative paths "
                             "(default: cwd)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(ALL_RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in ALL_RULES]
        if unknown:
            print(f"opslint: unknown rule id(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(f"opslint: no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    project = load_project(args.paths, root=args.root)
    findings = run_project(project, rules=rules)

    if args.write_baseline:
        save_baseline(findings, args.write_baseline)
        print(f"opslint: wrote {len(findings)} finding(s) to "
              f"{args.write_baseline}")
        return 0

    baseline_path = args.baseline
    if baseline_path is None and Path(DEFAULT_BASELINE).exists():
        baseline_path = DEFAULT_BASELINE

    if args.fail_on_new:
        baseline = load_baseline(baseline_path) if baseline_path else []
        new, fixed = diff_against_baseline(findings, baseline)
        _emit(new, args.fmt)
        if args.fmt == "text":
            label = f" vs baseline {baseline_path}" if baseline_path else ""
            print(f"opslint: {len(findings)} finding(s), {len(new)} new"
                  f"{label}, {len(fixed)} fixed")
            if fixed:
                print("opslint: baseline entries no longer found "
                      "(refresh with --write-baseline):")
                for f in fixed:
                    print(f"  {f.path}:{f.line}: {f.rule}")
        return 1 if new else 0

    _emit(findings, args.fmt)
    if args.fmt == "text":
        print(f"opslint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
