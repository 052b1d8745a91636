"""CLI: ``python -m repro_torch.analysis [--strict] [--only RULE] ...``.

Exit codes: 0 clean (no new findings; --strict also requires no stale
baseline entries and no parse errors), 1 violations, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.baseline import (BASELINE_NAME, apply_baseline,
                                           load_baseline, write_baseline)
from repro_torch.analysis.core import (DEFAULT_PATHS, RULES, repo_root,
                                       run_analysis)
from repro_torch.analysis.reporters import render


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="stdlib-ast static invariant checker for the PyTorch "
                    "port: kernel bindings, autograd, host syncs, "
                    "fallbacks, replay, allocator "
                    "(src/repro_torch/analysis/README.md)")
    p.add_argument("paths", nargs="*",
                   help=f"files/dirs/globs relative to --root "
                        f"(default: {' '.join(DEFAULT_PATHS)})")
    p.add_argument("--root", type=Path, default=None,
                   help="repo root (default: autodetected from the "
                        "installed package)")
    p.add_argument("--only", action="append", default=[],
                   help="run only these rule(s); repeatable or "
                        "comma-separated (e.g. --only GRAD001,KRN001)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--output", type=Path, default=None,
                   help="write the report here instead of stdout")
    p.add_argument("--baseline", type=Path, default=None,
                   help=f"baseline file (default: <root>/{BASELINE_NAME})")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite the baseline to the current findings "
                        "(keeps existing justifications, drops stale "
                        "entries) and exit 0")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding as new")
    p.add_argument("--strict", action="store_true",
                   help="also fail on stale baseline entries and parse "
                        "errors (gate mode)")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    only = [r for chunk in args.only for r in chunk.split(",") if r.strip()]

    if args.list_rules:
        import repro_torch.analysis.rules  # noqa: F401
        for rid, rule in sorted(RULES.items()):
            print(f"{rid}  {rule.title}\n    why: {rule.motivation}")
        return 0

    root = (args.root or repo_root()).resolve()
    try:
        report = run_analysis(root, paths=args.paths or None,
                              only=only or None)
    except ValueError as e:          # unknown --only rule
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or (root / BASELINE_NAME)
    if args.write_baseline:
        old = load_baseline(baseline_path)
        new_bl = write_baseline(baseline_path, report.findings, old)
        print(f"wrote {len(new_bl.entries)} baseline entr"
              f"{'y' if len(new_bl.entries) == 1 else 'ies'} to "
              f"{baseline_path}")
        todo = sum(1 for e in new_bl.entries
                   if e.justification.startswith("TODO"))
        if todo:
            print(f"note: {todo} entr{'y needs' if todo == 1 else 'ies need'}"
                  f" a one-line justification before commit")
        return 0

    baseline = load_baseline(baseline_path) if not args.no_baseline \
        else load_baseline(Path("/nonexistent"))
    new, old, stale = apply_baseline(report.findings, baseline)

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        render(args.format, report, new, old, stale, out)
    finally:
        if args.output:
            out.close()
            # logs still want the one-line summary on stdout
            print(f"repro-torch-lint: {len(new)} new finding(s), "
                  f"{len(old)} baselined, {len(stale)} stale; report at "
                  f"{args.output}")

    if new:
        return 1
    if args.strict and (stale or report.parse_errors):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
