"""Text and JSON reporters over an analysis run + baseline split."""
from __future__ import annotations

import json
from dataclasses import asdict
from typing import List, Optional, TextIO

from repro_torch.analysis.baseline import BaselineEntry
from repro_torch.analysis.core import RULES, Finding, Report


def render_text(report: Report, new: List[Finding], old: List[Finding],
                stale: List[BaselineEntry], out: TextIO) -> None:
    for f in new:
        out.write(f.format() + "\n")
    if stale:
        out.write("\nstale baseline entries (violation fixed — remove "
                  "them or run --write-baseline):\n")
        for e in stale:
            out.write(f"  {e.rule} {e.path} [{e.symbol}] x{e.count} — "
                      f"{e.justification}\n")
    out.write(
        f"\nrepro-torch-lint: {report.files_scanned} file(s), "
        f"{len(new)} new finding(s), {len(old)} baselined, "
        f"{report.suppressed} suppressed, {len(stale)} stale baseline "
        f"entr{'y' if len(stale) == 1 else 'ies'}\n")
    for err in report.parse_errors:
        out.write(f"parse error: {err}\n")


def render_json(report: Report, new: List[Finding], old: List[Finding],
                stale: List[BaselineEntry], out: TextIO) -> None:
    blob = {
        "root": report.root,
        "files_scanned": report.files_scanned,
        "rules": {rid: {"title": r.title, "motivation": r.motivation}
                  for rid, r in sorted(RULES.items())},
        "summary": {
            "new": len(new),
            "baselined": len(old),
            "suppressed": report.suppressed,
            "stale_baseline": len(stale),
            "by_rule": report.by_rule(),
        },
        "findings": [dict(asdict(f), status="new") for f in new]
        + [dict(asdict(f), status="baselined") for f in old],
        "stale_baseline": [asdict(e) for e in stale],
        "parse_errors": report.parse_errors,
    }
    json.dump(blob, out, indent=2)
    out.write("\n")


def render(fmt: str, report: Report, new: List[Finding],
           old: List[Finding], stale: List[BaselineEntry],
           out: TextIO) -> None:
    if fmt == "json":
        render_json(report, new, old, stale, out)
    else:
        render_text(report, new, old, stale, out)
