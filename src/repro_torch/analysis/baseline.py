"""Checked-in baseline of grandfathered findings.

The analyzer fails the gate only on NEW violations: every finding is matched
against the baseline by ``(rule, path, symbol)`` — line numbers drift
too much to anchor on — with a per-key count, so adding a SECOND
violation next to a baselined one still fails.  Every entry carries a
one-line human justification (reviewed like code); entries that no
longer match anything are STALE and expire: ``--strict`` refuses them,
``--write-baseline`` drops them.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.core import Finding

BASELINE_NAME = ".repro-torch-lint-baseline.json"


@dataclass
class BaselineEntry:
    rule: str
    path: str
    symbol: str
    count: int
    justification: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.symbol)


@dataclass
class Baseline:
    entries: List[BaselineEntry] = field(default_factory=list)

    def by_key(self) -> Dict[Tuple[str, str, str], BaselineEntry]:
        return {e.key: e for e in self.entries}


def load_baseline(path: Path) -> Baseline:
    if not Path(path).exists():
        return Baseline()
    data = json.loads(Path(path).read_text())
    entries = [BaselineEntry(**e) for e in data.get("entries", [])]
    return Baseline(entries=entries)


def write_baseline(path: Path, findings: List[Finding],
                   old: Optional[Baseline] = None) -> Baseline:
    """Rewrite the baseline to exactly the CURRENT findings: new keys get
    a TODO justification (fill it in before committing), kept keys keep
    their justification, stale keys are dropped."""
    counts: Dict[Tuple[str, str, str], int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    prior = (old or Baseline()).by_key()
    entries = [
        BaselineEntry(rule=r, path=p, symbol=s, count=n,
                      justification=(prior[(r, p, s)].justification
                                     if (r, p, s) in prior
                                     else "TODO: justify this baseline"))
        for (r, p, s), n in sorted(counts.items())]
    blob = {"version": 1,
            "comment": "grandfathered repro-torch-lint findings; see "
                       "src/repro_torch/analysis/README.md",
            "entries": [asdict(e) for e in entries]}
    Path(path).write_text(json.dumps(blob, indent=2) + "\n")
    return Baseline(entries=entries)


def apply_baseline(findings: List[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], List[Finding],
                              List[BaselineEntry]]:
    """Split findings into (new, grandfathered) and report stale
    baseline entries (matched zero findings — the violation was fixed,
    so the entry must expire)."""
    remaining = {e.key: e.count for e in baseline.entries}
    matched = {e.key: 0 for e in baseline.entries}
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        if remaining.get(f.key, 0) > 0:
            remaining[f.key] -= 1
            matched[f.key] += 1
            old.append(f)
        else:
            new.append(f)
    stale = [e for e in baseline.entries if matched[e.key] == 0]
    return new, old, stale
