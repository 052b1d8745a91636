"""The numbers that decide ``correct``, and how they are printed.

Training: each check step's loss against the reference's (relative
gap), each leaf's first-gradient norm and each leaf's change after the
check's steps against the reference's: the gap between the two norms,
over the reference's norm of that leaf or of the median leaf, whichever
is larger, at the worst leaf.  Leaves whose reference gradient is under
``keep`` times the median leaf's move by round-off alone and are left
out of both.

Each number has its limit in the cell's file; a number above its limit,
or one that is missing or not finite, makes the run not correct.
"""
from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Optional


def kept_leaves(ref_grad1: Dict[str, float], keep: float):
    med = statistics.median(ref_grad1.values())
    return [n for n, g in ref_grad1.items() if g >= keep * med]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    if not prog:
        return float("inf")
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog.get(n, float("nan")) - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def train_numbers(prog: dict, ref: dict, keep: float) -> Dict[str, float]:
    names = kept_leaves(ref["grad1"], keep)
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(prog["grad1"], ref["grad1"], names),
            "delta_gap": leaf_gap(prog["delta"], ref["delta"], names)}


def verdict(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
            ) -> bool:
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not math.isfinite(v) or limit is None or v > limit:
            ok = False
    return ok


def report(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
           ) -> Dict[str, dict]:
    """Prints each number beside its limit as the last lines on standard
    error; returns them for the result line's last key."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v, "limit": limit}
        print(f"check {name}: {v!r} (limit {limit!r})", file=sys.stderr)
    return out
