"""Readings for the correctness limits, on the chip at a cell's own size.

    python3 -m cardbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control] [--faults]

For each seed, in one process: the program's run through the cell's
driver (a short window) and its compared numbers against the plain
reference; with ``--control``, the control's numbers (the reference in
float8 put in the program's place); with ``--faults``, the fault planted
in the reference put in the program's place (half of each batch left
out; a state left unchanged reads 1 by its measure and needs no run).
One JSON line per seed and reading, each with the verdict that
``check.verdict`` gives its numbers under the cell's limits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from cardbench import check, manifest
from cardbench.run import cache_env
from cardbench.traffic import lm_batches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path.cwd()
    c = manifest.cell(manifest.load_manifest(root), args.workload)
    cache_env(root)
    sys.path.insert(0, str(root / "src"))
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(c, seed, args.seconds, args.control,
                             args.faults, args.device):
            print(json.dumps(line), flush=True)
    return 0


def readings(c, seed, seconds, control, faults, device):
    """The program's reading of ``seed``, then the control's and the
    fault's, each with its verdict under the cell's limits."""
    driver = manifest.load_module("drivers", c.driver)
    limits = c.workload["check"]["limits"]
    t = time.time()
    res = driver.run(c, seed=seed, seconds=seconds, trace_on=False,
                     device=device, t_start=t)
    yield {"seed": seed, "reading": "program", "numbers": res["numbers"],
           "correct": check.verdict(res["numbers"], limits),
           "e2e": res["e2e"], "setup_s": res["setup_s"],
           "s": time.time() - t}
    rows = lm_batches(c.mix, seed, c.workload["check"]["steps"],
                      c.config["port"]["vocab_size"])
    keep = c.workload["check"]["keep_below_median"]
    runs = ([("control", dict(lowp=True))] if control else []) + (
        [("half_batch", dict(half_batch=True))] if faults else [])
    for name, kw in runs:
        t = time.time()
        other = driver.reference(c, seed, device, rows, **kw)
        numbers = check.train_numbers(other, res["ref"], keep)
        yield {"seed": seed, "reading": name, "numbers": numbers,
               "correct": check.verdict(numbers, limits),
               "s": time.time() - t}


if __name__ == "__main__":
    raise SystemExit(main())
