"""Collective bytes of the port's dry-run beside the JAX package's, pair by
pair, on the CPU.

    python3 scripts/dryrun_vs_jax.py [--out DIR] [--jobs N] [--paged]
                                     [ARCH:SHAPE ...]

For every baseline (arch, shape) pair (or those named): the JAX package's
dry-run record (``tests/_jax_dryrun_dump.py``: GSPMD's program compiled
for 256 host devices, loop-aware collective bytes from its HLO) and the
port's (``python -m repro_torch.launch.dryrun --device cpu``: DTensor's
program traced on fake tensors over a fake 256-rank process group), each
pair's port run in a process of its own, N at a time (default 6).  Prints
one line per pair: the global collective bytes by kind, port / JAX, the
ratio of the totals, and the port's roofline bottleneck; then the median
and the largest ratio.  ``--paged``: decode shapes run the paged
serving-engine step on both sides (the port's plain one: the kernels'
custom ops need the card's torch build).  Exits 1 if a record is not
"ok".  Both programs run on the host: neither needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pairs", nargs="*", help="ARCH:SHAPE (default: all)")
    ap.add_argument("--out", default=str(ROOT / "experiments" /
                                         "dryrun_vs_jax"))
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--paged", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import baseline_pairs
    pairs = ([tuple(p.split(":")) for p in args.pairs] if args.pairs
             else baseline_pairs()[0])
    out = Path(args.out)
    jax_dir, port_dir = out / "jax", out / "port"
    for d in (jax_dir, port_dir):
        d.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    subprocess.run([sys.executable, str(ROOT / "tests" /
                                        "_jax_dryrun_dump.py"),
                    str(jax_dir), *(["--paged"] if args.paged else []),
                    *(f"{a}:{s}" for a, s in pairs)],
                   env=env, check=True, capture_output=True)

    def port(pair):
        arch, shape = pair
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", arch, "--shape", shape, "--device", "cpu",
                        "--out", str(port_dir)]
                       + (["--paged"] if args.paged else []), env=env,
                       capture_output=True, timeout=1200)

    with ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(port, pairs))

    ok, ratios = True, []
    for arch, shape in pairs:
        name = f"{arch}_{shape}_pod16x16.json"
        recs = []
        for d in (port_dir, jax_dir):
            path = d / name
            recs.append(json.loads(path.read_text()) if path.exists()
                        else {"status": "missing"})
        if any(r["status"] != "ok" for r in recs):
            ok = False
            print(f"{arch} x {shape}: port {recs[0]['status']}, "
                  f"JAX {recs[1]['status']}")
            continue
        mine, theirs = (r["roofline"]["coll_detail"] for r in recs)
        ratio = mine["total"] / theirs["total"]
        ratios.append(ratio)
        kinds = ", ".join(f"{k} {mine[k]:.4g} / {theirs[k]:.4g}"
                          for k in KINDS)
        print(f"{arch} x {shape}: total {mine['total']:.4g} / "
              f"{theirs['total']:.4g} = {ratio:.3f} "
              f"(port bottleneck {recs[0]['roofline']['bottleneck']}); "
              f"{kinds}")
    if ratios:
        print(f"port / JAX collective bytes over {len(ratios)} pairs: "
              f"median {statistics.median(ratios):.3f}, "
              f"max {max(ratios):.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
