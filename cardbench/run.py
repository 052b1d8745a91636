"""Run one cell once and print its result line.

    python3 -m cardbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's driver builds the program
(``src/repro_torch``) from the seed, warms it up (set-up), measures for
``--seconds``, and once the window has closed checks what the timed path
produced against the plain reference.  With ``--trace 0`` the result's
metrics are the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by its reader in ``metrics/``, and the
device's busy time from the profiler's trace.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``, each compared number beside its
limit (also the last lines on standard error).

Exits without a result: 2 when the card or the cell's number of cards is
missing, 3 when the program cannot be imported, 4 when JAX or the JAX
package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        boot = next(int(line.split()[1]) for line in
                    Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX by themselves."""
    base = root / "build" / "cardbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m cardbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    from cardbench import manifest
    c = manifest.cell(manifest.load_manifest(root), args.workload)
    cache_env(root)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"cardbench: {c.name} needs {c.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"cardbench: the program is not importable: {e}",
              file=sys.stderr)
        return 3
    print(f"cardbench: {c.name} seed {args.seed} on {card_line()}",
          file=sys.stderr)

    driver = manifest.load_module("drivers", c.driver)
    res = driver.run(c, seed=args.seed, seconds=args.seconds,
                     trace_on=bool(args.trace), device="cuda",
                     t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"cardbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    return emit(c, res, bool(args.trace), torch.cuda.get_device_name(0))


def metric_line(c, res: dict, trace_on: bool) -> dict:
    """The metrics of the result line: the end-to-end metrics, or with the
    trace the per-layer metrics by their readers."""
    from cardbench import manifest
    if trace_on:
        values = manifest.read_metrics(c, res["run"])
        units = {m["name"]: m["unit"] for m in c.per_layer}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        units = {m["name"]: m["unit"] for m in c.end_to_end}
        values = {k: v for k, v in values.items() if k in units}
    return {k: {"value": v, "unit": units[k]} for k, v in values.items()}


def emit(c, res: dict, trace_on: bool, kind: str) -> int:
    from cardbench import check, trace
    limits = c.workload["check"]["limits"]
    correct = check.verdict(res["numbers"], limits)
    device = {"platform": "gpu", "kind": kind, "count": c.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]),
            "metrics": metric_line(c, res, trace_on), "device": device}
    if trace_on:
        tr = res["run"].get("trace") or {}
        device["busy_s"] = tr.get("busy_s", 0.0)
        device["window_s"] = tr.get("window_s", 0.0)
        bd = trace.breakdown(tr)
        if bd:
            line["breakdown"] = bd
    line["check"] = check.report(res["numbers"], limits)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
