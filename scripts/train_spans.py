"""What a span of ``repro_torch.tracing`` costs, and where a training
step's device time goes by the program's own spans.

    python3 scripts/train_spans.py [--seed N] [--seconds S] [--cost-only]

First the cost of one span on the host: ``N_OFF`` spans with the profiler
off (``with tracing.span(name)``, and the attention's ``_span`` with its
shape), which must record nothing and create no CUDA event; then, under
``torch.profiler`` (CPU and CUDA activities), its parts ``N_ON`` times
each: the profiler range alone, and on the card making a timing event,
its first record (which creates the CUDA event), a later record, and
whole spans.  Then, unless ``--cost-only``, a traced run of the
benchmark's training cell (``qwen3-8b-8l.train`` by
``cardbench/drivers/train_step.py``, ``--seconds`` long): each span
name's calls a step (``tracing.counts()``, dropped spans included), its
host and device milliseconds a step, its self device time (its own less
its child spans', by each record's parent) and the share of its calls
made off the main thread (autograd's backward thread); the device time
of ``train.forward`` + ``train.backward`` + ``train.optimizer`` as a
share of the traced window's busy time; and the cell's per-layer
metrics.  Prints a line per reading and last one JSON object.  The
traced run needs a CUDA device; the cost runs anywhere.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch import tracing  # noqa: E402
from repro_torch.kernels.flash_attention import _span  # noqa: E402

N_OFF = 1_000_000
N_ON = 5_000
PHASES = ("train.forward", "train.backward", "train.optimizer")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def span_cost() -> dict:
    """Host microseconds per span, off and on."""
    made = [0]
    event = torch.cuda.Event

    def counted(*a, **k):
        made[0] += 1
        return event(*a, **k)

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    q = torch.zeros((2, 32, 8, 128), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 8, 8, 128), dtype=torch.bfloat16, device=dev)
    tracing.reset()
    torch.cuda.Event = counted
    try:
        t0 = time.perf_counter()
        for _ in range(N_OFF):
            with tracing.span("train.step"):
                pass
        t1 = time.perf_counter()
        for _ in range(N_OFF):
            with _span("attn.forward", q, k, True, 0):
                pass
        t2 = time.perf_counter()
    finally:
        torch.cuda.Event = event
    assert not tracing.records() and not tracing.counts() and not made[0]
    out = {"off_us": (t1 - t0) / N_OFF * 1e6,
           "off_attn_us": (t2 - t1) / N_OFF * 1e6}
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = dev == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def spans(rec):
        for _ in range(N_ON):
            with rec.span("train.step", {}):
                pass

    def ranges():
        for _ in range(N_ON):
            with record_function("train.step"):
                pass

    with profile(activities=acts):
        out["range_us"] = _us_each(ranges)
        if cuda:
            evs = []
            out["event_new_us"] = _us_each(lambda: evs.extend(
                torch.cuda.Event(enable_timing=True) for _ in range(N_ON)))
            out["event_first_record_us"] = _us_each(
                lambda: [e.record() for e in evs])
            out["event_record_us"] = _us_each(
                lambda: [e.record() for e in evs])
        rec = tracing.Recorder()
        out["span_us"] = _us_each(lambda: spans(rec))
    n = len(rec.records())
    assert n == N_ON, n
    return out


def _us_each(fn) -> float:
    """Host microseconds of ``fn`` over ``N_ON``."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) / N_ON * 1e6


def phase_split(seed: int, seconds: float) -> dict:
    from cardbench import manifest
    from cardbench.run import cache_env
    cache_env(ROOT)
    c = manifest.cell(manifest.load_manifest(ROOT), "qwen3-8b-8l.train")
    driver = manifest.load_module("drivers", c.driver)
    tracing.reset()
    res = driver.run(c, seed=seed, seconds=seconds, trace_on=True,
                     device="cuda", t_start=time.time())
    metrics = manifest.read_metrics(c, res["run"])
    recs = tracing.records()
    calls = tracing.counts()
    steps = calls["train.step"]
    child = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            child[r.parent] += r.device_s or 0.0
    main = threading.main_thread().ident
    by = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for r in recs:
        row = by[r.name]
        row[0] += r.host_s
        row[1] += r.device_s or 0.0
        row[2] += (r.device_s or 0.0) - child[r.id]
        row[3] += r.thread != main
    tr = res["run"]["trace"]
    phases = sum(by[p][1] for p in PHASES)
    table = {name: {"calls_per_step": calls[name] / steps,
                    "host_ms_per_step": 1e3 * h / steps,
                    "device_ms_per_step": 1e3 * d / steps,
                    "self_device_ms_per_step": 1e3 * own / steps,
                    "off_main_thread": off / calls[name]}
             for name, (h, d, own, off) in sorted(by.items())}
    for name, row in table.items():
        print(f"span {name}: {row['calls_per_step']:g} a step, host "
              f"{row['host_ms_per_step']:.3f} ms, device "
              f"{row['device_ms_per_step']:.3f} ms (self "
              f"{row['self_device_ms_per_step']:.3f}) a step, "
              f"{row['off_main_thread']:.0%} off the main thread")
    return {"steps": steps, "spans": table, "dropped": tracing.dropped(),
            "busy_s": tr["busy_s"], "window_s": tr["window_s"],
            "phases_device_s": phases,
            "phases_share_of_busy": phases / tr["busy_s"],
            "metrics": metrics, "numbers": res["numbers"],
            "train_tokens_per_s": res["e2e"]["train_tokens_per_s"],
            "setup_s": res["setup_s"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7000000001)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost-only", action="store_true")
    args = ap.parse_args()
    out = {"card": card_line(), "torch": torch.__version__}
    out["cost"] = span_cost()
    print("span cost (us): " + ", ".join(
        f"{k.removesuffix('_us')} {v:.4f}" for k, v in out["cost"].items()))
    if not args.cost_only:
        out["trace"] = phase_split(args.seed, args.seconds)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
