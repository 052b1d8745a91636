"""The device trace of a traced run, reduced to what the per-layer
metrics read.

``start()`` / ``stop()`` bracket a window of the run with
``torch.profiler`` (CPU and CUDA activities) and a span named
``WINDOW`` on the profiler's own clock.  ``reduce`` takes from the
trace:

* every kernel's interval, and the time the device was busy as the
  UNION of those intervals inside the window (not a sum of kernel
  times, which double-counts overlap);
* the idle gaps, each labelled by the innermost host span the benchmark
  had open at the gap's middle (``HOST_SPANS``), else ``harness``;
* device time by kernel name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

WINDOW = "cardbench.trace_window"
HOST_SPANS = ("train_step",)


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    rf = record_function(WINDOW)
    rf.__enter__()
    return prof, rf


def stop(handle) -> dict:
    import torch
    prof, rf = handle
    torch.cuda.synchronize()
    rf.__exit__(None, None, None)
    prof.stop()
    return reduce(prof.events())


def _is_device(e) -> bool:
    import torch
    return e.device_type == torch.autograd.DeviceType.CUDA


def _is_kernel(e) -> bool:
    """Device activity: kernels, copies and sets, not the device-side
    copies of the benchmark's own annotations."""
    return (_is_device(e) and not getattr(e, "is_user_annotation", False)
            and e.name not in HOST_SPANS and e.name != WINDOW)


def union_length(intervals: List[Tuple[float, float]], lo: float,
                 hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Length of the union of ``intervals`` clipped to [lo, hi], and the
    gaps inside [lo, hi] that no interval covers."""
    busy, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def reduce(events) -> dict:
    """{"window_s", "busy_s", "kernels": [(name, start_us, end_us)],
    "by_kernel": {name: s}, "gaps": [(label, s)]}
    from a profiler's ``events()``; times in seconds."""
    window = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not window:
        return {}
    lo, hi = window[0].time_range.start, window[0].time_range.end
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if _is_kernel(e)]
    kernels = [k for k in kernels if k[2] > lo and k[1] < hi]
    busy, gaps = union_length([(a, b) for _, a, b in kernels], lo, hi)
    by_kernel: Dict[str, float] = {}
    for name, a, b in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) * 1e-6
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name in HOST_SPANS and not _is_device(e)
            and e.time_range.end > lo and e.time_range.start < hi]
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(s1 - s0, name) for name, s0, s1 in host if s0 <= mid <= s1]
        label = min(inside)[1] if inside else "harness"
        labelled.append((label, (b - a) * 1e-6))
    labelled.sort(key=lambda g: -g[1])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels, "by_kernel": by_kernel, "gaps": labelled}


def breakdown(tr: Optional[dict], n: int = 10) -> Optional[dict]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps by what the host was doing."""
    if not tr:
        return None
    ops = sorted(tr["by_kernel"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in tr["gaps"][:n]]}


def idle_share(tr: Optional[dict]) -> Optional[float]:
    """Percent of the traced window in which no kernel ran."""
    if not tr or not tr["kernels"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
