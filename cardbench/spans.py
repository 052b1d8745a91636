"""The program's own spans (``repro_torch.tracing``) as the per-layer
metrics read them.

The program records its spans only while torch's profiler runs, so in a
run of the benchmark they are the traced steps' spans.  Each carries its
device time (CUDA events on the stream it ran on) and its attrs.  A
program that records no spans, or none with a device time (the CPU),
gives every reader nothing to read.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from cardbench import flops


def timed(name: str) -> List[Tuple[dict, float]]:
    """(attrs, device seconds) of each recorded span ``name`` with a
    device time; [] where the program has no span recorder."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return [(r.attrs, r.device_s) for r in tracing.records()
            if r.name == name and r.device_s]


def share(spans: List[Tuple[dict, float]],
          bound: Callable[[dict], float]) -> Optional[float]:
    """Percent of their roofline: the least time of each span's work
    (``bound(attrs)``) over the spans' device time, both summed."""
    if not spans:
        return None
    return 100.0 * sum(bound(a) for a, _ in spans) / sum(t for _, t in spans)


def itemsize(attrs: dict) -> int:
    return 4 if attrs["dtype"] == "float32" else 2


def attn_fwd(attrs: dict) -> Tuple[float, float, float]:
    """``flops.flash_bound`` at an attention span's own shape: (seconds,
    bytes, flops).  Without the causal mask every query sees all T keys;
    a window without it is a mask the bound does not count, and raises."""
    a = attrs
    isz = itemsize(a)
    t, byts, fl = flops.flash_bound(a["B"], a["Hq"], a["Hkv"], a["S"],
                                    a["T"], a["D"], a["window"], isz)
    if a["causal"]:
        return t, byts, fl
    if a["window"] > 0:
        raise ValueError("a window without the causal mask")
    fl = a["B"] * a["Hq"] * a["S"] * a["T"] * 2 * 2 * a["D"]
    peak = flops.BF16_FLOPS if isz == 2 else flops.F32_FLOPS
    return max(byts / flops.HBM_BYTES_PER_S, fl / peak), byts, fl
