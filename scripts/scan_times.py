"""Device times of the two scan kernels, ``rwkv_scan`` and ``mamba_scan``,
at their served shapes, for this checkout's sources and another tree's.

    python3 scripts/scan_times.py --old DIR

Builds ``csrc/rwkv_scan.cu`` and ``csrc/mamba_scan.cu`` of this checkout
("new") and of the checkout unpacked at DIR ("old", for example the
parent commit from ``git archive``) into libraries under
``build/scan_times/`` with the flags of ``repro_torch/kernels/build.py``,
all four builds at once, and prints each instance's ptxas line.  Then, in
the order old, new, new, old, it hands each variant to the port's
wrappers (``build.use``) and runs ``chip_smoke.py``'s checks of both
scans against their plain versions (phases 5 and 8) and their times at
the served decode and prefill shapes as phases 7 and 10 take them:
device time under ``torch.profiler``, and CUDA events around
back-to-back calls.  Prints a line per time and last one JSON object;
fails if a build or a check fails.  Needs an H100 and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build                     # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_fwd  # noqa: E402
from repro_torch.kernels.ref import (mamba_scan_ref,      # noqa: E402
                                     rwkv_scan_ref)
from repro_torch.kernels.rwkv_scan import rwkv_scan_fwd   # noqa: E402

OUT = ROOT / "build" / "scan_times"
KERNELS = {  # name: (fwd, plain, check phase, served case, args, state key,
    #               decode shape, prefill shape, bound)
    "rwkv_scan": (rwkv_scan_fwd, rwkv_scan_ref, cs.phase_rwkv_vs_plain,
                  cs.served_rwkv_case, cs.rwkv_args, "s0", cs.RWKV_DECODE,
                  cs.RWKV_PREFILL, cs.rwkv_bound),
    "mamba_scan": (mamba_scan_fwd, mamba_scan_ref, cs.phase_mamba_vs_plain,
                   cs.served_mamba_case, cs.mamba_args, "h0",
                   cs.MAMBA_DECODE, cs.MAMBA_PREFILL, cs.mamba_bound),
}


def start_build(tag: str, csrc: Path, name: str):
    out = OUT / tag / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
           str(csrc / f"{name}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def times(name: str) -> dict:
    fwd, ref, _, served, args, s_key, dec, pre, bound = KERNELS[name]
    out = {}
    for shape_name, shape, n_bufs, reps in (("decode", dec, 8, 400),
                                            ("prefill", pre, 2, 50)):
        ms, call_ms, _ = cs.time_scan(fwd, ref, f"{name}_kernel", served,
                                      args, s_key, shape, n_bufs, reps, 1)
        out[shape_name] = {"ms": ms, "call_ms": call_ms,
                           "bound_ms": bound(served(shape))[0]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    variants = {"new": build.CSRC,
                "old": opt.old / "src" / "repro_torch" / "kernels" / "csrc"}
    jobs = {(tag, name): start_build(tag, csrc, name)
            for tag, csrc in variants.items() for name in KERNELS}
    libs = {}
    for (tag, name), (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for {tag} {name}:\n{log}")
        print(f"ptxas {tag} {name}: " + "; ".join(
            f"{inst} {regs} regs {smem} B static smem {spill} B spilled "
            f"{stack} B stack" for inst, regs, smem, spill, stack
            in cs.ptxas_summary(log)))
        libs[tag, name] = path

    result = {"card": card, "runs": []}
    for tag in ("old", "new", "new", "old"):
        run = {"variant": tag}
        for name, (fwd, ref, check, *_rest) in KERNELS.items():
            build.use(name, libs[tag, name])
            print(f"{tag} {name}:")
            check(fwd, ref)
            run[name] = t = times(name)
            for s, v in t.items():
                print(f"{tag} {name} {s}: {v['ms'] * 1e3:.2f} us of device "
                      f"time, {v['call_ms'] * 1e3:.2f} us per call back to "
                      f"back, bound {v['bound_ms'] * 1e3:.2f} us")
        result["runs"].append(run)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
