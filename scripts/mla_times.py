"""The paged-decode kernel at MLA's shape (deepseek-v3-671b's absorbed
decode: 128 query heads over one latent head, D = Dv = 512, De = 64, the
latent pool as both K and V), on its own.

    python3 scripts/mla_times.py

Builds ``csrc/paged_attention.cu`` and prints the ptxas line of each
head-tiled instance (the tensor-core ``paged_mma_kernel``, the CUDA-core
``paged_tiled_kernel``, their ``paged_merge_kernel``).  Then it runs
``chip_smoke.py``'s checks at this shape (phase 2b: both instances
against the plain version and the split-K mirror, -1 columns, idle
slots) and its times at the served decode shape (phase 10b: device time
under ``torch.profiler`` beside the bounds, the plain version and SDPA),
and adds, at that shape and at a full table (8 slots x 64 columns), the
device time of the tensor-core split kernel and the merge apart, and of
the CUDA-core instance on the served shape in float32.
Prints a line per time and last one JSON object; fails if a check fails.
Needs an H100 and nvcc; about a minute of command time.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.kernels.paged_attention import (             # noqa: E402
    paged_attention_fwd)
from repro_torch.kernels.ref import paged_attention_ref       # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    build.load("paged_attention")
    print("ptxas paged_attention: " + "; ".join(
        f"{inst} {regs} regs {spill} B spilled"
        for inst, regs, _, spill, _ in cs.ptxas_summary(
            build.build_log("paged_attention") or "")
        if "split_kernel" not in inst))
    fwd, ref = paged_attention_fwd, paged_attention_ref
    out = {"errors": cs.phase_mla_vs_plain(fwd, ref),
           "served": cs.phase_mla_kernel_times(fwd, ref)}
    out["served"].pop("library_kernels")
    for shape, c in (("served", cs.mla_decode_case(torch.bfloat16)),
                     ("full table", cs.mla_case(64, torch.bfloat16, seed=5)),
                     ("served, float32",
                      cs.mla_decode_case(torch.float32))):
        t = out[f"{shape} ms"] = {}
        parts = (("CUDA-core", ("paged_tiled_kernel", "paged_merge_kernel")),)
        if c["q"].dtype == torch.bfloat16:
            parts = (("tensor-core", ("paged_mma_kernel",
                                      "paged_merge_kernel")),
                     ("tensor-core split kernel", "paged_mma_kernel"),
                     ("merge kernel", "paged_merge_kernel"))
        for name, kernels in parts:
            t[name] = cs.device_ms(
                lambda i: cs.run_kernel(fwd, c, scale=cs.MLA_SCALE), 50,
                kernels)
            print(f"{shape} ({int((c['table'] >= 0).sum())} of 8 x 64 "
                  f"columns): {name} {t[name] * 1e3:.2f} us of device time")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
