"""Where the tensor-core MLA split kernel's time goes, by ablation.

    python3 scripts/mla_ablate.py

Builds ``csrc/paged_attention.cu`` as committed ("base") and five copies
of it, each with a phase of ``paged_mma_kernel`` taken out by a text
edit (the script raises if the source moved):

  no_load    the q and K rows are not copied (the rows hold whatever
             shared memory held);
  no_scores  no score products (the scores stay 0);
  no_pv      no P.V products and no partial stores;
  no_store   the P.V products run, their partials are not stored;
  no_work    every block returns once it has read its table columns
             (what is left: the launch of 150 KB blocks, the table).

Every variant but "base" computes a wrong result: it is timed, never
checked.  Each library is handed to the wrapper in turn (``build.use``)
and the split kernel alone is timed at deepseek-v3's served decode shape
and at a full table, by device time under ``torch.profiler`` as
``chip_smoke.py`` phase 10b takes it, twice in the order base, no_load,
no_scores, no_pv, no_store, no_work.  Prints a line per time and last
one JSON object; gates nothing.  Needs an H100 and nvcc; about a minute.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.kernels.paged_attention import (             # noqa: E402
    paged_attention_fwd)

OUT = ROOT / "build" / "mla_ablate"
KERNEL = "__global__ void __launch_bounds__(kThreads, 1) paged_mma_kernel("
# variant: (text in paged_mma_kernel, its replacement), ...; ``qp`` is
# never -7, so ``qp == -7`` is a false the compiler cannot fold away
EDITS = {
    "base": (),
    "no_load": (("cp_async16(qs + (size_t)r * KS + e,",
                 "if (qp == -7) cp_async16(qs + (size_t)r * KS + e,"),
                ("cp_async16(dst,\n", "if (qp == -7) cp_async16(dst,\n")),
    "no_scores": (("for (int kk = 0; kk < QW / 16; ++kk) {",
                   "for (int kk = 0; kk < QW / 16 * (qp == -7); ++kk) {"),),
    "no_pv": (("for (int n0 = 0; n0 < Dv; n0 += 128) {",
               "for (int n0 = 0; n0 < Dv * (qp == -7); n0 += 128) {"),),
    "no_store": (("*reinterpret_cast<float2*>(r0 + nt * 8) =",
                  "if (qp == -7) *reinterpret_cast<float2*>(r0 + nt * 8) ="),
                 ("*reinterpret_cast<float2*>(r1 + nt * 8) =",
                  "if (qp == -7) *reinterpret_cast<float2*>(r1 + nt * 8) =")),
    "no_work": (("    return;  // an idle slot or a split with no column: "
                 "nothing to merge\n",
                 "    return;\n  if (qp != -7) return;\n"),),
}


def variant(src: str, edits) -> str:
    i = src.index(KERNEL)
    j = src.index("\n}\n", i)
    body = src[i:j]
    for old, new in edits:
        if old not in body:
            raise RuntimeError(f"mla_ablate: the kernel no longer has {old!r}")
        body = body.replace(old, new)
    return src[:i] + body + src[j:]


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_ablate: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    src = (build.CSRC / "paged_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        cu = OUT / f"paged_attention_{name}.cu"
        cu.write_text(variant(src, edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"ptxas {name}: " + "; ".join(
            f"{inst} {regs} regs {spill} B spilled"
            for inst, regs, _, spill, _ in cs.ptxas_summary(log)
            if "mma" in inst))
    cases = {"served": cs.mla_decode_case(torch.bfloat16),
             "full table": cs.mla_case(64, torch.bfloat16, seed=5)}
    out = {}
    for rep in range(2):
        for name in EDITS:
            build.use("paged_attention", OUT / f"lib{name}.so")
            for shape, c in cases.items():
                ms = cs.device_ms(
                    lambda i: cs.run_kernel(paged_attention_fwd, c,
                                            scale=cs.MLA_SCALE),
                    50, "paged_mma_kernel")
                out.setdefault(f"{name}, {shape}", []).append(ms)
                print(f"{name} at the {shape} shape: split kernel "
                      f"{ms * 1e3:.2f} us of device time")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
