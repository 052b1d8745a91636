"""Where the MLA split kernel's time goes: by ablation, and block by block
on the kernel's own clock.

    python3 scripts/mla_ablate.py
    python3 scripts/mla_ablate.py --timeline

Builds ``csrc/paged_attention.cu`` as committed ("base") and copies of
it, each changed by a text edit (the script raises if the text it edits
is not in the source exactly once):

  no_q         the q tile is not copied (the producer arrives on its
               barrier; the scores read whatever shared memory held);
  no_pages     no live page is copied (the producer arrives on each
               slot's barrier without a copy);
  no_scores    no score products (the scores stay 0);
  no_softmax   P is the masked scores themselves (no exp);
  fast_exp     P by ``__expf`` (the approximate exponential) in place of
               the IEEE ``expf``: what the accurate one costs;
  no_pv        no P.V products;
  no_store     the partials are not stored;
  store_evict_last  the partials' TMA stores carry an L2 evict-last hint
               (a right result);
  half_store   half of each partial is stored;
  l2_promotion_none  the TMA maps ask for no L2 promotion (a right
               result);
  no_work      every block returns once it has read its slot's q_pos
               (what is left: the launch).

Every variant but "base", "store_evict_last" and "l2_promotion_none"
computes a wrong result: it is timed, never checked.  Each library is handed to the wrapper in turn
(``build.use``) and the split kernel and the merge kernel are timed apart
at deepseek-v3's served decode shape and at a full table, by device
time under ``torch.profiler`` as ``chip_smoke.py`` phase 10b takes it,
twice, base first.

``--timeline`` instead builds one copy with ``%globaltimer`` stamps at
the kernel's phase boundaries (text edits as above; they write a
``__device__`` table of 64 stamps a block, read back by a C function the
copy adds), runs it once at each shape after five untimed calls, and
prints, for the three blocks that end last and the two that end first,
each phase's time from the kernel's earliest stamp, in us: start, q
issued, table read, pages issued (each producer warp), consumers handed
over, row masks ready, each warpgroup's score products started and done,
the row maxima exchanged, the exponentials done, P ready (both rounds),
P.V done, stored (each warpgroup).  The stamps cost a little time of
their own.

Prints a line per reading and last one JSON object; gates nothing.
Needs an H100 and nvcc; about two minutes (the timeline, one).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.kernels import paged_attention as PA         # noqa: E402

OUT = ROOT / "build" / "mla_ablate"
Q_LOAD = """      mbar_expect_tx(bar_q, MLA_NB * L::Q_CB);
      for (int cb = 0; cb < MLA_NB - 1; ++cb)
        tma_load_2d(sq + cb * L::Q_CB, &tm_q, bar_q, 64 * cb, head0);
      tma_load_2d(sq + (MLA_NB - 1) * L::Q_CB, &tm_qe, bar_q, 0, head0);
"""
PAGE_LOAD = """        mbar_expect_tx(full, MLA_NB * L::SLOT);
        for (int cb = 0; cb < MLA_NB - 1; ++cb)
          tma_load_3d(dst + cb * L::SLOTS_CB, &tm_k, full, 64 * cb, h, row);
        tma_load_3d(dst + (MLA_NB - 1) * L::SLOTS_CB, &tm_ke, full, 0, h,
                    row);
"""
# variant: (text, its replacement), ...; ``qp`` is never -7, so ``qp ==
# -7`` is a false the compiler cannot fold away
EDITS = {
    "base": (),
    "no_q": ((Q_LOAD, "      if (qp == -7) {\n" + Q_LOAD
              + "      } else mbar_arrive(bar_q);\n"),),
    "no_pages": ((PAGE_LOAD, "        if (qp == -7) {\n" + PAGE_LOAD
                  + "        } else mbar_arrive(full);\n"),),
    "no_scores": (("  for (int ks = 0; ks < MLA_NB * 4; ++ks) {",
                   "  for (int ks = 0; ks < MLA_NB * 4 * (qp == -7); "
                   "++ks) {"),),
    "no_softmax": (("      pv[e] = y > kNegInf ? expf(y - (e < 2 ? M0 : M1)) "
                    ": 0.f;", "      pv[e] = y;"),),
    "fast_exp": (("      pv[e] = y > kNegInf ? expf(y - (e < 2 ? M0 : M1)) "
                  ": 0.f;", "      pv[e] = y > kNegInf ? __expf(y - (e < 2 ? "
                  "M0 : M1)) : 0.f;"),),
    "no_pv": (("      wgmma_ss_n256(acc,", "      if (qp == -7) wgmma_ss_n256(acc,"),),
    "no_store": (("        tma_store_3d(&tm_part,",
                  "        if (qp == -7) tma_store_3d(&tm_part,"),
                 ("  if (wg == 0 && (lane & 3) == 0) {\n    const int PM",
                  "  if (wg == 0 && (lane & 3) == 0 && qp == -7) {\n"
                  "    const int PM")),
    "store_evict_last": ((
        '      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"\n'
        '      " [%0, {%2, %3, %4}], [%1];\\n" ::',
        '      "{\\n.reg .b64 pol;\\ncreatepolicy.fractional.L2::evict_last'
        '.b64 pol, 1.0;\\n"\n'
        '      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group'
        '.L2::cache_hint"\n'
        '      " [%0, {%2, %3, %4}], [%1], pol;\\n}\\n" ::'),),
    "half_store": (("      for (int j = 0; j < MLA_NW / 32; ++j)",
                    "      for (int j = 0; j < MLA_NW / 64; ++j)"),),
    "l2_promotion_none": (("CU_TENSOR_MAP_L2_PROMOTION_L2_256B",
                           "CU_TENSOR_MAP_L2_PROMOTION_NONE"),),
    "no_work": (("  if (qp < 0) return;                        // an idle",
                 "  if (qp != -7) return;                        // an idle"),),
}


# the stamps of --timeline: (text, its replacement); stamp i of block
# (x, y) goes to slot 64 (y * gridDim.x + x) + i, slot 63 the live pages
STAMPS = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long g_stamp[256 * 64];\n"
     "#define STAMP(i) asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"("
     "g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 64 + (i)]))\n"),
    ("  if (qp < 0) return;                        // an idle slot: nothing"
     " to merge\n",
     "  if (qp < 0) return;                        // an idle slot: nothing"
     " to merge\n  if (tid == 0) STAMP(0);\n"),
    ("      tma_load_2d(sq + (MLA_NB - 1) * L::Q_CB, &tm_qe, bar_q, 0, head0);"
     "\n    }\n",
     "      tma_load_2d(sq + (MLA_NB - 1) * L::Q_CB, &tm_qe, bar_q, 0, head0);"
     "\n      STAMP(20);\n    }\n"),
    ("    const int n_live = lst[PPS];\n    // the live list and the barriers",
     "    const int n_live = lst[PPS];\n    if (pt == 0) STAMP(21);\n"
     "    // the live list and the barriers"),
    ("                    row);\n      }\n    }\n",
     "                    row);\n      }\n      STAMP(22 + pw);\n    }\n"),
    ("  if (n_live == 0) return;                   // no live column: no "
     "partial\n",
     "  if (n_live == 0) return;                   // no live column: no "
     "partial\n  if (tid == 0) { STAMP(1); g_stamp[(blockIdx.y * gridDim.x"
     " + blockIdx.x) * 64 + 63] = n_live; }\n"),
    ('  asm volatile("bar.sync 2, %0;\\n" ::"n"(MLA_THREADS) : "memory");\n',
     '  asm volatile("bar.sync 2, %0;\\n" ::"n"(MLA_THREADS) : "memory");\n'
     "  if (tid == 0) STAMP(2);\n"),
    ("  fence_regs(s);\n  wgmma_fence();\n#pragma unroll\n  for (int ks",
     "  if (tid == 0) STAMP(3);\n  if (tid == 128) STAMP(13);\n"
     "  fence_regs(s);\n  wgmma_fence();\n#pragma unroll\n  for (int ks"),
    ("  wgmma_commit();\n  wgmma_wait<0>();\n  fence_regs(s);\n",
     "  wgmma_commit();\n  wgmma_wait<0>();\n  fence_regs(s);\n"
     "  if (tid == 0) STAMP(4);\n  if (tid == 128) STAMP(14);\n"),
    ("  consumers_sync(3);                  // both have scored: q is free\n",
     "  consumers_sync(3);                  // both have scored: q is free\n"
     "  if (tid == 0) STAMP(5);\n"),
    ("  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);\n",
     "  if (tid == 0) STAMP(10);\n"
     "  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);\n"),
    ("    consumers_sync(r == 0 ? 4 : 8);\n",
     "    consumers_sync(r == 0 ? 4 : 8);\n"
     "    if (tid == 0) STAMP(r == 0 ? 6 : 12);\n"),
    ("  wgmma_wait<0>();\n  fence_regs(acc);\n",
     "  wgmma_wait<0>();\n  fence_regs(acc);\n  if (tid == 0) STAMP(7);\n"),
    ("    my_part[PL + g1] = rowsum[g1] + rowsum[MLA_TH + g1];\n  }\n}\n",
     "    my_part[PL + g1] = rowsum[g1] + rowsum[MLA_TH + g1];\n  }\n"
     "  if (tid == 0) STAMP(8);\n  if (tid == 128) STAMP(9);\n}\n"),
    ('extern "C" {\n',
     'extern "C" {\nint mla_stamps(void* dst, int clear) {\n'
     "  static unsigned long long zero[256 * 64];\n"
     "  return clear ? (int)cudaMemcpyToSymbol(g_stamp, zero, sizeof(zero))\n"
     "               : (int)cudaMemcpyFromSymbol(dst, g_stamp,"
     " sizeof(g_stamp));\n}\n"),
)
PHASES = ((0, "start"), (20, "q issued"), (21, "table"), (22, "pages w0"),
          (23, "pages w1"), (24, "pages w2"), (25, "pages w3"),
          (1, "handed over"), (2, "masks"), (3, "S0 start"), (13, "S1 start"),
          (4, "S0 done"), (14, "S1 done"), (5, "maxima"), (10, "exp done"),
          (6, "P0 ready"), (12, "P1 ready"), (7, "PV done"), (8, "stored0"),
          (9, "stored1"))


def variant(src: str, name: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"mla_ablate {name}: the source holds "
                               f"{src.count(old)} of {old[:60]!r}, not 1")
        src = src.replace(old, new)
    return src


def timeline(src: str, cases) -> dict:
    """Build the stamped copy, run it once a shape, print and return the
    blocks' phases (us from the kernel's first stamp)."""
    cu = OUT / "paged_attention_timeline.cu"
    cu.write_text(variant(src, "timeline", STAMPS))
    so = OUT / "libtimeline.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the timeline:\n{proc.stdout}")
    build.use("paged_attention", so)
    lib = ctypes.CDLL(str(so))
    out = {}
    for shape, c in cases.items():
        for _ in range(5):
            cs.run_kernel(PA.paged_attention_fwd, c, scale=cs.MLA_SCALE)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (256 * 64))()
        lib.mla_stamps(buf, 1)
        cs.run_kernel(PA.paged_attention_fwd, c, scale=cs.MLA_SCALE)
        torch.cuda.synchronize()
        lib.mla_stamps(buf, 0)
        rows = [list(buf[i * 64:(i + 1) * 64]) for i in range(256)]
        live = [r for r in rows if r[63] > 0 and r[0] > 0]
        t0 = min(r[0] for r in rows if r[0] > 0)
        live.sort(key=lambda r: -max(r[8], r[9]))
        blocks = []
        for r in live[:3] + live[-2:]:
            ph = {name: (r[i] - t0) / 1e3 for i, name in PHASES if r[i]}
            blocks.append({"live pages": r[63], **ph})
            print(f"{shape}: {r[63]} live pages: " + ", ".join(
                f"{name} {t:.2f}" for name, t in ph.items()))
        out[shape] = {"live blocks": len(live), "blocks": blocks}
        print(f"{shape}: {len(live)} live blocks")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeline", action="store_true")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_ablate: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    src = (build.CSRC / "paged_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    cases = {"served": cs.mla_decode_case(torch.bfloat16),
             "full table": cs.mla_case(64, torch.bfloat16, seed=5)}
    if opt.timeline:
        print(json.dumps(timeline(src, cases)))
        return 0
    procs = {}
    for name, edits in EDITS.items():
        cu = OUT / f"paged_attention_{name}.cu"
        cu.write_text(variant(src, name, edits))
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
            if "mla" in inst) + "".join(
            f"; {line.strip()}" for line in log.splitlines() if "(C7" in line))
    out = {}
    for rep in range(2):
        for name in EDITS:
            build.use("paged_attention", OUT / f"lib{name}.so")
            for shape, c in cases.items():
                t = {k: cs.device_ms(
                    lambda i: cs.run_kernel(PA.paged_attention_fwd, c,
                                            scale=cs.MLA_SCALE), 50, k)
                     for k in cs.MLA_KERNELS}
                out.setdefault(f"{name}, {shape}", []).append(t)
                print(f"{name} at the {shape} shape: split kernel "
                      f"{t[cs.MLA_KERNELS[0]] * 1e3:.2f} us, merge "
                      f"{t[cs.MLA_KERNELS[1]] * 1e3:.2f} us of device time")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
