"""The two head-dim-256 kernel instances of gemma3-12b, this checkout's
against another tree's: flash attention's forward at the training shapes
and paged decode at the serving shapes.

    python3 scripts/d256_times.py --old DIR [--step0 [SEED ...]]
    python3 scripts/d256_times.py --ablate

Builds ``csrc/flash_attention.cu`` and ``csrc/paged_attention.cu`` of
this checkout ("new") and of the checkout unpacked at DIR ("old", for
example the parent commit from ``git archive``) with the flags of
``repro_torch/kernels/build.py``, and a third flash library ("p1"): this
checkout's source with the D = 256 instance's P rounded once to bf16
instead of as hi + lo (a text edit, as the variants below); all five
builds at once.  Prints each instance's ptxas line.  Then, in the order
old, new, p1, p1, new, old, one process per turn imports that tree's
package and ``chip_smoke.py`` and runs their checks at gemma3's shapes
(phase 2c: paged decode against its plain version and split-K mirror,
-1 columns, idle slots; phase 11's gemma3 rows: flash output and lse
against the plain version in bf16 and f32) and their timings (phase
10c: paged decode at the ring and table shapes, device time under
``torch.profiler`` and CUDA events, SDPA on the gathered K/V in the same
process; phase 13b: flash with the window and causal, the same, SDPA's
backend named; and the D <= 128 rows as yardsticks: flash at qwen3-8b's
training shape, phase 13, and paged decode at qwen3-8b's served shape,
phase 4).  A "p1" turn runs the new tree with the p1 flash library.

``--step0`` then reads phase 12c's step 0 (gemma3-12b, 6 of 48 layers,
B 2 x S 4096, remat) through the new flash kernel with P as hi + lo and
with P once, beside the plain path with its kv chunk halved (the
rounding floor), relative to the plain path, on seeds 0-3 (or those
given), as ``scripts/step0_spread.py`` reads seeds: seed s draws the
weights with ``init_params(s)`` and takes batch s.

``--ablate`` instead asks where the two instances' time goes: it builds
this checkout's two sources as committed ("base") and copies with one
phase of the D = 256 flash instance (``flash_fwd_tc_kernel<256, 64>``)
or of the wide-head paged instance (``paged_wide_kernel``) taken out by
a text edit (the script raises if the source moved):

  flash p1          P rounded once to bf16: right within the bf16
                    tolerance, not the step-0 one;
  flash no_pv       no P.V products;
  flash no_qk       no Q.K^T products (the scores are whatever the
                    registers held);
  flash no_softmax  no online softmax (P = the raw scores);
  flash no_load     K and V are loaded for the first two tiles only; the
                    producer then only arrives on the tiles' barriers;
  paged no_compute  pages are copied and waited for, never scored;
  paged no_merge    the last split does not merge (run last: its blocks
                    leave the split counters unreset).

Every variant but "base" and "p1" computes a wrong result: it is timed,
never checked.  Each library is handed to the wrapper in turn
(``build.use``) and timed at gemma3-12b's shapes by device time under
``torch.profiler``, as phases 13b (flash: B 2, Hq 16, Hkv 8, S 4096,
window 1024 and causal) and 10c (paged decode: the full 64-column ring
and the 128-column table) take it; base runs first and again last.

Prints a line per reading and last one JSON object; fails if a build or
a check fails.  Needs an H100 and nvcc.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("flash_attention", "paged_attention")
OUT = ROOT / "build" / "d256_times"

# Variants of a source: (text, its replacement, the times the text occurs)
# for each edit; ``DP != 256`` keeps the D <= 128 flash instances as
# committed
P1 = (("          pl[kk][e] = pack_bf16(",
       "          if (DP != 256) pl[kk][e] = pack_bf16(", 1),
      ("        wgmma_rs<DP>(acc, pl[kk], dv);\n",
       "        if (DP != 256) wgmma_rs<DP>(acc, pl[kk], dv);\n", 1),
      ("fence_regs(pl);", "if (DP != 256) fence_regs(pl);", 3))
K_LOAD = """        mbar_expect_tx(kb, L::TILE_BYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load_3d(sk + st * L::TILE_BYTES + c * BK * 128, &tm_k, kb,
                      c * 64, kv0, kvh);"""
V_LOAD = """        mbar_expect_tx(vb, L::TILE_BYTES);
        for (int c = 0; c < L::NB; ++c)
          tma_load_3d(sv + st * L::TILE_BYTES + c * BK * 128, &tm_v, vb,
                      c * 64, kv0, kvh);"""
PV = ("        wgmma_rs<DP>(acc, p[kk], dv);\n"
      "        wgmma_rs<DP>(acc, pl[kk], dv);\n")
FLASH = {
    "base": (),
    "p1": P1,
    "no_pv": ((PV, PV.replace("        wgmma_rs",
                              "        if (DP != 256) wgmma_rs"), 1),),
    "no_qk": (("        wgmma_ss<BK>(s,",
               "        if (DP != 256) wgmma_ss<BK>(s,", 1),),
    "no_softmax": (("        softmax(it, alpha0, alpha1);\n",
                    "        if (DP != 256) softmax(it, alpha0, alpha1);\n"
                    "        else alpha0 = alpha1 = 1.f;\n", 1),),
    "no_load": ((K_LOAD, "        if (DP == 256 && it >= 2) "
                 "mbar_arrive(kb); else {\n" + K_LOAD + "}", 1),
                (V_LOAD, "        if (DP == 256 && it >= 2) "
                 "mbar_arrive(vb); else {\n" + V_LOAD + "}", 1)),
}
WIDE_MERGE = ("  if (!last_split(counter + bh, flag)) return;\n"
              "  merge_splits<G * Dv / kThreads>(")
PAGED = {
    "base": (),
    "no_compute": (("    if (okp != 0) {\n      float s[WIDE_ROWS * G];",
                    "    if (okp != 0 && qp == -7) {\n"
                    "      float s[WIDE_ROWS * G];", 1),),
    "no_merge": ((WIDE_MERGE, WIDE_MERGE.replace(
        "  if (!last_split(counter + bh, flag)) return;",
        "  last_split(counter + bh, flag);\n  return;"), 1),),
}


def variant_source(src: str, name: str, edits) -> str:
    for old, new, n in edits:
        if src.count(old) != n:
            raise RuntimeError(f"{name}.cu holds {src.count(old)} of "
                               f"{old[:60]!r}, expected {n}")
        src = src.replace(old, new)
    return src


def start_variant(b, name: str, var: str, edits):
    """Start nvcc for a variant of ``csrc/<name>.cu`` (its text edits
    applied) into OUT; returns (library, process)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}_{var}.cu"
    cu.write_text(variant_source((b.CSRC / f"{name}.cu").read_text(), name,
                                 edits))   # includes nothing from csrc/
    so = cu.with_suffix(".so")
    return so, subprocess.Popen([b._nvcc(), *b.NVCC_FLAGS, "-o", str(so),
                                 str(cu)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def finish_variant(cs, key, so, proc):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        cs.fail(f"nvcc failed for {key}:\n{log}")
    return log


def tree_build(root: Path):
    """The ``build`` module of the tree at ``root`` (its own CSRC and
    BUILD_DIR), loaded under a name of its own."""
    path = root / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"_d256_build_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_log(b, name: str):
    """ptxas's report for a tree's library, where its build module has
    one (a tree that keeps no log beside its libraries: this process's)."""
    return b.build_log(name) if hasattr(b, "build_log") else b.logs.get(name)


def print_ptxas(cs, tag: str, name: str, text) -> None:
    if text is None:
        print(f"ptxas {tag} {name}: built before this run")
        return
    print(f"ptxas {tag} {name}: " + "; ".join(
        f"{inst} {regs} regs {smem} B static smem {spill} B spilled "
        f"{stack} B stack" for inst, regs, smem, spill, stack
        in cs.ptxas_summary(text)
        if inst.startswith(("flash_fwd_tc", "paged_split", "paged_wide"))))
    for line in text.splitlines():
        if "(C7" in line:
            print(f"nvcc {tag} {name}: {line.strip()}")


def build_all(old_root: Path) -> dict:
    """Start the five nvcc builds at once, wait, print the ptxas lines;
    returns {tag: {name: library path}} (p1: flash only)."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    trees = {"new": tree_build(ROOT), "old": tree_build(old_root)}
    jobs = {}
    for tag, b in trees.items():
        for name in NAMES:
            jobs[tag, name] = (b, name, *b._start(name))
    so, p1 = start_variant(trees["new"], "flash_attention", "p1", P1)
    libs = {"new": {}, "old": {}, "p1": {"flash_attention": so}}
    for (tag, name), (b, _, proc, tmp) in jobs.items():
        b._finish(name, proc, tmp)
        libs[tag][name] = b.library_path(name)
    logs = {(tag, name): tree_log(trees[tag], name) for tag, name in jobs}
    logs["p1", "flash_attention"] = finish_variant(cs, "p1", so, p1)
    for (tag, name), text in logs.items():
        print_ptxas(cs, tag, name, text)
    return {t: {n: str(p) for n, p in d.items()} for t, d in libs.items()}


def child(root: Path, flash_lib) -> dict:
    """One turn: the checks and times of the tree at ``root``."""
    import torch
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         paged_attention_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if flash_lib:
        build.use("flash_attention", Path(flash_lib))
    res = {"paged_errs": cs.phase_gemma_vs_plain(paged_attention_fwd,
                                                 paged_attention_ref)}
    errs = {}
    for name, shape in (("gemma3 window 1024", cs.FLASH_GEMMA),
                        ("gemma3 causal", cs.FLASH_GEMMA_CAUSAL)):
        B, Hq, Hkv, S, T, D, window = shape
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            q, k, v = cs.flash_case(B, Hq, Hkv, S, T, D, seed=1, dtype=dtype)
            out, lse = flash_attention_fwd(q, k, v, window=window)
            torch.cuda.synchronize()
            eo, el = flash_attention_ref(q, k, v, window=window,
                                         return_lse=True)
            e = errs[f"{name} {dname}"] = cs._flash_err(
                out, lse, eo, el, cs.TOL[dname], f"{name} {dname}")
            print(f"flash vs plain at the {name} shape, {dname}: max abs "
                  f"err out {e[0]:.3e} (tol {cs.TOL[dname]}), lse "
                  f"{e[1]:.3e} (tol 1e-4)")
            del q, k, v, out, lse, eo, el
            torch.cuda.empty_cache()
    res["flash_errs"] = errs
    res["paged"] = cs.phase_gemma_kernel_times(paged_attention_fwd,
                                               paged_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    res["flash"] = cs.phase_flash_gemma_times(flash_attention_fwd,
                                              flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    res["flash_qwen3"] = cs.phase_flash_times(flash_attention_fwd,
                                              flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    res["paged_qwen3"] = cs.phase_kernel_times(
        paged_attention_fwd, paged_attention_ref, cs.QWEN3_HQ, "qwen3-8b")
    return res


def step0(libs: dict, seeds) -> dict:
    """Phase 12c's step 0 on each seed: the plain path with its kv chunk
    halved, the flash kernel with P as hi + lo and with P once, each
    relative to the plain path."""
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params, trainable
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.train_config("gemma3-12b")
    loader = cs.train_loader(cfg)
    out = {}
    for seed in seeds:
        params = trainable(init_params(seed, cfg, device="cuda"))
        batch = loader.batch(seed)
        ref = cs.step0_run(cfg, params, batch, False)
        out[seed] = {}
        for name in ("floor", "hi+lo", "p1"):
            if name == "floor":
                run = cs.step0_run(cfg, params, batch, False, kv_chunk=512)
            else:
                build.use("flash_attention", Path(
                    libs["p1" if name == "p1" else "new"]["flash_attention"]))
                run = cs.step0_run(cfg, params, batch, True)
            d = cs.step0_diffs(run, ref)
            ok = all(v <= cs.STEP0_TOL[k] for k, v in d.items())
            out[seed][name] = dict(d, within_tol=ok)
            print(f"gemma3 step 0 seed {seed} {name:5s}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items())
                + f" -> {'within' if ok else 'OUTSIDE'} STEP0_TOL")
            del run
            gc.collect()
        del params, batch, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ablate(card: str) -> dict:
    """Build every variant at once, then time each at gemma3's shapes."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd
    jobs = {}
    for name, table in (("flash_attention", FLASH),
                        ("paged_attention", PAGED)):
        for var, edits in table.items():
            jobs[name, var] = start_variant(build, name, var, edits)
    libs = {}
    for key, (so, proc) in jobs.items():
        finish_variant(cs, key, so, proc)
        libs[key] = so

    def flash_times(cases) -> dict:
        return {k: 1e3 * cs.device_ms(
            lambda i: flash_attention_fwd(*cases[k][i % 2], window=w), 10,
            "flash_fwd") for k, w in (("window", 1024), ("causal", 0))}

    def paged_times(cases) -> dict:
        return {k: 1e3 * cs.device_ms(
            lambda i: cs.run_kernel(paged_attention_fwd, cases[k][0][i % 4],
                                    window=cases[k][1]), 200,
            ("paged_split_kernel", "paged_wide_kernel")) for k in cases}

    fcases = {}
    for k, shape in (("window", cs.FLASH_GEMMA),
                     ("causal", cs.FLASH_GEMMA_CAUSAL)):
        B, Hq, Hkv, S, T, D, _ = shape
        fcases[k] = [cs.flash_case(B, Hq, Hkv, S, T, D, seed=20 + i,
                                   dtype=torch.bfloat16) for i in range(2)]
    full = [cs.GEMMA_RING_COLS * 16 + 500 + 37 * b for b in range(8)]
    pcases = {
        "ring": ([cs.ring_case(torch.bfloat16, seed=s, lag=[1] * 8,
                               lengths=full) for s in range(4)],
                 cs.GEMMA_WINDOW),
        "table": ([cs.pool_case(8, cs.GEMMA_HQ, cs.GEMMA_HKV, cs.GEMMA_D, 16,
                                cs.GEMMA_COLS, cs.GEMMA_COLS, seed=s,
                                dtype=torch.bfloat16, N=1024)
                   for s in range(4)], 0)}
    result = {"card": card, "flash": [], "paged": []}
    for var in (*FLASH, "base"):
        build.use("flash_attention", libs["flash_attention", var])
        t = flash_times(fcases)
        result["flash"].append({"variant": var, **t})
        print(f"flash {var}: window 1024 {t['window']:.1f} us, causal "
              f"{t['causal']:.1f} us")
    del fcases
    torch.cuda.empty_cache()
    for var in ("base", "no_compute", "base", "no_merge"):
        build.use("paged_attention", libs["paged_attention", var])
        t = paged_times(pcases)
        result["paged"].append({"variant": var, **t})
        print(f"paged {var}: ring {t['ring']:.2f} us, table "
              f"{t['table']:.2f} us")
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--step0", type=int, nargs="*")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--flash-lib", help=argparse.SUPPRESS)
    ap.add_argument("--step0-libs", help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("d256_times: no CUDA device", file=sys.stderr)
        return 2
    if opt.child:
        print("D256_RESULT " + json.dumps(child(opt.child, opt.flash_lib)))
        return 0
    if opt.step0_libs:
        res = step0(json.loads(opt.step0_libs), opt.step0 or [0, 1, 2, 3])
        print("D256_RESULT " + json.dumps(res))
        return 0
    if opt.old is None and not opt.ablate:
        ap.error("--old DIR or --ablate is required")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if opt.ablate:
        print(json.dumps(ablate(card)))
        return 0
    libs = build_all(opt.old.resolve())
    result = {"card": card, "runs": []}

    def run(args):
        proc = subprocess.run([sys.executable, __file__, *args],
                              stdout=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONUNBUFFERED="1"))
        lines = proc.stdout.splitlines()
        for line in lines:
            if not line.startswith("D256_RESULT "):
                print(line)
        if proc.returncode != 0:
            cs.fail(f"a turn {args} exited {proc.returncode}")
        return json.loads(lines[-1][len("D256_RESULT "):])

    for tag in ("old", "new", "p1", "p1", "new", "old"):
        root = opt.old.resolve() if tag == "old" else ROOT
        print(f"== {tag}")
        args = ["--child", str(root)]
        if tag == "p1":
            args += ["--flash-lib", libs["p1"]["flash_attention"]]
        res = run(args)
        result["runs"].append({"variant": tag, **res})
        t = res
        print(f"{tag}: flash window {t['flash']['window 1024']['ms'] * 1e3:.1f}"
              f" / causal {t['flash']['causal']['ms'] * 1e3:.1f} us (cuDNN "
              f"{t['flash']['causal']['library_ms'] * 1e3:.1f}); paged ring "
              f"{t['paged']['ring']['ms'] * 1e3:.2f} / table "
              f"{t['paged']['global']['ms'] * 1e3:.2f} us (SDPA "
              f"{t['paged']['ring']['library_ms'] * 1e3:.2f} / "
              f"{t['paged']['global']['library_ms'] * 1e3:.2f}); qwen3 flash "
              f"{t['flash_qwen3']['ms'] * 1e3:.1f} us, paged "
              f"{t['paged_qwen3']['ms'] * 1e3:.2f} us")
    if opt.step0 is not None:
        result["step0"] = run(["--step0-libs", json.dumps(libs),
                               "--step0", *map(str, opt.step0 or [0, 1, 2, 3])])
        result["step0_tol"] = cs.STEP0_TOL
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
