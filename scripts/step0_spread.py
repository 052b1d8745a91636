"""Step 0 of chip_smoke.py's training check on several seeds, for the
flash kernel's exp function.

Phase 12 of ``chip_smoke.py`` holds step 0 of qwen3-8b training (8 of 36
layers, B=2, S=4096, remat) through the flash kernel against the plain
scan attention within ``STEP0_TOL``, on seed 0.  This script reads the
same three metrics (relative loss, grad norm and gradient differences
from the plain path) on each seed given, for:

  floor  the plain path with its kv chunk halved: another float32
         summation order, the same bf16 roundings;
  expf   the flash kernel as committed (the softmax in ``expf``, in the
         natural domain, as the plain path);
  ex2    the same source with the tensor-core instance's softmax in the
         base-2 domain on ``ex2.approx.ftz`` (scale x log2 e folded into
         the scores' multiply, lse turned back with ln 2), built beside
         the committed library under ``build/repro_torch/``.

Seed s draws the weights with ``init_params(s)`` and takes batch s of
the SyntheticLM stream phase 12 uses.  Then it times the two kernels at
the training shape as phase 13 does (CUDA events, two 168 MB inputs in
turn), in the order expf, ex2, ex2, expf.  Prints one line per seed and
variant and per timing, then one JSON object; it gates nothing.  Needs
an H100 and nvcc:

    python3 scripts/step0_spread.py [seed ...]      (default: 0 1 2 3)
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                   # noqa: E402
from repro_torch.kernels import build                     # noqa: E402

# (old, new, occurrences) on csrc/flash_attention.cu: the tensor-core
# instance's softmax moved to the base-2 domain on ex2.approx
EX2_EDITS = [
    ("constexpr int TC_STAGES = 2;     // K / V ring depth\n",
     "constexpr int TC_STAGES = 2;     // K / V ring depth\n"
     "constexpr float LOG2E = 1.4426950408889634f;\n"
     "constexpr float LN2 = 0.6931471805599453f;\n"
     "__device__ __forceinline__ float exp2_ftz(float x) {\n"
     "  float y;\n"
     "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n"
     "  return y;\n"
     "}\n", 1),
    ("      alpha0 = expf(m0 - mn0);\n      alpha1 = expf(m1 - mn1);\n",
     "      alpha0 = exp2_ftz(m0 - mn0);\n      alpha1 = exp2_ftz(m1 - mn1);\n",
     1),
    *[(f"s[4 * i{o}] = expf(s[4 * i{o}] * scale - mn{r});",
       f"s[4 * i{o}] = exp2_ftz(fmaf(s[4 * i{o}], scale, -mn{r}));", 1)
      for o, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))],
    ("lse[(size_t)bh * S + row0] = m0 + logf(d0);",
     "lse[(size_t)bh * S + row0] = (l0 > 0.f ? m0 * LN2 : m0) + logf(d0);", 1),
    ("lse[(size_t)bh * S + row1] = m1 + logf(d1);",
     "lse[(size_t)bh * S + row1] = (l1 > 0.f ? m1 * LN2 : m1) + logf(d1);", 1),
    ("static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, S, T_, D,\n"
     "      scale, causal, window);",
     "static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, S, T_, D,\n"
     "      scale * LOG2E, causal, window);", 1),
]


def ex2_source(src: str) -> str:
    """The committed flash source with ``EX2_EDITS`` applied; raises if
    the source no longer holds a line an edit expects."""
    for old, new, n in EX2_EDITS:
        if src.count(old) != n:
            raise RuntimeError(f"flash_attention.cu holds {src.count(old)} "
                               f"of {old!r}, expected {n}")
        src = src.replace(old, new)
    return src


def start_ex2_build():
    """Start nvcc on the ex2 variant; returns (process, library path)."""
    src = ex2_source((build.CSRC / "flash_attention.cu").read_text())
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"flash_attention_ex2_{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    # the source includes nothing from csrc/, so it builds from build/
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main(seeds) -> int:
    if not torch.cuda.is_available():
        print("step0_spread: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.transformer import init_params, trainable
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    proc, so = start_ex2_build()
    libs = {"expf": build.load("flash_attention")}
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the ex2 variant:\n{log}")
    libs["ex2"] = ctypes.CDLL(str(so))

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=cs.TRAIN_LAYERS)
    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_S,
        global_batch=cs.TRAIN_B, noise=0.05, seed=0), device="cuda")
    out = {}
    for seed in seeds:
        params = trainable(init_params(seed, cfg, device="cuda"))
        batch = loader.batch(seed)
        ref = cs.step0_run(cfg, params, batch, False)
        runs = {"floor": lambda: cs.step0_run(cfg, params, batch, False,
                                              kv_chunk=512)}
        for name in libs:
            runs[name] = lambda: cs.step0_run(cfg, params, batch, True)
        out[seed] = {}
        for name, run in runs.items():
            if name in libs:             # the flash wrapper loads this one
                build._loaded["flash_attention"] = libs[name]
            d = cs.step0_diffs(run(), ref)
            ok = all(v <= cs.STEP0_TOL[k] for k, v in d.items())
            out[seed][name] = dict(d, within_tol=ok)
            print(f"seed {seed} {name:5s}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items())
                + f" -> {'within' if ok else 'OUTSIDE'} STEP0_TOL")
            gc.collect()
        del params, batch, ref
        gc.collect()
        torch.cuda.empty_cache()
    B, Hq, Hkv, S, T, D, _ = cs.FLASH_TRAIN
    cases = [cs.flash_case(B, Hq, Hkv, S, T, D, seed=10 + i,
                           dtype=torch.bfloat16) for i in range(2)]
    times = {name: [] for name in libs}
    for name in ("expf", "ex2", "ex2", "expf"):
        build._loaded["flash_attention"] = libs[name]
        for c in cases:                  # warm up
            flash_attention_fwd(*c)
        times[name].append(1e3 * cs.event_ms(
            lambda i: flash_attention_fwd(*cases[i % 2]), 10))
        print(f"flash {name} at the training shape {(B, Hq, Hkv, S, D)}: "
              f"{times[name][-1]:.1f} us")
    build._loaded["flash_attention"] = libs["expf"]
    print(json.dumps({"step0_spread": out, "tol": cs.STEP0_TOL,
                      "flash_us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [0, 1, 2, 3]))
