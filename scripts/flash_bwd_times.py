"""The flash-attention backward kernel of ``csrc/flash_attention.cu`` alone,
on the card.

    python3 scripts/flash_bwd_times.py [--check-only] [--step0 [SEED ...]]

Builds the flash library and prints the ptxas line of each of its
tensor-core instances (the forward's and the backward's two passes) and
any advisory; runs ``chip_smoke.py``'s phase 11c (the kernel against the
plain backward on the same bf16 inputs, over phase 11's sweep and at
qwen3-8b's training shape, causal and with a 1,024-token window, each
gradient within ``BWD_TOL``; two calls bit for bit); then, unless
``--check-only``, phase 13c (device time at the training shape, the two
passes apart, beside the bound, the kernel's tensor work at the peak, the
plain backward and SDPA's backward).

``--step0`` then reads phase 12's step 0 (qwen3-8b, 8 of 36 layers, B 2 x
S 4096, remat) on each seed given (default 0 1 2 3; seed s draws the
weights with ``init_params(s)`` and takes batch s, as
``scripts/step0_spread.py``): the relative loss, grad norm and gradient
differences from the plain scan attention, as ``STEP0_TOL`` bounds them,
for the flash forward with the backward kernel ("kernel") and with the
backward forced to its plain route ("plain_bwd", the route before the
kernel), beside the plain path with its kv chunk halved ("floor": another
float32 summation order, the same bf16 roundings).

Prints a line per reading and last one JSON object; fails if a check
fails.  Needs an H100 and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402


def step0(seeds) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.models.transformer import init_params, trainable
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=cs.TRAIN_LAYERS)
    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_S,
        global_batch=cs.TRAIN_B, noise=0.05, seed=0), device="cuda")
    route = FA.bwd_route
    out = {}
    for seed in seeds:
        params = trainable(init_params(seed, cfg, device="cuda"))
        batch = loader.batch(seed)
        ref = cs.step0_run(cfg, params, batch, False)
        runs = {"floor": lambda: cs.step0_run(cfg, params, batch, False,
                                              kv_chunk=512),
                "kernel": lambda: cs.step0_run(cfg, params, batch, True),
                "plain_bwd": lambda: cs.step0_run(cfg, params, batch, True)}
        out[seed] = {}
        for name, run in runs.items():
            FA.bwd_route = ((lambda *a: "plain") if name == "plain_bwd"
                            else route)
            try:
                d = cs.step0_diffs(run(), ref)
            finally:
                FA.bwd_route = route
            ok = all(v <= cs.STEP0_TOL[k] for k, v in d.items())
            out[seed][name] = dict(d, within_tol=ok)
            print(f"step 0 seed {seed} {name:9s}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items())
                + f" -> {'within' if ok else 'OUTSIDE'} STEP0_TOL")
            gc.collect()
        del params, batch, ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--step0", type=int, nargs="*")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    FA._lib()
    log = build.build_log("flash_attention") or ""
    for inst, regs, smem, spill, stack in cs.ptxas_summary(log):
        if inst.startswith(("flash_fwd_tc", "flash_bwd")):
            print(f"ptxas {inst}: {regs} regs, {smem} B static smem, {spill} "
                  f"B spilled, {stack} B stack")
    for line in log.splitlines():
        if "(C7" in line or "warning" in line.lower():
            print(f"nvcc: {line.strip()}")
    res = {"card": card, "check": cs.phase_flash_bwd_vs_plain()}
    if not opt.check_only:
        res["times"] = cs.phase_flash_bwd_times()
    if opt.step0 is not None:
        res["step0"] = step0(opt.step0 or [0, 1, 2, 3])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
