#!/usr/bin/env python3
"""Card-side smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository's sources beside this file; it
imports ``repro_torch``, torch and numpy only.  Phases, each fatal on
failure:

1. build every kernel of ``src/repro_torch/kernels/csrc`` with nvcc and
   print each instance's registers, static shared memory, spilled bytes
   and stack, the compiler's warnings and advisories, the dynamic shared
   memory of the flash and paged-decode blocks, and whether the flash
   library's SASS holds HGMMA (tensor-core) instructions; fail if an
   instance of ``flash_fwd_tc_kernel``, ``paged_wide_kernel`` or
   ``paged_mla_kernel`` spills or ptxas serializes its wgmma (advisory
   C7512), or if their libraries'
   ptxas report (kept beside a library built by an earlier process) is
   missing; the rest informational;
2. hold the paged-decode kernel against its plain PyTorch version and
   against the plain mirror of its split-K algorithm on the card over
   the sweep of ``tests/test_paged_kernel.py`` plus the decode shapes of
   qwen3-8b and jamba-1.5-large (32 and 64 q heads over 8 kv heads;
   bf16 within 2e-2, f32 within 1e-4 — the sums run in another
   order than the plain version's), and check that -1 table columns
   (2 and 9 appended, inside a split and as whole empty splits) are
   exactly neutral and idle slots exactly zero.  2b holds the head-tiled
   instances at deepseek-v3's MLA shape (the MLA instance, wgmma over a
   TMA page ring, against its own split mirror too); 2c the wide-head
   instance (bf16)
   and the split instance (f32) at gemma3-12b's (16 q / 8 kv heads of
   256), each checked to have run: a wrapped 64-column ring
   with window 1024 whose oldest positions lie below the window, and a
   128-column table, bf16 and f32, against the plain version and the
   split-K mirror, -1 columns neutral bit for bit, idle slots zero.  2d
   holds the port's threefry sampling on the card against the same calls
   on the CPU: bits and uniforms of an (8, 151936) draw from 8 raw keys
   bit for bit, gumbel noise within 2.4e-7 x max(1, |g|), and
   ``topp_sample`` over rows of mixed temperature / top-p / top-k picking
   the CPU's tokens in 8 draws (a differing token only where the CPU's
   two best Gumbel scores tie within that tolerance, reported);
3. serve qwen3-8b at full width (random bf16 weights drawn on the card)
   through ``ServingEngine(paged=True, use_kernel=True)``: 16 requests,
   half sharing a 256-token system prompt, two sampled through the
   threefry ``topp_sample`` (at most 2 rows a draw, at least their 2 x 32
   tokens' rows).  Every decode
   tick must have gone through the kernel (launches == decode_calls x
   36), and one decode tick on a served state must give the same logits
   through the kernel and through the scan path (within the bf16
   tolerance 2e-2, relative to the logit scale); the ms of decode ticks
   with and without a sampling slot are printed apart;
4. time serving (CUDA events around each engine step) and the kernel at
   the served shape beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` on the gathered K/V (a yardstick
   only; the port never calls it): kernel and SDPA by their device time
   under ``torch.profiler`` (a ~20 µs launch takes less device time than
   its wrapper's host time, so back-to-back event timing, printed beside
   it, measures the host);
5. hold the ``rwkv_scan`` kernel against its plain version and against
   the plain mirror of its arithmetic (``rwkv_scan_split_ref``) over the
   sweep of ``tests/test_kernels.py::test_rwkv_scan_vs_ref`` plus head
   dims 20 and 18 (zero state), with a nonzero initial state and the
   final state returned (S = 1, 150; hd 64 and 18), and at the two
   served shapes (a decode tick, B=8 S=1 H=64 hd=64, and a 128-token
   prefill chunk with one live row), state written in place; bf16
   output within 2e-2, f32 output and state within 1e-4, rows flagged
   idle keep their state bit for bit;
6. free qwen3-8b, then serve rwkv6-7b at full width through the same
   engine: 16 requests of 32..600 tokens plus one of 1,500 tokens (above
   cache_len: only an attention-free model admits it), two sampled.
   Every RWKV time-mix must have gone through the kernel (launches ==
   (prefill_calls + decode_calls) x 32) and no page may be shared.  On
   a served state, one decode tick (8 live slots) and one 128-token
   prefill chunk (one live slot) go through each of the 32 layers'
   mixers by the kernel and by the plain scan on the same input
   (outputs within 2e-2 of their scale, states within 1e-4, shifts bit
   for bit), and through the whole model by both paths in float32
   activations (bf16 weights upcast exactly, TF32 off): the live slots'
   logits must agree within 2e-2 of the logit scale with equal greedy
   tokens, and idle slots' state and shift stay unchanged bit for bit;
7. time rwkv serving and the kernel at both served shapes beside its
   bound and its plain version (no single PyTorch call computes the wkv
   recurrence, so there is no library time): the kernel by its device
   time under ``torch.profiler``, its event time per back-to-back call
   beside it;
8. hold the ``mamba_scan`` kernel against its plain version over the
   sweep of ``tests/test_kernels.py::test_mamba_scan_vs_ref`` plus
   d_inner 50 (zero state), with a nonzero initial state and the final
   state returned (S = 1, 150; d_inner 192 and 50), and at the two served
   shapes of jamba-1.5-large (a
   decode tick, B=8 S=1 d_inner=16384 d_state=16, and a 128-token
   prefill chunk with one live row), state written in place; y in bf16
   within 2e-2, y in f32 and the state within 1e-4, rows flagged idle
   keep their state bit for bit;
9. serve jamba-1.5-large (Mamba + attention + MoE) at full width with 4
   of its 72 layers (attention + dense, Mamba + MoE, Mamba + dense,
   Mamba + MoE: 23.02 B parameters, 46 GB of bf16) through the same
   engine: the 16 requests of phase 6 without the long one, two
   sampled.  Every Mamba mixer must have gone through ``mamba_scan``
   (launches == (prefill_calls + decode_calls) x 3) and every decode
   attention through the paged-decode kernel (launches == decode_calls),
   and no page may be shared.  On a served state, one decode tick (8
   live slots) and one 128-token prefill chunk (one live slot) go
   through each layer's mixer by the kernels and by the plain path on
   the same input (outputs within 2e-2 of their scale, Mamba state
   within 1e-4 of its scale, conv history bit for bit), and through the
   whole model: in bf16 beside a rounding floor (the plain path again
   with its attention summed in 16-position chunks) with equal greedy
   tokens wherever the top-2 margin exceeds the floor, and in float32
   activations with the live slots' logits within 2e-2 of their scale
   and equal greedy tokens; idle slots keep their Mamba state and conv
   history bit for bit.  Then one ``moe_apply`` layer at
   qwen3-moe-235b-a22b's widths (d 4096, 128 experts of 1536, top-8,
   4.83 GB of bf16 experts drawn on the card) runs twice on 8 decode rows
   and twice on one 128-token chunk: the same bits each time.  9b serves
   deepseek-v3-671b at full width (4 of 61 layers).  9c serves gemma3-12b
   at full width and full depth (48 layers: 40 sliding-window, 8
   global; 11.77 B parameters; 8 slots, cache_len 2048, 16-row pages,
   chunk 128): the 16 requests of phase 3 and two greedy ones of 1,500
   tokens whose rings wrap.  Every decode tick's 48 attentions go
   through the paged-decode kernel (launches == decode ticks x 48, of
   them with a window == decode ticks x 40, all by the wide-head
   instance), no page is shared, the ring pool is 512 pages and both allocators end
   all free; on a served state with a wrapped ring, one decode tick
   through the kernel vs the plain path layer by layer in bf16 (within
   2e-2 of each layer's scale) and for the whole model in float32
   activations (within 1e-4 of the logit scale, equal greedy tokens).
   9d: two engines over the same weights; a 1,300-token greedy request
   exported after 8 decode ticks (its ring columns in the payload) and
   imported into the other finishes with the unmoved run's tokens bit
   for bit, and a payload with one flipped byte is rejected with the
   destination's caches unchanged.  9e: a ``FleetRouter`` of two gemma3
   replicas and a standby over the same weights, a fault plan with a
   crash, a partition and pool pressure, migration "auto", snapshots
   and rebalancing every 4 ticks: every request ends "ok", the standby
   is drafted, requests move by export / import and resume from a
   snapshot, and those never re-prefilled give the tokens of a
   fault-free run bit for bit (re-prefilled ones are counted);
10. time ``mamba_scan`` at both served shapes beside its bound (bytes,
   float32 flops and exps on the SFUs) and its plain version (no single
   PyTorch call computes the selective scan, so there is no library
   time), by device time with the event time beside it, and the
   paged-decode kernel at jamba's decode shape (64 q / 8 kv heads); 10c
   times it at gemma3's two decode shapes (the full ring with its
   window, the 128-column table) beside its bound, its plain version
   and SDPA on the gathered K/V with the window as a boolean mask;
11. hold the flash-attention kernel against its plain version over the
   sweep of ``tests/test_kernels.py::test_flash_attention_vs_ref`` (plus
   T > S) and at the training shape of qwen3-8b (B=2, S=4096, GQA 32 / 8
   heads of 128) with and without a 1,024-token window, each in bf16
   (the tensor-core instance) and f32 (the CUDA-core instance): output
   bf16 within 2e-2, f32 within 1e-4, logsumexp within 1e-4 (also at
   gemma3-12b's training shapes: 16 q / 8 kv heads of 256, S = 4096,
   window 1024 and causal); then autograd
   through the port's flash attention (kernel forward, plain blocked
   backward) against autograd through the plain version, f32, each
   gradient within 1e-4 of its scale;
12. train qwen3-8b at full width, 8 of its 36 layers, through the port's
   ``Trainer`` (adamw, cosine_lr, full remat, ``use_kernel=True``) for 7
   steps of 2 x 4096 SyntheticLM tokens: every attention forward and
   remat recompute must have gone through the kernel (launches == 16 x
   7), the losses must be finite and the last below the first; step 0
   through the kernel and through the plain scan attention must agree
   in loss, grad norm and gradients (``STEP0_TOL``, set from a measured
   rounding floor).  Prints step ms, tokens/s, MFU and peak memory.
   12b: the same scenario for 3 steps under each remat policy ("full",
   "dots_no_batch", "dots"): flash launches == 16 a step under each,
   step 0's loss and grad norm equal "full"'s within ``STEP0_TOL``; ms
   per step and peak memory printed.  12c: gemma3-12b trained the same
   way at full width, one period of its 48 layers (5 sliding-window of
   window 1024 + 1 global, 2.35 B parameters), 5 steps: flash launches
   == 12 a step, 10 of them with the window, step 0 kernel vs plain
   within ``STEP0_TOL``, falling loss.  12d: the scan kernels have no
   backward: one training step (``loss_fn`` + gradients, B=2, S=512)
   with ``use_kernel=True`` on jamba-1.5-large's attention and first
   dense Mamba layer and on two rwkv6-7b layers, at full width in float32
   activations, launches no scan kernel and matches the all-plain path
   within 1e-4 (loss, grad norm, gradients); ``ops.mamba_scan`` /
   ``ops.rwkv_scan`` on CUDA inputs that require grad raise, and launch
   under ``torch.no_grad()``;
13. time the flash kernel at the training shape beside its bound, its
   plain version and ``F.scaled_dot_product_attention`` (a yardstick
   only; the port never calls it); 13b at gemma3-12b's two training
   shapes (D = 256, window 1024 and causal) by device time, SDPA with
   ``enable_gqa=True`` (the window as a boolean mask) and its backend
   named;
14. hold the int8 block quantization kernels (``int8_quantize`` /
   ``int8_dequantize``) against their plain versions: the sweep of
   ``tests/test_kernels.py`` (n 17..4096, f32 and bf16, block 256 and
   128), an odd block, an unaligned input and a NaN row: codes, scales
   and the decoded values (f32 and bf16) bit for bit.  After phase 15,
   one run over the plane's whole gradient size (2.788 B bf16 elements,
   more than 2^31): every row against the plain version in chunks, the
   rows around element 2^31 and the last rows against the plain version
   on those rows alone, a partial last row; then kernel, plain and
   ``torch.mul(codes, scales)`` times beside the bytes bounds;
15. the paper's decentralized plane at full width, the steps of
   ``examples/decentralized_pipeline.py``: a ``Broker`` (backup pool
   0.25) takes a fleet of 8 consumer GPUs and schedules the train DAG of
   qwen3-8b (8 of 36 layers, 2.788 B parameters, B=2, S=4096) in 4
   parts; batches come from ``SyntheticLM`` through a ``DataProvider``
   on the broker's DHT; a ``LocalCluster`` of 4 compnodes
   (``use_kernel=True``) and one of 1 compnode drawn from the same seed
   give the same ``forward`` logits and two steps' losses bit for bit.
   Then the main path: 4 SGD steps of the 4-part cluster over the Bus,
   the last driven through the executors' own fp / bp with a recording
   Bus, every payload and the whole gradient (one bf16 vector) through
   ``int8_block_encode`` / ``decode``: flash launches == 8 x 4, int8
   launches == payloads + 1, finite losses, each of the cluster's six
   (two equality steps, then these four) below the one before,
   Bus bytes within [1.8, 4] x the DAG's cut model; each payload, each
   gradient leaf and the whole gradient coded by the kernels equal the
   plain versions bit for bit.  Prints step ms, tokens/s, peak memory,
   Bus bytes per link and each compnode's FP / BP ms beside the paper's
   Eq. 1 estimate for an h100 ``CompNode``.

16. the dry-run plane: 16a runs ``python -m repro_torch.launch.dryrun
   --kernel --device cuda`` for the pairs whose trace needs the card's
   torch build (``DRYRUN_PAIRS``: the decode programs that reach the
   three custom ops, on the fake 256-rank (16 x 16) mesh) and for
   qwen3-8b decode_32k on the 2 x 16 x 16 mesh, each in a process of its
   own, all at once (the CPU program of every pair is traced by
   ``tests/test_torch_dryrun.py``): every record "ok", one line each with
   its bottleneck, per-chip GB and each roofline term's ms.
   16b dry-runs qwen3-8b's engine step (8 slots, cache_len 1024, page
   16, the kernels' custom ops) on a 1 x 1 mesh and holds it to the
   real step on the card: the bytes of params and caches, the FLOPs by
   ``FlopCounterMode``'s formulas and the 36 paged-decode launches a
   tick must be equal; the predicted peak and the roofline's ms are
   printed beside ``max_memory_allocated`` and the tick's time on CUDA
   events and by device time.
17. the staged execution as an SPMD pipeline, and the examples.  17a
   runs ``core.executor.spmd_pipeline`` over a 4-stage ("stage",) mesh
   of 4 gloo processes that all compute on the one card: qwen3-8b at
   full width, 8 of its 36 layers (2 a stage, each rank holding its own
   as ``Shard(0)`` DTensors), ``layer_apply`` with the flash kernel and
   no cache under ``torch.no_grad()``, 8 microbatches of (1, 4096, 4096)
   bf16.  Every rank's outputs must equal, bit for bit, a one-process
   forward of the same layers over the same microbatches on the card,
   and every rank must count 16 flash launches (its 8 microbatches x 2
   layers; each stage process sets the count to 0 before the pipeline
   and reports it after).  Prints the one-process forward's ms on CUDA
   events and wall, each rank's stage compute on CUDA events and its
   pipeline wall time, the bytes sent and broadcast, and the transport
   (gloo takes host memory: "host-staged").  17b runs each
   ``examples_torch`` script with ``--device cuda`` as a process of its
   own, all seven at once (``EXAMPLE_RUNS``): ``train_e2e --preset 100m
   --steps 300``, ``serve_batched --kernel`` for qwen3-8b and rwkv6-7b,
   ``serve_fleet``, ``quickstart``, ``decentralized_pipeline`` (whose
   tail spawns 4 gloo processes of its own) and ``estimate_cluster``;
   each must exit 0 (their self-checks are assertions), and each one's
   wall time and self-check lines are printed.
18. the port's static checker and the kernels' interfaces: 18a runs
   ``python -m repro_torch.analysis --strict --format json`` on the
   checkout (exit 0 required; files scanned, new / baselined /
   suppressed counts and its wall time printed); 18b holds every
   ``extern "C"`` function that the checker's KRN001 parses from
   ``csrc/*.cu`` (17 over 5 sources) to the built libraries: the
   functions each wrapper binds are exactly its source's, each is a
   symbol of the built library, and each live ctypes binding's
   ``argtypes`` / ``restype`` match the declaration in count and width;
   18c shows that paged decode, flash and the int8 pair refuse a CUDA
   input that requires grad under grad mode ("has no backward", nothing
   launched) and launch once under ``torch.no_grad()``, equal to their
   plain versions.  The phase's time is printed with the card's name and
   power limit.

The phases run in the order 1-2c, 10c, 5, 11, 13b (the kernel checks
and the times a profiler takes before serving), 2d, 3-4, 6-7, 8-10b, 9b,
9c-9e, 12-12d, 13, 14 (the sweep), 15, 14 (the large run and times),
16, 17, 18; each model is freed before the next is drawn.  The total time
is printed before the result lines.

Output: human-readable lines, then one JSON line ``{"kernels": [...]}``,
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's sources, it exits nonzero and prints no result.

``python3 chip_smoke.py --plane-lr-sweep`` builds the kernels and runs
only the SGD learning-rate sweep of phase 15's cluster (``plane_lr_sweep``).
"""
from __future__ import annotations

import copy
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same source
F32_FLOPS = 67e12                  # float32 outside the tensor cores, same
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def ptxas_summary(log: str):
    """(kernel instance, registers, static shared bytes, spilled bytes,
    stack frame bytes) from nvcc -Xptxas=-v output; the instance is the
    kernel's name and its mangled template arguments (the name alone for
    a kernel that is no template)."""
    out, name, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)"
                      r"(?:I(\w*?)EEv|E)", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            spill = 0
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            spill = int(m.group(2))
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), int(sm.group(1)) if sm else 0,
                        spill, stack))
            name = None
    return out


def sass_mma_count(lib: Path):
    """Tensor-core instructions in a built library's SASS: {"HGMMA": n,
    "HMMA": n} from cuobjdump, or None where there is no cuobjdump."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return None
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def pool_case(B, Hq, Hkv, D, page, n_cols, used, *, seed, dtype,
              Dv=None, De=0, N=None):
    """A paged pool on the card: row b maps ``used[b]`` scattered blocks
    (the rest of its table row -1) and its last page is partly written."""
    g = torch.Generator().manual_seed(seed)
    Dv = Dv or D
    N = N or B * n_cols + 2
    used = [used] * B if isinstance(used, int) else used

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dtype).cuda()

    case = {"q": rnd(B, 1, Hq, D), "k": rnd(N, page, Hkv, D),
            "v": rnd(N, page, Hkv, Dv)}
    if De:
        case["q_extra"], case["k_extra"] = rnd(B, 1, Hq, De), rnd(N, page, Hkv, De)
    pos = torch.full((N, page), -1, dtype=torch.int32)
    table = torch.full((B, n_cols), -1, dtype=torch.int32)
    q_pos = torch.zeros((B, 1), dtype=torch.int32)
    perm = torch.randperm(N, generator=g)
    blk = 0
    for b in range(B):
        total = used[b] * page - int(torch.randint(0, page, (1,), generator=g))
        q_pos[b, 0] = total
        for c in range(used[b]):
            table[b, c] = perm[blk]
            lo, hi = c * page, min((c + 1) * page, total)
            if hi > lo:
                pos[perm[blk], :hi - lo] = torch.arange(lo, hi)
            blk += 1
    case.update(pos=pos.cuda(), table=table.cuda(), q_pos=q_pos.cuda())
    return case


def run_kernel(fn, c, **kw):
    extra = {k: c[k] for k in ("q_extra", "k_extra") if k in c}
    return fn(c["q"], c["k"], c["v"], c["pos"], c["table"], c["q_pos"],
              **extra, **kw)


SWEEP = [  # (B, Hq, Hkv, D, page, n_cols, used, window, softcap, De)
    (2, 4, 2, 32, 8, 4, 3, 0, 0.0, 0),      # GQA, -1 tail columns
    (1, 8, 8, 64, 16, 4, 4, 0, 0.0, 0),     # MHA, full table
    (3, 4, 1, 80, 8, 6, 2, 0, 0.0, 0),      # MQA, odd head dim
    (2, 4, 2, 32, 8, 8, 5, 20, 0.0, 0),     # SWA window crossing pages
    (1, 4, 2, 32, 8, 4, 3, 0, 30.0, 0),     # softcap
    (2, 16, 4, 128, 16, 3, 3, 0, 0.0, 0),   # wide heads
    (2, 4, 1, 48, 8, 4, 3, 0, 0.0, 16),     # MLA second contraction
]


QWEN3_HQ, JAMBA_HQ = 32, 64       # q heads over 8 kv heads of 128


def decode_case(Hq, dtype, seed=0):
    """A served decode shape: 8 slots, ``Hq`` q / 8 kv heads of 128
    (qwen3-8b 32, jamba-1.5-large 64), 16-row pages, 64 table columns
    over a 512-page pool, rows filled to mixed lengths (2..40 pages, as
    32..600-token prompts plus 32 new tokens)."""
    g = torch.Generator().manual_seed(seed + 100)
    used = torch.randint(2, 41, (8,), generator=g).tolist()
    return pool_case(8, Hq, 8, 128, 16, 64, used, seed=seed,
                     dtype=dtype, N=512)


def phase_kernel_vs_plain(fwd, ref):
    """The kernel against the sequential plain version and against the
    plain mirror of its split-K algorithm (``paged_attention_split_ref``),
    both at the dtype's tolerance; -1 columns appended (inside a split
    and as whole empty splits) leave the output bit for bit; an idle
    slot outputs exact zeros."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    worst = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        tol = TOL[dname]
        cases = [(pool_case(B, Hq, Hkv, D, page, n, used, seed=B + used,
                            dtype=dtype, De=De, Dv=None), window, softcap,
                  (48 + De) ** -0.5 if De else None)
                 for (B, Hq, Hkv, D, page, n, used, window, softcap, De)
                 in SWEEP]
        cases += [(decode_case(Hq, dtype), 0, 0.0, None)
                  for Hq in (QWEN3_HQ, JAMBA_HQ)]
        for c, window, softcap, scale in cases:
            if "q_extra" in c:
                c["v"] = c["k"]                  # MLA: latent pool is K = V
            kw = dict(window=window, softcap=softcap, scale=scale)
            out = run_kernel(fwd, c, **kw)
            torch.cuda.synchronize()
            exp = run_kernel(ref, c, **kw)
            err = (out.float() - exp.float()).abs().max().item()
            torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                       rtol=tol)
            split = run_kernel(paged_attention_split_ref, c, **kw)
            torch.testing.assert_close(out.float(), split.float(), atol=tol,
                                       rtol=tol)
            worst[dname] = max(worst.get(dname, 0.0), err)
        # a -1 column is exactly neutral; an idle slot outputs exact zeros
        for c in (cases[0][0], cases[-2][0]):
            base = run_kernel(fwd, c)
            for extra in (2, 9):
                wide = dict(c, table=torch.cat(
                    [c["table"], torch.full_like(c["table"][:, :1].expand(
                        -1, extra), -1)], 1).contiguous())
                if not torch.equal(run_kernel(fwd, wide), base):
                    fail(f"{dname}: {extra} -1 table columns changed the "
                         f"output")
        c = cases[0][0]
        base = run_kernel(fwd, c)
        idle = dict(c, q_pos=c["q_pos"].clone())
        idle["q_pos"][1, 0] = -1
        out = run_kernel(fwd, idle)
        if out[1].abs().max().item() != 0.0 or not torch.equal(out[0], base[0]):
            fail(f"{dname}: an idle slot did not output exact zeros")
        torch.cuda.synchronize()
        print(f"kernel vs plain [{dname}]: {len(cases)} cases, max abs err "
              f"{worst[dname]:.3e} (tol {tol}; also within it of the split-K "
              f"mirror); -1 columns neutral, idle slots zero")
    return worst


# ---------------------------------------------------------------------------
# Phase 2d: the port's threefry sampling on the card
# ---------------------------------------------------------------------------

SAMPLE_ROWS, SAMPLE_V = 8, 151936     # 8 slots over qwen3-8b's vocabulary
SAMPLE_DRAWS = 8
# each row's temperature, top-p and top-k (0 = no cut): plain, nucleus,
# top-k, both, greedy by top-k 1
SAMPLE_TEMP = (1.0, 0.8, 0.7, 1.2, 0.9, 1.0, 0.6, 1.5)
SAMPLE_TOP_P = (1.0, 0.95, 0.9, 1.0, 0.5, 0.99, 1.0, 0.8)
SAMPLE_TOP_K = (0, 50, 0, 20, 0, 0, 1, 100)
GUMBEL_TOL = 2.4e-7   # x max(1, |g|): two ulps (tests/test_torch_prng.py)


def phase_sampling_bits():
    """Threefry bits and uniforms of an (8, 151936) draw from 8 raw keys
    on the card equal the same call on the CPU bit for bit, and the gumbel
    noise lies within ``GUMBEL_TOL`` of the CPU's (two logs, each the
    device's own); ``topp_sample`` on the card picks the CPU's tokens for
    fixed float32 logits over rows of mixed temperature / top-p / top-k
    in ``SAMPLE_DRAWS`` draws.  A token may differ only where the CPU's
    two best Gumbel scores lie within ``GUMBEL_TOL`` of each other (a
    tie, reported).  Prints one draw's device time."""
    from repro_torch import prng
    from repro_torch.models.layers import NEG_INF
    from repro_torch.serve.engine import topp_sample
    rng = np.random.default_rng(0)

    def keys_of(draw):
        return torch.from_numpy(rng.integers(
            0, 2 ** 32, (SAMPLE_ROWS, 2), dtype=np.uint64).astype(np.int64))
    keys = keys_of(0)
    shape = (SAMPLE_V,)
    for what, fn in (("bits", prng.random_bits), ("uniforms", prng.uniform)):
        a, b = fn(keys, shape), fn(keys.cuda(), shape).cpu()
        same = (torch.equal(a, b) if what == "bits" else
                torch.equal(a.view(torch.int32), b.view(torch.int32)))
        if not same:
            fail(f"threefry {what} on the card differ from the CPU's")
    g_cpu, g = prng.gumbel(keys, shape), prng.gumbel(keys.cuda(), shape).cpu()
    g_err = ((g.double() - g_cpu.double()).abs()
             / g_cpu.double().abs().clamp(min=1.0)).max().item()
    if not g_err <= GUMBEL_TOL:
        fail(f"gumbel on the card vs the CPU: {g_err} x max(1, |g|)")
    logits = torch.from_numpy(
        rng.standard_normal((SAMPLE_ROWS, SAMPLE_V)).astype(np.float32) * 3)
    opts = [torch.tensor(SAMPLE_TEMP), torch.tensor(SAMPLE_TOP_P),
            torch.tensor(SAMPLE_TOP_K, dtype=torch.int32)]
    opts_gpu = [t.cuda() for t in opts]
    ties, rows = 0, 0
    for draw in range(SAMPLE_DRAWS):
        k = keys_of(draw)
        cpu = topp_sample(k, logits, *opts)[:, 0]
        gpu = topp_sample(k.cuda(), logits.cuda(), *opts_gpu)[:, 0].cpu()
        rows += SAMPLE_ROWS
        for r in torch.nonzero(cpu != gpu)[:, 0].tolist():
            # the CPU's Gumbel scores over the row's kept tokens, as
            # topp_sample forms them
            lg = logits[r] / opts[0][r]
            order = torch.argsort(-lg, stable=True)
            slg = lg[order]
            p = torch.softmax(slg, dim=-1)
            keep = (torch.cumsum(p, -1) - p) < opts[1][r]
            if opts[2][r] > 0:
                keep &= torch.arange(SAMPLE_V) < opts[2][r]
            score = (prng.gumbel(k[r], shape)
                     + torch.where(keep, slg, NEG_INF)).topk(2).values
            gap = (score[0] - score[1]).item()
            if gap > GUMBEL_TOL * max(1.0, abs(score[0].item())):
                fail(f"topp_sample draw {draw} row {r}: card token "
                     f"{gpu[r].item()} vs CPU {cpu[r].item()}, Gumbel "
                     f"score gap {gap}")
            ties += 1
            print(f"topp_sample draw {draw} row {r}: a tie (gap {gap:.3e})")
    k = keys_of(SAMPLE_DRAWS).cuda()
    lg = logits.cuda()
    ms = device_ms(lambda i: topp_sample(k, lg, *opts_gpu), 20)
    call_ms = event_ms(lambda i: topp_sample(k, lg, *opts_gpu), 20)
    print(f"threefry on the card vs the CPU, (8, 151936) from 8 raw keys: "
          f"bits and uniforms bit for bit, gumbel within {g_err:.3e} x "
          f"max(1, |g|) (tol {GUMBEL_TOL}); topp_sample {rows - ties} of "
          f"{rows} rows the CPU's token, {ties} ties; one (8, 151936) draw "
          f"{ms:.3f} ms of device time ({call_ms:.3f} ms per call back to "
          f"back)")
    return {"gumbel_err": g_err, "ties": ties, "rows": rows,
            "topp_sample_ms": ms, "topp_sample_call_ms": call_ms}


# ---------------------------------------------------------------------------
# Phase 3: full-width serving
# ---------------------------------------------------------------------------

def make_requests(Request, vocab, seed=0):
    """16 requests: prompts of 32..600 tokens, the even ones behind one
    256-token system prompt; requests 3 and 10 sample.  No prompt leaves a
    1-token prefill chunk (a chunk of 1 would be a decode-shaped step)."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 256).tolist()
    reqs = []
    for i in range(16):
        shared = i % 2 == 0
        n = int(rng.integers(32, 345 if shared else 601))
        if n % 128 == 1:
            n += 1
        tail = rng.integers(0, vocab, n).tolist()
        prompt = system + tail if shared else tail
        kw = (dict(temperature=0.8, top_p=0.95, top_k=50) if i in (3, 10)
              else {})
        reqs.append(Request(i, prompt, max_new=32, **kw))
    return reqs


def time_steps(eng):
    """Wrap the engine's step with CUDA events; returns the record list
    of (start, end, S, valid tokens, whether a live slot samples)."""
    rec = []
    step = eng._call_step

    def timed(toks, pos):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        sampled = bool((eng._temp[(pos >= 0).any(axis=1)] > 0).any())
        a.record()
        out = step(toks, pos)
        b.record()
        rec.append((a, b, toks.shape[1], int((pos >= 0).sum()), sampled))
        return out
    eng._call_step = timed
    return rec


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0
        if hasattr(k, "window_launches"):
            k.window_launches = 0
        if hasattr(k, "instance_launches"):
            k.instance_launches = dict.fromkeys(k.instance_launches, 0)


def serving_times(rec, wall):
    """Prefill / decode rates from the CUDA-event records of a served run,
    its wall time and the peak device memory; printed and returned."""
    pre = [(a.elapsed_time(b), n) for a, b, S, n, _ in rec if S > 1]
    dec = [(a.elapsed_time(b), n) for a, b, S, n, _ in rec if S == 1]
    # decode ticks with a sampling slot (the threefry draw) and without
    hot = [a.elapsed_time(b) for a, b, S, _, x in rec if S == 1 and x]
    cold = [a.elapsed_time(b) for a, b, S, _, x in rec if S == 1 and not x]
    timing = {
        "prefill_tok_s": sum(n for _, n in pre) / sum(t for t, _ in pre) * 1e3,
        "decode_tok_s": sum(n for _, n in dec) / sum(t for t, _ in dec) * 1e3,
        "ms_per_decode_tick": sum(t for t, _ in dec) / len(dec),
        "ms_per_prefill_call": sum(t for t, _ in pre) / len(pre),
        "wall_s": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if hot:
        timing["ms_per_sampled_decode_tick"] = sum(hot) / len(hot)
        timing["sampled_decode_ticks"] = len(hot)
    if hot and cold:
        timing["ms_per_greedy_decode_tick"] = sum(cold) / len(cold)
    print("serving: " + ", ".join(f"{k}={v}" for k, v in timing.items()))
    return timing


def phase_serve(fwd, kernels):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import forward, init_params, unembed
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config("qwen3-8b")
    t0 = time.time()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"qwen3-8b: {n_params / 1e9:.3f} B parameters drawn on the card "
          f"in {time.time() - t0:.1f}s")
    eng = ServingEngine(params, cfg, slots=8, cache_len=1024, page_size=16,
                        chunk=128, paged=True, use_kernel=True, device="cuda")
    t0 = time.time()
    eng.warmup()
    print(f"warmup: {time.time() - t0:.1f}s")
    reqs = make_requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    rec = time_steps(eng)
    draws = []                           # the sampled slots of each draw
    topp_sample = engine_mod.topp_sample

    def counted(keys, logits, *args):
        draws.append(keys.shape[0])
        return topp_sample(keys, logits, *args)
    engine_mod.topp_sample = counted
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        done = eng.run()
    finally:
        engine_mod.topp_sample = topp_sample
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fwd.launches
    st = eng.stats
    n_layers = cfg.n_layers
    if len(done) != 16 or any(len(r.generated) != 32 for r in done):
        fail("not every request finished with 32 tokens")
    # requests 3 and 10 sample (their slots draw at every step while they
    # hold a temperature, the others are greedy): at least their 2 x 32
    # tokens' rows, at most 2 rows a draw
    if sum(draws) < 2 * 32 or max(draws) > 2:
        fail(f"{sum(draws)} sampled rows in {len(draws)} draws (at most "
             f"{max(draws, default=0)} a draw): not requests 3 and 10's")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail("a generated token lies outside the vocabulary")
    if st["shared_pages"] <= 0:
        fail("no prefix page was shared")
    if launches != st["decode_calls"] * n_layers:
        fail(f"kernel launches {launches} != decode_calls "
             f"{st['decode_calls']} x {n_layers}")
    print(f"served 16 requests x 32 tokens in {wall:.2f}s: "
          f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
          f"ticks, {st['shared_pages']} shared pages, {st['cow_copies']} CoW, "
          f"{st['backpressure']} backpressure; kernel launches {launches} "
          f"= {st['decode_calls']} x {n_layers}; {len(draws)} threefry "
          f"draws of {sum(draws)} sampled rows (requests 3 and 10)")
    timing = serving_times(rec, wall)

    # one decode tick on a served state: kernel path vs scan path logits
    del eng._call_step                   # back to the untimed step
    for r in make_requests(Request, cfg.vocab_size, seed=1)[:8]:
        eng.submit(r)
    eng._admit()
    act = [s for s in range(eng.slots) if eng.active[s] is not None]
    toks = np.zeros((eng.slots, 1), np.int32)
    pos = np.full((eng.slots, 1), -1, np.int32)
    for s in act:
        eng._ensure_blocks(s, eng.positions[s], eng.positions[s])
        toks[s, 0], pos[s, 0] = eng.active[s].pending, eng.positions[s]
    toks, pos = torch.from_numpy(toks).cuda(), torch.from_numpy(pos).cuda()
    table = eng._table_arg()
    snapshot = copy.deepcopy(eng.caches)
    logits = []
    for caches, use_kernel in ((eng.caches, True), (snapshot, False)):
        h, _, _ = forward(params, cfg, {"tokens": toks}, caches=caches,
                          positions=pos, masked_slots=True,
                          block_table=table, compute_logits=False,
                          use_kernel=use_kernel)
        logits.append(unembed(params, cfg, h[:, -1:, :])[:, 0])
    lk, ls = logits
    if lk.shape != (8, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail("decode logits are not finite (8, vocab)")
    err = (lk - ls).abs().max().item()
    scale = max(1.0, ls.abs().max().item())
    agree = (lk.argmax(-1) == ls.argmax(-1)).float().mean().item()
    if err > 2e-2 * scale:
        fail(f"kernel-path logits differ from the scan path by {err} "
             f"(scale {scale})")
    print(f"decode tick kernel vs scan: max |dlogit| {err:.4e} at logit "
          f"scale {scale:.3f} (tol {2e-2 * scale:.4f}), greedy agree {agree}")
    del snapshot, logits, lk, ls
    timing.update(profile_ticks(eng))
    return launches, timing


def profile_ticks(eng, n=3, step=None, what="decode ticks"):
    """Device-busy share and the top kernels of ``n`` decode ticks over
    the 8 slots admitted above (or of ``n`` calls of ``step``), under
    ``torch.profiler`` (its own overhead inflates the wall time, so the
    busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    step = step or eng.tick
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    tracing.reset()                    # the session's spans: read by none
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        print("profile: the profiler saw no device time (not measured)")
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # the paged-decode kernel's instances and merge, whichever ran
    paged = sum(e.self_device_time_total for e in kernels
                if "paged_" in e.key) / busy
    print(f"profile of {n} {what}: {wall_us / n / 1e3:.2f} ms/tick "
          f"under the profiler, device busy {busy / n / 1e3:.2f} ms/tick "
          f"({busy / wall_us:.3f} of wall), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/tick; paged "
          f"decode {paged:.3f} of device time; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.3f}"
                      for e in top))
    return {"profiled_ms_per_tick": wall_us / n / 1e3,
            "device_busy_ms_per_tick": busy / n / 1e3,
            "device_busy_share": busy / wall_us,
            "paged_share": paged,
            "kernels_per_tick": sum(e.count for e in kernels) / n}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# Phase 4: kernel times at the served shape
# ---------------------------------------------------------------------------

def event_ms(fn, n):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n, kernel=None):
    """Device time per call of ``fn(i)`` over ``n`` calls, from the
    records that ``torch.profiler`` (CUPTI) keeps of the kernels the calls
    launch: the time the card spends in them, not the host time between
    them.  Only records whose name holds ``kernel`` (or one of a tuple
    of names) count (all of the call's when None), and each name must
    come ``n`` times as often as in one call profiled alone: a dropped or
    stray record would read as a shorter or longer call, so both are
    profiled again, up to three times in all, and then the run fails.
    Once the serving phases have run, a session loses the records of its
    first launches (the marker's among them, in some runs, so that
    nothing counts), so each session starts with 20 untimed calls and a
    marker kernel, and only records after the marker count."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    def records(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(20):
                fn(i)
            torch.cuda._sleep(1000)                # the marker
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        tracing.reset()                # the session's spans: read by none
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
        marks = [k for k, e in enumerate(ev) if "spin_kernel" in e.name]
        return [e for e in ev[marks[-1] + 1 if marks else len(ev):]
                if kernel is None or any(k in e.name for k in names)]
    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        one = Counter(e.name for e in records(1))
        ev = records(n)
        got = Counter(e.name for e in ev)
        if one and got == Counter({k: c * n for k, c in one.items()}):
            return sum(e.self_device_time_total for e in ev) / n / 1e3
    fail(f"the profiler kept {sum(got.values())} records of "
         f"{kernel or 'the call'} over {n} calls, {sum(one.values())} in "
         f"one call")


def phase_kernel_times(fwd, ref, Hq, model):
    import torch.nn.functional as F
    from repro_torch.models.layers import gather_pages, gather_pos
    # four pools (4 x 33.5 MB of K/V) in turn, so L2 (50 MB) holds no
    # previous launch's pages — the serving loop reads them cold too
    cases = [decode_case(Hq, torch.bfloat16, seed=s) for s in range(4)]
    c = cases[0]
    B, _, Hq, D = c["q"].shape
    page, Hkv, Dv = c["v"].shape[1], c["v"].shape[2], c["v"].shape[3]
    out = run_kernel(fwd, c)
    exp = run_kernel(ref, c)
    max_err = (out.float() - exp.float()).abs().max().item()
    for _ in range(3):
        run_kernel(fwd, c)
    # a launch takes less device time than the wrapper's host time, so
    # back-to-back calls timed by events measure the host: the kernel's
    # time is its device time under the profiler (events kept beside it)
    call_ms = event_ms(lambda i: run_kernel(fwd, cases[i % 4]), 200)
    ms = device_ms(lambda i: run_kernel(fwd, cases[i % 4]), 200,
                   "paged_split_kernel")
    plain_ms = event_ms(lambda i: run_kernel(ref, cases[i % 4]), 5)

    def sdpa_inputs(c):
        t = c["table"]
        kd = gather_pages(c["k"], t).transpose(1, 2)         # (B,Hkv,T,D)
        vd = gather_pages(c["v"], t).transpose(1, 2)
        kp = gather_pos(c["pos"], t)                         # (B,T)
        mask = ((kp >= 0) & (kp <= c["q_pos"]))[:, None, None, :]
        return c["q"].transpose(1, 2), kd, vd, mask
    gathered = [sdpa_inputs(c) for c in cases]

    def sdpa(i):
        q, kd, vd, mask = gathered[i % 4]
        return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask,
                                              enable_gqa=True)
    lib = sdpa(0).transpose(1, 2)
    torch.testing.assert_close(lib.float(), exp.float(), atol=2e-2, rtol=2e-2)
    for i in range(3):
        sdpa(i)
    library_call_ms = event_ms(sdpa, 200)
    library_ms = device_ms(sdpa, 200)

    # least time for the same work, from this run's data: each allocated
    # page's K/V (+ positions) read once per kv head, q / table / q_pos
    # read once, the output written once
    cols = int((c["table"] >= 0).sum())
    isz = c["q"].element_size()
    byts = (cols * page * Hkv * (D + Dv) * isz + cols * page * 4
            + c["table"].numel() * 4 + B * 4 + B * Hq * D * isz
            + B * Hq * Dv * isz)
    flops = 2 * cols * page * Hq * (D + Dv)      # q.k and p.v per position
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"paged_attention at {model}'s served shape (B=8, Hq={Hq}, Hkv=8, "
          f"D=128, page 16, 64 columns, {cols} allocated): kernel "
          f"{ms * 1e3:.2f} us of device time ({call_ms * 1e3:.2f} us per call "
          f"back to back), bound {bound_ms * 1e3:.2f} us ({byts / 1e6:.2f} "
          f"MB), plain {plain_ms * 1e3:.1f} us, sdpa on gathered K/V "
          f"{library_ms * 1e3:.2f} us of device time ({library_call_ms * 1e3:.2f}"
          f" us per call)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max_err, "call_ms": call_ms,
            "library_call_ms": library_call_ms}


# ---------------------------------------------------------------------------
# Phase 2b / 10b: the paged-decode kernel at MLA's shape
# ---------------------------------------------------------------------------

# deepseek-v3-671b's absorbed decode: 128 query heads over one latent head
# of kv_lora_rank 512, the rope term of qk_rope_dim 64, the latent pool as
# both K and V; scale (qk_nope_dim + qk_rope_dim) ** -0.5
MLA_HQ, MLA_D, MLA_DE = 128, 512, 64
MLA_SCALE = (128 + 64) ** -0.5
# the kernels one call of the MLA instance launches: split kernel, merge
MLA_KERNELS = ("paged_mla_kernel", "paged_merge_kernel")


def mla_case(used, dtype, seed=0, N=None, page=16):
    """8 slots at MLA's shape, 64 table columns of ``page`` rows; ``used``
    pages per row (an int or one per row); v is the same tensor as k."""
    c = pool_case(8, MLA_HQ, 1, MLA_D, page, 64, used, seed=seed,
                  dtype=dtype, De=MLA_DE, N=N)
    c["v"] = c["k"]
    return c


def mla_decode_case(dtype, seed=0):
    """The served decode shape of deepseek-v3-671b at 8 slots: rows filled
    to the mixed lengths of ``decode_case`` (2..40 pages) over a 512-page
    latent pool."""
    g = torch.Generator().manual_seed(seed + 100)
    used = torch.randint(2, 41, (8,), generator=g).tolist()
    return mla_case(used, dtype, seed=seed, N=512)


def phase_mla_vs_plain(fwd, ref):
    """The kernel at MLA's shape (G = 128, D = Dv = 512, De = 64, k is v)
    against the sequential plain version and the split-K mirror of the
    instance that ran, with 1, 3 and all 64 columns used per row: the MLA
    instance (bf16, 16-row pages: the main path's; its mirror takes
    ``MLA_PAGES_PER_SPLIT`` columns a split and rounds P to bf16), in
    both of the cases the tensor cores
    see in bf16 (pools of random rows, and pools whose rows repeat one
    page, so many scores tie), and the CUDA-core head-tiled instance
    (float32; and bf16 with 8-row pages, which the MLA instance does not
    take; the split kernel's mirror); each case's launch is counted by the
    instance it names; -1 columns appended leave the output bit for bit;
    an idle slot outputs exact zeros and leaves the other rows' bits."""
    from repro_torch.kernels.ref import (MLA_PAGES_PER_SPLIT,
                                         paged_attention_split_ref)
    worst = {}
    for dname, dtype, page, inst, tied in (
            ("bfloat16", torch.bfloat16, 16, "mla", False),
            ("bfloat16", torch.bfloat16, 16, "mla", True),
            ("bfloat16", torch.bfloat16, 8, "tiled", False),
            ("float32", torch.float32, 16, "tiled", False)):
        tol = TOL[dname]
        key = (f"{dname}, page {page}, "
               + ("MLA instance" if inst == "mla" else "CUDA cores")
               + (", tied rows" if tied else ""))
        split_kw = (dict(pages_per_split=MLA_PAGES_PER_SPLIT, round_p=True)
                    if inst == "mla" else {})

        def mirror(*a, **kw):
            return paged_attention_split_ref(*a, **kw, **split_kw)

        def kern(c):
            before = fwd.instance_launches[inst]
            out = run_kernel(fwd, c, scale=MLA_SCALE)
            if fwd.instance_launches[inst] != before + 1:
                fail(f"MLA {key}: the call did not run the {inst} instance")
            return out
        for used in (1, 3, 64):
            c = mla_case(used, dtype, seed=used, page=page)
            if tied:                     # every page a copy of one page
                src = c["table"][0, 0].item()
                for name in ("k", "k_extra"):
                    c[name][:] = c[name][src]
                c["v"] = c["k"]
            out = kern(c)
            torch.cuda.synchronize()
            for what, plain in (("plain", ref), ("split-K mirror", mirror)):
                exp = run_kernel(plain, c, scale=MLA_SCALE)
                err = (out.float() - exp.float()).abs().max().item()
                scale = max(1.0, exp.float().abs().max().item())
                if err > tol * scale:
                    fail(f"MLA {key}, {used} columns: kernel vs {what} "
                         f"{err} (tol {tol} x scale {scale})")
                worst[key] = max(worst.get(key, 0.0), err)
            for extra in (2, 9):
                wide = dict(c, table=torch.cat(
                    [c["table"], torch.full_like(c["table"][:, :1].expand(
                        -1, extra), -1)], 1).contiguous())
                if not torch.equal(kern(wide), out):
                    fail(f"MLA {key}: {extra} -1 table columns changed the "
                         f"output")
            idle = dict(c, q_pos=c["q_pos"].clone())
            idle["q_pos"][1, 0] = -1
            o = kern(idle)
            if (o[1].abs().max().item() != 0.0
                    or not torch.equal(o[0], out[0])
                    or not torch.equal(o[2:], out[2:])):
                fail(f"MLA {key}: an idle slot did not output exact zeros "
                     f"or moved another row")
        torch.cuda.synchronize()
        print(f"kernel vs plain at MLA's shape [{key}] (B=8, Hq=128, "
              f"Hkv=1, D=Dv=512, De=64, k is v; 1, 3 and 64 columns "
              f"used): max abs err {worst[key]:.3e} against the plain "
              f"version and the {inst} instance's split-K mirror (tol "
              f"{tol} of the scale); -1 columns neutral bit for bit, idle "
              f"slots zero")
    return worst


def sdpa_backend(fn) -> str:
    """The kernels one call of ``fn()`` launches, by name (they name the
    backend ``scaled_dot_product_attention`` picked)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    return "; ".join(n[:60] for n in names)


def phase_mla_kernel_times(fwd, ref):
    """The MLA instance at deepseek-v3-671b's served decode shape,
    by device time, beside its bounds (bytes; operations on the tensor
    cores, the card's least time; operations on the CUDA cores, the floor
    of this instance's design), its plain version and
    ``scaled_dot_product_attention`` on the gathered latents (q = [q_lat
    | q_rope], k = [ckv | krope], v = ckv: E = 576, Ev = 512)."""
    import torch.nn.functional as F
    from repro_torch.models.layers import gather_pages, gather_pos
    # six pools of 9.4 MB at most in turn, past the 50 MB of L2
    cases = [mla_decode_case(torch.bfloat16, seed=s) for s in range(6)]
    c = cases[0]
    B, _, Hq, D = c["q"].shape
    page, Dv, De = c["v"].shape[1], c["v"].shape[3], MLA_DE
    kw = dict(scale=MLA_SCALE)
    out = run_kernel(fwd, c, **kw)
    exp = run_kernel(ref, c, **kw)
    max_err = (out.float() - exp.float()).abs().max().item()
    for _ in range(3):
        run_kernel(fwd, c, **kw)
    # the MLA split kernel and the merge kernel
    ms = device_ms(lambda i: run_kernel(fwd, cases[i % 6], **kw), 100,
                   MLA_KERNELS)
    call_ms = event_ms(lambda i: run_kernel(fwd, cases[i % 6], **kw), 100)
    plain_ms = event_ms(lambda i: run_kernel(ref, cases[i % 6], **kw), 3)

    def sdpa_inputs(c):
        t = c["table"]
        q = torch.cat([c["q"], c["q_extra"]], -1).transpose(1, 2)
        kd = torch.cat([gather_pages(c["k"], t),
                        gather_pages(c["k_extra"], t)],
                       -1).transpose(1, 2)                    # (B,1,T,576)
        vd = gather_pages(c["v"], t).transpose(1, 2)          # (B,1,T,512)
        kp = gather_pos(c["pos"], t)
        mask = ((kp >= 0) & (kp <= c["q_pos"]))[:, None, None, :]
        return q, kd, vd, mask
    gathered = [sdpa_inputs(c) for c in cases]

    def sdpa(i):
        q, kd, vd, mask = gathered[i % 6]
        return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask,
                                              scale=MLA_SCALE,
                                              enable_gqa=True)
    lib = sdpa(0).transpose(1, 2)
    torch.testing.assert_close(lib.float(), exp.float(), atol=2e-2, rtol=2e-2)
    backend = sdpa_backend(lambda: sdpa(0))
    for i in range(3):
        sdpa(i)
    library_call_ms = event_ms(sdpa, 100)
    library_ms = device_ms(sdpa, 100)

    # least time for the same work on this run's data: each allocated
    # page's latent and rope rows (K is V: read once) and positions read
    # once, q / q_extra / table / q_pos read once, the output written once;
    # q.k over D + De and p.v over Dv for every row of an allocated page
    cols = int((c["table"] >= 0).sum())
    isz = c["q"].element_size()
    byts = (cols * page * (D + De) * isz + cols * page * 4
            + c["table"].numel() * 4 + B * 4 + B * Hq * (D + De) * isz
            + B * Hq * Dv * isz)
    flops = 2 * cols * page * Hq * (D + De + Dv)
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_tc, t_cc = flops / BF16_FLOPS * 1e3, flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_tc)
    print(f"paged_attention at deepseek-v3-671b's MLA decode shape (B=8, "
          f"Hq=128, Hkv=1, D=Dv=512, De=64, page 16, 64 columns, {cols} "
          f"allocated, k is v): MLA instance {ms * 1e3:.2f} us of "
          f"device time ({call_ms * 1e3:.2f} us per call back to back); "
          f"bound "
          f"{bound_ms * 1e3:.2f} us (bytes {byts / 1e6:.2f} MB = "
          f"{t_bytes * 1e3:.2f} us; {flops / 1e9:.3f} GFLOP = "
          f"{t_tc * 1e3:.2f} us on the tensor cores, {t_cc * 1e3:.2f} us on "
          f"the CUDA cores); plain {plain_ms * 1e3:.1f} us; sdpa on the "
          f"gathered latents {library_ms * 1e3:.2f} us of device time "
          f"({library_call_ms * 1e3:.2f} us per call), kernels: {backend}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bound_cuda_cores_ms": t_cc, "max_abs_err": max_err,
            "call_ms": call_ms, "library_call_ms": library_call_ms,
            "library_kernels": backend}


# ---------------------------------------------------------------------------
# Phase 2c / 10c: the paged-decode kernel at gemma3-12b's shape
# ---------------------------------------------------------------------------

# gemma3-12b's decode: 16 q / 8 kv heads (G = 2, the kernel's GB = 4
# bucket) of 256, 16-row pages; its 40 sliding-window layers read a
# 64-column ring (window 1024), its 8 global layers a 128-column table
# (cache_len 2048)
GEMMA_HQ, GEMMA_HKV, GEMMA_D, GEMMA_WINDOW = 16, 8, 256, 1024
GEMMA_RING_COLS, GEMMA_COLS = 64, 128


def ring_case(dtype, seed=0, lag=None, lengths=None):
    """8 slots over a pool of 8 x 64 ring pages, each row's own 64 ring
    columns (scattered blocks).  Row b has written positions 0 ..
    ``last_b`` (``lengths``, most past the 1,024-position ring, so it has
    wrapped: ring slot l holds the largest written p with p % 1024 == l)
    and queries at ``last_b + lag_b``: the ``lag_b - 1`` oldest positions
    in the ring lie below q_pos - 1023 and must be masked by the window."""
    g = torch.Generator().manual_seed(seed + 300)
    B, page, R = 8, 16, GEMMA_RING_COLS
    lengths = lengths or [1500, 2040, 1100, 300, 1024, 1700, 1999, 40]
    lag = lag or torch.randint(1, 41, (B,), generator=g).tolist()
    N = B * R

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dtype).cuda()

    table = torch.randperm(N, generator=g).reshape(B, R).to(torch.int32)
    pos = torch.full((N, page), -1, dtype=torch.int32)
    for b in range(B):
        for p in range(max(0, lengths[b] - R * page), lengths[b]):
            sl = p % (R * page)
            pos[table[b, sl // page], sl % page] = p
        # a ring not yet wrapped leaves its unwritten columns unallocated
        n_used = min(R, -(-lengths[b] // page))
        table[b, n_used:] = -1
    q_pos = torch.tensor([[lengths[b] - 1 + lag[b]] for b in range(B)],
                         dtype=torch.int32)
    return {"q": rnd(B, 1, GEMMA_HQ, GEMMA_D),
            "k": rnd(N, page, GEMMA_HKV, GEMMA_D),
            "v": rnd(N, page, GEMMA_HKV, GEMMA_D), "pos": pos.cuda(),
            "table": table.cuda(), "q_pos": q_pos.cuda()}


def global_case(dtype, seed=0):
    """The global layers' shape: 8 slots, a 128-column table over a
    1,024-page pool, rows filled to mixed lengths (2..128 pages)."""
    g = torch.Generator().manual_seed(seed + 400)
    used = torch.randint(2, GEMMA_COLS + 1, (8,), generator=g).tolist()
    return pool_case(8, GEMMA_HQ, GEMMA_HKV, GEMMA_D, 16, GEMMA_COLS, used,
                     seed=seed, dtype=dtype, N=1024)


def phase_gemma_vs_plain(fwd, ref):
    """The kernel at gemma3's shape against the plain version and the
    split-K mirror: a wrapped windowed ring and the 128-column table, bf16
    within 2e-2 and f32 within 1e-4; a windowed position below the window
    really changes the output when unmasked (so the mask is exercised);
    -1 columns appended to the ring bit for bit neutral; an idle slot
    exact zeros."""
    from repro_torch.kernels.ref import paged_attention_split_ref
    worst = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        tol = TOL[dname]
        # bf16 runs the wide-head instance, float32 the split kernel's GB = 4
        want = "wide" if dtype == torch.bfloat16 else "split"
        before = fwd.instance_launches[want]
        cases = [(ring_case(dtype, seed=s), GEMMA_WINDOW) for s in (0, 1)]
        cases += [(global_case(dtype, seed=s), 0) for s in (0, 1)]
        for c, window in cases:
            out = run_kernel(fwd, c, window=window)
            torch.cuda.synchronize()
            exp = run_kernel(ref, c, window=window)
            torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                       rtol=tol)
            split = run_kernel(paged_attention_split_ref, c, window=window)
            torch.testing.assert_close(out.float(), split.float(), atol=tol,
                                       rtol=tol)
            worst[dname] = max(worst.get(dname, 0.0),
                               (out.float() - exp.float()).abs().max().item())
        if fwd.instance_launches[want] != before + len(cases):
            fail(f"{dname}: gemma3's shape did not run the {want} instance")
        c = cases[0][0]
        base = run_kernel(fwd, c, window=GEMMA_WINDOW)
        # the window is doing work: the same ring without it reads the
        # positions below q_pos - 1023 and must differ
        nowin = run_kernel(fwd, c)
        tab = c["table"]
        got = c["pos"][tab.clamp(min=0).long()]            # (8, 64, 16)
        masked = int(((tab >= 0)[..., None] & (got >= 0)
                      & (got <= c["q_pos"][:, :, None] - GEMMA_WINDOW)).sum())
        if masked == 0 or torch.equal(nowin, base):
            fail(f"{dname}: the ring case holds no position below the "
                 f"window ({masked}) or the window changed nothing")
        for extra in (2, 9):
            wide = dict(c, table=torch.cat(
                [c["table"], torch.full((8, extra), -1, dtype=torch.int32,
                                        device="cuda")], 1).contiguous())
            if not torch.equal(run_kernel(fwd, wide, window=GEMMA_WINDOW),
                               base):
                fail(f"{dname}: {extra} -1 columns changed gemma3's output")
        idle = dict(c, q_pos=c["q_pos"].clone())
        idle["q_pos"][2, 0] = -1
        out = run_kernel(fwd, idle, window=GEMMA_WINDOW)
        if out[2].abs().max().item() != 0.0 or not torch.equal(out[0],
                                                              base[0]):
            fail(f"{dname}: an idle gemma3 slot did not output exact zeros")
        torch.cuda.synchronize()
        print(f"gemma3 shape (B=8, Hq=16, Hkv=8, D=256) kernel ({want} "
              f"instance) vs plain [{dname}]: wrapped 64-column ring with window 1024 "
              f"({masked} ring positions below the window) and 128-column "
              f"table, max abs err {worst[dname]:.3e} (tol {tol}; also "
              f"within it of the split-K mirror); -1 columns neutral, idle "
              f"slots zero")
    return worst


def phase_gemma_kernel_times(fwd, ref):
    """The kernel at gemma3's two decode shapes beside its bound, its
    plain version and SDPA on the gathered K/V with the window as a
    boolean mask: the full ring (8 x 1024 positions, every column
    allocated) and the 128-column table filled to 2,048 positions."""
    import torch.nn.functional as F
    from repro_torch.models.layers import gather_pages, gather_pos
    full = [GEMMA_RING_COLS * 16 + 500 + 37 * b for b in range(8)]
    shapes = {
        "ring": ([ring_case(torch.bfloat16, seed=s, lag=[1] * 8,
                            lengths=full) for s in range(4)], GEMMA_WINDOW),
        "global": ([pool_case(8, GEMMA_HQ, GEMMA_HKV, GEMMA_D, 16,
                              GEMMA_COLS, GEMMA_COLS, seed=s,
                              dtype=torch.bfloat16, N=1024)
                    for s in range(4)], 0)}
    res = {}
    for name, (cases, window) in shapes.items():
        c = cases[0]
        B, _, Hq, D = c["q"].shape
        page, Hkv, Dv = c["v"].shape[1], c["v"].shape[2], c["v"].shape[3]
        out = run_kernel(fwd, c, window=window)
        exp = run_kernel(ref, c, window=window)
        max_err = (out.float() - exp.float()).abs().max().item()
        for _ in range(3):
            run_kernel(fwd, c, window=window)
        call_ms = event_ms(
            lambda i: run_kernel(fwd, cases[i % 4], window=window), 200)
        ms = device_ms(lambda i: run_kernel(fwd, cases[i % 4], window=window),
                       200, ("paged_split_kernel", "paged_wide_kernel"))
        plain_ms = event_ms(
            lambda i: run_kernel(ref, cases[i % 4], window=window), 5)

        def sdpa_inputs(c):
            t = c["table"]
            kd = gather_pages(c["k"], t).transpose(1, 2)
            vd = gather_pages(c["v"], t).transpose(1, 2)
            kp = gather_pos(c["pos"], t)
            mask = (kp >= 0) & (kp <= c["q_pos"])
            if window:
                mask &= kp > c["q_pos"] - window
            return c["q"].transpose(1, 2), kd, vd, mask[:, None, None, :]
        gathered = [sdpa_inputs(c) for c in cases]

        def sdpa(i):
            q, kd, vd, mask = gathered[i % 4]
            return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask,
                                                  enable_gqa=True)
        torch.testing.assert_close(sdpa(0).transpose(1, 2).float(),
                                   exp.float(), atol=2e-2, rtol=2e-2)
        for i in range(3):
            sdpa(i)
        library_call_ms = event_ms(sdpa, 200)
        library_ms = device_ms(sdpa, 200)
        del gathered
        # each allocated page's K/V (+ positions) read once per kv head,
        # q / table / q_pos read once, the output written once; q.k and
        # p.v over every allocated position
        cols = int((c["table"] >= 0).sum())
        isz = c["q"].element_size()
        byts = (cols * page * Hkv * (D + Dv) * isz + cols * page * 4
                + c["table"].numel() * 4 + B * 4 + B * Hq * D * isz
                + B * Hq * Dv * isz)
        flops = 2 * cols * page * Hq * (D + Dv)
        t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        print(f"paged_attention at gemma3-12b's {name} shape (B=8, Hq=16, "
              f"Hkv=8, D=256, page 16, {c['table'].shape[1]} columns, {cols} "
              f"allocated{', window 1024' if window else ''}): kernel "
              f"{ms * 1e3:.2f} us of device time ({call_ms * 1e3:.2f} us per "
              f"call back to back), bound {bound_ms * 1e3:.2f} us "
              f"({byts / 1e6:.2f} MB), plain {plain_ms * 1e3:.1f} us, sdpa "
              f"on gathered K/V {library_ms * 1e3:.2f} us of device time "
              f"({library_call_ms * 1e3:.2f} us per call)")
        res[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "max_abs_err": max_err, "call_ms": call_ms,
                     "library_call_ms": library_call_ms}
    return res


# ---------------------------------------------------------------------------
# Phase 5: the rwkv_scan kernel against its plain version
# ---------------------------------------------------------------------------

RWKV_SWEEP = [(1, 32, 2, 16), (2, 64, 3, 16), (1, 40, 1, 32)]  # (B, S, H, hd)
# head dims whose bf16 rows (hd 20) or state rows (hd 18) are no whole
# 16-byte units: the kernel's element-by-element staging and state moves
RWKV_ODD = [(1, 9, 2, 20), (2, 5, 1, 18)]
RWKV_DECODE = (8, 1, 64, 64)       # the served shapes of rwkv6-7b at 8 slots
RWKV_PREFILL = (8, 128, 64, 64)    # (a 128-token chunk, one live row)
RWKV_LIVE_ROW = 3


def rwkv_case(B, S, H, hd, *, seed, dtype, w_dtype=None, state=False):
    """r, k, v ~ N(0, 1), w = sigmoid(N(0, 1)) in (0, 1), u ~ 0.1 N(0, 1)
    (as in ``tests/test_kernels.py``), optionally a N(0, 1) state."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    c = {n: rnd(B, S, H, hd).to(dtype).cuda() for n in "rkv"}
    c["w"] = torch.sigmoid(rnd(B, S, H, hd)).to(w_dtype or dtype).cuda()
    c["u"] = (rnd(H, hd) * 0.1).cuda()
    if state:
        c["s0"] = rnd(B, H, hd, hd).cuda()
    return c


def rwkv_args(c):
    return [c[n] for n in "rkvwu"]


def served_rwkv_case(shape, seed=0):
    """The model path's operands: bf16 r / k / v, f32 w, a cached state,
    and (prefill) one live row."""
    c = rwkv_case(*shape, seed=seed, dtype=torch.bfloat16,
                  w_dtype=torch.float32, state=True)
    if shape[1] > 1:
        c["rows"] = torch.zeros(shape[0], dtype=torch.bool, device="cuda")
        c["rows"][RWKV_LIVE_ROW] = True
    return c


def _err(out, exp, tol, what):
    err = (out.float() - exp.float()).abs().max().item()
    try:
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as e:
        fail(f"rwkv_scan {what}: {e}")
    return err


def phase_rwkv_vs_plain(fwd, ref):
    """The kernel against the plain version and against the plain mirror
    of its arithmetic (``rwkv_scan_split_ref``: the bonus factored out,
    the i-sum split in row groups added in order), both at the dtype's
    tolerance; rows flagged idle keep their state bit for bit."""
    from repro_torch.kernels.ref import rwkv_scan_split_ref as mirror
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for B, S, H, hd in RWKV_SWEEP + RWKV_ODD:
            c = rwkv_case(B, S, H, hd, seed=S, dtype=dtype)
            out = fwd(*rwkv_args(c))
            torch.cuda.synchronize()
            for f, what in ((ref, "plain"), (mirror, "mirror")):
                worst[dname] = max(worst[dname], _err(
                    out, f(*rwkv_args(c)), TOL[dname],
                    f"sweep {dname} {(B, S, H, hd)} vs {what}"))
    print(f"rwkv_scan vs plain and mirror, sweep of test_rwkv_scan_vs_ref "
          f"plus hd 20 and 18, zero state: max abs err bf16 "
          f"{worst['bfloat16']:.3e} (tol 2e-2), f32 {worst['float32']:.3e} "
          f"(tol 1e-4)")
    tol = TOL["float32"]
    for S in (1, 150):
        for dtype in (torch.bfloat16, torch.float32):
            for H, hd in ((4, 64), (3, 18)):
                c = rwkv_case(2, S, H, hd, seed=S, dtype=dtype,
                              w_dtype=torch.float32, state=True)
                o, st = fwd(*rwkv_args(c), s0=c["s0"],
                            out_dtype=torch.float32, return_state=True)
                torch.cuda.synchronize()
                e = []
                for f in (ref, mirror):
                    eo, es = f(*rwkv_args(c), s0=c["s0"],
                               out_dtype=torch.float32, return_state=True)
                    e += [_err(o, eo, tol, f"o with s0, hd={hd}"),
                          _err(st, es, tol, f"state, hd={hd}")]
                print(f"rwkv_scan vs plain / mirror, s0 given, S={S}, "
                      f"hd={hd}, {dtype}: max abs err o {e[0]:.3e} / "
                      f"{e[2]:.3e}, state {e[1]:.3e} / {e[3]:.3e} (tol 1e-4)")
    errs = {}
    for name, shape in (("decode", RWKV_DECODE), ("prefill", RWKV_PREFILL)):
        c = served_rwkv_case(shape)
        rows = c.get("rows")
        buf = c["s0"].clone()                    # the state, in place
        o = fwd(*rwkv_args(c), s0=buf, out_dtype=torch.float32, rows=rows,
                state_out=buf)
        torch.cuda.synchronize()
        eo, es = ref(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                     return_state=True, rows=rows)
        mo, ms = mirror(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                        return_state=True, rows=rows)
        errs[name] = (_err(o, eo, tol, f"{name} o"),
                      _err(buf, es, tol, f"{name} state"))
        mirror_errs = (_err(o, mo, tol, f"{name} o vs mirror"),
                       _err(buf, ms, tol, f"{name} state vs mirror"))
        if rows is not None and not torch.equal(buf[~rows], c["s0"][~rows]):
            fail(f"rwkv_scan {name}: an idle row's state changed")
        print(f"rwkv_scan vs plain / mirror at the served {name} shape "
              f"(B,S,H,hd)={shape}, state in place: max abs err o "
              f"{errs[name][0]:.3e} / {mirror_errs[0]:.3e}, state "
              f"{errs[name][1]:.3e} / {mirror_errs[1]:.3e} (tol 1e-4)"
              + ("; idle rows' state unchanged bit for bit" if rows is not None
                 else ""))
    return errs


# ---------------------------------------------------------------------------
# Phase 6: rwkv6-7b served at full width
# ---------------------------------------------------------------------------

def make_rwkv_requests(Request, vocab, seed=0, n=16):
    """``n`` requests with prompts of 32..600 tokens, then (seed 0) one of
    1,500 tokens: above cache_len 1024, which only an attention-free model
    admits, and 11 full 128-token chunks plus a 92-token one.  Requests 3
    and 10 sample.  No prompt leaves a 1-token prefill chunk."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(32, 601)) for _ in range(n)]
    if seed == 0:
        lens.append(1500)
    reqs = []
    for i, m in enumerate(lens):
        m += m % 128 == 1
        kw = (dict(temperature=0.8, top_p=0.95, top_k=50) if i in (3, 10)
              else {})
        reqs.append(Request(i, rng.integers(0, vocab, m).tolist(),
                            max_new=32, **kw))
    return reqs


def f32_copy(tree):
    """A float32 copy of a cache tree (bf16 leaves upcast, which is
    exact; other leaves copied as they are)."""
    if isinstance(tree, dict):
        return {k: f32_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(f32_copy(v) for v in tree)
    if torch.is_tensor(tree):
        return (tree.to(torch.float32, copy=True) if tree.is_floating_point()
                else tree.clone())
    return tree


def phase_serve_rwkv(fwd, kernels):
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.layers import ffn_apply, rmsnorm
    from repro_torch.models.transformer import (_period, embed_inputs,
                                                forward, init_params, unembed)
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config("rwkv6-7b")
    t0 = time.time()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"rwkv6-7b: {n_params / 1e9:.3f} B parameters drawn on the card "
          f"in {time.time() - t0:.1f}s ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.rwkv_n_heads} heads of {cfg.rwkv_head_dim})")
    eng = ServingEngine(params, cfg, slots=8, cache_len=1024, chunk=128,
                        paged=True, use_kernel=True, device="cuda")
    t0 = time.time()
    eng.warmup()
    print(f"warmup: {time.time() - t0:.1f}s")
    reqs = make_rwkv_requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)                    # 1,500 > cache_len: admitted
    rec = time_steps(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fwd.launches
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_calls"]
    if len(done) != len(reqs) or any(len(r.generated) != 32 for r in done):
        fail("not every rwkv request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail("a generated token lies outside the vocabulary")
    if st["shared_pages"] != 0:
        fail("an attention-free engine shared a page")
    if launches != calls * cfg.n_layers:
        fail(f"rwkv_scan launches {launches} != (prefill_calls "
             f"{st['prefill_calls']} + decode_calls {st['decode_calls']}) x "
             f"{cfg.n_layers}")
    longest = max(len(r.prompt) for r in done)
    print(f"served {len(done)} requests x 32 tokens (longest prompt "
          f"{longest} > cache_len {eng.cache_len}) in {wall:.2f}s: "
          f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
          f"ticks, {st['shared_pages']} shared pages; rwkv_scan launches "
          f"{launches} = {calls} x {cfg.n_layers}")
    timing = serving_times(rec, wall)

    # a served state: 8 new requests admitted through the kernel path
    del eng._call_step                   # back to the untimed step
    for r in make_rwkv_requests(Request, cfg.vocab_size, seed=1, n=8):
        eng.submit(r)
    eng._admit()

    # float32 activations: the bf16 weights are upcast in each matmul
    # (exactly), and TF32 is off, so the two paths differ by float32
    # roundings only
    params32 = dict(params, embed=params["embed"].float())

    def step_logits(caches, toks, pos, use_kernel):
        h, _, _ = forward(params32, cfg, {"tokens": toks}, caches=caches,
                          positions=pos, masked_slots=True,
                          compute_logits=False, use_kernel=use_kernel)
        return unembed(params32, cfg, h[:, -1:, :])[:, 0]

    def end_to_end(toks, pos, what):
        """One step of the whole model through the kernel path and through
        the plain path, each from a float32 copy of the served caches.  The
        live rows' logits must agree within 2e-2 of the logit scale and
        give the same greedy token; rows that are not live keep their
        state and shift bit for bit on both paths."""
        live = (pos >= 0).any(dim=1)
        before = f32_copy(eng.caches)
        ck, cp = f32_copy(eng.caches), f32_copy(eng.caches)
        lk = step_logits(ck, toks, pos, True)[live]
        lp = step_logits(cp, toks, pos, False)[live]
        n = int(live.sum())
        if lk.shape != (n, cfg.vocab_size) or not torch.isfinite(lk).all():
            fail(f"{what}: logits are not finite ({n}, vocab)")
        err = (lk - lp).abs().max().item()
        scale = max(1.0, lp.abs().max().item())
        top2 = lp.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
        print(f"{what}, whole model in float32: max |dlogit| kernel vs plain "
              f"{err:.4e} over {n} live slot(s) at logit scale {scale:.3f} "
              f"(tol {2e-2 * scale:.4f}); greedy equal in {same}/{n} "
              f"(smallest top-2 margin {margin:.4e})")
        if err > 2e-2 * scale:
            fail(f"{what}: kernel-path logits differ from the plain path by "
                 f"{err} (tol {2e-2 * scale})")
        if same != n:
            fail(f"{what}: a live slot's greedy token differs")
        idle = torch.nonzero(~live).flatten()
        state_err = 0.0
        for caches in (ck, cp):
            for layer, old in zip(caches["stack"], before["stack"]):
                for name in ("state", "shift"):
                    if not torch.equal(layer[name][:, idle],
                                       old[name][:, idle]):
                        fail(f"{what}: an idle slot's {name} changed")
        for a, b in zip(ck["stack"], cp["stack"]):
            state_err = max(state_err, (
                (a["state"][:, live] - b["state"][:, live]).abs().max()
                / b["state"][:, live].abs().max()).item())
        print(f"{what}: live slots' state kernel vs plain max err "
              f"{state_err:.3e} of its scale"
              + (f"; {len(idle)} idle slots' state and shift unchanged bit "
                 f"for bit (kernel and plain paths)" if len(idle) else ""))

    def layerwise(toks, pos, what):
        """Each layer's RWKV mixer through the kernel and through the plain
        scan, on the same input: the plain path's residual stream feeds
        both, so no difference is carried from one layer to the next.
        Outputs (bf16) within 2e-2 of their scale, states (f32) within
        1e-4 of theirs, shifts bit for bit."""
        ck, cp = copy.deepcopy(eng.caches), copy.deepcopy(eng.caches)
        valid = (pos >= 0).any(dim=1)
        x = embed_inputs(params, cfg, {"tokens": toks})
        worst_o = worst_s = 0.0
        for stack in cfg.stacks:
            for t in range(stack.n_periods):
                pp = _period(params["stack"], t)
                pk, pq = _period(ck["stack"], t), _period(cp["stack"], t)
                for j in range(len(stack.period)):
                    h = rmsnorm(x, pp[j]["norm1"], cfg.norm_eps)
                    ok, _ = ssm.rwkv_apply(pp[j]["mixer"], h, cfg,
                                           cache=pk[j], valid=valid,
                                           use_kernel=True)
                    op, _ = ssm.rwkv_apply(pp[j]["mixer"], h, cfg,
                                           cache=pq[j], valid=valid,
                                           use_kernel=False)
                    e_o = ((ok.float() - op.float()).abs().max()
                           / op.float().abs().max().clamp(min=1e-30)).item()
                    e_s = ((pk[j]["state"] - pq[j]["state"]).abs().max()
                           / pq[j]["state"].abs().max().clamp(min=1e-30)
                           ).item()
                    if (e_o > 2e-2 or e_s > 1e-4
                            or not torch.equal(pk[j]["shift"],
                                               pq[j]["shift"])):
                        fail(f"{what}: period {t} layer {j}: kernel vs "
                             f"plain mixer output {e_o}, state {e_s} of "
                             f"scale, or the shift differs")
                    worst_o, worst_s = max(worst_o, e_o), max(worst_s, e_s)
                    x = x + op
                    x = x + ffn_apply(pp[j]["ffn"],
                                      rmsnorm(x, pp[j]["norm2"], cfg.norm_eps))
        print(f"{what}, layer by layer on the same input ({cfg.n_layers} "
              f"layers): kernel vs plain mixer output max err {worst_o:.3e} "
              f"of its scale (tol 2e-2), state {worst_s:.3e} (tol 1e-4), "
              f"shift bit for bit")

    # one decode tick, every slot live
    toks = torch.tensor([[eng.active[s].pending] for s in range(8)],
                        dtype=torch.int32, device="cuda")
    pos = torch.tensor([[eng.positions[s]] for s in range(8)],
                       dtype=torch.int32, device="cuda")
    layerwise(toks, pos, "decode tick")
    end_to_end(toks, pos, "decode tick")
    # one 128-token prefill chunk into slot RWKV_LIVE_ROW, the others idle
    s = RWKV_LIVE_ROW
    g = torch.Generator().manual_seed(2)
    toks = torch.zeros((8, 128), dtype=torch.int32)
    toks[s] = torch.randint(0, cfg.vocab_size, (128,), generator=g)
    pos = torch.full((8, 128), -1, dtype=torch.int32)
    pos[s] = torch.arange(eng.positions[s], eng.positions[s] + 128)
    toks, pos = toks.cuda(), pos.cuda()
    layerwise(toks, pos, "prefill chunk")
    end_to_end(toks, pos, "prefill chunk")
    del params32
    timing.update(profile_ticks(eng))
    return launches, timing


# ---------------------------------------------------------------------------
# Phase 7: rwkv_scan times at the served shapes
# ---------------------------------------------------------------------------

def rwkv_bound(c):
    """Least time for one call on these operands: every input read once
    (the state of every row, since every row's output needs it), the
    output written once and the state of the updated rows written once;
    float32 flops per (b, h, step): r.S is 2 per state element, the
    update w*S + k v^T is 3 (a multiply and an fma), and the bonus term
    v_j * sum_i r_i u_i k_i is rank one, 5 per head dim."""
    B, S, H, hd = c["r"].shape
    rows = B if "rows" not in c else int(c["rows"].sum())
    n = B * S * H * hd
    byts = (n * (3 * c["r"].element_size() + c["w"].element_size())
            + c["u"].numel() * 4 + B * H * hd * hd * 4
            + rows * H * hd * hd * 4
            + n * 4 + (B if "rows" in c else 0))          # o in f32
    flops = B * S * H * hd * (5 * hd + 5)
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), byts, flops


def time_scan(fwd, ref, kernel, served_case, args, s_key, shape, n_bufs,
              reps, plain_reps):
    """Times of one scan kernel at one served shape: (device ms per call
    of the records named ``kernel`` under ``torch.profiler``, ms per call by CUDA events around ``reps``
    back-to-back calls, ms per call of the plain version).  ``n_bufs``
    cases in turn, so that L2 (50 MB) holds none of the previous launch's
    operands, as in serving (each layer has its own).  The kernel writes
    the state in place, as the model path does.  A launch at decode takes
    less device time than the wrapper's host time, so the event time
    measures the host there; the device time is the kernel's."""
    cases = [served_case(shape, seed=i) for i in range(n_bufs)]

    def kern(i):
        c = cases[i % n_bufs]
        return fwd(*args(c), **{s_key: c[s_key]}, out_dtype=torch.float32,
                   rows=c.get("rows"), state_out=c[s_key])

    def plain(i):
        c = cases[i % n_bufs]
        return ref(*args(c), **{s_key: c[s_key]}, out_dtype=torch.float32,
                   return_state=True, rows=c.get("rows"))
    for i in range(3):
        kern(i)
    call_ms = event_ms(kern, reps)
    ms = device_ms(kern, reps, kernel)
    return ms, call_ms, event_ms(plain, plain_reps)


def scan_err(fwd, ref, served_case, args, s_key, shape):
    """Largest |kernel - plain| of the output on a fresh served case."""
    c = served_case(shape, seed=99)
    kw = {s_key: c[s_key], "out_dtype": torch.float32}
    out = fwd(*args(c), rows=c.get("rows"), **kw)
    return (out - ref(*args(c), **kw)).abs().max().item()


def phase_rwkv_kernel_times(fwd, ref):
    out = {}
    for name, shape, n_bufs, reps, plain_reps in (
            ("decode", RWKV_DECODE, 8, 400, 20),
            ("prefill", RWKV_PREFILL, 2, 50, 3)):
        ms, call_ms, plain_ms = time_scan(
            fwd, ref, "rwkv_scan_kernel", served_rwkv_case, rwkv_args, "s0",
            shape, n_bufs, reps, plain_reps)
        bound_ms, bound_by, byts, flops = rwkv_bound(
            served_rwkv_case(shape))
        err = scan_err(fwd, ref, served_rwkv_case, rwkv_args, "s0", shape)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "max_abs_err": err, "call_ms": call_ms}
        print(f"rwkv_scan at the served {name} shape (B,S,H,hd)={shape}: "
              f"kernel {ms * 1e3:.2f} us of device time ({call_ms * 1e3:.2f}"
              f" us per call back to back), bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}: {byts / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP "
              f"f32), plain {plain_ms * 1e3:.1f} us, library none")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the mamba_scan kernel against its plain version
# ---------------------------------------------------------------------------

MAMBA_SWEEP = [(1, 32, 64, 8), (2, 96, 192, 16), (1, 50, 48, 4)]  # B,S,di,ds
# a bf16 row of 50 channels is no whole number of 16-byte units: the
# kernel's element-by-element x / dt staging
MAMBA_ODD = [(2, 20, 50, 16)]
MAMBA_DECODE = (8, 1, 16384, 16)   # the served shapes of jamba-1.5-large
MAMBA_PREFILL = (8, 128, 16384, 16)  # at 8 slots (a 128-token chunk, one
MAMBA_LIVE_ROW = 5                 # live row)
# exp throughput of the SFUs: 16 results per clock per SM on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) x 132 SMs x 1.98 GHz (H100 SXM boost clock, data sheet)
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def mamba_case(B, S, di, ds, *, seed, dtype, state=False):
    """x ~ 0.5 N(0, 1), dt = 0.1 softplus(N(0, 1)), b, c ~ N(0, 1),
    a = -exp(N(0, 1)) (as in ``tests/test_kernels.py``), optionally a
    N(0, 1) initial state."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    c = {"x": (rnd(B, S, di) * 0.5).to(dtype).cuda(),
         "dt": (torch.nn.functional.softplus(rnd(B, S, di)) * 0.1
                ).to(dtype).cuda(),
         "b": rnd(B, S, ds).to(dtype).cuda(),
         "c": rnd(B, S, ds).to(dtype).cuda(),
         "a": (-torch.exp(rnd(di, ds))).cuda()}
    if state:
        c["h0"] = rnd(B, di, ds).cuda()
    return c


def mamba_args(c):
    return [c[n] for n in ("x", "dt", "b", "c", "a")]


def served_mamba_case(shape, seed=0):
    """The model path's operands: bf16 x / dt / b / c, a cached state,
    and (prefill) one live row."""
    c = mamba_case(*shape, seed=seed, dtype=torch.bfloat16, state=True)
    if shape[1] > 1:
        c["rows"] = torch.zeros(shape[0], dtype=torch.bool, device="cuda")
        c["rows"][MAMBA_LIVE_ROW] = True
    return c


def _close(out, exp, tol, what):
    err = (out.float() - exp.float()).abs().max().item()
    try:
        torch.testing.assert_close(out.float(), exp.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as e:
        fail(f"{what}: {e}")
    return err


def phase_mamba_vs_plain(fwd, ref):
    """y in bf16 within 2e-2, y in f32 and the final state within 1e-4 of
    the plain version (the kernel's exp is the SFU's ``ex2.approx``, a
    few ulp off, and its sums contract into fma); rows flagged idle keep
    their state bit for bit."""
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for B, S, di, ds in MAMBA_SWEEP + MAMBA_ODD:
            c = mamba_case(B, S, di, ds, seed=S, dtype=dtype)
            out = fwd(*mamba_args(c))
            torch.cuda.synchronize()
            worst[dname] = max(worst[dname], _close(
                out, ref(*mamba_args(c)), TOL[dname],
                f"mamba_scan sweep {dname} {(B, S, di, ds)}"))
    print(f"mamba_scan vs plain, sweep of test_mamba_scan_vs_ref plus "
          f"d_inner 50, zero state: max abs err bf16 "
          f"{worst['bfloat16']:.3e} (tol 2e-2), f32 {worst['float32']:.3e} "
          f"(tol 1e-4)")
    tol = TOL["float32"]
    for S in (1, 150):
        for dtype in (torch.bfloat16, torch.float32):
            for di in (192, 50):
                c = mamba_case(2, S, di, 16, seed=S, dtype=dtype, state=True)
                y, h = fwd(*mamba_args(c), h0=c["h0"],
                           out_dtype=torch.float32, return_state=True)
                torch.cuda.synchronize()
                ey, eh = ref(*mamba_args(c), h0=c["h0"],
                             out_dtype=torch.float32, return_state=True)
                e = (_close(y, ey, tol, f"mamba_scan y with h0, S={S}, "
                            f"di={di}"),
                     _close(h, eh, tol, f"mamba_scan state, S={S}, di={di}"))
                print(f"mamba_scan vs plain, h0 given, S={S}, di={di}, "
                      f"{dtype}: max abs err y {e[0]:.3e}, state {e[1]:.3e} "
                      f"(tol 1e-4)")
    errs = {}
    for name, shape in (("decode", MAMBA_DECODE), ("prefill", MAMBA_PREFILL)):
        c = served_mamba_case(shape)
        rows = c.get("rows")
        buf = c["h0"].clone()                    # the state, in place
        y = fwd(*mamba_args(c), h0=buf, out_dtype=torch.float32, rows=rows,
                state_out=buf)
        torch.cuda.synchronize()
        ey, eh = ref(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                     return_state=True, rows=rows)
        errs[name] = (_close(y, ey, tol, f"mamba_scan {name} y"),
                      _close(buf, eh, tol, f"mamba_scan {name} state"))
        if rows is not None and not torch.equal(buf[~rows], c["h0"][~rows]):
            fail(f"mamba_scan {name}: an idle row's state changed")
        print(f"mamba_scan vs plain at the served {name} shape "
              f"(B,S,di,ds)={shape}, state in place: max abs err y "
              f"{errs[name][0]:.3e}, state {errs[name][1]:.3e} (tol 1e-4)"
              + ("; idle rows' y written, their state unchanged bit for bit"
                 if rows is not None else ""))
    return errs


# ---------------------------------------------------------------------------
# Phase 9: jamba-1.5-large served at full width (depth cut to 4 of 72)
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 4     # the first half of one 8-layer block: 46.0 GB of bf16


def jamba_config():
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("jamba-1.5-large-398b")
    return dataclasses.replace(cfg, n_layers=JAMBA_LAYERS,
                               period=cfg.period[:JAMBA_LAYERS])


# qwen3-moe-235b-a22b's MoE widths (hf:Qwen/Qwen3-235B-A22B): d_model 4096,
# 128 experts of 1536, top-8; one layer's experts are 4.83 GB of bf16
QWEN3_MOE = dict(d_model=4096, n_experts=128, d_expert=1536, top_k=8,
                 n_shared_experts=0)


def phase_moe_bits():
    """One ``moe_apply`` layer at qwen3-moe-235b-a22b's widths (random bf16
    experts drawn on the card), run twice on 8 decode rows and twice on
    one 128-token chunk: each pair must give the same bits (the top-8
    combine sums each token's eight terms in a fixed order, no atomics)."""
    import dataclasses
    from repro_torch.models.layers import moe_apply, moe_init
    cfg = dataclasses.replace(jamba_config(), **QWEN3_MOE)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe_init(gen, cfg, device="cuda")
    expert_gb = sum(p[k].numel() * 2 for k in ("w_gate", "w_up", "w_down")) / 1e9
    g = torch.Generator(device="cuda").manual_seed(1)
    for what, shape in (("8 decode rows", (8, 1, cfg.d_model)),
                        ("one 128-token chunk", (1, 128, cfg.d_model))):
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        o1, a1 = moe_apply(p, x, cfg)
        o2, a2 = moe_apply(p, x, cfg)
        torch.cuda.synchronize()
        if not (torch.isfinite(o1.float()).all() and torch.equal(o1, o2)
                and torch.equal(a1, a2)):
            fail(f"moe_apply top-{cfg.top_k} on {what}: two runs differ")
        print(f"moe_apply at qwen3-moe-235b-a22b's widths (d {cfg.d_model}, "
              f"{cfg.n_experts} experts of {cfg.d_expert}, top-{cfg.top_k}; "
              f"{expert_gb:.2f} GB of bf16 experts) on {what}: two runs give "
              f"the same bits")
    del p
    torch.cuda.empty_cache()


def phase_serve_jamba(mamba_fwd, paged_fwd, kernels):
    from repro_torch.models import ssm
    from repro_torch.models.config import MAMBA, MOE
    from repro_torch.models.layers import (attn_apply, ffn_apply, moe_apply,
                                           rmsnorm)
    from repro_torch.models.transformer import (_period, embed_inputs,
                                                forward, init_params, unembed)
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = jamba_config()
    n_mamba = sum(sp.mixer == MAMBA for sp in cfg.period)    # 3
    n_attn = len(cfg.period) - n_mamba                       # 1
    t0 = time.time()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"jamba-1.5-large-398b, {JAMBA_LAYERS} of 72 layers "
          f"({', '.join(f'{sp.mixer}+{sp.ffn}' for sp in cfg.period)}): "
          f"{n_params / 1e9:.3f} B parameters drawn on the card in "
          f"{time.time() - t0:.1f}s (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k} of width "
          f"{cfg.d_expert}, Mamba d_inner {cfg.mamba_d_inner}); "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    eng = ServingEngine(params, cfg, slots=8, cache_len=1024, page_size=16,
                        chunk=128, paged=True, use_kernel=True, device="cuda")
    t0 = time.time()
    eng.warmup()
    print(f"warmup: {time.time() - t0:.1f}s")
    # the 16 requests of the rwkv6-7b phase without its 1,500-token one,
    # which jamba's attention layer bounds by cache_len
    reqs = make_rwkv_requests(Request, cfg.vocab_size)[:16]
    for r in reqs:
        eng.submit(r)
    rec = time_steps(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"mamba_scan": mamba_fwd.launches,
                "paged_attention": paged_fwd.launches}
    st = eng.stats
    calls = st["prefill_calls"] + st["decode_calls"]
    if len(done) != 16 or any(len(r.generated) != 32 for r in done):
        fail("not every jamba request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail("a generated token lies outside the vocabulary")
    if st["shared_pages"] != 0:
        fail("an MoE / Mamba engine shared a page")
    if launches["mamba_scan"] != calls * n_mamba:
        fail(f"mamba_scan launches {launches['mamba_scan']} != (prefill_calls "
             f"{st['prefill_calls']} + decode_calls {st['decode_calls']}) x "
             f"{n_mamba}")
    if launches["paged_attention"] != st["decode_calls"] * n_attn:
        fail(f"paged_attention launches {launches['paged_attention']} != "
             f"decode_calls {st['decode_calls']} x {n_attn}")
    print(f"served 16 requests x 32 tokens in {wall:.2f}s: "
          f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
          f"ticks, {st['shared_pages']} shared pages; mamba_scan launches "
          f"{launches['mamba_scan']} = {calls} x {n_mamba}, paged_attention "
          f"launches {launches['paged_attention']} = {st['decode_calls']} x "
          f"{n_attn}")
    timing = serving_times(rec, wall)

    # a served state: 8 new requests admitted through the kernel path
    del eng._call_step                   # back to the untimed step
    for r in make_rwkv_requests(Request, cfg.vocab_size, seed=1, n=8):
        eng.submit(r)
    eng._admit()

    def layerwise(toks, pos, what):
        """Each layer's mixer through its kernel and through the plain path
        on the same input: the plain path's residual stream feeds both, so
        no difference is carried from one layer to the next.  Mixer outputs
        (bf16) within 2e-2 of their scale, Mamba state (f32) within 1e-4 of
        its scale, conv history bit for bit (a copy of the same input)."""
        ck, cp = copy.deepcopy(eng.caches), copy.deepcopy(eng.caches)
        table = eng._table_arg()
        valid = (pos >= 0).any(dim=1)
        x = embed_inputs(params, cfg, {"tokens": toks})
        worst_o = worst_s = 0.0
        for stack in cfg.stacks:
            for t in range(stack.n_periods):
                pp = _period(params["stack"], t)
                pk, pq = _period(ck["stack"], t), _period(cp["stack"], t)
                for j, spec in enumerate(stack.period):
                    h = rmsnorm(x, pp[j]["norm1"], cfg.norm_eps)
                    outs = []
                    for c, k in ((pk[j], True), (pq[j], False)):
                        if spec.mixer == MAMBA:
                            o, _ = ssm.mamba_apply(pp[j]["mixer"], h, cfg,
                                                   cache=c, valid=valid,
                                                   use_kernel=k)
                        else:
                            o, _ = attn_apply(pp[j]["mixer"], h, cfg,
                                              positions=pos, cache=c,
                                              masked_slots=True,
                                              table=table, use_kernel=k)
                        outs.append(o)
                    ok, op = outs
                    e_o = ((ok.float() - op.float()).abs().max()
                           / op.float().abs().max().clamp(min=1e-30)).item()
                    e_s = 0.0
                    if spec.mixer == MAMBA:
                        e_s = ((pk[j]["h"] - pq[j]["h"]).abs().max()
                               / pq[j]["h"].abs().max().clamp(min=1e-30)
                               ).item()
                        if not torch.equal(pk[j]["conv"], pq[j]["conv"]):
                            fail(f"{what}: layer {j}: the conv history "
                                 f"differs between kernel and plain")
                    if e_o > 2e-2 or e_s > 1e-4:
                        fail(f"{what}: layer {j} ({spec.mixer}): kernel vs "
                             f"plain mixer output {e_o}, state {e_s} of "
                             f"scale")
                    worst_o, worst_s = max(worst_o, e_o), max(worst_s, e_s)
                    x = x + op
                    h = rmsnorm(x, pp[j]["norm2"], cfg.norm_eps)
                    x = x + (moe_apply(pp[j]["ffn"], h, cfg)[0]
                             if spec.ffn == MOE else ffn_apply(pp[j]["ffn"], h))
        kernels_used = ("the paged-decode kernel and mamba_scan"
                        if toks.shape[1] == 1 else "mamba_scan")
        print(f"{what}, layer by layer on the same input ({cfg.n_layers} "
              f"layers through {kernels_used}): kernel vs plain mixer output max "
              f"err {worst_o:.3e} of its scale (tol 2e-2), Mamba state "
              f"{worst_s:.3e} (tol 1e-4), conv history bit for bit")

    def step_logits(prm, caches, toks, pos, use_kernel, kv_chunk=1024):
        h, _, _ = forward(prm, cfg, {"tokens": toks}, caches=caches,
                          positions=pos, masked_slots=True,
                          block_table=eng._table_arg(), compute_logits=False,
                          kv_chunk=kv_chunk, use_kernel=use_kernel)
        return unembed(prm, cfg, h[:, -1:, :])[:, 0]

    def end_to_end(toks, pos, what):
        """One step of the whole model through the kernels and through the
        plain path, from copies of the served caches.

        bf16 (the served arithmetic): the plain path run again with its
        attention summed in 16-position chunks instead of one 1024-position
        chunk measures the rounding floor of this step; live slots' greedy
        tokens must be equal wherever the plain path's top-2 margin exceeds
        that floor (MoE routing amplifies one-ulp differences, see
        PERF.md).  float32 activations (the embedding upcast; bf16 weights
        upcast exactly in each matmul; TF32 off): live slots' logits within
        1e-4 of the logit scale (the card reads about 5e-6 of it, the
        float32 summation-order difference; PERF.md) and equal greedy
        tokens.  Idle slots keep their Mamba state and conv history bit
        for bit on every path."""
        live = (pos >= 0).any(dim=1)
        idle = torch.nonzero(~live).flatten()
        n = int(live.sum())
        before = copy.deepcopy(eng.caches)
        runs = {}
        for name, use_kernel, kv_chunk in (("kernel", True, 1024),
                                           ("plain", False, 1024),
                                           ("plain, 16-position chunks",
                                            False, 16)):
            c = copy.deepcopy(eng.caches)
            runs[name] = step_logits(params, c, toks, pos, use_kernel,
                                     kv_chunk)[live]
            for layer, old in zip(c["stack"], before["stack"]):
                for leaf in ("h", "conv"):
                    if leaf in layer and not torch.equal(
                            layer[leaf][:, idle], old[leaf][:, idle]):
                        fail(f"{what} ({name}): an idle slot's {leaf} changed")
            del c
        lk, lp, lr = (runs[k] for k in runs)
        if lk.shape != (n, cfg.vocab_size) or not torch.isfinite(lk).all():
            fail(f"{what}: logits are not finite ({n}, vocab)")
        scale = max(1.0, lp.abs().max().item())
        err = (lk - lp).abs().max().item()
        floor = (lr - lp).abs().max().item()
        top2 = lp.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        clear = margin > floor
        same = lk.argmax(-1) == lp.argmax(-1)
        print(f"{what}, whole model in bf16: max |dlogit| kernel vs plain "
              f"{err:.4e}, rounding floor (plain, attention in 16-position "
              f"chunks) {floor:.4e}, over {n} live slot(s) at logit scale "
              f"{scale:.3f}; greedy equal in {int(same.sum())}/{n}, "
              f"{int(clear.sum())} with a top-2 margin above the floor "
              f"(smallest margin {margin.min().item():.4e})")
        if not bool(same[clear].all()):
            fail(f"{what}: a live slot's greedy token differs where the "
                 f"top-2 margin exceeds the rounding floor {floor}")
        del runs, lk, lp, lr
        params32 = dict(params, embed=params["embed"].float())
        lk, lp = (step_logits(params32, f32_copy(eng.caches), toks, pos, k)
                  [live] for k in (True, False))
        del params32
        err = (lk - lp).abs().max().item()
        scale = max(1.0, lp.abs().max().item())
        same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
        top2 = lp.topk(2, dim=-1).values
        print(f"{what}, whole model in float32 activations: max |dlogit| "
              f"kernel vs plain {err:.4e} over {n} live slot(s) at logit "
              f"scale {scale:.3f} (tol {1e-4 * scale:.4e}); greedy equal in "
              f"{same}/{n} (smallest top-2 margin "
              f"{(top2[:, 0] - top2[:, 1]).min().item():.4e})")
        if err > 1e-4 * scale:
            fail(f"{what}: float32 kernel-path logits differ from the plain "
                 f"path by {err} (tol {1e-4 * scale})")
        if same != n:
            fail(f"{what}: a live slot's float32 greedy token differs")

    # one decode tick, every slot live
    toks = torch.tensor([[eng.active[s].pending] for s in range(8)],
                        dtype=torch.int32, device="cuda")
    pos = torch.tensor([[eng.positions[s]] for s in range(8)],
                       dtype=torch.int32, device="cuda")
    for s in range(8):
        eng._ensure_blocks(s, eng.positions[s], eng.positions[s])
    layerwise(toks, pos, "decode tick")
    end_to_end(toks, pos, "decode tick")
    # one 128-token prefill chunk into slot MAMBA_LIVE_ROW, the others idle
    s = MAMBA_LIVE_ROW
    g = torch.Generator().manual_seed(2)
    toks = torch.zeros((8, 128), dtype=torch.int32)
    toks[s] = torch.randint(0, cfg.vocab_size, (128,), generator=g)
    pos = torch.full((8, 128), -1, dtype=torch.int32)
    pos[s] = torch.arange(eng.positions[s], eng.positions[s] + 128)
    need = 128 // eng.page_size          # pool pages the chunk may touch
    if not eng._alloc.reserve(need):
        fail("no pool pages left for the prefill chunk")
    eng._slot_reserved[s] += need
    eng._ensure_blocks(s, eng.positions[s], eng.positions[s] + 127)
    toks, pos = toks.cuda(), pos.cuda()
    layerwise(toks, pos, "prefill chunk")
    end_to_end(toks, pos, "prefill chunk")
    timing.update(profile_ticks(eng))
    return launches, timing


# ---------------------------------------------------------------------------
# Phase 9b: deepseek-v3-671b served at full width (depth cut to 4 of 61)
# ---------------------------------------------------------------------------

DEEPSEEK_LAYERS = 4  # the 3 dense-FFN prefix layers + the first MoE layer


def deepseek_config():
    """deepseek-v3-671b at full width, 4 of its 61 layers; no MTP head
    (training only: the engine never runs it, and its MoE layer would add
    22.6 GB)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v3-671b"),
                               n_layers=DEEPSEEK_LAYERS, mtp_depth=0)


def deepseek_reckoning(cfg) -> dict:
    """bf16 bytes of the served model from its widths (GB): embedding and
    head, MLA per layer, each dense FFN, the MoE layer's routed and shared
    experts (the float32 router and norms apart)."""
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    mla = (d * qr + qr * H * (dn + dr) + d * (kr + dr) + 2 * kr * H * dn
           + H * dv * d)
    n_moe = cfg.n_layers - len(cfg.prefix_layers)
    parts = {"embed + lm_head": 2 * cfg.vocab_size * d,
             f"MLA x {cfg.n_layers}": cfg.n_layers * mla,
             f"dense FFN x {len(cfg.prefix_layers)}":
                 len(cfg.prefix_layers) * 3 * d * cfg.d_ff,
             f"routed experts x {n_moe}":
                 n_moe * cfg.n_experts * 3 * d * cfg.d_expert,
             f"shared expert x {n_moe}":
                 n_moe * cfg.n_shared_experts * 3 * d * cfg.d_expert}
    return {k: 2 * v / 1e9 for k, v in parts.items()}


def phase_serve_deepseek(paged_fwd, kernels):
    from repro_torch.models.layers import ffn_apply, moe_apply, rmsnorm
    from repro_torch.models.mla import mla_apply
    from repro_torch.models.config import MOE
    from repro_torch.models.transformer import (_period, embed_inputs,
                                                forward, init_params, unembed)
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = deepseek_config()
    t0 = time.time()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    leaf_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    reck = deepseek_reckoning(cfg)
    print(f"deepseek-v3-671b, {DEEPSEEK_LAYERS} of 61 layers "
          f"({len(cfg.prefix_layers)} dense FFN + "
          f"{cfg.n_layers - len(cfg.prefix_layers)} MoE, MLA in all; "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"q/kv lora {cfg.q_lora_rank}/{cfg.kv_lora_rank}, nope/rope/v "
          f"{cfg.qk_nope_dim}/{cfg.qk_rope_dim}/{cfg.v_head_dim}, d_ff "
          f"{cfg.d_ff}, {cfg.n_experts} experts of {cfg.d_expert} top-"
          f"{cfg.top_k} + {cfg.n_shared_experts} shared, vocab "
          f"{cfg.vocab_size}) drawn on the card in {time.time() - t0:.1f}s: "
          f"reckoned " + ", ".join(f"{k} {v:.3f}" for k, v in reck.items())
          + f" = {sum(reck.values()):.2f} GB of bf16; leaves {leaf_gb:.2f} GB;"
          f" {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    eng = ServingEngine(params, cfg, slots=8, cache_len=1024, page_size=16,
                        chunk=128, paged=True, use_kernel=True, device="cuda")
    pool_mb = sum(t.numel() * t.element_size()
                  for t in _leaves(eng.caches)) / 1e6
    t0 = time.time()
    eng.warmup()
    print(f"warmup: {time.time() - t0:.1f}s; latent pools {pool_mb:.1f} MB "
          f"({eng.num_blocks} pages of 16 x ({cfg.kv_lora_rank} + "
          f"{cfg.qk_rope_dim}) bf16 + positions, {cfg.n_layers} layers)")
    reqs = make_rwkv_requests(Request, cfg.vocab_size)[:16]
    for r in reqs:
        eng.submit(r)
    rec = time_steps(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = paged_fwd.launches
    st = eng.stats
    if len(done) != 16 or any(len(r.generated) != 32 for r in done):
        fail("not every deepseek request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail("a generated token lies outside the vocabulary")
    if st["shared_pages"] != 0:
        fail("an MoE engine shared a page")
    if launches != st["decode_calls"] * cfg.n_layers:
        fail(f"paged_attention launches {launches} != decode_calls "
             f"{st['decode_calls']} x {cfg.n_layers}")
    mla = paged_fwd.instance_launches["mla"]
    if mla != launches:
        fail(f"{launches - mla} of deepseek's {launches} paged-decode "
             f"launches did not run the MLA instance")
    print(f"served 16 requests x 32 tokens in {wall:.2f}s: "
          f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
          f"ticks, {st['shared_pages']} shared pages; paged_attention "
          f"launches {launches} = {st['decode_calls']} x {cfg.n_layers}, all "
          f"{mla} through the MLA instance (paged_mla_kernel)")
    timing = serving_times(rec, wall)

    # a served state: 8 new requests admitted through the kernel path,
    # then one decode tick with every slot live
    del eng._call_step                   # back to the untimed step
    for r in make_rwkv_requests(Request, cfg.vocab_size, seed=1, n=8):
        eng.submit(r)
    eng._admit()
    toks = torch.tensor([[eng.active[s].pending] for s in range(8)],
                        dtype=torch.int32, device="cuda")
    pos = torch.tensor([[eng.positions[s]] for s in range(8)],
                       dtype=torch.int32, device="cuda")
    for s in range(8):
        eng._ensure_blocks(s, eng.positions[s], eng.positions[s])
    table = eng._table_arg()

    # each layer's MLA through the kernel and through the plain path on
    # the same input (the plain path's residual stream feeds both)
    ck, cp = copy.deepcopy(eng.caches), copy.deepcopy(eng.caches)
    x = embed_inputs(params, cfg, {"tokens": toks})
    layers = [(params["prefix"][i], spec, ck["prefix"][i], cp["prefix"][i])
              for i, spec in enumerate(cfg.prefix_layers)]
    for stack in cfg.stacks:
        for t in range(stack.n_periods):
            pp = _period(params["stack"], t)
            pk, pq = _period(ck["stack"], t), _period(cp["stack"], t)
            layers += [(pp[j], spec, pk[j], pq[j])
                       for j, spec in enumerate(stack.period)]
    worst = 0.0
    for j, (lp, spec, c_k, c_p) in enumerate(layers):
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        ok_, op = (mla_apply(lp["mixer"], h, cfg, positions=pos, cache=c,
                             decode=True, masked_slots=True, table=table,
                             use_kernel=k)[0]
                   for c, k in ((c_k, True), (c_p, False)))
        e = ((ok_.float() - op.float()).abs().max()
             / op.float().abs().max().clamp(min=1e-30)).item()
        if e > 2e-2:
            fail(f"deepseek decode tick: layer {j}: kernel vs plain MLA "
                 f"output {e} of its scale")
        worst = max(worst, e)
        x = x + op
        h = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        x = x + (moe_apply(lp["ffn"], h, cfg)[0] if spec.ffn == MOE
                 else ffn_apply(lp["ffn"], h))
    del ck, cp, x
    print(f"decode tick, layer by layer on the same input ({cfg.n_layers} "
          f"MLA layers through the paged-decode kernel): kernel vs plain MLA "
          f"output max err {worst:.3e} of its scale (tol 2e-2)")

    # the whole model in float32 activations from f32 copies of the caches
    params32 = dict(params, embed=params["embed"].float())
    logits = []
    for use_kernel in (True, False):
        h, _, _ = forward(params32, cfg, {"tokens": toks},
                          caches=f32_copy(eng.caches), positions=pos,
                          decode=True, masked_slots=True, block_table=table,
                          compute_logits=False, use_kernel=use_kernel)
        logits.append(unembed(params32, cfg, h[:, -1:, :])[:, 0])
        del h
    del params32
    lk, lp = logits
    if lk.shape != (8, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail("deepseek decode logits are not finite (8, vocab)")
    err = (lk - lp).abs().max().item()
    scale = max(1.0, lp.abs().max().item())
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    top2 = lp.topk(2, dim=-1).values
    print(f"decode tick, whole model in float32 activations: max |dlogit| "
          f"kernel vs plain {err:.4e} at logit scale {scale:.3f} (tol "
          f"{1e-4 * scale:.4e}); greedy equal in {same}/8 (smallest top-2 "
          f"margin {(top2[:, 0] - top2[:, 1]).min().item():.4e})")
    if err > 1e-4 * scale:
        fail(f"deepseek: float32 kernel-path logits differ from the plain "
             f"path by {err} (tol {1e-4 * scale})")
    if same != 8:
        fail("deepseek: a live slot's float32 greedy token differs")
    del logits, lk, lp
    timing.update(profile_ticks(eng))
    # one 128-token prefill chunk into slot MAMBA_LIVE_ROW, the others idle
    s = MAMBA_LIVE_ROW
    g = np.random.default_rng(2)
    toks = np.zeros((8, 128), np.int32)
    toks[s] = g.integers(0, cfg.vocab_size, 128)
    pos = np.full((8, 128), -1, np.int32)
    pos[s] = np.arange(eng.positions[s], eng.positions[s] + 128)
    if not eng._alloc.reserve(128 // eng.page_size):
        fail("no pool pages left for the prefill chunk")
    eng._slot_reserved[s] += 128 // eng.page_size
    eng._ensure_blocks(s, eng.positions[s], eng.positions[s] + 127)
    timing.update({f"prefill_{k}": v for k, v in profile_ticks(
        eng, step=lambda: eng._call_step(toks, pos),
        what="prefill calls (one live 128-token chunk)").items()})
    return launches, timing


# ---------------------------------------------------------------------------
# Phase 9c: gemma3-12b served at full width and full depth
# ---------------------------------------------------------------------------

GEMMA_CACHE_LEN = 2048           # above the window: rings wrap


def gemma_requests(Request, vocab, seed=0):
    """The 16 requests of phase 3 (32..600 tokens, the even ones behind a
    256-token system prompt, requests 3 and 10 sampled) and two greedy
    ones of 1,500 tokens: longer than the 1,024-position window, so their
    rings wrap in prefill and again in decode (11 full chunks and one of
    92 tokens: no 1-token chunk)."""
    reqs = make_requests(Request, vocab, seed)
    rng = np.random.default_rng(seed + 50)
    for i in (16, 17):
        reqs.append(Request(i, rng.integers(0, vocab, 1500).tolist(),
                            max_new=32))
    return reqs


def gemma_engine(params, cfg, ServingEngine, device="cuda"):
    return ServingEngine(params, cfg, slots=8, cache_len=GEMMA_CACHE_LEN,
                         page_size=16, chunk=128, paged=True, use_kernel=True,
                         device=device)


def phase_serve_gemma(paged_fwd, kernels):
    """Serve gemma3-12b (48 layers: 40 sliding-window, 8 global) and hold
    one decode tick on a wrapped ring through the kernel against the
    plain path; returns (launches, timing, params, cfg) — launches of
    the ring (windowed) and global layers, counted apart; the parameters
    stay for phases 9d and 9e."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SWA
    from repro_torch.models.layers import attn_apply, ffn_apply, rmsnorm
    from repro_torch.models.transformer import (_period, embed_inputs,
                                                forward, init_params, unembed)
    from repro_torch.serve.engine import Request, ServingEngine, _cache_leaves

    cfg = get_config("gemma3-12b")
    t0 = time.time()
    params = init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    leaf_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    print(f"gemma3-12b, all {cfg.n_layers} layers ({cfg.n_layers * 5 // 6} "
          f"sliding-window of window {cfg.sliding_window}, "
          f"{cfg.n_layers // 6} global; d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}): {n_params / 1e9:.3f} B "
          f"parameters, {leaf_gb:.2f} GB, drawn on the card in "
          f"{time.time() - t0:.1f}s")
    eng = gemma_engine(params, cfg, ServingEngine)
    pools = {kind: sum(t.numel() * t.element_size() for _, idx, name, _, t
                       in _cache_leaves(eng.caches)
                       if (cfg.period[idx].mixer == SWA) == (kind == "swa"))
             / 1e9 for kind in ("swa", "global")}
    if eng.num_blocks_swa != 512 or eng._ring_blocks != 64:
        fail(f"gemma3 ring pool {eng.num_blocks_swa} pages, ring "
             f"{eng._ring_blocks} columns (expected 512, 64)")
    t0 = time.time()
    eng.warmup()
    print(f"warmup: {time.time() - t0:.1f}s; pools: {eng.num_blocks} global "
          f"pages x {cfg.n_layers // 6} layers ({pools['global']:.2f} GB), "
          f"{eng.num_blocks_swa} ring pages (8 slots x {eng._ring_blocks}) x "
          f"{cfg.n_layers * 5 // 6} layers ({pools['swa']:.2f} GB)")
    reqs = gemma_requests(Request, cfg.vocab_size)
    for r in reqs:
        eng.submit(r)
    rec = time_steps(eng)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = paged_fwd.launches
    ring = paged_fwd.window_launches
    wide = paged_fwd.instance_launches["wide"]
    n_swa = (cfg.n_layers // len(cfg.period)
             * sum(spec.mixer == SWA for spec in cfg.period))
    st = eng.stats
    if len(done) != 18 or any(len(r.generated) != 32 for r in done):
        fail("not every gemma3 request finished with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.generated):
        fail("a generated token lies outside the vocabulary")
    if st["shared_pages"] != 0:
        fail("a sliding-window engine shared a page")
    if launches != st["decode_calls"] * cfg.n_layers:
        fail(f"paged_attention launches {launches} != decode_calls "
             f"{st['decode_calls']} x {cfg.n_layers}")
    if ring != st["decode_calls"] * n_swa:
        fail(f"windowed paged_attention launches {ring} != decode_calls "
             f"{st['decode_calls']} x {n_swa} sliding-window layers")
    if wide != launches:
        fail(f"only {wide} of gemma3's {launches} paged_attention launches "
             f"ran the wide-head instance")
    if (eng._alloc.n_free, eng._alloc_swa.n_free) != (
            eng.num_blocks, eng.num_blocks_swa) or eng._alloc.reserved \
            or eng._alloc_swa.reserved:
        fail("gemma3: the allocators are not back to all free")
    print(f"served 18 requests x 32 tokens in {wall:.2f}s: "
          f"{st['prefill_calls']} prefill calls, {st['decode_calls']} decode "
          f"ticks, {st['shared_pages']} shared pages; paged_attention "
          f"launches {launches} = {st['decode_calls']} x {cfg.n_layers}, "
          f"{ring} of them windowed = {st['decode_calls']} x {n_swa}, all "
          f"{wide} by the wide-head instance; both allocators all free at "
          f"the end")
    timing = serving_times(rec, wall)

    # a served state: 8 new requests, one of 1,300 tokens (its ring has
    # wrapped), then one decode tick with every slot live
    del eng._call_step                   # back to the untimed step
    more = make_requests(Request, cfg.vocab_size, seed=1)[:7]
    more.append(Request(99, np.random.default_rng(9).integers(
        0, cfg.vocab_size, 1300).tolist(), max_new=8))
    for r in more:
        eng.submit(r)
    eng._admit()
    if max(eng.positions) <= cfg.sliding_window:
        fail("no ring has wrapped in the served state")
    toks = torch.tensor([[eng.active[s].pending] for s in range(8)],
                        dtype=torch.int32, device="cuda")
    pos = torch.tensor([[eng.positions[s]] for s in range(8)],
                       dtype=torch.int32, device="cuda")
    for s in range(8):
        eng._ensure_blocks(s, eng.positions[s], eng.positions[s])
    table = eng._table_arg()
    ck, cp = copy.deepcopy(eng.caches), copy.deepcopy(eng.caches)
    x = embed_inputs(params, cfg, {"tokens": toks})
    worst = {SWA: 0.0, "attn": 0.0}
    stack = cfg.stacks[0]
    for t in range(stack.n_periods):
        pp = _period(params["stack"], t)
        pk, pq = _period(ck["stack"], t), _period(cp["stack"], t)
        for j, spec in enumerate(stack.period):
            lp = pp[j]
            window = cfg.sliding_window if spec.mixer == SWA else 0
            h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            ok_, op = (attn_apply(lp["mixer"], h, cfg, positions=pos, cache=c,
                                  window=window, masked_slots=True,
                                  table=table, use_kernel=k)[0]
                       for c, k in ((pk[j], True), (pq[j], False)))
            e = ((ok_.float() - op.float()).abs().max()
                 / op.float().abs().max().clamp(min=1e-30)).item()
            if e > 2e-2:
                fail(f"gemma3 decode tick: layer {t * 6 + j} ({spec.mixer}): "
                     f"kernel vs plain attention output {e} of its scale")
            worst[spec.mixer] = max(worst[spec.mixer], e)
            x = x + op
            x = x + ffn_apply(lp["ffn"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    del ck, cp, x
    print(f"decode tick on a served state (slot positions "
          f"{sorted(eng.positions)}; rings wrapped past {cfg.sliding_window}), "
          f"layer by layer on the same input: kernel vs plain attention "
          f"output max err {worst[SWA]:.3e} (40 ring layers) / "
          f"{worst['attn']:.3e} (8 global layers) of its scale (tol 2e-2)")

    # the whole model in float32 activations (the embedding upcast; every
    # matmul upcasts its bf16 weight on the fly, one layer at a time)
    params32 = dict(params, embed=params["embed"].float())
    logits = []
    for use_kernel in (True, False):
        h, _, _ = forward(params32, cfg, {"tokens": toks},
                          caches=f32_copy(eng.caches), positions=pos,
                          decode=True, masked_slots=True, block_table=table,
                          compute_logits=False, use_kernel=use_kernel)
        logits.append(unembed(params32, cfg, h[:, -1:, :])[:, 0])
        del h
    del params32
    lk, lp = logits
    if lk.shape != (8, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail("gemma3 decode logits are not finite (8, vocab)")
    err = (lk - lp).abs().max().item()
    scale = max(1.0, lp.abs().max().item())
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"decode tick, all {cfg.n_layers} layers in float32 activations: "
          f"max |dlogit| "
          f"kernel vs plain {err:.4e} at logit scale {scale:.3f} (tol "
          f"{1e-4 * scale:.4e}); greedy equal in {same}/8")
    if err > 1e-4 * scale:
        fail(f"gemma3: float32 kernel-path logits differ from the plain "
             f"path by {err} (tol {1e-4 * scale})")
    if same != 8:
        fail("gemma3: a live slot's float32 greedy token differs")
    del logits, lk, lp
    timing.update(profile_ticks(eng))
    return ({"ring": ring, "global": launches - ring}, timing, params,
            cfg)


# ---------------------------------------------------------------------------
# Phase 9d: a live gemma3-12b request migrated between two engines
# ---------------------------------------------------------------------------

def phase_gemma_migration(params, cfg):
    """Engines A and B over one parameter tree: a 1,300-token greedy
    request decodes 8 ticks on A, is exported, and finishes on B with the
    tokens of the same request served on A unmoved; a payload with one
    flipped byte is rejected with B's caches unchanged bit for bit."""
    import dataclasses
    from repro_torch.serve.engine import Request, ServingEngine, _cache_leaves
    from repro_torch.serve.router import _flip_payload
    a = gemma_engine(params, cfg, ServingEngine)
    b = gemma_engine(params, cfg, ServingEngine)
    if a.migration_fingerprint() != b.migration_fingerprint():
        fail("two engines over one tree differ in fingerprint")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                                1300).tolist()
    a.submit(Request(0, list(prompt), max_new=32))
    ref = a.run()[0].generated
    req = Request(1, list(prompt), max_new=32)
    a.submit(req)
    while len(req.generated) < 8:
        a.tick()
    torch.cuda.synchronize()
    t0 = time.time()
    state = a.export_state(req)
    export_ms = (time.time() - t0) * 1e3
    if state.cols_swa != list(range(64)) or state.position <= 1024:
        fail(f"gemma3 export: ring columns {state.cols_swa}, position "
             f"{state.position} (a wrapped ring expected)")
    if a.n_active or a._alloc.n_free != a.num_blocks \
            or a._alloc_swa.n_free != a.num_blocks_swa:
        fail("gemma3 export did not release the source slot")
    bad = dataclasses.replace(state, pool=dict(state.pool))
    _flip_payload(bad)
    before = [t.clone() for _, _, _, _, t in _cache_leaves(b.caches)]
    if b.import_state(bad) or b.stats["import_rejects"] != 1:
        fail("gemma3: a payload with a flipped byte was not rejected")
    if not all(torch.equal(x, t) for x, (_, _, _, _, t)
               in zip(before, _cache_leaves(b.caches))) or b.n_active \
            or b._alloc.n_free != b.num_blocks:
        fail("gemma3: a rejected import changed the destination")
    del before, bad
    t0 = time.time()
    if not b.import_state(state):
        fail("gemma3: the verified payload was not imported")
    torch.cuda.synchronize()
    import_ms = (time.time() - t0) * 1e3
    out = b.run()
    if out[0] is not req or req.generated != ref:
        fail("gemma3: the migrated request's tokens differ from the "
             "unmoved run")
    print(f"migration: a 1,300-token request exported after 8 decode ticks "
          f"(position {state.position}, {len(state.cols)} global + "
          f"{len(state.cols_swa)} ring columns, payload "
          f"{state.payload_bytes / 1e6:.1f} MB), export {export_ms:.1f} ms, "
          f"import {import_ms:.1f} ms (host clock, synchronized); its 32 "
          f"tokens equal the unmoved run's bit for bit; a flipped byte was "
          f"rejected (import_rejects 1) with B's caches unchanged")
    return {"payload_bytes": state.payload_bytes, "export_ms": export_ms,
            "import_ms": import_ms}


# ---------------------------------------------------------------------------
# Phase 9e: FleetRouter over gemma3-12b replicas on the card
# ---------------------------------------------------------------------------

def fleet_plan(Fault, FaultPlan):
    """A partition of replica 1 (ticks 3-5), a crash of replica 0 mid-decode
    (tick 12) and pool pressure on replica 1 (64 pages, ticks 14-17).
    The router decides from token counts alone: with these ticks a
    request rebalanced before the crash survives it, so the run holds a
    migrated request that was never re-prefilled."""
    return FaultPlan([Fault(3, 1, "partition", duration=3),
                      Fault(12, 0, "crash"),
                      Fault(14, 1, "pool_pressure", pages=64, duration=4)])


def fleet_requests(Request, vocab, n=12, seed=3):
    """``n`` greedy requests of 32..600 tokens, 24 new tokens each (no
    1-token prefill chunk)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        m = int(rng.integers(32, 601))
        m += m % 128 == 1
        reqs.append(Request(i, rng.integers(0, vocab, m).tolist(),
                            max_new=24))
    return reqs


def phase_fleet(params, cfg, device="cuda"):
    """Two replicas and a standby over one parameter tree on the card, the
    plan above, ``migration="auto"``, snapshots every 4 ticks and
    rebalancing every 4: every request ends "ok", the standby is drafted,
    requests move by export / import and resume from a snapshot; those
    that never moved, or moved by migration, give the tokens of a
    fault-free run of one engine bit for bit (at least one of them moved
    by migration).  Requests re-prefilled
    from the prompt or a snapshot are counted, not gated: their KV comes
    from the plain prefill path, the KV they replace from kernel decode
    ticks, and the two sum in different orders."""
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.faults import Fault, FaultPlan
    from repro_torch.serve.router import FleetRouter

    def engine():
        return gemma_engine(params, cfg, ServingEngine, device)
    plain = engine()
    for r in fleet_requests(Request, cfg.vocab_size):
        plain.submit(r)
    t0 = time.time()
    ref = {r.req_id: r.generated for r in plain.run()}
    plain_s = time.time() - t0
    del plain
    engines = [engine() for _ in range(3)]
    submits = {}
    for e in engines:
        def counted(req, _submit=e.submit):
            submits[req.req_id] = submits.get(req.req_id, 0) + 1
            _submit(req)
        e.submit = counted
    router = FleetRouter([(engines[0], "rtx4090"), (engines[1], "rtx4090")],
                         standby=[(engines[2], "rtx4090")],
                         fault_plan=fleet_plan(Fault, FaultPlan),
                         migration="auto", snapshot_every=4,
                         rebalance_every=4)
    reqs = fleet_requests(Request, cfg.vocab_size)
    for r in reqs:
        router.submit(r)
    t0 = time.time()
    res = router.run(max_ticks=2000)
    fleet_s = time.time() - t0
    st = router.stats
    eng_st = {k: sum(e.stats[k] for e in engines)
              for k in ("exported", "imported", "import_rejects",
                        "resumed_tokens", "deduped_pages")}
    if len(res.completed) != len(reqs) or any(r.outcome != "ok"
                                              for r in res.completed):
        fail(f"fleet: outcomes {res.outcomes()}")
    if st["replacements"] < 1 or not engines[2] in [r.engine for r in
                                                    router.live_replicas()]:
        fail("fleet: the standby was not drafted")
    if st["injected_crashes"] != 1 or st["partitions"] != 1 \
            or st["pool_pressure"] != 1:
        fail(f"fleet: the plan's faults did not all strike ({st})")
    if eng_st["exported"] < 1 or eng_st["imported"] < 1:
        fail(f"fleet: no export / import happened ({eng_st})")
    if st["snapshot_restores"] < 1 or eng_st["resumed_tokens"] < 1:
        fail(f"fleet: no snapshot resume happened ({st}, {eng_st})")
    reprefilled = [r.req_id for r in reqs if submits.get(r.req_id, 0) > 1]
    kept = [r for r in res.completed if r.req_id not in reprefilled]
    bad = [r.req_id for r in kept if r.generated != ref[r.req_id]]
    if bad:
        fail(f"fleet: requests {bad} (never re-prefilled) differ from the "
             f"fault-free run")
    moved = [r.req_id for r in kept if len(router.placements[r.req_id]) > 1]
    if not moved:
        fail("fleet: no request moved by migration alone")
    same_re = sum(r.generated == ref[r.req_id] for r in res.completed
                  if r.req_id in reprefilled)
    print(f"fleet: 2 replicas + 1 standby, {len(reqs)} requests in "
          f"{res.ticks} ticks ({fleet_s:.1f}s; one engine without faults "
          f"{plain_s:.1f}s): outcomes {res.outcomes()}; crash "
          f"{st['injected_crashes']}, partition {st['partitions']} (healed "
          f"{st['partition_heals']}), pool pressure {st['pool_pressure']}, "
          f"standby drafted {st['replacements']}, requeued {st['requeued']}, "
          f"snapshot restores {st['snapshot_restores']}, migrations "
          f"{st['migrations']}, rebalances {st['rebalances']} (held in place "
          f"{st['rebalance_holds']}); engines: {eng_st}.  "
          f"{len(kept)} requests never re-prefilled (of them {len(moved)} "
          f"moved by migration) equal the fault-free run bit for bit; "
          f"{len(reprefilled)} re-prefilled, {same_re} of them equal too "
          f"(not gated)")
    return {"fleet_s": fleet_s, "ticks": res.ticks, **eng_st,
            "reprefilled": len(reprefilled), "moved": len(moved)}


# ---------------------------------------------------------------------------
# Phase 10: mamba_scan times at the served shapes
# ---------------------------------------------------------------------------

def mamba_bound(c):
    """Least time for one call on these operands: every input read once
    (the state of every row, since every row's output needs it), y (f32)
    written once and the state of the updated rows written once; per state
    element and step one exp (at the SFU rate) and six float32 flops
    (dt*a; a multiply and a multiply-add for the update; a multiply-add
    for y)."""
    B, S, di = c["x"].shape
    ds = c["b"].shape[-1]
    rows = B if "rows" not in c else int(c["rows"].sum())
    isz = c["x"].element_size()
    byts = (2 * B * S * di * isz + 2 * B * S * ds * isz + di * ds * 4
            + B * di * ds * 4 + rows * di * ds * 4 + B * S * di * 4
            + (B if "rows" in c else 0))
    elems = B * S * di * ds
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = max(6 * elems / F32_FLOPS, elems / SFU_EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), byts, elems


def phase_mamba_kernel_times(fwd, ref):
    out = {}
    for name, shape, n_bufs, reps, plain_reps in (
            ("decode", MAMBA_DECODE, 8, 400, 20),
            ("prefill", MAMBA_PREFILL, 2, 50, 3)):
        ms, call_ms, plain_ms = time_scan(
            fwd, ref, "mamba_scan_kernel", served_mamba_case, mamba_args, "h0",
            shape, n_bufs, reps, plain_reps)
        bound_ms, bound_by, byts, elems = mamba_bound(
            served_mamba_case(shape))
        err = scan_err(fwd, ref, served_mamba_case, mamba_args, "h0", shape)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "max_abs_err": err, "call_ms": call_ms}
        print(f"mamba_scan at the served {name} shape (B,S,di,ds)={shape}: "
              f"kernel {ms * 1e3:.2f} us of device time ({call_ms * 1e3:.2f}"
              f" us per call back to back), bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}: {byts / 1e6:.2f} MB = "
              f"{byts / HBM_BYTES_PER_S * 1e6:.2f} us; {elems / 1e6:.1f} M "
              f"exps = {elems / SFU_EXP_PER_S * 1e6:.2f} us; "
              f"{6 * elems / 1e9:.3f} GFLOP f32 = "
              f"{6 * elems / F32_FLOPS * 1e6:.2f} us), plain "
              f"{plain_ms * 1e3:.1f} us, library none")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the flash attention kernel against its plain version
# ---------------------------------------------------------------------------

FLASH_SWEEP = [  # (B, Hq, Hkv, S, T, D, window): tests/test_kernels.py:17-34
    (2, 4, 2, 64, 64, 64, 0),       # GQA causal
    (1, 8, 8, 128, 128, 128, 0),    # MHA
    (2, 4, 1, 37, 37, 80, 16),      # odd sizes + window
    (1, 2, 2, 192, 192, 64, 64),    # sliding window
    (1, 16, 4, 48, 48, 256, 0),     # wide heads
    (2, 4, 2, 40, 100, 64, 0),      # more keys than queries (T > S)
]
FLASH_TRAIN = (2, 32, 8, 4096, 4096, 128, 0)     # qwen3-8b, B=2, S=4096
FLASH_WINDOW = (2, 32, 8, 4096, 4096, 128, 1024)  # the same, window 1024
# gemma3-12b trained at B=2, S=4096: its sliding-window layers (window
# 1024) and its global layers, 16 q / 8 kv heads of 256
FLASH_GEMMA = (2, 16, 8, 4096, 4096, 256, 1024)
FLASH_GEMMA_CAUSAL = (2, 16, 8, 4096, 4096, 256, 0)


def flash_case(B, Hq, Hkv, S, T, D, *, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).cuda()
            for shape in ((B, Hq, S, D), (B, Hkv, T, D), (B, Hkv, T, D))]


def _flash_err(out, lse, eo, el, tol, what):
    try:
        torch.testing.assert_close(out.float(), eo.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, el, atol=1e-4, rtol=1e-4)
    except AssertionError as e:
        fail(f"flash_attention {what}: {e}")
    return ((out.float() - eo.float()).abs().max().item(),
            (lse - el).abs().max().item())


def phase_flash_vs_plain(fwd, ref):
    """The kernel's output (bf16 within 2e-2, f32 within 1e-4) and
    logsumexp (within 1e-4: the scores are exact float32 products of the
    inputs in both dtypes) against the plain version, over the sweep of
    test_kernels.py and at the full-width training shapes: qwen3-8b's
    (causal and with a 1,024-token window) and gemma3-12b's (D = 256,
    window 1024 and causal)."""
    worst = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for B, Hq, Hkv, S, T, D, window in FLASH_SWEEP:
            q, k, v = flash_case(B, Hq, Hkv, S, T, D, seed=S, dtype=dtype)
            out, lse = fwd(q, k, v, window=window)
            torch.cuda.synchronize()
            eo, el = ref(q, k, v, window=window, return_lse=True)
            e = _flash_err(out, lse, eo, el, TOL[dname],
                           f"sweep {dname} {(B, Hq, Hkv, S, T, D, window)}")
            w = worst.get(dname, (0.0, 0.0))
            worst[dname] = (max(w[0], e[0]), max(w[1], e[1]))
    print(f"flash_attention vs plain, sweep of test_kernels.py + T > S: max "
          f"abs err out bf16 {worst['bfloat16'][0]:.3e} (tol 2e-2), f32 "
          f"{worst['float32'][0]:.3e} (tol 1e-4); lse "
          f"{max(worst['bfloat16'][1], worst['float32'][1]):.3e} (tol 1e-4)")
    # At these shapes a typical output element is about 0.03 (a softmax
    # average over up to 4096 randn rows), so bf16's 2e-2 alone would let
    # an error in P.V through; float32 at 1e-4 holds the accumulator.
    errs = {}
    for name, shape in (("training", FLASH_TRAIN), ("window 1024", FLASH_WINDOW),
                        ("gemma3 window 1024", FLASH_GEMMA),
                        ("gemma3 causal", FLASH_GEMMA_CAUSAL)):
        B, Hq, Hkv, S, T, D, window = shape
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            q, k, v = flash_case(B, Hq, Hkv, S, T, D, seed=1, dtype=dtype)
            out, lse = fwd(q, k, v, window=window)
            torch.cuda.synchronize()
            eo, el = ref(q, k, v, window=window, return_lse=True)
            e = errs[name, dname] = _flash_err(out, lse, eo, el, TOL[dname],
                                               f"{name} {dname}")
            del q, k, v, out, lse, eo, el
            torch.cuda.empty_cache()
            print(f"flash_attention vs plain at the {name} shape "
                  f"(B,Hq,Hkv,S,D,window)={(B, Hq, Hkv, S, D, window)}, "
                  f"{dname}: max abs err out {e[0]:.3e} (tol {TOL[dname]}), "
                  f"lse {e[1]:.3e} (tol 1e-4)")
    return errs


def phase_flash_backward():
    """Autograd through the port's flash attention (kernel forward, plain
    blocked backward fed by the kernel's logsumexp) against autograd
    through the plain version, float32, at a mid-size GQA shape: each
    gradient within 1e-4 of its scale."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref
    B, Hq, Hkv, S, D = 2, 8, 2, 1024, 128
    base = flash_case(B, Hq, Hkv, S, S, D, seed=5, dtype=torch.float32)
    d_out = flash_case(B, Hq, Hkv, S, S, D, seed=6, dtype=torch.float32)[0]
    grads = []
    before = flash_attention_fwd.launches
    for fn in (ops.flash_attention, flash_attention_ref):
        xs = [t.clone().requires_grad_() for t in base]
        out = fn(*xs)
        grads.append(torch.autograd.grad(out, xs, d_out))
    if flash_attention_fwd.launches != before + 1:
        fail("the differentiable flash attention did not launch the kernel")
    errs = []
    for name, a, b in zip("qkv", *grads):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        if not err <= 1e-4 * scale:
            fail(f"flash backward d{name}: max abs err {err} > 1e-4 x {scale}")
        errs.append(err / scale)
    print(f"flash_attention backward (kernel lse, plain blocked FA2) vs "
          f"autograd through the plain version, f32 (B,Hq,Hkv,S,D)="
          f"{(B, Hq, Hkv, S, D)}: max err dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
          f"dv {errs[2]:.3e} of each gradient's scale (tol 1e-4)")
    return max(errs)


def flash_bound(B, Hq, Hkv, S, T, D, window, isz):
    """Least time at one shape: q, k, v read once, out written once (in
    the input dtype), lse written once (f32); two products of D
    multiply-adds over every (q, k) pair the masks keep, at the bf16
    tensor-core peak (the f32 peak for f32 inputs)."""
    i = torch.arange(S, dtype=torch.float64)
    keys = torch.minimum(i + 1, torch.tensor(float(T)))
    if window > 0:
        keys = torch.minimum(keys, torch.tensor(float(window)))
    pairs = B * Hq * keys.sum().item()
    byts = (2 * B * Hq * S * D + 2 * B * Hkv * T * D) * isz + B * Hq * S * 4
    flops = pairs * 2 * 2 * D
    peak = BF16_FLOPS if isz == 2 else F32_FLOPS
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), byts, flops


def phase_flash_times(fwd, ref):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    B, Hq, Hkv, S, T, D, window = FLASH_TRAIN
    cases = [flash_case(B, Hq, Hkv, S, T, D, seed=10 + i, dtype=torch.bfloat16)
             for i in range(2)]          # 2 x 168 MB in turn: L2 holds neither
    out, lse = fwd(*cases[0])
    eo = ref(*cases[0])
    max_err = (out.float() - eo.float()).abs().max().item()
    del eo
    torch.cuda.empty_cache()
    for i in range(2):
        fwd(*cases[i])
    ms = event_ms(lambda i: fwd(*cases[i % 2]), 10)
    plain_ms = event_ms(lambda i: ref(*cases[i % 2]), 2)
    torch.cuda.empty_cache()

    def sdpa(i):
        return F.scaled_dot_product_attention(*cases[i % 2], is_causal=True,
                                              enable_gqa=True)
    torch.testing.assert_close(sdpa(0).float(), out.float(), atol=2e-2,
                               rtol=2e-2)
    for i in range(2):
        sdpa(i)
    library_ms = event_ms(sdpa, 20)
    # the backward the training step runs after each launch (plain
    # PyTorch), timed alone for the step's breakdown
    d_out = torch.randn_like(out)
    backward_ms = event_ms(lambda i: flash_attention_bwd(
        *cases[i % 2], out, lse, d_out), 2)
    bound_ms, bound_by, byts, flops = flash_bound(*FLASH_TRAIN, 2)
    print(f"flash_attention at the training shape (B,Hq,Hkv,S,D)="
          f"{(B, Hq, Hkv, S, D)}, bf16 causal: kernel {ms * 1e3:.1f} us, bound "
          f"{bound_ms * 1e3:.1f} us ({bound_by}: {byts / 1e6:.1f} MB, "
          f"{flops / 1e9:.1f} GFLOP), plain {plain_ms * 1e3:.1f} us, sdpa "
          f"{library_ms * 1e3:.1f} us; its plain blocked backward "
          f"{backward_ms * 1e3:.1f} us")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max_err,
            "plain_backward_ms": backward_ms}


def phase_flash_gemma_times(fwd, ref):
    """Phase 13b: the kernel at gemma3-12b's training shapes (D = 256,
    window 1024 and causal), bf16, by device time (the event time per
    back-to-back call beside it), beside its bound, its plain version and
    ``F.scaled_dot_product_attention`` on the same inputs with
    ``enable_gqa=True`` (the window as a boolean mask; causal by
    ``is_causal``), whose backend is named by its kernels."""
    import torch.nn.functional as F
    res = {}
    for name, shape in (("window 1024", FLASH_GEMMA),
                        ("causal", FLASH_GEMMA_CAUSAL)):
        B, Hq, Hkv, S, T, D, window = shape
        cases = [flash_case(B, Hq, Hkv, S, T, D, seed=20 + i,
                            dtype=torch.bfloat16) for i in range(2)]
        out, _ = fwd(*cases[0], window=window)
        eo = ref(*cases[0], window=window)
        max_err = (out.float() - eo.float()).abs().max().item()
        del eo
        torch.cuda.empty_cache()
        # device time first: its 20 untimed calls bring the clocks up
        ms = device_ms(lambda i: fwd(*cases[i % 2], window=window), 10,
                       "flash_fwd")
        call_ms = event_ms(lambda i: fwd(*cases[i % 2], window=window), 10)
        plain_ms = event_ms(lambda i: ref(*cases[i % 2], window=window), 2)
        torch.cuda.empty_cache()
        mask = None
        if window:
            i_ = torch.arange(S, device="cuda")[:, None]
            j_ = torch.arange(T, device="cuda")[None, :]
            mask = (j_ <= i_) & (j_ > i_ - window)

        def sdpa(i):
            return F.scaled_dot_product_attention(
                *cases[i % 2], attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        torch.testing.assert_close(sdpa(0).float(), out.float(), atol=2e-2,
                                   rtol=2e-2)
        backend = sdpa_backend(lambda: sdpa(0))
        library_ms = device_ms(sdpa, 10)
        library_call_ms = event_ms(sdpa, 10)
        bound_ms, bound_by, byts, flops = flash_bound(*shape, 2)
        print(f"flash_attention at gemma3-12b's training shape (B,Hq,Hkv,S,D)="
              f"{(B, Hq, Hkv, S, D)}, bf16, {name}: kernel {ms * 1e3:.1f} us "
              f"of device time ({call_ms * 1e3:.1f} us per call back to "
              f"back), bound {bound_ms * 1e3:.1f} us ({bound_by}: "
              f"{byts / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), plain "
              f"{plain_ms * 1e3:.1f} us, sdpa {library_ms * 1e3:.1f} us of "
              f"device time ({library_call_ms * 1e3:.1f} us per call; its "
              f"kernels: {backend}); max abs err vs plain {max_err:.3e}")
        res[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": max_err, "call_ms": call_ms,
                     "library_call_ms": library_call_ms,
                     "library_backend": backend}
        del cases, out
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 12: qwen3-8b trained at full width (depth cut to 8 layers)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8                 # of 36: 44.6 GB of state (16 B / param)
TRAIN_B, TRAIN_S = 2, 4096       # 8192 tokens per step
TRAIN_STEPS = 7                  # one warmup step, then six timed
# gemma3-12b trained at full width, depth cut to one period of 5
# sliding-window layers and 1 global (2.35 B parameters with the tied
# 1.007 B embedding; two periods, 3.70 B at about 21 B a parameter with
# activations as qwen3-8b's run measured, would leave under 10 of 80 GB)
GEMMA_TRAIN_LAYERS = 6
GEMMA_TRAIN_STEPS = 5            # one warmup step, then four timed
REMAT_STEPS = 3                  # per policy: one warmup step, two timed
# step 0 through the kernel vs the plain scan attention, relative to the
# plain path's value ("grads": the L2 norm of the difference of the two
# gradient trees over the plain one's).  The same comparison with the
# plain path's kv chunk halved (another float32 summation order, the same
# bf16 roundings) measured the rounding floor once: loss 1.5e-5, grad
# norm 1.8e-5, grads 1.5e-2 on an H100 80GB HBM3 at 700 W, the last from
# bf16 gradients through 8 layers.  The tolerances sit at about 7x, 5x
# and 1.3x that floor; the float32 CUDA-core kernel measured 6.4e-6,
# 3.7e-7 and 1.65e-2 there, the bf16 tensor-core kernel (P as bf16 hi + lo,
# the softmax in expf) 1.42e-5, 5.79e-5 and 1.761e-2.
STEP0_TOL = {"loss": 1e-4, "grad_norm": 1e-4, "grads": 2e-2}


def train_flops(cfg, B, S):
    """Model flops of one training step: 6 x the matmul parameters (the
    layers and the head, tied or not; the embedding is a lookup) x tokens,
    plus 3 x the causal attention forward's two products (forward, and
    twice that in the backward) over the (query, key) pairs each layer's
    masks keep (a sliding-window layer's window cuts them), as MFU counts
    them."""
    from repro_torch.models.config import SWA
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                 + 3 * d * cfg.d_ff)
    matmul_params = cfg.n_layers * per_layer + d * cfg.vocab_size
    keys = torch.arange(1, S + 1, dtype=torch.float64)
    pairs = 0.0
    for st in cfg.stacks:
        for spec in st.period * st.n_periods:
            w = cfg.sliding_window if spec.mixer == SWA else S
            pairs += B * cfg.n_heads * keys.clamp(max=w).sum().item()
    return 6 * matmul_params * B * S + 3 * pairs * 2 * 2 * hd


def step0_run(cfg, params, batch, use_kernel, kv_chunk=1024):
    """Loss, grad norm and gradients of one training step's forward and
    backward (remat, chunked cross-entropy) from ``params`` on ``batch``;
    ``kv_chunk`` sets the plain attention's float32 summation order."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.loss import cross_entropy_chunked
    from repro_torch.train.step import _head_matrix, grads_of
    from repro_torch.models.transformer import forward
    h, _, _ = forward(params, cfg, batch, remat=True, compute_logits=False,
                      kv_chunk=kv_chunk, use_kernel=use_kernel,
                      scan_kernel=False)
    loss, _ = cross_entropy_chunked(h, _head_matrix(params, cfg),
                                    batch["labels"])
    grads = grads_of(params, loss)
    return loss.item(), global_norm(grads).item(), grads


def rel_l2(ga, gb) -> float:
    """L2 norm of the difference of two gradient trees over ``gb``'s."""
    from repro_torch.tree import leaves
    num = sum(((a.float() - b.float()).square().sum())
              for a, b in zip(leaves(ga), leaves(gb)))
    den = sum(b.float().square().sum() for b in leaves(gb))
    return (num / den).sqrt().item()


def step0_diffs(run, ref) -> dict:
    """The relative loss, grad norm and gradient differences of one
    ``step0_run`` result from another, as ``STEP0_TOL`` bounds them."""
    (l, n, g), (lr, nr, gr) = run, ref
    return {"loss": abs(l - lr) / abs(lr), "grad_norm": abs(n - nr) / nr,
            "grads": rel_l2(g, gr)}


def step0_compare(cfg, params, batch):
    """Loss, grad norm and gradients of step 0 through the kernel path and
    through the plain scan attention, from the same params and batch."""
    lp, np_, gp = step0_run(cfg, params, batch, False)
    lk, nk, gk = step0_run(cfg, params, batch, True)
    d_kernel = step0_diffs((lk, nk, gk), (lp, np_, gp))
    del gk, gp
    print(f"step 0, kernel vs plain scan attention: loss {lk:.6f} vs "
          f"{lp:.6f}, grad norm {nk:.6f} vs {np_:.6f}; relative differences "
          + ", ".join(f"{k} {v:.3e} (tol {STEP0_TOL[k]})"
                      for k, v in d_kernel.items()))
    for k, v in d_kernel.items():
        if not v <= STEP0_TOL[k]:
            fail(f"step 0 {k}: kernel path differs from the plain path by "
                 f"{v} relative (tol {STEP0_TOL[k]})")
    return d_kernel


def profile_train_step(trainer, step_fn, loader, step):
    """Device time of one more training step (batch ``step``) by kernel,
    under ``torch.profiler``: the busy share of the step's wall time and
    the shares of the flash kernel, the matmuls and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    batch = loader.batch(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.params, trainer.opt_state, _ = step_fn(
            trainer.params, trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    tracing.reset()                    # the session's spans: read by none
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        print("profile: the profiler saw no device time (not measured)")
        return {}

    def share(pred):
        return sum(e.self_device_time_total for e in kernels
                   if pred(e.key)) / busy
    flash = share(lambda k: "flash_fwd" in k)     # either instance
    gemm = share(lambda k: any(w in k for w in ("gemm", "xmma", "cutlass",
                                                "nvjet")))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile of one training step: {wall_us / 1e3:.1f} ms under the "
          f"profiler, device busy {busy / 1e3:.1f} ms ({busy / wall_us:.3f} "
          f"of wall), {sum(e.count for e in kernels)} kernels; flash "
          f"{flash:.3f}, matmuls {gemm:.3f}, rest {1 - flash - gemm:.3f} of "
          f"device time; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.3f}"
                      for e in top))
    return {"profiled_step_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us, "flash_share": flash,
            "matmul_share": gemm,
            "kernels_per_step": sum(e.count for e in kernels)}


def train_config(arch):
    """The training scenarios' configs: qwen3-8b with 8 of its 36 layers,
    gemma3-12b with one period (6 of 48)."""
    import dataclasses
    from repro_torch.configs import get_config
    n = {"qwen3-8b": TRAIN_LAYERS, "gemma3-12b": GEMMA_TRAIN_LAYERS}[arch]
    return dataclasses.replace(get_config(arch), n_layers=n)


def train_loader(cfg):
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    return SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B,
        noise=0.05, seed=0), device="cuda")


def phase_train(fwd, kernels, arch="qwen3-8b", steps=TRAIN_STEPS):
    """``arch`` at full width, depth cut (``train_config``), trained
    through the port's Trainer (adamw, cosine_lr, full remat, use_kernel)
    for ``steps`` steps on SyntheticLM batches of 2 x 4096 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import SWA
    from repro_torch.models.transformer import init_params, trainable
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = train_config(arch)
    loader = train_loader(cfg)
    params = trainable(init_params(0, cfg, device="cuda"))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{arch}, {cfg.n_layers} of {get_config(arch).n_layers} layers: "
          f"{n_params / 1e9:.3f} B parameters; batch {TRAIN_B} x {TRAIN_S} "
          f"tokens")
    step0 = step0_compare(cfg, params, loader.batch(0))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = TrainConfig(steps=steps, lr=1e-3, warmup=1,
                       weight_decay=0.01, remat=True, log_every=1,
                       use_kernel=True, device="cuda", seed=0)
    t0 = time.time()
    trainer = Trainer(cfg, tcfg, loader)
    torch.cuda.synchronize()
    print(f"trainer: params and adamw state on the card in "
          f"{time.time() - t0:.1f}s")
    rec = []
    step_fn = trainer.step_fn

    def timed(params, opt_state, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step_fn(params, opt_state, batch)
        b.record()
        rec.append((a, b))
        return out
    trainer.step_fn = timed
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    hist = trainer.fit(log=print)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, window_launches = fwd.launches, fwd.window_launches
    layers = [sp for st in cfg.stacks for sp in st.period * st.n_periods]
    per_step = 2 * len(layers)           # forward + remat recompute
    per_step_window = 2 * sum(sp.mixer == SWA for sp in layers)
    if launches != per_step * steps:
        fail(f"flash launches {launches} != {per_step} x {steps} steps")
    if window_launches != per_step_window * steps:
        fail(f"flash launches with a window {window_launches} != "
             f"{per_step_window} x {steps} steps")
    losses = [m["loss"] for m in hist]
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"training losses are not {steps} finite values: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    ms = [a.elapsed_time(b) for a, b in rec[1:]]     # after the warmup step
    step_ms = sum(ms) / len(ms)
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    timing = {
        "step_ms": step_ms, "step_ms_min": min(ms), "step_ms_max": max(ms),
        "tokens_per_s": TRAIN_B * TRAIN_S / step_ms * 1e3,
        "mfu": flops / (step_ms * 1e-3) / BF16_FLOPS,
        "model_tflop_per_step": flops / 1e12,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "fit_wall_s": wall, "loss_first": losses[0], "loss_last": losses[-1],
    }
    print(f"trained {steps} steps ({wall:.1f}s): loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; flash launches {launches} = {per_step} x "
          f"{steps}, {window_launches} of them with a window")
    print(f"training {arch}: " + ", ".join(f"{k}={v}"
                                           for k, v in timing.items()))
    timing.update(profile_train_step(trainer, step_fn, loader, steps))
    del trainer, hist
    gc.collect()
    torch.cuda.empty_cache()
    return {"all": launches, "window": window_launches}, timing, step0


def phase_remat_policies(fwd, kernels):
    """Phase 12b: qwen3-8b's training scenario (8 of 36 layers, B=2,
    S=4096, adamw, flash on) for REMAT_STEPS steps under remat "full",
    "dots_no_batch" and "dots" from the same params: step 0's loss and
    grad norm under each equal "full"'s within ``STEP0_TOL``, flash
    launches == 16 a step under each (the kernel runs again in every
    recompute); ms per step, the step's peak memory and that of one more
    forward and backward printed, not gated."""
    from repro_torch.models.transformer import init_params, trainable
    from repro_torch.optim.adamw import adamw, cosine_lr
    from repro_torch.train.step import grads_of, loss_fn, make_train_step

    cfg = train_config("qwen3-8b")
    loader = train_loader(cfg)
    rows = {}
    for policy in ("full", "dots_no_batch", "dots"):
        params = trainable(init_params(0, cfg, device="cuda"))
        opt = adamw(cosine_lr(1e-3, 1, REMAT_STEPS), weight_decay=0.01)
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=True, remat_policy=policy,
                               use_kernel=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        rec = []
        for i in range(REMAT_STEPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, state, m = step(params, state, loader.batch(i))
            b.record()
            rec.append((a, b))
            if i == 0:
                first = {k: m[k].item() for k in ("loss", "grad_norm")}
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in rec[1:]]
        rows[policy] = dict(first, step_ms=sum(ms) / len(ms),
                            peak_mem_gb=torch.cuda.max_memory_allocated()
                            / 1e9, launches=fwd.launches)
        if fwd.launches != 2 * cfg.n_layers * REMAT_STEPS:
            fail(f"remat {policy}: flash launches {fwd.launches} != "
                 f"{2 * cfg.n_layers} x {REMAT_STEPS} steps")
        # the step's peak falls in the optimizer's update; the policy
        # moves the peak of the forward and backward, read apart here
        # (params and adamw state still held, as in the step)
        torch.cuda.reset_peak_memory_stats()
        loss, _ = loss_fn(params, cfg, loader.batch(REMAT_STEPS),
                          remat_policy=policy, use_kernel=True)
        grads = grads_of(params, loss)
        torch.cuda.synchronize()
        rows[policy]["peak_fwd_bwd_gb"] = (torch.cuda.max_memory_allocated()
                                           / 1e9)
        del params, state, step, m, loss, grads
        gc.collect()
        torch.cuda.empty_cache()
    full = rows["full"]
    for policy, r in rows.items():
        d = {k: abs(r[k] - full[k]) / abs(full[k])
             for k in ("loss", "grad_norm")}
        r["step0_vs_full"] = d
        for k, v in d.items():
            if not v <= STEP0_TOL[k]:
                fail(f"remat {policy}: step 0 {k} differs from full's by "
                     f"{v} relative (tol {STEP0_TOL[k]})")
        print(f"remat {policy}: {r['step_ms']:.1f} ms a step, peak "
              f"{r['peak_mem_gb']:.2f} GB ({r['peak_fwd_bwd_gb']:.2f} GB in "
              f"the forward and backward), step 0 loss {r['loss']:.6f} grad "
              f"norm {r['grad_norm']:.6f} (relative to full's: loss "
              f"{d['loss']:.3e}, grad norm {d['grad_norm']:.3e}; tol "
              f"{STEP0_TOL['loss']}); flash launches {r['launches']}")
    return rows


def scan_train_config(arch):
    """Phase 12d's configs at full width: jamba-1.5-large's attention
    layer and its first Mamba layer with a dense FFN (layers 0 and 2 of
    its period; an MoE layer is 9.66 B parameters), and two rwkv6-7b
    layers."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch == "rwkv6-7b":
        return dataclasses.replace(cfg, n_layers=2)
    return dataclasses.replace(cfg, n_layers=2,
                               period=(cfg.period[0], cfg.period[2]))


def loss_grads(cfg, params, batch, use_kernel):
    """Loss, grad norm and gradients of the training path
    (``train.step.loss_fn``: full remat, chunked cross entropy), as
    ``make_train_step`` takes them."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import grads_of, loss_fn
    loss, _ = loss_fn(params, cfg, batch, use_kernel=use_kernel)
    grads = grads_of(params, loss)
    return loss.item(), global_norm(grads).item(), grads


def phase_scan_training(kernels, flash_fwd, mamba_fwd, rwkv_fwd):
    """Phase 12d: the scan kernels have no backward.  One training step's
    loss and gradients at full width (``scan_train_config``, B=2, S=512,
    float32 activations: the bf16 weights upcast, exactly) with
    ``use_kernel=True`` against the all-plain path: no scan kernel is
    launched, flash runs in jamba's attention layer (forward and remat
    recompute), and the two agree within 1e-4 relative (loss, grad norm,
    the gradients' L2 difference; in bf16 the flash-vs-plain rounding
    alone moves jamba's gradients by about 4e-2 on an H100; rwkv6-7b has
    no attention, so its two paths run the same ops).  Then
    ``ops.mamba_scan`` / ``ops.rwkv_scan`` on CUDA inputs that require
    grad must raise, and launch under ``torch.no_grad()``."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.config import ATTN
    from repro_torch.models.transformer import init_params, trainable
    from repro_torch.tree import leaves, unflatten
    out = {}
    for arch, scan in (("jamba-1.5-large-398b", mamba_fwd),
                       ("rwkv6-7b", rwkv_fwd)):
        cfg = scan_train_config(arch)
        params = init_params(0, cfg, device="cuda")
        params = trainable(unflatten(params, (t.float() for t in
                                              leaves(params))))
        n_params = sum(t.numel() for t in _leaves(params))
        batch = SyntheticLM(SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=512, global_batch=2,
            noise=0.05, seed=0), device="cuda").batch(0)
        reset_counts(kernels)
        run = loss_grads(cfg, params, batch, True)
        torch.cuda.synchronize()
        n_attn = sum(sp.mixer == ATTN for sp in cfg.period)
        if scan.launches != 0 or flash_fwd.launches != 2 * n_attn:
            fail(f"{arch} training step: {scan.launches} scan launches, "
                 f"{flash_fwd.launches} flash launches (want 0 and "
                 f"{2 * n_attn})")
        ref = loss_grads(cfg, params, batch, False)
        d = step0_diffs(run, ref)
        for k, v in d.items():
            if not v <= TOL["float32"]:
                fail(f"{arch} training step {k}: use_kernel differs from "
                     f"the plain path by {v} relative")
        layers = ", ".join(f"{sp.mixer}+{sp.ffn}" for sp in cfg.period)
        print(f"{arch} at full width ({layers} x "
              f"{cfg.n_layers // len(cfg.period)}, {n_params / 1e9:.3f} B "
              f"parameters), one training step in float32 activations, "
              f"B=2 S=512: use_kernel vs "
              f"plain loss {run[0]:.6f} vs {ref[0]:.6f}; relative "
              + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
              + f" (tol {TOL['float32']})"
              + f"; scan launches 0, flash launches {2 * n_attn}")
        out[arch] = d
        del params, batch, run, ref
        gc.collect()
        torch.cuda.empty_cache()
    # the guard: inputs that require grad under grad mode are refused
    for name, case, args, fwd in (
            ("mamba_scan", mamba_case(1, 8, 64, 16, seed=0,
                                      dtype=torch.bfloat16), mamba_args,
             mamba_fwd),
            ("rwkv_scan", rwkv_case(1, 8, 2, 16, seed=0, dtype=torch.bfloat16,
                                    w_dtype=torch.float32), rwkv_args,
             rwkv_fwd)):
        xs = args(case)
        xs[0] = xs[0].clone().requires_grad_()
        before = fwd.launches
        try:
            getattr(ops, name)(*xs)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{name} on CUDA inputs that require grad did not raise")
        with torch.no_grad():
            getattr(ops, name)(*xs)
        torch.cuda.synchronize()
        if fwd.launches != before + 1:
            fail(f"{name}: {fwd.launches - before} launches, want 1 (the "
                 f"call under no_grad)")
        print(f"{name} on CUDA inputs that require grad under grad mode: "
              f"raised; under no_grad: launched")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the int8 kernels against their plain versions
# ---------------------------------------------------------------------------

INT8_SWEEP = [17, 256, 1000, 4096]     # tests/test_kernels.py:37-48
INT8_BLOCK = 256
INT8_ENCODE_OPS = 6                    # abs, max, divide, rint, 2 clamps
INT8_CHUNK_ROWS = 1 << 20              # rows per plain-version chunk


def same_bits(a, b) -> bool:
    """Equal shape, dtype and values; NaN where the other has NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def int8_check(qfwd, dqfwd, x, block, what):
    """Kernel against plain on one input: codes, scales and the decoded
    values in float32 and bf16, bit for bit."""
    from repro_torch.kernels.ref import int8_dequantize_ref, int8_quantize_ref
    q, s = qfwd(x, block=block)
    torch.cuda.synchronize()
    eq, es = int8_quantize_ref(x, block)
    if not (same_bits(q, eq) and same_bits(s, es)):
        bad_s = (s.nan_to_num() != es.nan_to_num())[:, 0]
        bad_q = (q != eq).any(dim=1)
        fail(f"int8_quantize {what}: of {q.shape[0]} rows, {int(bad_s.sum())} "
             f"scales and {int(bad_q.sum())} code rows differ from the plain "
             f"version (max scale difference "
             f"{(s - es).abs().max().item():.3e})")
    for dt in (torch.float32, torch.bfloat16):
        out = dqfwd(q, s, tuple(x.shape), dt)
        torch.cuda.synchronize()
        if not same_bits(out, int8_dequantize_ref(eq, es, tuple(x.shape), dt)):
            fail(f"int8_dequantize {what} -> {dt}: differs from the plain "
                 f"version")
    return q, s


def phase_int8_vs_plain(qfwd, dqfwd):
    """The sweep of tests/test_kernels.py (n 17..4096, f32 and bf16,
    block 256 and 128), plus an odd block and an unaligned input (the
    scalar paths) and a row holding a NaN: codes, scales and decoded
    values bit for bit."""
    n_cases = 0
    for n in INT8_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for block in (INT8_BLOCK, 128):
                g = torch.Generator().manual_seed(n)
                x = (torch.randn(n, generator=g) * 5).to(dtype).cuda()
                int8_check(qfwd, dqfwd, x, block, f"n={n} {dtype} block={block}")
                n_cases += 1
    g = torch.Generator().manual_seed(1)
    base = (torch.randn(4097, generator=g) * 5).cuda()
    int8_check(qfwd, dqfwd, base.reshape(17, 241), 100, "block 100")
    int8_check(qfwd, dqfwd, base[1:], INT8_BLOCK, "unaligned input")
    nan = base.clone()
    nan[300] = float("nan")
    q, s = int8_check(qfwd, dqfwd, nan, INT8_BLOCK, "a NaN row")
    if not (torch.isnan(s[1, 0]) and (q[1] == 0).all()
            and not torch.isnan(s[[0, 2]]).any()):
        fail("int8_quantize: a NaN must make its row's scale NaN and codes 0")
    print(f"int8 kernels vs plain: {n_cases} cases of the test_kernels.py "
          f"sweep plus block 100, an unaligned input and a NaN row: codes, "
          f"scales and f32 / bf16 decode bit for bit")


def int8_bounds(n, block, in_bytes, out_bytes):
    """(encode, decode) least times in ms and what bounds each: each input
    read once, each output written once; encode's few float32 operations
    per element at the f32 rate."""
    rows = -(-n // block)
    enc_b = n * in_bytes + rows * block + rows * 4
    dec_b = rows * block + rows * 4 + n * out_bytes
    out = []
    for byts, ops in ((enc_b, INT8_ENCODE_OPS * n), (dec_b, n)):
        t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        out.append((max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
                    byts))
    return out


def phase_int8_times(qfwd, dqfwd, n):
    """One run over n > 2^31 elements (the decentralized step's whole
    gradient, bf16): every row's codes and scales and every decoded value
    against the plain version run chunk by chunk, the rows around element
    2^31 and the last rows against the plain version on those rows
    alone, and a prefix of n - 77 elements (a partial last row).  Then
    kernel, plain and ``torch.mul`` times at that size."""
    from repro_torch.kernels.ref import int8_dequantize_ref, int8_quantize_ref
    if n <= 2 ** 31:
        fail(f"the large int8 run needs more than 2^31 elements, not {n}")
    blk = INT8_BLOCK
    g = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(n, generator=g, dtype=torch.bfloat16, device="cuda")
    q, s = qfwd(x)
    dec = dqfwd(q, s, (n,))
    torch.cuda.synchronize()
    rows = q.shape[0]
    q_err = dq_err = 0.0     # codes and scales; decoded values
    for r0 in range(0, rows, INT8_CHUNK_ROWS):
        r1 = min(rows, r0 + INT8_CHUNK_ROWS)
        eq, es = int8_quantize_ref(x[r0 * blk:min(n, r1 * blk)], blk)
        ed = int8_dequantize_ref(eq, es, (min(n, r1 * blk) - r0 * blk,))
        q_err = max(q_err, (q[r0:r1].float() - eq.float()).abs().max().item(),
                    (s[r0:r1] - es).abs().max().item())
        dq_err = max(dq_err, (dec[r0 * blk:r1 * blk] - ed).abs().max().item())
        if not (same_bits(q[r0:r1], eq) and same_bits(s[r0:r1], es)
                and same_bits(dec[r0 * blk:r1 * blk], ed)):
            fail(f"int8 kernels over {n} elements: rows {r0}..{r1} differ "
                 f"from the plain version")
    del eq, es, ed
    edge = 2 ** 31 // blk
    windows = {"around element 2^31": (edge - 4, edge + 4),
               "last": (rows - 8, rows)}
    for name, (r0, r1) in windows.items():
        eq, es = int8_quantize_ref(x[r0 * blk:r1 * blk].clone(), blk)
        if not (same_bits(q[r0:r1], eq) and same_bits(s[r0:r1], es)):
            fail(f"int8_quantize over {n} elements: the {name} rows differ "
                 f"from the plain version on those rows alone")
    del dec
    m = n - 77
    qp, sp = qfwd(x[:m])
    dp = dqfwd(qp, sp, (m,), torch.bfloat16)
    r0 = qp.shape[0] - 4
    tq, ts = int8_quantize_ref(x[r0 * blk:m].clone(), blk)
    if not (same_bits(qp[r0:], tq) and same_bits(sp[r0:], ts)
            and same_bits(qp[:r0], q[:r0])
            and same_bits(dp[r0 * blk:], int8_dequantize_ref(
                tq, ts, (m - r0 * blk,), torch.bfloat16))):
        fail(f"int8 kernels over a partial last row ({m} elements) differ "
             f"from the plain version")
    del qp, sp, dp
    print(f"int8 kernels over {n} elements (> 2^31, bf16): every row and "
          f"decoded value equal to the plain version in chunks of "
          f"{INT8_CHUNK_ROWS} rows (largest difference: codes and scales "
          f"{q_err}, decoded values {dq_err}); rows around element 2^31, "
          f"the last rows and a partial last row ({m} elements) equal on "
          f"their own")
    torch.cuda.empty_cache()

    for _ in range(2):
        qfwd(x)
    q_ms = event_ms(lambda i: qfwd(x), 5)
    dq_ms = event_ms(lambda i: dqfwd(q, s, (n,)), 5)
    torch.cuda.empty_cache()
    q_plain = event_ms(lambda i: int8_quantize_ref(x, blk), 2)
    torch.cuda.empty_cache()
    dq_plain = event_ms(lambda i: int8_dequantize_ref(q, s, (n,)), 2)
    torch.cuda.empty_cache()
    lib = torch.mul(q, s)              # int8 x f32 promotes to f32: one call
    if not torch.equal(lib.reshape(-1)[:n], dqfwd(q, s, (n,))):
        fail("torch.mul(codes, scales) does not compute int8_dequantize")
    del lib
    torch.cuda.empty_cache()
    dq_lib = event_ms(lambda i: torch.mul(q, s), 3)
    (qb, qby, qbytes), (db, dby, dbytes) = int8_bounds(n, blk, 2, 4)
    print(f"int8_quantize over {n} bf16 elements: kernel {q_ms * 1e3:.1f} us, "
          f"bound {qb * 1e3:.1f} us ({qby}: {qbytes / 1e9:.3f} GB), plain "
          f"{q_plain * 1e3:.1f} us, library none")
    print(f"int8_dequantize to {n} f32 elements: kernel {dq_ms * 1e3:.1f} us, "
          f"bound {db * 1e3:.1f} us ({dby}: {dbytes / 1e9:.3f} GB), plain "
          f"{dq_plain * 1e3:.1f} us, torch.mul {dq_lib * 1e3:.1f} us")
    del x, q, s
    torch.cuda.empty_cache()
    return ({"ms": q_ms, "plain_ms": q_plain, "bound_ms": qb, "bound_by": qby,
             "library_ms": None, "max_abs_err": q_err, "n": n},
            {"ms": dq_ms, "plain_ms": dq_plain, "bound_ms": db,
             "bound_by": dby, "library_ms": dq_lib, "max_abs_err": dq_err,
             "n": n})


# ---------------------------------------------------------------------------
# Phase 15: the decentralized plane (broker, DAG, executor over the Bus)
# ---------------------------------------------------------------------------

PLANE_LAYERS = 8                 # of 36, as phase 12: 2.788 B parameters
PLANE_B, PLANE_S = 2, 4096
PLANE_PARTS = 4
PLANE_STEPS = 4                  # 3 train_step calls + 1 step driven by hand
PLANE_LR = 1e-3                  # plain SGD: the loss falls at every step
                                 # (--plane-lr-sweep; PERF.md §6)
PLANE_FLEET = [("rtx3080", 4), ("rtx4090", 2), ("rtx4080", 2)]
PLANE_LR_SWEEP = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)


def plane_lm(cfg):
    """Phase 15's batches: SyntheticLM at the plane's shape, on the card."""
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    return SyntheticLM(SyntheticConfig(cfg.vocab_size, PLANE_S, PLANE_B,
                                       noise=0.05, seed=0), device="cuda")


def run_plane(cfg, lr, kernels):
    """The steps of examples/decentralized_pipeline.py for ``cfg`` on the
    card, at batch PLANE_B x PLANE_S.  A broker schedules the train DAG
    over a consumer fleet; batches come from SyntheticLM through a
    DataProvider on the broker's DHT.  A LocalCluster of PLANE_PARTS
    compnodes (flash attention on) and one of a single compnode, from the
    same seed, must agree bit for bit: ``forward`` logits, then two
    steps' losses.  Then the main path, with every counter in ``kernels``
    set to 0 first: PLANE_STEPS steps of the 4-part cluster, the last
    driven through the executors' own fp / bp with a recording Bus, every
    floating payload and the whole gradient (one bf16 vector) through
    int8_block_encode / decode, then the update.  The counters are read
    right after.  Then each payload, each gradient
    leaf and the whole gradient are held against the plain int8 versions.
    Returns the readings."""
    from repro_torch.core.broker import Broker
    from repro_torch.core.compression import (CompressionSpec,
                                              int8_block_decode,
                                              int8_block_encode)
    from repro_torch.core.dag import PLACEHOLDER, build_model_dag
    from repro_torch.core.decomposer import decompose_contiguous
    from repro_torch.core.executor import Bus, LocalCluster
    from repro_torch.core.perfmodel import (DEVICE_CATALOG, LINK_REGIMES,
                                            CompNode, PerfModel, make_fleet)
    from repro_torch.data.synthetic import DataProvider
    from repro_torch.kernels.ref import int8_dequantize_ref, int8_quantize_ref
    from repro_torch.tree import leaves

    sync = torch.cuda.synchronize

    def stamp():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(a, b):
        return a.elapsed_time(b)

    B, S = PLANE_B, PLANE_S
    out = {}
    dag = build_model_dag(cfg, batch=B, seq=S, kind="train")
    broker = Broker(backup_fraction=0.25, seed=0)
    for node in make_fleet(PLANE_FLEET, LINK_REGIMES["wan_1gbps"]):
        node.reliability = 0.98
        broker.register(node)
    sched = broker.submit_job(dag, n_parts=PLANE_PARTS)
    print(f"broker: {len(broker.active)} active + {len(broker.backup)} backup "
          f"compnodes; {len(dag)} ops, {dag.total_flops() / 1e12:.2f} TFLOP "
          f"forward; schedule over the fleet: makespan "
          f"{sched.makespan * 1e3:.1f} ms, feasible={sched.feasible}, "
          f"task -> compnode {sorted(sched.assignment.items())}")
    provider = DataProvider(plane_lm(cfg), broker.dht)
    provider.publish(0, 1)
    batch = provider.fetch(0)
    toks, labels = batch["tokens"], batch["labels"]

    parts = decompose_contiguous(dag, PLANE_PARTS)
    t0 = time.time()
    cluster = LocalCluster(dag, parts, cfg, 0, use_kernel=True)
    mono = LocalCluster(dag, [dag.topo_order()], cfg, 0, use_kernel=True)
    sync()
    params = {n: p for ex in cluster.executors for n, p in ex.params.items()}
    n_params = sum(t.numel() for t in leaves(params))
    if not all(torch.equal(a, b) for a, b in zip(
            leaves(params), leaves(mono.executors[0].params))):
        fail("the 1-part and 4-part clusters drew different parameters")
    print(f"clusters of {PLANE_PARTS} compnodes ({[len(p) for p in parts]} "
          f"ops) and of 1, {n_params / 1e9:.3f} B parameters each, the same "
          f"draws, in {time.time() - t0:.1f}s")
    out["n_params"] = n_params

    l4 = cluster.forward(toks)
    l1 = mono.forward(toks)
    sync()
    if l4.shape != (B, S, cfg.vocab_size) or not torch.isfinite(l4).all():
        fail(f"forward logits: shape {tuple(l4.shape)} or not finite")
    if not torch.equal(l1, l4):
        fail(f"forward logits of 1 and {PLANE_PARTS} compnodes differ by up "
             f"to {(l1 - l4).abs().max().item()}")
    del l1, l4
    pairs = [(mono.train_step(toks, labels, lr),
              cluster.train_step(toks, labels, lr)) for _ in range(2)]
    if any(a != b for a, b in pairs):
        fail(f"losses of 1 and {PLANE_PARTS} compnodes differ: {pairs}")
    print(f"1 compnode vs {PLANE_PARTS}: forward logits bit for bit, the "
          f"losses of two steps bit for bit: {[a for a, _ in pairs]}")
    out["equal_losses"] = [a for a, _ in pairs]
    del mono, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path ---------------------------------------------------
    reset_counts(kernels)
    sync()
    losses, step_ms = [], []
    for _ in range(PLANE_STEPS - 1):
        cluster.bus = Bus()
        a = stamp()
        losses.append(cluster.train_step(toks, labels, lr))
        b = stamp()
        sync()
        step_ms.append(ms(a, b))
    link_bytes = dict(cluster.bus.bytes_sent)
    class RecordingBus(Bus):
        """Keeps every payload sent over it: (src, dst, key, tensor)."""

        def __init__(self):
            super().__init__()
            self.payloads = []

        def send(self, src, dst, key, value):
            super().send(src, dst, key, value)
            self.payloads.append((src, dst, key, value))

    bus = cluster.bus = RecordingBus()
    positions = torch.arange(S, dtype=torch.int32,
                             device=toks.device)[None].expand(B, S)
    fp_ms, bp_ms, loss, grads = {}, {}, None, {}
    for ex in cluster.executors:
        ph = {n: {"input": toks, "label": labels}[n] for n in ex.op_names
              if dag[n].op_type == PLACEHOLDER}
        a = stamp()
        l, _ = ex.fp(bus, cluster.assignment, ph, positions)
        b = stamp()
        fp_ms[ex.compnode_id] = (a, b)
        loss = l if l is not None else loss
    for ex in reversed(cluster.executors):
        a = stamp()
        grads[ex.compnode_id] = ex.bp(bus, cluster.assignment)
        b = stamp()
        bp_ms[ex.compnode_id] = (a, b)
    losses.append(float(loss))
    payloads = [(key, v) for _, _, key, v in bus.payloads
                if v.is_floating_point() and v.numel()]
    coded = [(key, v) + int8_block_encode(v.contiguous())
             for key, v in payloads]
    decoded = [int8_block_decode(q, s, v.shape) for _, v, q, s in coded]
    grad_leaves = [g for g in leaves(grads) if g is not None]
    flat = torch.cat([g.reshape(-1).to(torch.bfloat16) for g in grad_leaves])
    qg, sg = int8_block_encode(flat)
    dg = int8_block_decode(qg, sg, flat.shape)
    for ex in cluster.executors:
        ex.update(grads[ex.compnode_id], lr)
    sync()
    out["launches"] = {k.__name__: k.launches for k in kernels}
    # ---- end of the main path --------------------------------------------

    fp_ms = {k: ms(*v) for k, v in fp_ms.items()}
    bp_ms = {k: ms(*v) for k, v in bp_ms.items()}
    out.update(losses=losses, step_ms=step_ms, link_bytes=link_bytes,
               cut_bytes=dag.cut_bytes(cluster.assignment),
               fp_ms=fp_ms, bp_ms=bp_ms, n_payloads=len(coded),
               n_grad=flat.numel(),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    spec = CompressionSpec("int8")
    for (key, v, q, s), d in zip(coded, decoded):
        if q.shape[0] * INT8_BLOCK < v.numel() or d.shape != v.shape:
            fail(f"payload {key}: coded shapes {tuple(q.shape)} / "
                 f"{tuple(d.shape)} for {tuple(v.shape)}")
        if v.numel() + 4 * s.numel() != spec.bytes(v.numel()):
            fail(f"payload {key}: encoded bytes differ from CompressionSpec")
        eq, es = int8_quantize_ref(v, INT8_BLOCK)
        if not (same_bits(q, eq) and same_bits(s, es) and same_bits(
                d, int8_dequantize_ref(eq, es, tuple(v.shape)))):
            fail(f"payload {key}: the int8 kernels differ from the plain "
                 f"versions")
    if not (torch.isfinite(dg).all() and dg.shape == flat.shape):
        fail("the decoded gradient is not finite or has the wrong shape")
    if flat.numel() + 4 * sg.numel() != spec.bytes(flat.numel()):
        fail("the coded gradient's bytes differ from CompressionSpec")
    rows = qg.shape[0]
    for r0 in range(0, rows, INT8_CHUNK_ROWS):
        r1 = min(rows, r0 + INT8_CHUNK_ROWS)
        eq, es = int8_quantize_ref(flat[r0 * INT8_BLOCK:r1 * INT8_BLOCK],
                                   INT8_BLOCK)
        if not (same_bits(qg[r0:r1], eq) and same_bits(sg[r0:r1], es)):
            fail(f"the coded gradient's rows {r0}..{r1} differ from the "
                 f"plain version")
    del dg, decoded, coded, eq, es
    for g in grad_leaves:
        g = g.contiguous()
        q, s = int8_block_encode(g)
        eq, es = int8_quantize_ref(g, INT8_BLOCK)
        if not (same_bits(q, eq) and same_bits(s, es)):
            fail(f"a gradient leaf {tuple(g.shape)} {g.dtype}: the int8 "
                 f"kernel differs from the plain version")
        d = int8_block_decode(q, s, g.shape)
        if not same_bits(d, int8_dequantize_ref(eq, es, tuple(g.shape))):
            fail(f"a gradient leaf {tuple(g.shape)}: int8 decode differs "
                 f"from the plain version")
        del q, s, eq, es, d
    out["largest_leaf"] = max(g.numel() for g in grad_leaves)
    out["raw_grad_bytes"] = 2 * flat.numel()
    out["coded_grad_bytes"] = spec.bytes(flat.numel())
    out["payload_bytes"] = sum(v.numel() * v.element_size()
                               for _, v in payloads)
    out["coded_payload_bytes"] = sum(spec.bytes(v.numel())
                                     for _, v in payloads)
    del flat, qg, sg, grads, grad_leaves, payloads, bus
    pm = PerfModel([CompNode(i, DEVICE_CATALOG["h100"], LINK_REGIMES["nvlink"])
                    for i in range(PLANE_PARTS)])
    out["eq1_fp_ms"] = {i: 1e3 * pm.subgraph_time(dag, part, i,
                                                   cluster.assignment)[0]
                        for i, part in enumerate(parts)}
    del cluster
    gc.collect()
    torch.cuda.empty_cache()
    return out


def plane_config():
    """qwen3-8b at full width with PLANE_LAYERS of its 36 layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=PLANE_LAYERS)


def plane_lr_sweep(steps=8):
    """``chip_smoke.py --plane-lr-sweep``: phase 15's 4-compnode cluster
    (its model, seed and batch) trained ``steps`` SGD steps from its first
    weights at each lr of PLANE_LR_SWEEP.  Prints each loss curve and
    checks nothing: it is how PLANE_LR was chosen (PERF.md §6)."""
    from repro_torch.core.dag import build_model_dag
    from repro_torch.core.decomposer import decompose_contiguous
    from repro_torch.core.executor import LocalCluster
    cfg = plane_config()
    dag = build_model_dag(cfg, batch=PLANE_B, seq=PLANE_S, kind="train")
    parts = decompose_contiguous(dag, PLANE_PARTS)
    batch = plane_lm(cfg).batch(0)
    curves = {}
    for lr in PLANE_LR_SWEEP:
        c = LocalCluster(dag, parts, cfg, 0, use_kernel=True)
        curves[lr] = [c.train_step(batch["tokens"], batch["labels"], lr)
                      for _ in range(steps)]
        print(f"plane SGD lr {lr}: losses {curves[lr]}")
        del c
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"plane_lr_sweep": {str(k): v
                                         for k, v in curves.items()}}))


def phase_plane(kernels, flash_fwd):
    """qwen3-8b at full width, 8 of 36 layers, through the decentralized
    plane on the card (``run_plane``): the checks on its readings."""
    cfg = plane_config()
    t0 = time.time()
    r = run_plane(cfg, PLANE_LR, kernels)
    wall = time.time() - t0
    launches = r["launches"]
    flash = launches[flash_fwd.__name__]
    if flash != cfg.n_layers * PLANE_STEPS:
        fail(f"flash launches {flash} != {cfg.n_layers} x {PLANE_STEPS} steps")
    n_coded = r["n_payloads"] + 1
    for name in ("int8_quantize_fwd", "int8_dequantize_fwd"):
        if launches[name] != n_coded:
            fail(f"{name} launches {launches[name]} != {r['n_payloads']} "
                 f"payloads + 1 gradient")
    losses = r["losses"]
    if len(losses) != PLANE_STEPS or not all(np.isfinite(losses)):
        fail(f"the plane's losses are not {PLANE_STEPS} finite values: {losses}")
    curve = r["equal_losses"] + losses        # the cluster's six steps
    if not all(b < a for a, b in zip(curve, curve[1:])):
        fail(f"the plane's loss did not fall at every step: {curve}")
    total = sum(r["link_bytes"].values())
    cut = r["cut_bytes"]
    if not 1.8 * cut <= total <= 4 * cut:
        fail(f"Bus bytes {total} outside [1.8, 4] x the cut model {cut}")
    step_ms = sum(r["step_ms"]) / len(r["step_ms"])
    timing = {"step_ms": step_ms, "step_ms_all": r["step_ms"],
              "tokens_per_s": PLANE_B * PLANE_S / step_ms * 1e3,
              "peak_mem_gb": r["peak_mem_gb"], "wall_s": wall}
    print(f"decentralized plane, qwen3-8b {PLANE_LAYERS} of 36 layers, "
          f"{PLANE_PARTS} compnodes, B={PLANE_B} S={PLANE_S}, SGD lr "
          f"{PLANE_LR}: losses {losses}; launches {launches}")
    print("Bus bytes of one step per link (src, dst): "
          + ", ".join(f"{k}: {v:.0f}" for k, v in sorted(r["link_bytes"].items()))
          + f"; total {total:.0f} = {total / cut:.4f} x the cut model {cut:.0f}")
    print(f"int8 coding of the hand-driven step: {r['n_payloads']} payloads, "
          f"{r['payload_bytes']} B -> {r['coded_payload_bytes']:.0f} B; the "
          f"gradient, {r['n_grad']} elements (largest leaf "
          f"{r['largest_leaf']}), {r['raw_grad_bytes']} B bf16 -> "
          f"{r['coded_grad_bytes']:.0f} B; kernels equal the plain versions "
          f"on every payload, leaf and row")
    for i in sorted(r["fp_ms"]):
        est = r["eq1_fp_ms"][i]
        print(f"compnode {i}: FP {r['fp_ms'][i]:.3f} ms, BP "
              f"{r['bp_ms'][i]:.3f} ms (CUDA events); PerfModel.subgraph_time "
              f"on an h100 CompNode (Eq. 1, 756 TFLOP/s x 0.75): FP "
              f"{est:.3f} ms, FP+BP x3 {3 * est:.3f} ms")
    print("plane: " + ", ".join(f"{k}={v}" for k, v in timing.items()))
    r.update(timing)
    return launches, r


# ---------------------------------------------------------------------------
# Phase 16: the dry-run plane (fake 256-rank mesh) and its prediction of
# the real engine step
# ---------------------------------------------------------------------------

# the pairs whose trace needs the card's torch build: decode programs with
# the kernels' custom ops on fake cuda tensors (the CPU program of every
# pair is traced by tests/test_torch_dryrun.py); between them they reach
# all three custom ops.  DRYRUN_MULTI_POD runs on the 2x16x16 mesh.
DRYRUN_PAIRS = [("rwkv6-7b", "long_500k"),
                ("jamba-1.5-large-398b", "decode_32k")]
DRYRUN_MULTI_POD = ("qwen3-8b", "decode_32k")
DRYRUN_WORKERS = 6                 # of the machine's 8 cores
DRYRUN_TIMEOUT = 400               # seconds per pair


def phase_dryrun(pairs=None):
    """16a: ``python -m repro_torch.launch.dryrun`` per pair, each in a
    process of its own (the fake process group is global state), on the
    fake 256-rank mesh with the card's own program (device cuda; decode
    shapes run the paged engine step with the kernels' custom ops).
    Every record must be "ok"."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import os
    pairs = list(pairs or DRYRUN_PAIRS)
    jobs = [(a, s, False) for a, s in pairs] + [(*DRYRUN_MULTI_POD, True)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    with tempfile.TemporaryDirectory() as out:
        def run(job):
            arch, shape, multi = job
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--kernel",
                   "--device", "cuda", "--out", out] + (
                       ["--multi-pod"] if multi else [])
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=DRYRUN_TIMEOUT, cwd=str(ROOT))
            mesh = "pod2x16x16" if multi else "pod16x16"
            path = Path(out) / f"{arch}_{shape}_{mesh}.json"
            if r.returncode != 0 or not path.exists():
                fail(f"dry-run {arch} {shape} {mesh}: exit {r.returncode}: "
                     f"{r.stderr[-2000:]}")
            return json.loads(path.read_text())
        workers = min(DRYRUN_WORKERS, len(jobs))
        with ThreadPoolExecutor(workers) as pool:
            recs = list(pool.map(run, jobs))
    wall = time.time() - t0
    for rec in recs:
        if rec["status"] != "ok":
            fail(f"dry-run {rec['arch']} {rec['shape']} {rec['mesh']}: "
                 f"{rec.get('error')} at {rec.get('where')}")
        ro = rec["roofline"]
        print(f"dry-run {rec['arch']} x {rec['shape']} x {rec['mesh']} "
              f"({rec['chips']} ranks, kernel {rec['kernel']}): "
              f"bottleneck {ro['bottleneck']}; per chip "
              f"{rec['per_chip_arg_bytes'] / 1e9:.3f} GB of arguments, "
              f"peak {ro['per_chip_peak_mem'] / 1e9:.3f} GB; compute "
              f"{ro['compute_s'] * 1e3:.3f} ms, memory "
              f"{ro['memory_s'] * 1e3:.3f} ms, collective "
              f"{ro['collective_s'] * 1e3:.3f} ms; trace "
              f"{rec['compile_s']:.1f} s")
    print(f"dry-run: {len(recs)} records ok in {wall:.1f}s of wall time "
          f"({workers} processes)")
    return recs


def dryrun_state(cfg, B, cache_len, page):
    """A decode tick's real operands for ``make_engine_step`` on the card:
    every slot live at position 100 over its own 64 table columns."""
    from repro_torch.models.transformer import init_cache
    n_cols = cache_len // page
    caches = init_cache(cfg, B, cache_len, paged=True, page_size=page,
                        device="cuda")
    table = torch.arange(B * n_cols, dtype=torch.int32,
                         device="cuda").reshape(B, n_cols)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32,
                           device="cuda")
    positions = torch.full((B, 1), 100, dtype=torch.int32, device="cuda")
    seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device="cuda")
    return caches, seen, tokens, positions, table


def phase_dryrun_vs_real(paged_fwd, card: str):
    """16b: the dry-run of qwen3-8b's engine step (8 slots, cache_len 1024,
    page 16, the kernels' custom ops) on a 1x1 mesh against the real step
    on the card: argument bytes of params + caches, FLOPs by
    ``FlopCounterMode``'s formulas and custom-op launches a tick must be
    equal; the predicted peak and the roofline's ms are printed beside
    ``max_memory_allocated`` and a tick's time on CUDA events and by
    device time (``device_ms``; "not measured" where the profiler's
    records of ten ticks do not come to ten times one tick's)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import make_engine_step
    B, T, page = 8, 1024, 16
    shape = InputShape("qwen3-8b_engine_8x1024", T, B, "decode")
    cfg = get_config("qwen3-8b")
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device_type="cuda")
    try:
        rec = dryrun.run_one("qwen3-8b", shape, mesh=mesh, mesh_name="1x1",
                             page_size=page, use_kernel=True, verbose=False)
    finally:
        mesh_mod.teardown()
    if rec["status"] != "ok":
        fail(f"dry-run of the engine step: {rec.get('error')} at "
             f"{rec.get('where')}")
    pred_bytes = {g: rec["per_chip_arg_bytes_by_group"][g]
                  for g in ("params", "caches")}
    pred_flops = rec["cost_flops_per_device"]
    pred_launches = rec["custom_op_calls"].get("paged_attention", 0)

    params = init_params(0, cfg, device="cuda")
    caches, seen, tokens, positions, table = dryrun_state(cfg, B, T, page)
    real_bytes = {"params": sum(t.numel() * t.element_size()
                                for t in _leaves(params)),
                  "caches": sum(t.numel() * t.element_size()
                                for t in _leaves(caches))}
    fn = make_engine_step(cfg, paged=True, use_kernel=True)
    host = (np.zeros((B, 2), np.uint32), np.zeros(B, np.float32),
            np.ones(B, np.float32), np.zeros(B, np.int32),
            np.ones(B, np.float32))
    run = lambda: fn(params, caches, seen, tokens, positions, table, *host)
    with torch.no_grad():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = paged_fwd.launches
        with FlopCounterMode(display=False) as fc:
            run()
        torch.cuda.synchronize()
        launches = paged_fwd.launches - before
        peak = torch.cuda.max_memory_allocated()
        tick_ms = event_ms(lambda i: run(), 10)
        # reported, not gated: a profile whose records do not add up is
        # no measurement
        try:
            dev_ms = f"{device_ms(lambda i: run(), 10):.3f} ms"
        except RuntimeError:
            dev_ms = "not measured"
    real_flops = fc.get_total_flops()
    if pred_bytes != real_bytes:
        fail(f"predicted argument bytes {pred_bytes} != the real {real_bytes}")
    if pred_flops != real_flops:
        fail(f"predicted FLOPs {pred_flops} != the real step's {real_flops}")
    if not pred_launches == launches == cfg.n_layers:
        fail(f"custom-op launches a tick: predicted {pred_launches}, real "
             f"{launches}, want {cfg.n_layers}")
    ro = rec["roofline"]
    roof_ms = max(ro["compute_s"], ro["memory_s"], ro["collective_s"]) * 1e3
    print(f"dry-run vs the real qwen3-8b engine step (B {B}, cache_len {T}, "
          f"page {page}, kernels) on {card}: params + caches "
          f"{sum(real_bytes.values()) / 1e9:.4f} GB, equal; FLOPs "
          f"{real_flops:.6e}, equal; paged-decode launches {launches} a "
          f"tick, equal; predicted peak {ro['per_chip_peak_mem'] / 1e9:.3f} "
          f"GB vs max_memory_allocated {peak / 1e9:.3f} GB; roofline "
          f"{roof_ms:.3f} ms ({ro['bottleneck']}) vs {tick_ms:.3f} ms a "
          f"tick on CUDA events, device time {dev_ms}; trace "
          f"{rec['compile_s']:.1f} s")
    del params, caches
    return {"pred_peak_gb": ro["per_chip_peak_mem"] / 1e9,
            "peak_gb": peak / 1e9, "roofline_ms": roof_ms,
            "tick_event_ms": tick_ms, "tick_device": dev_ms}


# kernels whose instances must compile with no serialized wgmma (ptxas
# advisory C7512) and no spilled bytes, by the source that holds them:
# phase 1 fails otherwise
STRICT_KERNELS = {"flash_fwd_tc_kernel": "flash_attention",
                  "paged_wide_kernel": "paged_attention",
                  "paged_mla_kernel": "paged_attention"}


def print_build_report(build, libs) -> None:
    """Registers, static shared memory and spills of every kernel instance
    (ptxas), the dynamic shared memory of the redesigned kernels' blocks,
    the compiler's warnings, and whether the flash library's SASS holds
    tensor-core instructions; fails when an instance of a kernel in
    ``STRICT_KERNELS`` spills or has its wgmma serialized (C7512), or its
    library's ptxas report is missing (the log kept beside a library
    built by an earlier process is read too); the rest is
    informational."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    strict = tuple(STRICT_KERNELS)
    logs = {name: build.build_log(name) for name in sorted(libs)}
    bad = [f"no ptxas report for {name}'s library (delete build/repro_torch "
           f"to rebuild it)" for name in sorted(set(STRICT_KERNELS.values()))
           if logs.get(name) is None]
    for name, log in logs.items():
        if log is None:
            print(f"phase 1: no ptxas report for {name} (built without its "
                  f"log; delete build/repro_torch to check it)")
            continue
        insts = ptxas_summary(log)
        print(f"ptxas {name}: " + "; ".join(
            f"{inst} {regs} regs {smem} B static smem {spill} B spilled "
            f"{stack} B stack" for inst, regs, smem, spill, stack in insts))
        bad += [f"{inst} spills {spill} B" for inst, _, _, spill, _ in insts
                if spill and inst.startswith(strict)]
        bad += [f"{k} has no instance in {name}'s ptxas report"
                for k, src in STRICT_KERNELS.items() if src == name
                and not any(inst.startswith(k) for inst, *_ in insts)]
        for line in log.splitlines():
            if "warning" in line.lower() or "(C7" in line:
                print(f"nvcc {name}: {line.strip()}")
            if "(C7512)" in line and any(k in line for k in strict):
                bad.append(line.strip())
    for D in (64, 128, 256):
        inst = FA.instance(torch.bfloat16, D)
        print(f"flash_attention bf16 D={D}: tensor cores "
              f"{inst['tensor_cores']}, {inst['smem_bytes']} B dynamic smem "
              f"per block")
    print(f"paged_attention: {PA.PAGES_PER_SPLIT} table columns per split; "
          f"{PA.smem_bytes('split', 4, 128, 128, 0, 16, 2)} / "
          f"{PA.smem_bytes('split', 8, 128, 128, 0, 16, 2)} B dynamic smem "
          f"per block at G = 4 / 8, D = 128, page 16, bf16; at MLA's G = "
          f"128, D = Dv = 512, De = 64, k is v: MLA instance "
          f"({PA.MLA_HEADS} heads a block, {PA.MLA_PAGES_PER_SPLIT} columns "
          f"a split) "
          f"{PA.smem_bytes('mla', 128, 512, 512, 64, 16, 2, True)} B, "
          f"CUDA-core instance ({PA.TILE_HEADS} heads) "
          f"{PA.smem_bytes('tiled', 128, 512, 512, 64, 16, 2, True)} / "
          f"{PA.smem_bytes('tiled', 128, 512, 512, 64, 16, 4, True)} B in "
          f"bf16 / f32; at gemma3's G = 2, D = Dv = 256: wide-head instance "
          f"{PA.smem_bytes('wide', 2, 256, 256, 0, 16, 2)} B in bf16, split "
          f"instance {PA.smem_bytes('split', 2, 256, 256, 0, 16, 4)} B in "
          f"f32")
    for name in ("rwkv_scan", "mamba_scan"):   # PERF.md names each spill
        spills = [f"{inst} {spill} B" for inst, _, _, spill, _
                  in ptxas_summary(logs.get(name) or "") if spill]
        print(f"{name} instances that spill: "
              + (", ".join(spills) if spills else "none"))
    counts = sass_mma_count(libs["flash_attention"])
    print("flash_attention SASS: " + (
        "not checked (no cuobjdump)" if counts is None else
        f"{counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA instructions"))
    if bad:
        fail("phase 1: " + "; ".join(bad))
    print(f"phase 1: no instance of {', '.join(strict)} spills or "
          f"serializes its wgmma")


# ---------------------------------------------------------------------------
# Phase 17: spmd_pipeline over a stage mesh, and the examples
# ---------------------------------------------------------------------------

PIPE_STAGES = 4                  # gloo processes, all on the one card
PIPE_LAYERS = 8                  # of qwen3-8b's 36, 2 a stage
PIPE_MICRO = 8                   # microbatches of (1, 4096, 4096) bf16
PIPE_S = 4096
PIPE_TIMEOUT = 600               # s for the four stage processes
EXAMPLE_TIMEOUT = 600            # s for each example
EXAMPLE_RUNS = [                 # each with --device cuda, all at once
    ("train_e2e.py", "--preset", "100m", "--steps", "300"),
    ("serve_batched.py", "--arch", "qwen3-8b", "--kernel"),
    ("serve_batched.py", "--arch", "rwkv6-7b", "--kernel"),
    ("serve_fleet.py",),
    ("quickstart.py",),
    ("decentralized_pipeline.py",),
    ("estimate_cluster.py",),
]


def pipe_config():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-8b"), n_layers=PIPE_LAYERS)


def pipe_stage_params(cfg, stage, device):
    """Stage ``stage``'s layers stacked leaf by leaf, (layers a stage, ...):
    layer i drawn on the card from a generator seeded with i (seed 0 plus
    the layer's index), so every cut of the model draws the same
    weights."""
    from repro_torch.models.transformer import layer_init
    from repro_torch.tree import tree_map
    per = PIPE_LAYERS // PIPE_STAGES
    layers = [layer_init(torch.Generator(device).manual_seed(i),
                         cfg.period[0], cfg, device=device)
              for i in range(stage * per, (stage + 1) * per)]
    return tree_map(lambda *ts: torch.stack(ts), *layers)


def pipe_inputs(cfg, device):
    gen = torch.Generator(device).manual_seed(PIPE_LAYERS)
    return torch.randn((PIPE_MICRO, 1, PIPE_S, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def pipe_stage_fn(cfg, positions):
    """A stage: ``layer_apply`` over its layers, flash on, no cache."""
    from repro_torch.models.transformer import layer_apply
    from repro_torch.tree import tree_map

    def stage_fn(p, x):
        for j in range(PIPE_LAYERS // PIPE_STAGES):
            x = layer_apply(tree_map(lambda t: t[j], p), cfg.period[0], cfg,
                            x, positions, None, use_kernel=True)[0]
        return x
    return stage_fn


def pipe_stage_main(rank, port, tmp):
    """One stage process of phase 17a: a gloo rank computing on cuda:0."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.core.executor import spmd_pipeline
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=PIPE_STAGES)
    try:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        mesh = make_host_mesh(PIPE_STAGES)           # the card
        cfg = pipe_config()
        local = pipe_stage_params(cfg, rank, dev)
        params = tree_map(lambda t: DTensor.from_local(
            t[None], mesh, [Shard(0)], shape=(PIPE_STAGES, *t.shape),
            stride=(t.numel(), *t.stride())), local)
        xs = pipe_inputs(cfg, dev)
        positions = torch.arange(PIPE_S, dtype=torch.int32,
                                 device=dev)[None]
        fn = pipe_stage_fn(cfg, positions)
        events = []

        def timed(p, x):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            y = fn(p, x)
            b.record()
            events.append((a, b))
            return y
        stats = {}
        with torch.no_grad():
            fn(local, xs[0])                         # warm-up, not counted
            torch.cuda.synchronize()
            dist.barrier()
            flash_attention_fwd.launches = 0
            t0 = time.perf_counter()
            out = spmd_pipeline(timed, params, xs, mesh, stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention_fwd.launches
        ref = torch.load(Path(tmp) / "ref.pt", map_location=dev)
        torch.save(dict(stats, launches=launches, wall_s=wall,
                        stage_ms=sum(a.elapsed_time(b) for a, b in events),
                        equal=bool(torch.equal(out, ref)),
                        max_abs_err=float((out.float() - ref.float()).abs()
                                          .max()),
                        shape=tuple(out.shape)),
                   Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_pipeline(fwd):
    """17a: qwen3-8b's layers at full width (8 of 36, 2 a stage) through
    ``spmd_pipeline`` over a 4-stage mesh of gloo processes on the one
    card, against a one-process forward of the same layers over the same
    microbatches on the card, bit for bit; every rank's flash launches
    must be its microbatches x its layers."""
    import tempfile
    import torch.multiprocessing as mp
    cfg = pipe_config()
    dev = torch.device("cuda")
    stages = [pipe_stage_params(cfg, s, dev) for s in range(PIPE_STAGES)]
    xs = pipe_inputs(cfg, dev)
    fn = pipe_stage_fn(cfg, torch.arange(PIPE_S, dtype=torch.int32,
                                         device=dev)[None])
    n_params = sum(t.numel() for p in stages for t in _leaves(p))
    with torch.no_grad():
        fn(stages[0], xs[0])                          # warm-up
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        ref = []
        for m in range(PIPE_MICRO):
            h = xs[m]
            for p in stages:
                h = fn(p, h)
            ref.append(h)
        ref = torch.stack(ref)
        b.record()
        torch.cuda.synchronize()
        ref_wall, ref_ms = time.perf_counter() - t0, a.elapsed_time(b)
    if not torch.isfinite(ref.float()).all():
        fail("17a: the one-process forward is not finite")
    del stages, xs
    gc.collect()
    torch.cuda.empty_cache()
    mb = ref[0].numel() * ref.element_size()
    print(f"pipeline 17a: qwen3-8b {PIPE_LAYERS} of 36 layers "
          f"({n_params / 1e9:.3f} B parameters, "
          f"{n_params * 2 / 1e9:.2f} GB bf16; "
          f"{n_params * 2 / PIPE_STAGES / 1e9:.2f} GB a stage), "
          f"{PIPE_MICRO} microbatches of (1, {PIPE_S}, {cfg.d_model}) bf16 "
          f"({mb / 1e6:.2f} MB each); one-process forward "
          f"{ref_ms:.2f} ms on CUDA events, {ref_wall * 1e3:.2f} ms wall")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(ref.cpu(), Path(tmp) / "ref.pt")
        t0 = time.perf_counter()
        ctx = mp.spawn(pipe_stage_main, args=(free_port(), tmp),
                       nprocs=PIPE_STAGES, join=False)
        deadline = time.time() + PIPE_TIMEOUT
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"17a: the stage processes ran past {PIPE_TIMEOUT}s")
        spawn_wall = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt")
                 for r in range(PIPE_STAGES)]
    per = PIPE_LAYERS // PIPE_STAGES
    for r, st in enumerate(ranks):
        print(f"pipeline 17a rank {r}: stage {st['stage']}, "
              f"{st['stage_calls']} stage calls, {st['launches']} flash "
              f"launches, stage compute {st['stage_ms']:.2f} ms on CUDA "
              f"events, pipeline {st['wall_s'] * 1e3:.2f} ms wall; sent "
              f"{st['bytes_sent'] / 1e6:.2f} MB, received "
              f"{st['bytes_received'] / 1e6:.2f} MB, broadcast "
              f"{st['bytes_broadcast'] / 1e6:.2f} MB; transport "
              f"{st['transport']}; outputs {'equal' if st['equal'] else 'DIFFER'}"
              f" (max abs err {st['max_abs_err']:.3e})")
        if st["stage"] != r or st["stage_calls"] != PIPE_MICRO:
            fail(f"17a rank {r}: stage {st['stage']}, "
                 f"{st['stage_calls']} stage calls")
        if st["launches"] != PIPE_MICRO * per:
            fail(f"17a rank {r}: {st['launches']} flash launches, expected "
                 f"{PIPE_MICRO * per}")
        if not st["equal"] or st["shape"] != tuple(ref.shape):
            fail(f"17a rank {r}: the pipeline's outputs differ from the "
                 f"one-process forward (max abs err {st['max_abs_err']})")
    sent = sum(st["bytes_sent"] for st in ranks)
    bcast = ranks[-1]["bytes_broadcast"]
    wall = max(st["wall_s"] for st in ranks)
    print(f"pipeline 17a: {PIPE_STAGES} stages == one-process forward bit "
          f"for bit on every rank; wall {wall * 1e3:.2f} ms (slowest "
          f"rank) against {ref_wall * 1e3:.2f} ms; sends {sent / 1e6:.2f} "
          f"MB, broadcast {bcast / 1e6:.2f} MB to each of "
          f"{PIPE_STAGES - 1} ranks; transport {ranks[0]['transport']}; "
          f"stage processes {spawn_wall:.1f}s from spawn to exit")
    return {"launches": sum(st["launches"] for st in ranks),
            "ranks": [st["launches"] for st in ranks]}


def phase_examples():
    """17b: each ``examples_torch`` script with ``--device cuda`` as a
    process of its own, all at once; any nonzero exit fails."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        def run(job):
            script, *args = job
            extra = (["--ckpt-dir", str(Path(tmp) / "ckpt")]
                     if script == "train_e2e.py" else [])
            t = time.time()
            r = subprocess.run([sys.executable,
                                str(ROOT / "examples_torch" / script),
                                *args, *extra, "--device", "cuda"],
                               env=env, capture_output=True, text=True,
                               timeout=EXAMPLE_TIMEOUT, cwd=str(ROOT))
            return job, r, time.time() - t
        with ThreadPoolExecutor(len(EXAMPLE_RUNS)) as pool:
            runs = list(pool.map(run, EXAMPLE_RUNS))
    for job, r, wall in runs:
        name = " ".join(job)
        if r.returncode != 0:
            fail(f"17b {name}: exit {r.returncode}: {r.stdout[-1500:]}"
                 f"{r.stderr[-2500:]}")
        lines = r.stdout.splitlines()
        keep = [ln for ln in lines if "✓" in ln or "final loss" in ln
                or "hash-rule" in ln or "max err" in ln] or lines[-1:]
        print(f"example {name}: exit 0 in {wall:.1f}s; "
              + "; ".join(ln.strip() for ln in keep))
    print(f"examples 17b: {len(runs)} runs exit 0 in "
          f"{time.time() - t0:.1f}s of wall time (all at once)")


# ---------------------------------------------------------------------------
# Phase 18: the port's static checker, and the kernels' interfaces on the card
# ---------------------------------------------------------------------------

def phase_checker(card: str) -> dict:
    """18a runs ``python -m repro_torch.analysis --strict --format json``
    on this checkout: it must exit 0.  18b holds the five built libraries
    to the ``extern "C"`` declarations KRN001 parses from ``csrc/*.cu``
    (17 functions): after each wrapper's ``_lib()`` has typed its
    bindings, the functions it bound are exactly the parsed ones, each is
    a symbol of the built library, and each one's live ``argtypes`` /
    ``restype`` have the parsed C signature's count and widths (the
    bindings the static rule cannot see, a ``getattr`` loop, included).
    18c: each wrapper that gained a ``refuse_autograd`` guard (paged
    decode, flash, the int8 pair) raises "has no backward" on a CUDA
    input that requires grad under grad mode, launching nothing, and
    under ``torch.no_grad()`` launches once and agrees with its plain
    version."""
    import ctypes
    import os
    from repro_torch.analysis.rules.krn001 import ctype_kind, load_exports
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba_scan as MS
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels import rwkv_scan as RS
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         int8_dequantize_ref,
                                         int8_quantize_ref,
                                         paged_attention_ref)
    t0 = time.time()
    # 18a
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--format", "json"], cwd=str(ROOT), capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    lint_s = time.time() - t0
    if proc.returncode != 0:
        fail(f"18a repro_torch.analysis --strict exited {proc.returncode}: "
             f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    summary = report["summary"]
    print(f"18a repro_torch.analysis --strict: exit 0 in {lint_s:.2f}s of "
          f"wall time; {report['files_scanned']} files, "
          f"{len(report['rules'])} rules; {summary['new']} new, "
          f"{summary['baselined']} baselined, {summary['suppressed']} "
          f"suppressed, {summary['stale_baseline']} stale")
    # 18b
    exports = load_exports(ROOT / "src" / "repro_torch" / "kernels" / "csrc")
    wrappers = {"flash_attention": FA, "mamba_scan": MS,
                "paged_attention": PA, "quantize": QZ, "rwkv_scan": RS}
    if sorted(wrappers) != build.sources():
        fail(f"18b kernel sources {build.sources()} are not the wrapped "
             f"{sorted(wrappers)}")
    checked = []
    for name, mod in sorted(wrappers.items()):
        lib = mod._lib()
        declared = {f: d for f, d in exports.items()
                    if d.source == f"{name}.cu"}
        bound = {f for f, v in vars(lib).items()
                 if isinstance(v, ctypes._CFuncPtr)}
        if bound != set(declared):
            fail(f"18b {name}: the wrapper binds {sorted(bound)}, "
                 f"csrc/{name}.cu declares {sorted(declared)}")
        for fname, decl in sorted(declared.items()):
            if not hasattr(lib, fname):
                fail(f"18b {build.library_path(name).name} has no {fname}")
            fn = getattr(lib, fname)
            args = None if fn.argtypes is None else [
                ctype_kind(t.__name__) for t in fn.argtypes]
            ret = ctype_kind(None if fn.restype is None
                             else fn.restype.__name__)
            if args != list(decl.param_kinds) or ret != decl.ret_kind:
                fail(f"18b {fname}: bound ({args}) -> {ret}; "
                     f"csrc/{decl.source}:{decl.line} declares "
                     f"{list(decl.param_kinds)} -> {decl.ret_kind}")
            checked.append(fname)
    if len(checked) != 17:
        fail(f"18b checked {len(checked)} exports, want 17: {checked}")
    print(f"18b kernel interfaces: {len(checked)} exports of "
          f"{len(wrappers)} libraries bound by their wrappers, present in "
          f"the built libraries, argtypes and restype equal to csrc's "
          f"declarations in count and width")
    # 18c
    pc = pool_case(2, 4, 2, 32, 8, 4, 3, seed=0, dtype=torch.bfloat16)
    fq, fk, fv = flash_case(1, 4, 2, 128, 128, 64, seed=0,
                            dtype=torch.bfloat16)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)).cuda()
    codes, scales = QZ.int8_quantize_fwd(x)
    guards = (
        ("paged_attention", PA.paged_attention_fwd,
         lambda g: run_kernel(PA.paged_attention_fwd, dict(pc, q=g(pc["q"]))),
         lambda out: _close(out, paged_attention_ref(
             pc["q"], pc["k"], pc["v"], pc["pos"], pc["table"], pc["q_pos"]),
             TOL["bfloat16"], "18c paged_attention")),
        ("flash_attention", FA.flash_attention_fwd,
         lambda g: FA.flash_attention_fwd(g(fq), fk, fv),
         lambda out: _flash_err(*out, *flash_attention_ref(
             fq, fk, fv, return_lse=True), TOL["bfloat16"], "18c")),
        ("int8_quantize", QZ.int8_quantize_fwd,
         lambda g: QZ.int8_quantize_fwd(g(x)),
         lambda out: same_bits(out[0], int8_quantize_ref(x)[0])
         or fail("18c int8_quantize differs from the plain version")),
        ("int8_dequantize", QZ.int8_dequantize_fwd,
         lambda g: QZ.int8_dequantize_fwd(codes, g(scales), x.shape),
         lambda out: same_bits(out, int8_dequantize_ref(codes, scales,
                                                        x.shape))
         or fail("18c int8_dequantize differs from the plain version")),
    )
    for name, fwd, call, check in guards:
        before = fwd.launches
        try:
            call(lambda t: t.detach().clone().requires_grad_())
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"18c {name} on a CUDA input that requires grad did not "
                 f"raise")
        with torch.no_grad():
            out = call(lambda t: t.detach().clone().requires_grad_())
        torch.cuda.synchronize()
        if fwd.launches != before + 1:
            fail(f"18c {name}: {fwd.launches - before} launches, want 1 "
                 f"(the call under no_grad)")
        check(out)
        print(f"18c {name} on a CUDA input that requires grad under grad "
              f"mode: raised, nothing launched; under no_grad: launched "
              f"once, equal to the plain version")
    dt = time.time() - t0
    print(f"phase 18: {dt:.1f}s ({card})")
    return {"lint_s": lint_s, "files": report["files_scanned"],
            "exports": len(checked), "seconds": dt}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the repository's sources are not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd
    from repro_torch.kernels.paged_attention import paged_attention_fwd
    from repro_torch.kernels.quantize import (int8_dequantize_fwd,
                                              int8_quantize_fwd)
    from repro_torch.kernels.ref import (flash_attention_ref, mamba_scan_ref,
                                         paged_attention_ref, rwkv_scan_ref)
    from repro_torch.kernels.rwkv_scan import rwkv_scan_fwd
    kernels = (paged_attention_fwd, rwkv_scan_fwd, mamba_scan_fwd,
               flash_attention_fwd, int8_quantize_fwd, int8_dequantize_fwd)

    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel source(s) in {time.time() - t0:.1f}s")
    if sys.argv[1:] == ["--plane-lr-sweep"]:
        plane_lr_sweep()
        return 0
    print_build_report(build, libs)

    phase_kernel_vs_plain(paged_attention_fwd, paged_attention_ref)
    phase_mla_vs_plain(paged_attention_fwd, paged_attention_ref)
    phase_gemma_vs_plain(paged_attention_fwd, paged_attention_ref)
    # timed before any serving phase: after them a profiler session loses
    # the records of its first launches, and 10c's one-call count read 0
    pa_gemma = phase_gemma_kernel_times(paged_attention_fwd,
                                        paged_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    phase_rwkv_vs_plain(rwkv_scan_fwd, rwkv_scan_ref)
    phase_flash_vs_plain(flash_attention_fwd, flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    # by device time before any serving phase, as 10c
    fa_gemma = phase_flash_gemma_times(flash_attention_fwd,
                                       flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    phase_flash_backward()
    phase_sampling_bits()
    pa_launches, _ = phase_serve(paged_attention_fwd, kernels)
    pa_times = phase_kernel_times(paged_attention_fwd, paged_attention_ref,
                                  QWEN3_HQ, "qwen3-8b")
    gc.collect()                         # qwen3-8b's weights go first
    torch.cuda.empty_cache()
    rw_launches, _ = phase_serve_rwkv(rwkv_scan_fwd, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    rw_times = phase_rwkv_kernel_times(rwkv_scan_fwd, rwkv_scan_ref)
    phase_mamba_vs_plain(mamba_scan_fwd, mamba_scan_ref)
    gc.collect()
    torch.cuda.empty_cache()
    jamba_launches, _ = phase_serve_jamba(mamba_scan_fwd, paged_attention_fwd,
                                          kernels)
    gc.collect()                         # jamba's 46 GB go before training
    torch.cuda.empty_cache()
    phase_moe_bits()
    mb_times = phase_mamba_kernel_times(mamba_scan_fwd, mamba_scan_ref)
    pa_jamba = phase_kernel_times(paged_attention_fwd, paged_attention_ref,
                                  JAMBA_HQ, "jamba-1.5-large")
    gc.collect()
    torch.cuda.empty_cache()
    pa_mla = phase_mla_kernel_times(paged_attention_fwd, paged_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    ds_launches, _ = phase_serve_deepseek(paged_attention_fwd, kernels)
    gc.collect()                         # deepseek's 30 GB go before gemma3
    torch.cuda.empty_cache()
    gm_launches, _, gm_params, gm_cfg = phase_serve_gemma(paged_attention_fwd,
                                                          kernels)
    gc.collect()
    torch.cuda.empty_cache()
    phase_gemma_migration(gm_params, gm_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    phase_fleet(gm_params, gm_cfg)
    del gm_params                        # gemma3's 23.5 GB go before training
    gc.collect()
    torch.cuda.empty_cache()
    fa_launches, _, _ = phase_train(flash_attention_fwd, kernels)
    phase_remat_policies(flash_attention_fwd, kernels)
    gt_launches, _, _ = phase_train(flash_attention_fwd, kernels,
                                    "gemma3-12b", GEMMA_TRAIN_STEPS)
    phase_scan_training(kernels, flash_attention_fwd, mamba_scan_fwd,
                        rwkv_scan_fwd)
    fa_times = phase_flash_times(flash_attention_fwd, flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    phase_int8_vs_plain(int8_quantize_fwd, int8_dequantize_fwd)
    plane_launches, plane = phase_plane(kernels, flash_attention_fwd)
    q_times, dq_times = phase_int8_times(int8_quantize_fwd,
                                         int8_dequantize_fwd, plane["n_grad"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_dryrun()
    phase_dryrun_vs_real(paged_attention_fwd, card)
    gc.collect()
    torch.cuda.empty_cache()
    pipe = phase_pipeline(flash_attention_fwd)
    phase_examples()
    phase_checker(card)

    result = [
        # qwen3-8b's decode shape leads; jamba's (G = 8) follows with the
        # launches of its own served run
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:201",
         "launches": pa_launches, **pa_times,
         "shapes": {"qwen3-8b decode B=8 Hq=32 Hkv=8 D=128":
                        dict(pa_times, launches=pa_launches),
                    "jamba-1.5-large decode B=8 Hq=64 Hkv=8 D=128":
                        dict(pa_jamba,
                             launches=jamba_launches["paged_attention"]),
                    "deepseek-v3-671b MLA decode B=8 Hq=128 Hkv=1 "
                    "D=Dv=512 De=64, k is v":
                        dict(pa_mla, launches=ds_launches,
                             instance="mla: " + " + ".join(MLA_KERNELS)),
                    # 40 of gemma3's 48 layers read the ring, 8 the table
                    "gemma3-12b ring decode B=8 Hq=16 Hkv=8 D=256, 64 "
                    "columns, window 1024":
                        dict(pa_gemma["ring"],
                             launches=gm_launches["ring"]),
                    "gemma3-12b global decode B=8 Hq=16 Hkv=8 D=256, 128 "
                    "columns":
                        dict(pa_gemma["global"],
                             launches=gm_launches["global"])}},
        # the decode shape leads (every tick runs it); both shapes follow
        {"name": "rwkv_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:131",
         "launches": rw_launches, **rw_times["decode"],
         "shapes": {"decode B=8 S=1 H=64 hd=64": rw_times["decode"],
                    "prefill B=8 S=128 H=64 hd=64, 1 live row":
                        rw_times["prefill"]}},
        # jamba-1.5-large's decode shape leads; both shapes follow
        {"name": "mamba_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/ssm_scan.py:59",
         "launches": jamba_launches["mamba_scan"], **mb_times["decode"],
         "shapes": {"decode B=8 S=1 di=16384 ds=16": mb_times["decode"],
                    "prefill B=8 S=128 di=16384 ds=16, 1 live row":
                        mb_times["prefill"]}},
        # the training shape: qwen3-8b, B=2, S=4096, bf16, causal; then
        # gemma3-12b's two, with the launches of its own trained run
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:76",
         "launches": fa_launches["all"], **fa_times,
         "shapes": {"qwen3-8b training B=2 Hq=32 Hkv=8 S=4096 D=128 causal":
                        dict(fa_times, launches=fa_launches["all"]),
                    "gemma3-12b training B=2 Hq=16 Hkv=8 S=4096 D=256 "
                    "window 1024":
                        dict(fa_gemma["window 1024"],
                             launches=gt_launches["window"]),
                    "gemma3-12b training B=2 Hq=16 Hkv=8 S=4096 D=256 "
                    "causal":
                        dict(fa_gemma["causal"],
                             launches=gt_launches["all"]
                             - gt_launches["window"]),
                    # phase 17a: counted in each stage process
                    "qwen3-8b spmd_pipeline stages B=1 Hq=32 Hkv=8 "
                    "S=4096 D=128 causal, 4 gloo ranks on the card":
                        {"launches": pipe["launches"],
                         "launches_per_rank": pipe["ranks"]}}},
        # the decentralized plane's whole gradient (2.788 B bf16 elements);
        # launches: every payload and the gradient of its hand-driven step
        {"name": "int8_quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize.cu",
         "replaces": "src/repro/kernels/quantize.py:36",
         "launches": plane_launches["int8_quantize_fwd"], **q_times},
        {"name": "int8_dequantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantize.cu",
         "replaces": "src/repro/kernels/quantize.py:63",
         "launches": plane_launches["int8_dequantize_fwd"], **dq_times},
    ]
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.1f}s")
    print(json.dumps({"kernels": result}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
