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
   library's SASS holds HGMMA (tensor-core) instructions (informational);
2. hold the paged-decode kernel against its plain PyTorch version and
   against the plain mirror of its split-K algorithm on the card over
   the sweep of ``tests/test_paged_kernel.py`` plus the decode shapes of
   qwen3-8b and jamba-1.5-large (32 and 64 q heads over 8 kv heads;
   bf16 within 2e-2, f32 within 1e-4 — the sums run in another
   order than the plain version's), and check that -1 table columns
   (2 and 9 appended, inside a split and as whole empty splits) are
   exactly neutral and idle slots exactly zero;
3. serve qwen3-8b at full width (random bf16 weights drawn on the card)
   through ``ServingEngine(paged=True, use_kernel=True)``: 16 requests,
   half sharing a 256-token system prompt, two sampled.  Every decode
   tick must have gone through the kernel (launches == decode_calls x
   36), and one decode tick on a served state must give the same logits
   through the kernel and through the scan path (within the bf16
   tolerance 2e-2, relative to the logit scale);
4. time serving (CUDA events around each engine step) and the kernel at
   the served shape beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` on the gathered K/V (a yardstick
   only; the port never calls it): kernel and SDPA by their device time
   under ``torch.profiler`` (a ~20 µs launch takes less device time than
   its wrapper's host time, so back-to-back event timing, printed beside
   it, measures the host);
5. hold the ``rwkv_scan`` kernel against its plain version over the sweep
   of ``tests/test_kernels.py::test_rwkv_scan_vs_ref`` (zero state), with
   a nonzero initial state and the final state returned (S = 1, 150),
   and at the two served shapes (a decode tick, B=8 S=1 H=64 hd=64, and
   a 128-token prefill chunk with one live row), state written in place;
   bf16 output within 2e-2, f32 output and state within 1e-4, rows
   flagged idle keep their state bit for bit;
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
   recurrence, so there is no library time);
8. hold the ``mamba_scan`` kernel against its plain version over the
   sweep of ``tests/test_kernels.py::test_mamba_scan_vs_ref`` (zero
   state), with a nonzero initial state and the final state returned
   (S = 1, 150), and at the two served shapes of jamba-1.5-large (a
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
   and twice on one 128-token chunk: the same bits each time;
10. time ``mamba_scan`` at both served shapes beside its bound (bytes,
   float32 flops and exps on the SFUs) and its plain version (no single
   PyTorch call computes the selective scan, so there is no library
   time), and the paged-decode kernel at jamba's decode shape (64 q / 8
   kv heads);
11. hold the flash-attention kernel against its plain version over the
   sweep of ``tests/test_kernels.py::test_flash_attention_vs_ref`` (plus
   T > S) and at the training shape of qwen3-8b (B=2, S=4096, GQA 32 / 8
   heads of 128) with and without a 1,024-token window, each in bf16
   (the tensor-core instance) and f32 (the CUDA-core instance): output
   bf16 within 2e-2, f32 within 1e-4, logsumexp within 1e-4; then autograd
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
   rounding floor).  Prints step ms, tokens/s, MFU and peak memory;
13. time the flash kernel at the training shape beside its bound, its
   plain version and ``F.scaled_dot_product_attention`` (a yardstick
   only; the port never calls it);
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

The phases run in the order 1-2, 5, 11 (the kernel checks), 3-4, 6-7,
8-10, 12-13, 14 (the sweep), 15, 14 (the large run and times); each
model is freed before the next is drawn.

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
    kernel's name and its mangled template arguments."""
    out, name, spill, stack = [], None, 0, 0
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)I(\w*?)EEv",
                      line)
        if m:
            name, spill = f"{m.group(1)}<{m.group(2)}>", 0
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
    of (start, end, S, valid tokens)."""
    rec = []
    step = eng._call_step

    def timed(toks, pos):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(toks, pos)
        b.record()
        rec.append((a, b, toks.shape[1], int((pos >= 0).sum())))
        return out
    eng._call_step = timed
    return rec


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def serving_times(rec, wall):
    """Prefill / decode rates from the CUDA-event records of a served run,
    its wall time and the peak device memory; printed and returned."""
    pre = [(a.elapsed_time(b), n) for a, b, S, n in rec if S > 1]
    dec = [(a.elapsed_time(b), n) for a, b, S, n in rec if S == 1]
    timing = {
        "prefill_tok_s": sum(n for _, n in pre) / sum(t for t, _ in pre) * 1e3,
        "decode_tok_s": sum(n for _, n in dec) / sum(t for t, _ in dec) * 1e3,
        "ms_per_decode_tick": sum(t for t, _ in dec) / len(dec),
        "ms_per_prefill_call": sum(t for t, _ in pre) / len(pre),
        "wall_s": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serving: " + ", ".join(f"{k}={v}" for k, v in timing.items()))
    return timing


def phase_serve(fwd, kernels):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import forward, init_params, unembed
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
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)                # count only the main path's run
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fwd.launches
    st = eng.stats
    n_layers = cfg.n_layers
    if len(done) != 16 or any(len(r.generated) != 32 for r in done):
        fail("not every request finished with 32 tokens")
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
          f"= {st['decode_calls']} x {n_layers}")
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


def profile_ticks(eng, n=3):
    """Device-busy share and the top kernels of ``n`` decode ticks over
    the 8 slots admitted above, under ``torch.profiler`` (its own
    overhead inflates the wall time, so the busy share is a lower
    bound)."""
    from torch.profiler import ProfilerActivity, profile
    eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            eng.tick()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        print("profile: the profiler saw no device time (not measured)")
        return {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile of {n} decode ticks: {wall_us / n / 1e3:.2f} ms/tick "
          f"under the profiler, device busy {busy / n / 1e3:.2f} ms/tick "
          f"({busy / wall_us:.3f} of wall), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/tick; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / busy:.3f}"
                      for e in top))
    return {"profiled_ms_per_tick": wall_us / n / 1e3,
            "device_busy_ms_per_tick": busy / n / 1e3,
            "device_busy_share": busy / wall_us,
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


def device_ms(fn, n):
    """Device time per call of ``fn(i)``, from the kernel durations that
    ``torch.profiler`` records over ``n`` calls (CUPTI): the time the
    card spends in the call's kernels, not the host time between them.
    None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / n / 1e3 if busy > 0 else None


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
    ms = device_ms(lambda i: run_kernel(fwd, cases[i % 4]), 200)
    if ms is None:
        fail("the profiler saw no device time for the paged kernel")
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
# Phase 5: the rwkv_scan kernel against its plain version
# ---------------------------------------------------------------------------

RWKV_SWEEP = [(1, 32, 2, 16), (2, 64, 3, 16), (1, 40, 1, 32)]  # (B, S, H, hd)
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
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for B, S, H, hd in RWKV_SWEEP:
            c = rwkv_case(B, S, H, hd, seed=S, dtype=dtype)
            out = fwd(*rwkv_args(c))
            torch.cuda.synchronize()
            worst[dname] = max(worst[dname], _err(
                out, ref(*rwkv_args(c)), TOL[dname], f"sweep {dname}"))
    print(f"rwkv_scan vs plain, sweep of test_rwkv_scan_vs_ref, zero state: "
          f"max abs err bf16 {worst['bfloat16']:.3e} (tol 2e-2), f32 "
          f"{worst['float32']:.3e} (tol 1e-4)")
    tol = TOL["float32"]
    for S in (1, 150):
        for dtype in (torch.bfloat16, torch.float32):
            c = rwkv_case(2, S, 4, 64, seed=S, dtype=dtype,
                          w_dtype=torch.float32, state=True)
            o, st = fwd(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                        return_state=True)
            torch.cuda.synchronize()
            eo, es = ref(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                         return_state=True)
            eo_, es_ = _err(o, eo, tol, "o with s0"), _err(st, es, tol,
                                                           "state")
            print(f"rwkv_scan vs plain, s0 given, S={S}, {dtype}: max abs "
                  f"err o {eo_:.3e}, state {es_:.3e} (tol 1e-4)")
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
        errs[name] = (_err(o, eo, tol, f"{name} o"),
                      _err(buf, es, tol, f"{name} state"))
        if rows is not None and not torch.equal(buf[~rows], c["s0"][~rows]):
            fail(f"rwkv_scan {name}: an idle row's state changed")
        print(f"rwkv_scan vs plain at the served {name} shape "
              f"(B,S,H,hd)={shape}, state in place: max abs err o "
              f"{errs[name][0]:.3e}, state {errs[name][1]:.3e} (tol 1e-4)"
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


def phase_rwkv_kernel_times(fwd, ref):
    out = {}
    for name, shape, n_bufs, reps, plain_reps in (
            ("decode", RWKV_DECODE, 8, 400, 20),
            ("prefill", RWKV_PREFILL, 2, 50, 3)):
        # enough states / operands in turn that L2 (50 MB) holds none of
        # the previous launch's, as in serving (each layer has its own)
        cases = [served_rwkv_case(shape, seed=i) for i in range(n_bufs)]

        def kern(i):
            c = cases[i % n_bufs]
            return fwd(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                       rows=c.get("rows"), state_out=c["s0"])

        def plain(i):
            c = cases[i % n_bufs]
            return ref(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                       return_state=True, rows=c.get("rows"))
        for i in range(3):
            kern(i)
        ms = event_ms(kern, reps)
        plain_ms = event_ms(plain, plain_reps)
        bound_ms, bound_by, byts, flops = rwkv_bound(cases[0])
        c = served_rwkv_case(shape, seed=99)
        o = fwd(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32,
                rows=c.get("rows"))
        eo = ref(*rwkv_args(c), s0=c["s0"], out_dtype=torch.float32)
        err = (o - eo).abs().max().item()
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "max_abs_err": err}
        print(f"rwkv_scan at the served {name} shape (B,S,H,hd)={shape}: "
              f"kernel {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}: {byts / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP "
              f"f32), plain {plain_ms * 1e3:.1f} us, library none")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the mamba_scan kernel against its plain version
# ---------------------------------------------------------------------------

MAMBA_SWEEP = [(1, 32, 64, 8), (2, 96, 192, 16), (1, 50, 48, 4)]  # B,S,di,ds
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
    """y in bf16 within 2e-2, y in f32 and the final state within 1e-4 (the
    kernel's exp is the SFU's, a few ulp off, and its sums contract into
    fma); rows flagged idle keep their state bit for bit."""
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for B, S, di, ds in MAMBA_SWEEP:
            c = mamba_case(B, S, di, ds, seed=S, dtype=dtype)
            out = fwd(*mamba_args(c))
            torch.cuda.synchronize()
            worst[dname] = max(worst[dname], _close(
                out, ref(*mamba_args(c)), TOL[dname],
                f"mamba_scan sweep {dname} {(B, S, di, ds)}"))
    print(f"mamba_scan vs plain, sweep of test_mamba_scan_vs_ref, zero "
          f"state: max abs err bf16 {worst['bfloat16']:.3e} (tol 2e-2), "
          f"f32 {worst['float32']:.3e} (tol 1e-4)")
    tol = TOL["float32"]
    for S in (1, 150):
        for dtype in (torch.bfloat16, torch.float32):
            c = mamba_case(2, S, 192, 16, seed=S, dtype=dtype, state=True)
            y, h = fwd(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                       return_state=True)
            torch.cuda.synchronize()
            ey, eh = ref(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                         return_state=True)
            e_y = _close(y, ey, tol, f"mamba_scan y with h0, S={S}")
            e_h = _close(h, eh, tol, f"mamba_scan state, S={S}")
            print(f"mamba_scan vs plain, h0 given, S={S}, {dtype}: max abs "
                  f"err y {e_y:.3e}, state {e_h:.3e} (tol 1e-4)")
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
        # enough states / operands in turn that L2 (50 MB) holds none of
        # the previous launch's, as in serving (each layer has its own)
        cases = [served_mamba_case(shape, seed=i) for i in range(n_bufs)]

        def kern(i):
            c = cases[i % n_bufs]
            return fwd(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                       rows=c.get("rows"), state_out=c["h0"])

        def plain(i):
            c = cases[i % n_bufs]
            return ref(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                       return_state=True, rows=c.get("rows"))
        for i in range(3):
            kern(i)
        ms = event_ms(kern, reps)
        plain_ms = event_ms(plain, plain_reps)
        bound_ms, bound_by, byts, elems = mamba_bound(cases[0])
        c = served_mamba_case(shape, seed=99)
        y = fwd(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32,
                rows=c.get("rows"))
        ey = ref(*mamba_args(c), h0=c["h0"], out_dtype=torch.float32)
        err = (y - ey).abs().max().item()
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "max_abs_err": err}
        print(f"mamba_scan at the served {name} shape (B,S,di,ds)={shape}: "
              f"kernel {ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
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
    test_kernels.py and at the training and windowed full-width shapes."""
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
    for name, shape in (("training", FLASH_TRAIN), ("window 1024", FLASH_WINDOW)):
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


# ---------------------------------------------------------------------------
# Phase 12: qwen3-8b trained at full width (depth cut to 8 layers)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8                 # of 36: 44.6 GB of state (16 B / param)
TRAIN_B, TRAIN_S = 2, 4096       # 8192 tokens per step
TRAIN_STEPS = 7                  # one warmup step, then six timed
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
    layers and the untied head; the embedding is a lookup) x tokens, plus
    3 x the causal attention forward's two products (forward, and twice
    that in the backward), as MFU counts them."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                 + 3 * d * cfg.d_ff)
    matmul_params = cfg.n_layers * per_layer + d * cfg.vocab_size
    pairs = B * cfg.n_heads * S * (S + 1) / 2
    attn_fwd = cfg.n_layers * pairs * 2 * 2 * hd
    return 6 * matmul_params * B * S + 3 * attn_fwd


def step0_run(cfg, params, batch, use_kernel, kv_chunk=1024):
    """Loss, grad norm and gradients of one training step's forward and
    backward (remat, chunked cross-entropy) from ``params`` on ``batch``;
    ``kv_chunk`` sets the plain attention's float32 summation order."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.loss import cross_entropy_chunked
    from repro_torch.train.step import _head_matrix, grads_of
    from repro_torch.models.transformer import forward
    h, _, _ = forward(params, cfg, batch, remat=True, compute_logits=False,
                      kv_chunk=kv_chunk, use_kernel=use_kernel)
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


def profile_train_step(trainer, step_fn, loader):
    """Device time of one more training step by kernel, under
    ``torch.profiler``: the busy share of the step's wall time and the
    shares of the flash kernel, the matmuls and the rest."""
    from torch.profiler import ProfilerActivity, profile
    batch = loader.batch(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        trainer.params, trainer.opt_state, _ = step_fn(
            trainer.params, trainer.opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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


def phase_train(fwd, kernels):
    """qwen3-8b at full width, 8 of 36 layers, trained through the port's
    Trainer (adamw, cosine_lr, full remat, use_kernel) for TRAIN_STEPS
    steps on SyntheticLM batches of 2 x 4096 tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.models.transformer import init_params, trainable
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=TRAIN_LAYERS)
    loader = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B,
        noise=0.05, seed=0), device="cuda")

    params = trainable(init_params(0, cfg, device="cuda"))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"qwen3-8b, {TRAIN_LAYERS} of 36 layers: {n_params / 1e9:.3f} B "
          f"parameters; batch {TRAIN_B} x {TRAIN_S} tokens")
    step0 = step0_compare(cfg, params, loader.batch(0))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = TrainConfig(steps=TRAIN_STEPS, lr=1e-3, warmup=1,
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
    launches = fwd.launches
    per_step = 2 * cfg.n_layers          # forward + remat recompute
    if launches != per_step * TRAIN_STEPS:
        fail(f"flash launches {launches} != {per_step} x {TRAIN_STEPS} steps")
    losses = [m["loss"] for m in hist]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"training losses are not {TRAIN_STEPS} finite values: {losses}")
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
    print(f"trained {TRAIN_STEPS} steps ({wall:.1f}s): loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}; flash launches {launches} = {per_step} x "
          f"{TRAIN_STEPS}")
    print("training: " + ", ".join(f"{k}={v}" for k, v in timing.items()))
    timing.update(profile_train_step(trainer, step_fn, loader))
    del trainer, hist
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timing, step0


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


def print_build_report(build, libs) -> None:
    """Registers, static shared memory and spills of every kernel instance
    (ptxas), the dynamic shared memory of the redesigned kernels' blocks,
    the compiler's warnings, and whether the flash library's SASS holds
    tensor-core instructions (informational, not a gate)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    for name, log in sorted(build.logs.items()):
        print(f"ptxas {name}: " + "; ".join(
            f"{inst} {regs} regs {smem} B static smem {spill} B spilled "
            f"{stack} B stack" for inst, regs, smem, spill, stack
            in ptxas_summary(log)))
        for line in log.splitlines():
            if "warning" in line.lower() or "(C7" in line:
                print(f"nvcc {name}: {line.strip()}")
    for D in (64, 128, 256):
        inst = FA.instance(torch.bfloat16, D)
        print(f"flash_attention bf16 D={D}: tensor cores "
              f"{inst['tensor_cores']}, {inst['smem_bytes']} B dynamic smem "
              f"per block")
    print(f"paged_attention: {PA.PAGES_PER_SPLIT} table columns per split; "
          f"{PA.smem_bytes(4, 128, 128, 0, 16, 2)} / "
          f"{PA.smem_bytes(8, 128, 128, 0, 16, 2)} B dynamic smem per block "
          f"at G = 4 / 8, D = 128, page 16, bf16")
    counts = sass_mma_count(libs["flash_attention"])
    print("flash_attention SASS: " + (
        "not checked (no cuobjdump)" if counts is None else
        f"{counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA instructions"))


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
    phase_rwkv_vs_plain(rwkv_scan_fwd, rwkv_scan_ref)
    phase_flash_vs_plain(flash_attention_fwd, flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    phase_flash_backward()
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
    fa_launches, _, _ = phase_train(flash_attention_fwd, kernels)
    fa_times = phase_flash_times(flash_attention_fwd, flash_attention_ref)
    gc.collect()
    torch.cuda.empty_cache()
    phase_int8_vs_plain(int8_quantize_fwd, int8_dequantize_fwd)
    plane_launches, plane = phase_plane(kernels, flash_attention_fwd)
    q_times, dq_times = phase_int8_times(int8_quantize_fwd,
                                         int8_dequantize_fwd, plane["n_grad"])

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
                             launches=jamba_launches["paged_attention"])}},
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
        # the training shape: qwen3-8b, B=2, S=4096, bf16, causal
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:76",
         "launches": fa_launches, **fa_times},
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
    print(json.dumps({"kernels": result}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
