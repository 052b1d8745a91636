#!/usr/bin/env python3
"""Card-side smoke check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository's sources beside this file; it
imports ``repro_torch``, torch and numpy only.  Phases, each fatal on
failure:

1. build every kernel of ``src/repro_torch/kernels/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card over
   the sweep of ``tests/test_paged_kernel.py`` plus the qwen3-8b decode
   shape (bf16 within 2e-2, f32 within 1e-4 — the sums run in another
   order than the plain version's), and check that -1 table columns are
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
   only; the port never calls it).

Output: human-readable lines, then one JSON line ``{"kernels": [...]}``,
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's sources, it exits nonzero and prints no result.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same source
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


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


def qwen3_decode_case(dtype, seed=0):
    """The served decode shape: 8 slots, 32 q / 8 kv heads of 128, 16-row
    pages, 64 table columns over a 512-page pool, rows filled to mixed
    lengths (2..40 pages, as 32..600-token prompts plus 32 new tokens)."""
    g = torch.Generator().manual_seed(seed + 100)
    used = torch.randint(2, 41, (8,), generator=g).tolist()
    return pool_case(8, 32, 8, 128, 16, 64, used, seed=seed,
                     dtype=dtype, N=512)


def phase_kernel_vs_plain(fwd, ref):
    worst = {}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        tol = TOL[dname]
        cases = [(pool_case(B, Hq, Hkv, D, page, n, used, seed=B + used,
                            dtype=dtype, De=De, Dv=None), window, softcap,
                  (48 + De) ** -0.5 if De else None)
                 for (B, Hq, Hkv, D, page, n, used, window, softcap, De)
                 in SWEEP]
        cases.append((qwen3_decode_case(dtype), 0, 0.0, None))
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
            worst[dname] = max(worst.get(dname, 0.0), err)
        # a -1 column is exactly neutral; an idle slot outputs exact zeros
        c = cases[0][0]
        base = run_kernel(fwd, c)
        wide = dict(c, table=torch.cat(
            [c["table"], torch.full_like(c["table"][:, :2], -1)], 1).contiguous())
        if not torch.equal(run_kernel(fwd, wide), base):
            fail(f"{dname}: a -1 table column changed the output")
        idle = dict(c, q_pos=c["q_pos"].clone())
        idle["q_pos"][1, 0] = -1
        out = run_kernel(fwd, idle)
        if out[1].abs().max().item() != 0.0 or not torch.equal(out[0], base[0]):
            fail(f"{dname}: an idle slot did not output exact zeros")
        torch.cuda.synchronize()
        print(f"kernel vs plain [{dname}]: {len(cases)} cases, max abs err "
              f"{worst[dname]:.3e} (tol {tol}); -1 columns neutral, idle "
              f"slots zero")
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


def phase_serve(fwd):
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
    fwd.launches = 0                     # count only the main path's run
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


def phase_kernel_times(fwd, ref):
    import torch.nn.functional as F
    from repro_torch.models.layers import gather_pages, gather_pos
    # four pools (4 x 33.5 MB of K/V) in turn, so L2 (50 MB) holds no
    # previous launch's pages — the serving loop reads them cold too
    cases = [qwen3_decode_case(torch.bfloat16, seed=s) for s in range(4)]
    c = cases[0]
    B, _, Hq, D = c["q"].shape
    page, Hkv, Dv = c["v"].shape[1], c["v"].shape[2], c["v"].shape[3]
    out = run_kernel(fwd, c)
    exp = run_kernel(ref, c)
    max_err = (out.float() - exp.float()).abs().max().item()
    for _ in range(3):
        run_kernel(fwd, c)
    ms = event_ms(lambda i: run_kernel(fwd, cases[i % 4]), 200)
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
    library_ms = event_ms(sdpa, 200)

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
    print(f"paged_attention at the served shape (B=8, Hq=32, Hkv=8, D=128, "
          f"page 16, 64 columns, {cols} allocated): kernel {ms * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.2f} us ({byts / 1e6:.2f} MB), plain "
          f"{plain_ms * 1e3:.1f} us, sdpa on gathered K/V "
          f"{library_ms * 1e3:.2f} us")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max_err}


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
    from repro_torch.kernels.paged_attention import paged_attention_fwd
    from repro_torch.kernels.ref import paged_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel source(s) in {time.time() - t0:.1f}s")

    phase_kernel_vs_plain(paged_attention_fwd, paged_attention_ref)
    launches, _ = phase_serve(paged_attention_fwd)
    times = phase_kernel_times(paged_attention_fwd, paged_attention_ref)

    kernel = {"name": "paged_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
              "replaces": "src/repro/kernels/paged_attention.py:201",
              "launches": launches, **times}
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
