"""Batched serving example: chunked-prefill continuous batching with
mixed prompt lengths and request arrival between ticks, on any assigned
architecture (including the hybrid/SSM ones, whose decode uses recurrent
state).  Admission costs ceil(S/chunk) engine steps per prompt; the
decode tick is one step for all slots.  The PyTorch port of
``examples/serve_batched.py``.

By default the KV cache is **paged** (``--no-paged`` for the dense
per-slot rings): each request takes ceil((prompt + max_new) / page_size)
pages from a shared ``--num-blocks`` pool through a block table.  The
example asserts paged and dense decode are token-identical, that a late
arrival decodes as a fresh ``generate()``, and, with ``--kernel`` (the
paged-decode kernel, and the Mamba / RWKV scan kernels on the card),
that the kernel path matches the scan path too.
``--temperature``/``--top-p``/``--top-k``/``--rep-penalty`` exercise
the per-slot sampler instead.

    PYTHONPATH=src python examples_torch/serve_batched.py --arch rwkv6-7b --kernel
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu
"""
import argparse
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServingEngine, generate


def serve(params, cfg, args, paged: bool, use_kernel: bool = False,
          share: bool = True):
    engine = ServingEngine(params, cfg, slots=args.slots, cache_len=96,
                           chunk=args.chunk, paged=paged,
                           page_size=args.page_size,
                           num_blocks=args.num_blocks or None,
                           use_kernel=use_kernel, share_prefix=share,
                           device=args.device)
    sample_kw = dict(temperature=args.temperature, top_p=args.top_p,
                     top_k=args.top_k, rep_penalty=args.rep_penalty)
    # first wave
    for i in range(4):
        engine.submit(Request(i, [1 + i, 2, 3], max_new=6, **sample_kw))
    ticks = 0
    while engine.tick():
        ticks += 1
        if ticks == 3:   # late arrivals join running batch
            engine.submit(Request(100, [7, 8, 9, 10], max_new=5, **sample_kw))
            engine.submit(Request(101, [7, 8, 9, 10], max_new=5, **sample_kw))
    return engine, ticks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="rwkv6-7b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--paged", dest="paged", action="store_true",
                    default=True, help="block-table KV cache (default)")
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="dense per-slot ring caches only")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="0 = same memory as the dense cache")
    ap.add_argument("--kernel", action="store_true",
                    help="decode through the paged-decode kernel and run "
                         "the scans through their kernels (paged mode "
                         "only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="0 = no top-k cut")
    ap.add_argument("--rep-penalty", type=float, default=1.0,
                    help="1.0 = no repetition penalty")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    args.device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = init_params(0, cfg, device=args.device)
    engine, ticks = serve(params, cfg, args, paged=args.paged,
                          use_kernel=args.kernel)
    done = sorted(engine.finished, key=lambda r: r.req_id)
    st = engine.stats
    mode = (f"paged pool {engine.num_blocks}x{engine.page_size}"
            if engine.paged else "dense rings")
    print(f"{cfg.name}: {len(done)} requests over {ticks} engine ticks "
          f"({mode}, {args.device})")
    print(f"  {st['prefill_calls']} chunked-prefill steps (chunk="
          f"{engine.chunk}) + {st['decode_calls']} decode steps for "
          f"{st['admitted']} admissions, {st['backpressure']} backpressure")
    for r in done:
        print(f"  req{r.req_id:3d} prompt={r.prompt} -> {r.generated}")
    # admission cost is ceil(S/chunk) steps per prompt, never S — and
    # prefix sharing can only LOWER it (shared pages skip their chunks)
    expected = sum(math.ceil(len(r.prompt) / engine.chunk) for r in done)
    if engine._can_share:
        assert st["prefill_calls"] <= expected, (st["prefill_calls"],
                                                 expected)
        print(f"  prefix sharing: {st['shared_pages']} pages attached, "
              f"{st['shared_tokens']} prompt tokens skipped prefill, "
              f"{st['cow_copies']} copy-on-write")
    else:
        assert st["prefill_calls"] == expected, (st["prefill_calls"],
                                                 expected)
    if cfg.n_experts:
        # MoE capacity-factor dropping couples slots through the shared
        # per-batch expert budget, so same-prompt equality and generate()
        # parity don't hold here
        print("MoE arch: slot-isolation/parity self-checks skipped "
              "(capacity dropping is batch-coupled)")
        return
    if args.temperature > 0 or args.rep_penalty != 1.0:
        # sampled slots use per-slot PRNG streams / penalized logits, so
        # the greedy parity self-checks below don't apply
        print("sampling on: greedy parity self-checks skipped")
        return
    # same-prompt requests must decode identically (slot isolation)
    assert done[-1].generated == done[-2].generated
    ref = generate(params, cfg, torch.tensor([[7, 8, 9, 10]],
                                             dtype=torch.int32),
                   max_new=5)[0, 4:].tolist()
    assert done[-1].generated == ref, (done[-1].generated, ref)
    print("late-arrival decode == fresh generate() ✓")
    if args.paged:
        other, _ = serve(params, cfg, args, paged=False)
        dense = sorted(other.finished, key=lambda r: r.req_id)
        assert [r.generated for r in done] == [r.generated for r in dense]
        print("paged decode == dense decode ✓")
        if engine._can_share:
            private, _ = serve(params, cfg, args, paged=True, share=False)
            ns = sorted(private.finished, key=lambda r: r.req_id)
            assert [r.generated for r in done] == [r.generated for r in ns]
            assert st["prefill_calls"] <= private.stats["prefill_calls"]
            print("prefix-shared decode == private-pages decode ✓")
        if args.kernel:
            scan, _ = serve(params, cfg, args, paged=True, use_kernel=False)
            spath = sorted(scan.finished, key=lambda r: r.req_id)
            assert [r.generated for r in done] == [r.generated
                                                   for r in spath]
            print("kernel decode == scan-path decode ✓")


if __name__ == "__main__":
    main()
