"""Serving launcher of the port: the chunked-prefill continuous-batching
engine over a smoke config, on the GPU unless ``--device cpu`` is given.

The flags are the single-engine flags of ``repro.launch.serve``:
``--paged`` (default on) stores KV through a block table with
content-addressed prefix sharing (``--no-prefix-share`` turns it off,
``--prefix-tokens N`` prepends a shared system prompt); ``--kernel``
runs each mixer's Hopper kernel (paged decode attention, the Mamba and
RWKV recurrences in prefill and decode); ``--temperature`` /
``--top-p`` / ``--top-k`` / ``--rep-penalty`` choose tokens per slot;
``--warmup`` (default on) runs both engine shapes ahead of traffic.

    python -m repro_torch.launch.serve --arch qwen3-8b --kernel
    python -m repro_torch.launch.serve --device cpu --requests 6 --chunk 4
    python -m repro_torch.launch.serve --device cpu --arch rwkv6-7b --kernel
    python -m repro_torch.launch.serve --device cpu \
        --arch jamba-1.5-large-398b --kernel
    python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-v3-671b --kernel     # MLA absorbed decode

Serving takes tokens only, as the JAX engine does: the frontend-stub
models (llava-next-mistral-7b, musicgen-medium) serve their token path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServingEngine


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk: admission costs ceil(S/chunk) "
                         "steps instead of S")
    ap.add_argument("--paged", dest="paged", action="store_true",
                    default=True,
                    help="block-table KV cache: per-request pages from a "
                         "shared pool (default)")
    ap.add_argument("--no-paged", dest="paged", action="store_false",
                    help="dense per-slot ring caches (reference semantics)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="positions per cache page (paged mode)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="pool size in pages; 0 = same memory as the dense "
                         "cache (slots * cache_len / page_size)")
    ap.add_argument("--no-prefix-share", dest="prefix_share",
                    action="store_false", default=True,
                    help="disable content-addressed prefix sharing")
    ap.add_argument("--prefix-tokens", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every request (exercises prefix sharing)")
    ap.add_argument("--kernel", action="store_true",
                    help="run each mixer's Hopper kernel: decode attention "
                         "through the paged-decode kernel, the Mamba and "
                         "RWKV recurrences (prefill and decode) through "
                         "mamba_scan / rwkv_scan (paged mode only; their "
                         "plain PyTorch versions on the CPU)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (with --temperature > 0)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample only among the k highest-logit tokens "
                         "(0 = no top-k cut; with --temperature > 0)")
    ap.add_argument("--rep-penalty", type=float, default=1.0,
                    help="CTRL-style repetition penalty on already-emitted "
                         "tokens (1.0 = off; applies to greedy slots too)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the ahead-of-traffic run of the two engine "
                         "shapes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = init_params(args.seed, cfg, device=dev)
    engine = ServingEngine(params, cfg, slots=args.slots,
                           cache_len=args.cache_len, chunk=args.chunk,
                           paged=args.paged, page_size=args.page_size,
                           num_blocks=args.num_blocks or None,
                           use_kernel=args.kernel, seed=args.seed,
                           share_prefix=args.prefix_share, device=dev)
    if not args.no_warmup:
        t0 = time.time()
        engine.warmup()
        print(f"warmup: ran prefill ({args.slots},{engine.chunk}) + "
              f"decode ({args.slots},1) in {time.time() - t0:.2f}s")
    rng = np.random.default_rng(args.seed + 1)
    system = (rng.integers(0, cfg.vocab_size, args.prefix_tokens).tolist()
              if args.prefix_tokens else [])
    for i in range(args.requests):
        prompt = system + rng.integers(0, cfg.vocab_size, 4 + i % 4).tolist()
        engine.submit(Request(i, prompt, max_new=args.max_new,
                              temperature=args.temperature,
                              top_p=args.top_p, top_k=args.top_k,
                              rep_penalty=args.rep_penalty))
    _sync(dev)
    t0 = time.time()
    done = engine.run()
    _sync(dev)
    dt = time.time() - t0
    toks = sum(len(r.generated) for r in done)
    st = engine.stats
    mode = (f"paged:{engine.num_blocks}x{engine.page_size}"
            + ("+kernel" if engine.use_kernel else "")
            if engine.paged else "dense")
    print(f"{cfg.name}: served {len(done)} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks/dt:.1f} tok/s, slots={args.slots}, {mode}, "
          f"device={dev})")
    print(f"  engine calls: {st['prefill_calls']} prefill (chunk="
          f"{engine.chunk}) + {st['decode_calls']} decode ticks, "
          f"{st['admitted']} admissions, {st['backpressure']} backpressure")
    if engine._can_share:
        print(f"  prefix sharing: {st['shared_pages']} pages attached "
              f"({st['shared_tokens']} prompt tokens skipped prefill), "
              f"{st['cow_copies']} copy-on-write")
    for r in sorted(done, key=lambda r: r.req_id)[:4]:
        print(f"  req{r.req_id}: prompt={r.prompt} -> {r.generated}")


if __name__ == "__main__":
    main()
