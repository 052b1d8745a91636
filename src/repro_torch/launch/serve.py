"""Serving launcher of the port: the chunked-prefill continuous-batching
engine over a smoke config, on the GPU unless ``--device cpu`` is given.

The flags are the single-engine flags of ``repro.launch.serve``:
``--paged`` (default on) stores KV through a block table with
content-addressed prefix sharing (``--no-prefix-share`` turns it off,
``--prefix-tokens N`` prepends a shared system prompt); ``--kernel``
runs each mixer's Hopper kernel (paged decode attention, the Mamba and
RWKV recurrences in prefill and decode); ``--temperature`` /
``--top-p`` / ``--top-k`` / ``--rep-penalty`` choose tokens per slot;
``--warmup`` (default on) runs both engine shapes ahead of traffic;
``--hold-pages N`` keeps refcount-zero registered prefix pages in an LRU
hold.

``--replicas N`` serves the same traffic through a ``FleetRouter`` of N
engines sharing one parameter tree on the device, placed on simulated
consumer devices (``--devices``) by estimated completion time, with
``--standby`` spares in the broker's backup pool, heartbeat rounds every
``--heartbeat-every`` ticks (``--reliability`` < 1: seeded failures), a
seeded fault plan (``--chaos-rate`` over ``--chaos-ticks``,
``--chaos-seed``), a per-request ``--max-retries`` budget and
``--strict`` to raise on any failed request.  ``--migration``
(auto | always | never) moves soft-drained or rebalanced requests by
verified export / import, ``--snapshot-every`` lets crash victims resume
from a snapshot, ``--rebalance-every`` adds the load trigger.

    python -m repro_torch.launch.serve --arch qwen3-8b --kernel
    python -m repro_torch.launch.serve --device cpu --requests 6 --chunk 4
    python -m repro_torch.launch.serve --device cpu --arch rwkv6-7b --kernel
    python -m repro_torch.launch.serve --device cpu \
        --arch jamba-1.5-large-398b --kernel
    python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-v3-671b --kernel     # MLA absorbed decode
    python -m repro_torch.launch.serve --device cpu --arch gemma3-12b \
        --kernel                             # sliding-window ring pools
    python -m repro_torch.launch.serve --device cpu --arch gemma3-12b \
        --kernel --replicas 3 --standby 1 --chaos-rate 0.05

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
from repro_torch.core.perfmodel import DEVICE_CATALOG
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.router import FleetRouter, sim_node


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
    ap.add_argument("--hold-pages", type=int, default=0,
                    help="per-engine LRU hold: keep up to N refcount-zero "
                         "registered pages resident so re-admissions and "
                         "imports dedup against them (sharing engines)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a FleetRouter of this many engine "
                         "replicas (1 = a single engine, no router)")
    ap.add_argument("--devices", default="rtx4090,rtx3080",
                    help="comma-separated DEVICE_CATALOG names cycled over "
                         "the replicas (the router's placement speeds)")
    ap.add_argument("--standby", type=int, default=0,
                    help="spare replicas in the broker's backup pool, "
                         "drafted by speed match on failure")
    ap.add_argument("--heartbeat-every", type=int, default=0,
                    help="fleet mode: a broker heartbeat round every N "
                         "ticks (0 = no failure detection)")
    ap.add_argument("--reliability", type=float, default=1.0,
                    help="per-heartbeat survival probability of a replica "
                         "(< 1: seeded failures mid-decode)")
    ap.add_argument("--chaos-rate", type=float, default=0.0,
                    help="fleet mode: per-(tick, replica) probability of a "
                         "seeded fault (crash / straggle / partition / "
                         "pool_pressure / corrupt); 0 = no fault plan")
    ap.add_argument("--chaos-ticks", type=int, default=64,
                    help="faults strike over the first N ticks")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="fault-plan seed (-1 = --seed)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="requeues from the prompt a request may take "
                         "before it fails with outcome failed_retries")
    ap.add_argument("--strict", action="store_true",
                    help="fleet mode: raise on any failed request")
    ap.add_argument("--migration", choices=["auto", "always", "never"],
                    default="auto",
                    help="fleet mode: move soft-drained / rebalanced "
                         "requests by verified export / import; 'auto' "
                         "weighs bytes over bandwidth against re-prefill")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="fleet mode: snapshot every admitted request's "
                         "tokens every N ticks so crash victims resume "
                         "(0 = off)")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="fleet mode: every N ticks migrate the newest "
                         "request off an overloaded replica (0 = off)")
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

    def build_engine():
        return ServingEngine(params, cfg, slots=args.slots,
                             cache_len=args.cache_len, chunk=args.chunk,
                             paged=args.paged, page_size=args.page_size,
                             num_blocks=args.num_blocks or None,
                             use_kernel=args.kernel, seed=args.seed,
                             share_prefix=args.prefix_share,
                             hold_pages=args.hold_pages, device=dev)

    if args.replicas > 1:
        serve_fleet(args, cfg, build_engine, dev)
        return
    engine = build_engine()
    if not args.no_warmup:
        t0 = time.time()
        engine.warmup()
        print(f"warmup: ran prefill ({args.slots},{engine.chunk}) + "
              f"decode ({args.slots},1) in {time.time() - t0:.2f}s")
    for req in _requests(args, cfg):
        engine.submit(req)
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


def _requests(args, cfg):
    """The launcher's traffic: ``--requests`` prompts of 4..7 random
    tokens behind the optional shared system prompt."""
    rng = np.random.default_rng(args.seed + 1)
    system = (rng.integers(0, cfg.vocab_size, args.prefix_tokens).tolist()
              if args.prefix_tokens else [])
    return [Request(i, system + rng.integers(0, cfg.vocab_size,
                                             4 + i % 4).tolist(),
                    max_new=args.max_new, temperature=args.temperature,
                    top_p=args.top_p, top_k=args.top_k,
                    rep_penalty=args.rep_penalty,
                    max_retries=args.max_retries)
            for i in range(args.requests)]


def serve_fleet(args, cfg, build_engine, dev):
    """--replicas > 1: a broker-routed fleet of engines on simulated
    devices behind one FIFO queue, with standbys and an optional seeded
    fault plan; prints the outcomes and the router's counters."""
    devices = [d.strip() for d in args.devices.split(",") if d.strip()]
    for d in devices:
        if d not in DEVICE_CATALOG:
            raise SystemExit(f"--devices: unknown device {d!r} "
                             f"(catalog: {', '.join(DEVICE_CATALOG)})")

    def node(i):
        return sim_node(devices[i % len(devices)],
                        reliability=args.reliability)
    plan = None
    if args.chaos_rate > 0:
        chaos_seed = args.seed if args.chaos_seed < 0 else args.chaos_seed
        plan = FaultPlan.seeded(
            chaos_seed, ticks=args.chaos_ticks,
            replica_ids=list(range(args.replicas + args.standby)),
            rate=args.chaos_rate)
        print(f"chaos: {len(plan)} seeded faults over {args.chaos_ticks} "
              f"ticks (seed={chaos_seed}, rate={args.chaos_rate})")
    router = FleetRouter(
        [(build_engine(), node(i)) for i in range(args.replicas)],
        [(build_engine(), node(args.replicas + i))
         for i in range(args.standby)],
        seed=args.seed, fault_plan=plan, migration=args.migration,
        snapshot_every=args.snapshot_every,
        rebalance_every=args.rebalance_every)
    if not args.no_warmup:
        t0 = time.time()
        for rep in router.replicas:
            rep.engine.warmup()
        print(f"warmup: {len(router.replicas)} replicas in "
              f"{time.time() - t0:.2f}s")
    for req in _requests(args, cfg):
        router.submit(req)
    _sync(dev)
    t0 = time.time()
    res = router.run(heartbeat_every=args.heartbeat_every,
                     strict=args.strict)
    _sync(dev)
    dt = time.time() - t0
    done = res.completed
    toks = sum(len(r.generated) for r in done)
    st = router.stats
    print(f"{cfg.name} fleet: {len(router.live_replicas())} live replicas "
          f"served {len(done)}/{len(done) + len(res.failed)} requests, "
          f"{toks} tokens in {dt:.2f}s ({res.ticks} ticks, device={dev})")
    print("  outcomes: " + ", ".join(
        f"{k}={v}" for k, v in sorted(res.outcomes().items())))
    print(f"  router: {st['placed']} placements, {st['held']} held ticks, "
          f"{st['failures']} failures, {st['requeued']} requeued, "
          f"{st['replacements']} drafted from backup")
    shown = ("soft_drains", "preempted", "straggles", "partitions",
             "partition_heals", "partition_escalations", "pool_pressure",
             "injected_crashes", "corrupt_faults", "migrations",
             "migration_fallbacks", "rebalances", "rebalance_holds",
             "snapshot_restores")
    if any(st[k] for k in shown):
        print("  degraded mode / failover: " + ", ".join(
            f"{k}={st[k]}" for k in shown if st[k]))
    reps = list(router.replicas) + list(router._standby.values())
    engine_stats = {k: sum(r.engine.stats[k] for r in reps)
                    for k in ("imported", "import_rejects", "deduped_pages",
                              "resumed_tokens")}
    print("  engines: " + ", ".join(f"{k}={v}"
                                    for k, v in engine_stats.items()))
    for r in sorted(res.failed, key=lambda r: r.req_id)[:6]:
        tr = res.traces.get(r.req_id, {})
        print(f"  FAILED req{r.req_id}: outcome={r.outcome} "
              f"retries={r.retries}/{r.max_retries} "
              f"placements={tr.get('placements')}")


if __name__ == "__main__":
    main()
