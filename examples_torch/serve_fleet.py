"""Fleet serving example: a broker-routed multi-engine fleet surviving a
mid-decode replica failure.  The PyTorch port of
``examples/serve_fleet.py``: the replicas are the port's engines over one
weight tree on one device (the card unless ``--device cpu``).

Three engine replicas on heterogeneous simulated devices (one rtx4090,
two rtx3080) plus one rtx3080 standby share a FIFO queue; the router
places each request on the replica minimizing the Eq. 2-style estimated
completion time, so the fast device serves more of a uniform workload.
A broker heartbeat round then kills one rtx3080 replica mid-decode
(deterministically — its node's reliability is 0): the standby is
drafted by SPEED MATCH from the backup pool (rtx3080 replaces rtx3080,
not the fast peer), the dead replica's in-flight requests re-prefill
from their prompts on the survivors, and the example asserts that

* every submitted request still completes with its full max_new tokens,
* requests served by UNAFFECTED replicas are bitwise-identical to a
  no-failure run of the same fleet (slot isolation + greedy decode),
* re-queued requests produce the same tokens too (same params, greedy —
  re-prefill is exact, whichever replica picks them up).

Every request opens with the same full-page system prompt, so the run
also demonstrates content-addressed prefix sharing: each replica stores
that page once and attaches it (refcount++) on every later admission —
including failover requeues, whose drained requests carry their prefix
digests so the router co-locates them with their shared pages.

A final degraded-mode act injects a ``FaultPlan`` on a healthy fleet:
the fast replica straggles (soft-drain moves its work — by verified
KV-page migration when a compatible peer has room, so moved requests
keep their pages and generated tokens and pay no retry; requeue-from-
prompt is the fallback), one rtx3080 is network-partitioned (its
requests freeze and resume after heal with no re-prefill), and the run
still completes every request "ok", bitwise-equal to the calm run.

    PYTHONPATH=src python examples_torch/serve_fleet.py
    PYTHONPATH=src python examples_torch/serve_fleet.py --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.router import FleetRouter, sim_node


def build_fleet(params, cfg, device, *, kill_rtx3080: bool, plan=None):
    """3 active replicas + 1 standby.  ``kill_rtx3080`` sets replica 1's
    node reliability to 0 so the FIRST heartbeat round kills it; ``plan``
    optionally injects a degraded-mode fault schedule."""
    def engine():
        return ServingEngine(params, cfg, slots=2, cache_len=64, chunk=8,
                             paged=True, page_size=16, device=device)
    nodes = [sim_node("rtx4090", reliability=1.0),
             sim_node("rtx3080", reliability=0.0 if kill_rtx3080 else 1.0),
             sim_node("rtx3080", reliability=1.0)]
    return FleetRouter([(engine(), n) for n in nodes],
                       [(engine(), sim_node("rtx3080", reliability=1.0))],
                       seed=0, fault_plan=plan)


SYSTEM = list(range(40, 56))        # one full shared system-prompt page


def serve(router, cfg, n_requests, heartbeat_every):
    for i in range(n_requests):
        tail = [(3 + 5 * i + j) % cfg.vocab_size for j in range(4 + i % 3)]
        router.submit(Request(i, SYSTEM + tail, max_new=8))
    router.run(heartbeat_every=heartbeat_every)
    return {r.req_id: r.generated for r in router.finished}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS), default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    params = init_params(0, cfg, device=device)

    # reference: same fleet, no failure
    calm = build_fleet(params, cfg, device, kill_rtx3080=False)
    ref = serve(calm, cfg, args.requests, heartbeat_every=0)

    # failure run: heartbeat every 2 ticks, replica 1 dies on the first one
    stormy = build_fleet(params, cfg, device, kill_rtx3080=True)
    out = serve(stormy, cfg, args.requests, heartbeat_every=2)
    st = stormy.stats

    print(f"{cfg.name} fleet on {device}: {args.requests} requests, "
          f"replica 1 (rtx3080) killed mid-decode by heartbeat round 1")
    print(f"  router: {st['failures']} failure, {st['requeued']} in-flight "
          f"requests requeued, {st['replacements']} standby drafted")
    for rep in stormy.replicas:
        state = "live" if rep.alive else "DEAD"
        print(f"  replica {rep.replica_id} [{rep.node.device.name}, "
              f"{state}]: served {sorted(rep.served)}")

    # every submitted request completed, none dropped or truncated
    assert sorted(out) == list(range(args.requests)), sorted(out)
    assert all(len(g) == 8 for g in out.values())
    assert st["failures"] == 1 and st["replacements"] == 1
    # the drafted replacement speed-matches the dead rtx3080 (not rtx4090)
    drafted = stormy.replicas[-1]
    assert drafted.node.device.name == "rtx3080", drafted.node.device.name
    print("speed-matched standby drafted ✓")
    # placement skew: the rtx4090 replica served the most requests
    fast = stormy.replicas[0]
    assert all(len(fast.served) >= len(r.served)
               for r in stormy.replicas if r.alive)
    # bitwise parity with the no-failure run — for EVERY request (shared
    # params + greedy decode make re-prefill exact), which subsumes the
    # unaffected replicas
    assert out == ref
    print(f"all {args.requests} requests complete, outputs bitwise-equal "
          f"to the no-failure run ✓")
    # every request opens with the same full-page system prompt: replicas
    # serving more than one stored that page ONCE (content-addressed,
    # refcounted) and skipped its prefill chunks on every re-hit — the
    # parity assert above already proved sharing never changed a token
    if all(r.engine._can_share for r in stormy.replicas):
        shared = sum(r.engine.stats["shared_pages"]
                     for r in stormy.replicas)
        cow = sum(r.engine.stats["cow_copies"] for r in stormy.replicas)
        assert shared > 0, "system-prompt page never shared"
        print(f"prefix sharing: {shared} page attaches fleet-wide "
              f"({cow} copy-on-write), outputs unchanged ✓")

    # act 3 — degraded mode without any death: a FaultPlan straggles the
    # fast replica (its tick-latency EWMA crosses the drain threshold ->
    # in-flight work soft-drains: verified KV-page migration to a peer
    # with room, zero retries charged; requeue-from-prompt with digests
    # preserved when no destination fits) and partitions one rtx3080
    # (its requests FREEZE in place and resume after heal with no
    # re-dispatch and no re-prefill); every request still completes
    # "ok", bitwise-equal to the calm run
    plan = FaultPlan()
    plan.add(Fault(tick=2, replica_id=0, kind="straggle", factor=6.0,
                   duration=6))
    plan.add(Fault(tick=3, replica_id=2, kind="partition", duration=4))
    degraded = build_fleet(params, cfg, device, kill_rtx3080=False,
                           plan=plan)
    for i in range(args.requests):
        tail = [(3 + 5 * i + j) % cfg.vocab_size for j in range(4 + i % 3)]
        degraded.submit(Request(i, SYSTEM + tail, max_new=8))
    res = degraded.run()
    st = degraded.stats
    print(f"degraded run: outcomes " + ", ".join(
        f"{k}={v}" for k, v in sorted(res.outcomes().items())))
    print(f"  {st['straggles']} straggle ticks -> {st['soft_drains']} "
          f"soft-drain ({st['migrations']} migrated with pages+tokens, "
          f"{st['requeued']} requeued from prompt), "
          f"{st['partitions']} partition -> {st['partition_heals']} "
          f"healed in place")
    assert res.ok, res.outcomes()
    assert st["soft_drains"] >= 1, "straggler never crossed drain EWMA"
    # drained work went SOMEWHERE: live migration (state + pages move,
    # no retry) or the digest-preserving requeue fallback
    assert st["migrations"] + st["requeued"] >= 1, st
    assert st["partitions"] == 1 and st["partition_heals"] == 1
    assert {r.req_id: r.generated for r in res.completed} == ref
    print("straggler drained, partition healed, outputs bitwise-equal ✓")


if __name__ == "__main__":
    main()
