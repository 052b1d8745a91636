"""Fleet router: broker-routed multi-engine serving (paper §3.2 + §3.8).

``FleetRouter`` is the bridge between the repo's two halves: the
decentralized control plane (``core.broker.Broker`` — membership,
heartbeats, a backup pool, speed-matched replacement drafting) and the
serving data plane (``serve.engine.ServingEngine`` — chunked prefill,
paged slot cache, fused decode kernel).  It owns N engine replicas, each
bound to a simulated ``CompNode`` device (``perfmodel.DEVICE_CATALOG``),
pulls from ONE shared FIFO request queue, and places each request on the
replica minimizing the Eq. 2-style estimated completion time

    ECT(r, p) = (pending_tokens(p) + prompt + max_new
                 + prefill_call_cost * (pending_prefill_calls(p)
                                        + prefill_calls_for(r)
                                        + queued(p)))
                * flops_per_token(p) / CompNode.speed(p)
                * lat_ewma(p)

admission-aware: every jitted chunked-prefill call still ahead of the
replica (its queue's, prefix-sharing discounts applied, plus this
request's own tail) costs ``prefill_call_cost`` token-equivalents of
dispatch overhead, and each queued request one admission's worth of
service latency.  ``lat_ewma`` is the replica's observed tick-latency
EWMA (1.0 when healthy), so a straggling replica's ECT inflates by
exactly how slow it has actually been.  Replicas within ``tie_eps`` of
the best ECT are a near-tie, broken toward PREFIX AFFINITY — the replica
already holding (or about to admit) the request's shared prompt-prefix
pages — then by lowest replica id (fully deterministic).  Placement is
subject to the replica's free paged blocks (a request is only dispatched
to a replica whose pool can cover its worst-case reservation on top of
everything already queued there; otherwise it waits at the head of the
shared queue — FIFO is never reordered).  A head request that no LIVE
replica could ever run (heterogeneous fleets: vocab/context/pool gating)
drafts the fastest capable standby from the backup pool immediately
instead of waiting for a failure that may never come.

**Degraded modes** (see ``serve.faults`` for the injection plane): the
failure model is no longer binary.  A replica whose tick-latency EWMA
crosses ``drain_factor`` is **soft-drained** — its in-flight work is
requeued via the digest-preserving ``drain_requests()`` so victims
re-share their prefixes on healthier replicas — and receives no new work
until its EWMA recovers.  A **partitioned** replica is unreachable (no
dispatch, no engine ticks, no harvest) but its engine state is RETAINED:
on heal, in-flight decode resumes mid-token without re-prefill; a
partition outlasting ``partition_timeout`` escalates to the crash path.
A head-of-line request held for more than ``hol_patience`` ticks (its
worst-case page reservation fits nowhere because the pools are
fragmented) **preempts** the newest admitted request on its best
replica — preempted work is requeued-from-prompt behind it, never
dropped, and pays no retry budget.  Every fault-caused
requeue-from-prompt (crash, soft-drain, partition timeout) costs the
victim one retry; a request exhausting ``max_retries`` stops consuming
the fleet and fails terminally with outcome ``failed_retries``.

**Stateful failover** (``migration`` / ``snapshot_every`` /
``rebalance_every``): faults no longer have to cost re-prefill.  A
soft-drained replica's admitted requests are MIGRATED mid-decode via
``engine.export_state`` / ``import_state`` — page contents ship to the
min-ECT compatible peer, the importer's chained-crc32 verification
rejects any corrupted payload before a byte reaches its pool, and the
destination deduplicates shared prefix pages against its content
registry (only non-resident pages transfer; per-replica registry
views are gossiped on heartbeat rounds, which also lets placement
affinity see pages registered after earlier decisions).  Whether to
migrate is a bytes-over-bandwidth decision: payload bytes over the
source+destination ``LinkSpec`` versus re-prefilling prompt + decoded
tokens at the destination's speed plus per-call dispatch overhead —
``migration="auto"`` (default) migrates only when it is cheaper,
``"always"`` skips the cost check, ``"never"`` restores the old
requeue-from-prompt behavior everywhere.  ``rebalance_every`` > 0
additionally migrates the newest-admitted request off the
most-loaded replica whenever its pending-token backlog exceeds
``rebalance_factor``x the least-loaded peer's.  Independently,
``snapshot_every`` > 0 records each admitted request's
``(prefix digests, generated tokens)`` every that-many ticks, so the
CRASH path (where the replica's pages really are gone) restores
tokens-so-far deterministically: the victim re-prefills prompt +
snapshot tokens in one extended admission and re-decodes only what
was generated after the last snapshot.  A migrated request pays no
retry budget and keeps its decode progress; every fallback is the old
requeue-from-prompt path, so nothing new can be dropped — and a
``corrupt``-faulted transfer falls back there with the victim's final
output bitwise-identical to a no-fault run.

Fault tolerance reuses the broker verbatim: every replica's node is
registered ``active``, every standby replica's node ``backup``.  A
heartbeat round can kill a replica mid-decode (standbys are pinged by
the same seeded process — a dead standby is dropped, never drafted); the
broker then drafts the backup whose device speed best matches the dead
one, the router activates the corresponding standby engine, and the dead
replica's in-flight requests (admitted slots AND its internal queue) are
re-queued at the FRONT of the shared queue from their prompts — the
KV/pages died with the replica, so they re-prefill from scratch; nothing
is ever silently dropped.  Drained requests keep their prefix digests
(``drain_requests`` stamps them), so same-prefix victims still co-locate
by affinity and re-share their prefix pages on the survivor.  Requests
on unaffected replicas are untouched (slot isolation keeps their greedy
decode bitwise-identical to a no-failure run).

``run()`` returns a ``FleetResult``: completed requests, terminally
failed requests (every one stamped with a structured ``outcome``), and
a per-request placement/retry/latency trace — partial results are never
raised away.  ``run(strict=True)`` restores the old contract and raises
when anything failed.

Replicas may be heterogeneous in BOTH dimensions: different simulated
devices (speed skews placement toward fast peers) and different
(params, cfg) models (``can_serve`` gates by vocab bound, context
length, and pool size, so a request only routes to replicas whose model
can actually run it).

The port of ``repro.serve.router`` over the port's engine, broker and
performance model.  The replicas' engines may share one card (and one
parameter tree); the device catalog's speeds stay a host-side placement
model of consumer GPUs, whatever card the engines run on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.broker import Broker
from repro_torch.core.perfmodel import (DEVICE_CATALOG, LINK_REGIMES,
                                        CompNode, DeviceSpec, LinkSpec)
from repro_torch.serve.engine import Request, RequestState, ServingEngine
from repro_torch.serve.faults import FaultPlan
from repro_torch.tree import leaves

DeviceLike = Union[str, DeviceSpec, CompNode]

# terminal request outcomes (Request.outcome)
OUTCOMES = ("ok", "failed_retries", "failed_unservable", "deadline_exceeded")


def sim_node(device: DeviceLike, *,
             link: Optional[LinkSpec] = None, lam: float = 0.75,
             reliability: float = 0.999) -> CompNode:
    """A simulated provider for a replica: catalog name / spec -> CompNode
    (node_id is assigned by the broker at registration)."""
    if isinstance(device, CompNode):
        return device
    spec = DEVICE_CATALOG[device] if isinstance(device, str) else device
    return CompNode(-1, spec, link or LINK_REGIMES["lan_10gbps"], lam=lam,
                    reliability=reliability)


def _flip_payload(state: RequestState) -> None:
    """Apply a ``corrupt`` fault to an in-flight migration payload: flip
    one byte of the first non-empty pool page array (falling back to the
    checksum field for page-free payloads).  The importer's chained-crc32
    verification must reject the transfer — this helper exists so the
    chaos suite can prove it does."""
    for key in sorted(state.pool):
        arr = np.ascontiguousarray(state.pool[key]).copy()
        if arr.nbytes:
            arr.view(np.uint8).reshape(-1)[0] ^= 0xFF
            state.pool[key] = arr
            return
    state.checksum ^= 1


def _flops_per_token(engine: ServingEngine) -> float:
    """Analytic per-token cost of a replica's model: the standard
    2 * params FLOPs/token estimate, read off the replica's own param
    pytree so heterogeneous-model fleets cost each replica correctly."""
    n_params = sum(x.numel() for x in leaves(engine.params))
    return 2.0 * float(n_params)


@dataclass
class Replica:
    """One engine bound to one simulated device, plus its degraded-mode
    state: ``lat_ewma`` (observed tick-latency EWMA, 1.0 = healthy)
    scales its ECT and triggers soft-drain; ``busy_ticks`` counts the
    remaining fleet ticks of a straggling engine tick still in flight;
    ``partition_start`` >= 0 marks it unreachable (engine state
    retained) until ``partitioned_until``."""
    replica_id: int
    engine: ServingEngine
    node: CompNode
    flops_per_token: float
    alive: bool = True
    served: List[int] = field(default_factory=list)   # completed req_ids
    _harvested: int = 0        # prefix of engine.finished already collected
    # -- degraded-mode state (driven by FleetRouter + serve.faults) -----
    lat_ewma: float = 1.0      # tick-latency EWMA; multiplies the ECT
    busy_ticks: int = 0        # straggler: fleet ticks left in current tick
    straggle_factor: float = 1.0
    straggle_until: int = 0    # fleet tick the straggle episode ends
    partition_start: int = -1  # fleet tick the partition began (-1 = none)
    partitioned_until: int = 0
    pressure_until: int = 0    # fleet tick pool_pressure lifts
    corrupt_until: int = 0     # payloads exported before this tick flip
    soft_drained: bool = False  # already drained this degraded episode


@dataclass
class FleetResult:
    """What ``FleetRouter.run()`` produces: ``completed`` requests in
    finish order, terminally ``failed`` requests (each with a structured
    ``Request.outcome``), a per-request ``traces`` dict (req_id ->
    placements / retries / outcome / submitted+finished tick / latency),
    and the total fleet ``ticks`` run.  Iterating or ``len()``-ing the
    result walks the completed requests, so pre-existing
    ``for r in router.run()`` call sites keep working."""
    completed: List[Request]
    failed: List[Request]
    traces: Dict[int, dict]
    ticks: int

    @property
    def ok(self) -> bool:
        return not self.failed

    def outcomes(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for req in self.completed + self.failed:
            counts[req.outcome] = counts.get(req.outcome, 0) + 1
        return counts

    def __iter__(self) -> Iterator[Request]:
        return iter(self.completed)

    def __len__(self) -> int:
        return len(self.completed)

    def __repr__(self) -> str:
        return (f"FleetResult(completed={len(self.completed)}, "
                f"failed={len(self.failed)}, ticks={self.ticks}, "
                f"outcomes={self.outcomes()})")


class FleetRouter:
    """N serving replicas + standby spares behind one FIFO queue, with
    broker membership/failover and degraded-mode fault handling.  See
    the module docstring for semantics.

    ``replicas`` / ``standby``: sequences of ``(engine, device)`` pairs,
    ``device`` a ``DEVICE_CATALOG`` name, a ``DeviceSpec``, or a
    pre-built ``CompNode`` (whose ``reliability`` drives the seeded
    heartbeat failure process).

    ``fault_plan``: an optional ``serve.faults.FaultPlan`` consumed at
    the start of every tick (deterministic fault injection).
    ``drain_factor``: tick-latency EWMA at which a replica is
    soft-drained and stops receiving new work.  ``hol_patience``: held
    ticks before a head-of-line request preempts the newest admitted
    request on its best replica.  ``partition_timeout``: ticks after
    which an unhealed partition escalates to a crash.

    ``migration`` (``"auto"`` | ``"always"`` | ``"never"``): whether
    soft-drain and rebalance ship verified decode state between
    replicas instead of requeueing-from-prompt (``"auto"`` applies the
    bytes-over-bandwidth cost check; ``dispatch_s`` is the per-call
    overhead in its re-prefill estimate).  ``snapshot_every`` > 0
    records each admitted request's (digests, generated) every
    that-many ticks so crashes restore tokens-so-far.
    ``rebalance_every`` > 0 checks every that-many ticks whether the
    most-loaded replica's pending tokens exceed ``rebalance_factor``x
    the least-loaded peer's and migrates its newest-admitted request.

    ``stats`` counts ``placed`` dispatches, ``completed`` requests,
    replica ``failures``, ``requeued`` in-flight requests, backup-pool
    ``replacements``, head-of-line ``held`` ticks, plus the degraded-mode
    counters: ``soft_drains`` / ``preempted`` / ``straggles`` /
    ``partitions`` / ``partition_heals`` / ``partition_escalations`` /
    ``pool_pressure`` / ``injected_crashes`` / ``standby_deaths``, the
    stateful-failover counters: ``migrations`` / ``migration_fallbacks``
    / ``rebalances`` / ``snapshot_restores`` / ``corrupt_faults``, and
    the terminal failure outcomes.  ``placements`` records every
    req_id -> [replica_id, ...] dispatch history (len > 1 = re-queued
    after a fault, or migrated mid-decode).
    """

    def __init__(self, replicas: Sequence[Tuple[ServingEngine, DeviceLike]],
                 standby: Sequence[Tuple[ServingEngine, DeviceLike]] = (),
                 *, seed: int = 0, heartbeat_s: float = 10.0,
                 prefill_call_cost: float = 4.0, tie_eps: float = 0.02,
                 fault_plan: Optional[FaultPlan] = None,
                 drain_factor: float = 3.0, ewma_alpha: float = 0.5,
                 hol_patience: int = 8, partition_timeout: int = 32,
                 migration: str = "auto", snapshot_every: int = 8,
                 rebalance_every: int = 0, rebalance_factor: float = 4.0,
                 dispatch_s: float = 1e-3):
        if not replicas:
            raise ValueError("FleetRouter: at least one replica required")
        if migration not in ("auto", "always", "never"):
            raise ValueError(f"FleetRouter: migration must be 'auto', "
                             f"'always' or 'never', got {migration!r}")
        # admission-aware ECT: each outstanding jitted prefill call costs
        # this many token-equivalents of dispatch overhead on top of its
        # tokens, and each queued request one admission's worth of
        # service latency.  tie_eps is the relative ECT band treated as a
        # near-tie, broken toward prefix affinity then replica id.
        self.prefill_call_cost = prefill_call_cost
        self.tie_eps = tie_eps
        self.fault_plan = fault_plan
        self.drain_factor = drain_factor
        self.ewma_alpha = ewma_alpha
        self.hol_patience = hol_patience
        self.partition_timeout = partition_timeout
        # stateful failover: "auto" migrates when bytes-over-bandwidth
        # beats re-prefill, "always" skips the cost check, "never"
        # restores requeue-from-prompt everywhere.  dispatch_s is the
        # per-jitted-call overhead in the re-prefill cost estimate.
        self.migration = migration
        self.snapshot_every = snapshot_every
        self.rebalance_every = rebalance_every
        self.rebalance_factor = rebalance_factor
        self.dispatch_s = dispatch_s
        self.broker = Broker(seed=seed, heartbeat_s=heartbeat_s)
        self.replicas: List[Replica] = []
        self._standby: Dict[int, Replica] = {}      # node_id -> Replica
        self._by_node: Dict[int, Replica] = {}
        rid = 0
        seen_engines: set = set()
        for pool, pairs in (("active", replicas), ("backup", standby)):
            for engine, device in pairs:
                if id(engine) in seen_engines:
                    raise ValueError(
                        "FleetRouter: the same ServingEngine object was "
                        "passed for two replicas — each replica needs its "
                        "own engine (they hold independent slot caches)")
                seen_engines.add(id(engine))
                node = sim_node(device)
                self.broker.register(node, pool=pool)
                rep = Replica(rid, engine, node, _flops_per_token(engine),
                              alive=(pool == "active"))
                self._by_node[node.node_id] = rep
                if pool == "active":
                    self.replicas.append(rep)
                else:
                    self._standby[node.node_id] = rep
                rid += 1
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.placements: Dict[int, List[int]] = {}
        self.tick_count = 0
        self._submit_order: Dict[int, int] = {}     # req_id -> arrival seq
        self._order_seq = 0
        self._submitted_at: Dict[int, int] = {}     # req_id -> submit tick
        self._finished_at: Dict[int, int] = {}      # req_id -> terminal tick
        self._hol_req: Optional[int] = None         # held head req_id
        self._hol_held = 0                          # consecutive held ticks
        self._preempted_ids: set = set()            # ever-preempted req_ids
        # stateful-failover state: periodic (digests, generated) records
        # for the crash path, and the heartbeat-gossiped per-replica
        # content-registry views for affinity + migrate-dedup estimates
        self._snapshots: Dict[int, Tuple[tuple, List[int]]] = {}
        self._registry_view: Dict[int, frozenset] = {}
        self.stats = {"placed": 0, "completed": 0, "failures": 0,
                      "requeued": 0, "replacements": 0, "held": 0,
                      "soft_drains": 0, "preempted": 0, "straggles": 0,
                      "partitions": 0, "partition_heals": 0,
                      "partition_escalations": 0, "pool_pressure": 0,
                      "injected_crashes": 0, "standby_deaths": 0,
                      "migrations": 0, "migration_fallbacks": 0,
                      "rebalances": 0, "rebalance_holds": 0,
                      "snapshot_restores": 0, "corrupt_faults": 0,
                      "failed_retries": 0, "failed_unservable": 0,
                      "deadline_exceeded": 0}

    # -- membership ------------------------------------------------------

    def live_replicas(self) -> List[Replica]:
        return [r for r in self.replicas if r.alive]

    def _reachable(self, rep: Replica) -> bool:
        return rep.alive and rep.partition_start < 0

    def _healthy(self, rep: Replica) -> bool:
        """Eligible for NEW work: reachable and not latency-degraded."""
        return self._reachable(rep) and rep.lat_ewma < self.drain_factor

    def _servable_somewhere(self, req: Request) -> bool:
        pool = self.live_replicas() + list(self._standby.values())
        return any(r.engine.can_serve(req.prompt, req.max_new) for r in pool)

    # -- intake + placement ----------------------------------------------

    def submit(self, req: Request) -> None:
        if not self._servable_somewhere(req):
            raise ValueError(
                f"FleetRouter: no replica (live or standby) can ever serve "
                f"request {req.req_id} (prompt={len(req.prompt)} tokens, "
                f"max_new={req.max_new}) — check vocab/cache_len/pool sizes")
        self._note_order(req)
        self._submitted_at.setdefault(req.req_id, self.tick_count)
        self.queue.append(req)

    def _note_order(self, req: Request) -> None:
        if req.req_id not in self._submit_order:
            self._submit_order[req.req_id] = self._order_seq
            self._order_seq += 1

    def _ect(self, rep: Replica, req: Request) -> float:
        """Eq. 2-style estimated completion time of ``req`` on ``rep``,
        admission-aware: beyond the token count (outstanding work plus
        this request), every jitted chunked-prefill call still ahead —
        the replica's queue, prefix-sharing discounts applied, plus this
        request's own ``ceil(tail/chunk)`` — costs
        ``prefill_call_cost`` token-equivalents of dispatch overhead,
        and each already-queued request one more admission's worth of
        service latency.  The whole estimate is scaled by the replica's
        observed tick-latency EWMA (1.0 when healthy), so stragglers
        price themselves out of placement by exactly how slow they have
        actually been.  Two replicas with equal token backlogs no
        longer tie when one of them has the backlog fragmented across
        many short prompts (more calls, slower wall clock)."""
        eng = rep.engine
        tokens = eng.pending_tokens + len(req.prompt) + req.max_new
        calls = eng.pending_prefill_calls + eng.prefill_calls_for(req.prompt)
        tokens += self.prefill_call_cost * (calls + len(eng.queue))
        return tokens * rep.flops_per_token / rep.node.speed * rep.lat_ewma

    def _affinity(self, rep: Replica, req: Request) -> int:
        """Prefix-affinity score of placing ``req`` on ``rep``: resident
        shared prefix pages the engine could attach RIGHT NOW, or — when
        the pages died with a failed replica — the longest common
        prefix-digest run with a request already queued on ``rep`` (the
        pages will be registered when that request admits, so
        co-locating still converts to sharing), or the leading-digest
        run against the replica's last heartbeat-gossiped registry view
        (pages registered AFTER earlier placement decisions).  Digest
        trails come from ``drain_requests`` for failover requeues and
        are recomputed from the prompt otherwise."""
        eng = rep.engine
        pages = eng.shared_prefix_pages(req.prompt)
        mine = (req.prefix_digests if req.prefix_digests is not None
                else eng.prefix_digests(req.prompt))
        view = self._registry_view.get(rep.replica_id)
        if view:
            run = 0
            for d in mine:
                if d not in view:
                    break
                run += 1
            pages = max(pages, run)
        for other in eng.queue:
            theirs = (other.prefix_digests if other.prefix_digests is not None
                      else eng.prefix_digests(other.prompt))
            common = 0
            for a, b in zip(mine, theirs):
                if a != b:
                    break
                common += 1
            pages = max(pages, common)
        return pages

    def _draft_capable_standby(self, req: Request) -> Optional[Replica]:
        """No LIVE replica can ever serve ``req``: activate the fastest
        standby whose model can (waiting for a failure to draft it would
        hold the queue head forever)."""
        cands = [r for r in self._standby.values()
                 if r.engine.can_serve(req.prompt, req.max_new)]
        if not cands:
            return None
        rep = max(cands, key=lambda r: r.node.speed)
        self.broker.activate_backup(
            rep.node.node_id, f"req {req.req_id} unservable on live fleet")
        self._standby.pop(rep.node.node_id)
        rep.alive = True
        self.replicas.append(rep)
        self.stats["replacements"] += 1
        return rep

    def _dispatch(self) -> None:
        """Place queued requests, FIFO: the head request goes to the
        min-ECT healthy replica (reachable, not latency-degraded) whose
        paged pool can still cover its worst-case reservation; if none
        currently can (but one could later), the head WAITS — later
        requests are not reordered past it — and after ``hol_patience``
        held ticks the newest admitted request on the head's best
        replica is preempted to make room (requeued-from-prompt, never
        dropped).  A head that no live replica could EVER run drafts a
        capable standby from the backup pool, or fails terminally with
        outcome ``failed_unservable`` (never a silent drop, never a
        raise that loses everyone else's results)."""
        while self.queue:
            req = self.queue[0]
            able = [r for r in self.live_replicas()
                    if r.engine.can_serve(req.prompt, req.max_new)]
            if not able:
                drafted = self._draft_capable_standby(req)
                if drafted is None:
                    self.queue.pop(0)
                    self._fail(req, "failed_unservable")
                    continue
                able = [drafted]
            ready = [r for r in able
                     if self._healthy(r)
                     and r.engine.free_pages
                     >= r.engine.blocks_needed(len(req.prompt), req.max_new)]
            if not ready:
                self.stats["held"] += 1
                self._hold_head(req, able)
                if self._hol_held == 0:
                    continue           # preemption made room: retry now
                return
            self._hol_req, self._hol_held = None, 0
            # near-tie break toward prefix affinity: replicas within
            # tie_eps of the best ECT are effectively interchangeable on
            # load, so prefer the one already holding (or about to admit)
            # the request's shared prefix pages; exact ties fall back to
            # the lowest replica id — fully deterministic
            ects = {r.replica_id: self._ect(r, req) for r in ready}
            floor = min(ects.values())
            band = [r for r in ready
                    if ects[r.replica_id] <= floor * (1.0 + self.tie_eps)]
            best = min(band, key=lambda r: (-self._affinity(r, req),
                                            ects[r.replica_id],
                                            r.replica_id))
            self.queue.pop(0)
            best.engine.submit(req)
            self.placements.setdefault(req.req_id, []).append(best.replica_id)
            self.stats["placed"] += 1

    def _hold_head(self, req: Request, able: List[Replica]) -> None:
        """The queue head fits nowhere right now.  Track how long THIS
        head has been held; past ``hol_patience`` consecutive held
        ticks, satisfy its worst-case reservation by preempting the
        newest admitted request(s) on its best healthy replica —
        fragmented pools full of long-running work must not livelock
        the whole queue.  Victims are requeued-from-prompt BEHIND the
        head (their submission order is demoted — preemption
        deliberately reorders in the head's favor) and pay no retry
        budget.  Resets ``_hol_held`` to 0 when preemption made room.

        Anti-thrash: a head that was itself a preemption victim never
        triggers another preemption (it waits for natural drain) — two
        requests too big to coexist would otherwise evict each other
        forever, each eviction resetting the other's decode progress."""
        if self._hol_req != req.req_id:
            self._hol_req, self._hol_held = req.req_id, 0
        self._hol_held += 1
        if self._hol_held <= self.hol_patience:
            return
        if req.req_id in self._preempted_ids:
            return
        cands = [r for r in able if self._healthy(r)]
        if not cands:
            return                      # held on health, not pages: wait
        ects = {r.replica_id: self._ect(r, req) for r in cands}
        best = min(cands, key=lambda r: (ects[r.replica_id], r.replica_id))
        need = best.engine.blocks_needed(len(req.prompt), req.max_new)
        victims: List[Request] = []
        while best.engine.free_pages < need:
            v = best.engine.preempt_newest()
            if v is None:
                break
            victims.append(v)
        if not victims:
            return
        self.stats["preempted"] += len(victims)
        for v in victims:
            # demote behind the head: preemption exists to serve the
            # head, so the victim must not outrank it on requeue
            self._preempted_ids.add(v.req_id)
            self._submit_order[v.req_id] = self._order_seq
            self._order_seq += 1
        self._requeue(victims, count_retry=False)
        if best.engine.free_pages >= need:
            self._hol_held = 0          # room made: dispatch the head now

    # -- failure handling -------------------------------------------------

    def _fail(self, req: Request, outcome: str) -> None:
        """Terminally fail one request with a structured outcome."""
        assert outcome in OUTCOMES and outcome != "ok"
        req.outcome = outcome
        self.failed.append(req)
        self._finished_at[req.req_id] = self.tick_count
        self._snapshots.pop(req.req_id, None)
        self.stats[outcome] += 1

    def _requeue(self, reqs: List[Request], *,
                 count_retry: bool = True) -> None:
        """Put drained/preempted requests back at the front of the shared
        queue in GLOBAL submission order.  Fault-caused requeues
        (``count_retry=True``) cost each victim one retry; a victim past
        its ``max_retries`` budget fails terminally instead of riding
        the fleet forever.  Requests admitted directly via
        ``engine.submit()`` (bypassing the router) join the order book
        here, in arrival-at-drain order."""
        kept: List[Request] = []
        for req in reqs:
            self._note_order(req)
            self._submitted_at.setdefault(req.req_id, self.tick_count)
            if count_retry:
                req.retries += 1
                if req.retries > req.max_retries:
                    self._fail(req, "failed_retries")
                    continue
            kept.append(req)
        self.queue[:0] = kept
        # restore GLOBAL submission order: with several replicas dying in
        # one heartbeat round (or across rounds before redispatch), the
        # per-replica prepends alone would interleave newer requests
        # ahead of older ones
        self.queue.sort(key=lambda r: self._submit_order[r.req_id])
        self.stats["requeued"] += len(kept)

    def _harvest(self, rep: Replica) -> None:
        for req in rep.engine.finished[rep._harvested:]:
            req.outcome = "ok"
            self.finished.append(req)
            self._finished_at[req.req_id] = self.tick_count
            self._snapshots.pop(req.req_id, None)
            rep.served.append(req.req_id)
            self.stats["completed"] += 1
        rep._harvested = len(rep.engine.finished)

    def _on_death(self, node_id: int) -> None:
        rep = self._by_node.get(node_id)
        if rep is None or not rep.alive:
            return
        self._harvest(rep)                 # finished outputs survive
        rep.alive = False
        # the corpse carries no degraded state
        rep.partition_start = -1
        rep.straggle_factor, rep.straggle_until = 1.0, 0
        rep.busy_ticks = 0
        rep.corrupt_until = 0
        self._registry_view.pop(rep.replica_id, None)
        victims = rep.engine.drain_requests()
        for req in victims:
            # the pages died with the replica, but the router's periodic
            # snapshot survives: restore tokens-so-far so the victim
            # re-prefills prompt + snapshot in one extended admission and
            # re-decodes only what came after the last snapshot
            snap = self._snapshots.get(req.req_id)
            if snap:
                req.resume_tokens = list(snap[1])
                if req.prefix_digests is None:
                    req.prefix_digests = list(snap[0])
                self.stats["snapshot_restores"] += 1
        self._requeue(victims)
        self.stats["failures"] += 1
        sub = self.broker.draft_backup(node_id)
        if sub is not None:
            drafted = self._standby.pop(sub.node_id)
            drafted.alive = True
            self.replicas.append(drafted)
            self.stats["replacements"] += 1

    def heartbeat_round(self) -> List[int]:
        """One broker ping-pong round over ALL registered nodes —
        replicas and standbys alike fail with (1 - reliability), seeded.
        A replica failure mid-decode kills it, requeues its in-flight
        requests from their prompts, and drafts a speed-matched standby;
        a standby failure just removes it from the draft pool (a dead
        standby must never be drafted).  Each surviving reachable
        replica's content-registry digest set is gossiped fleet-wide,
        piggybacked on the same round — placement affinity and the
        migrate-dedup byte estimate read this (possibly stale) view, not
        the live engines.  Returns dead node ids."""
        dead = self.broker.heartbeat_round()
        for nid in dead:
            if nid in self._standby:
                self._standby.pop(nid)
                self.stats["standby_deaths"] += 1
            else:
                self._on_death(nid)
        for rep in self.replicas:
            if self._reachable(rep):
                self._registry_view[rep.replica_id] = \
                    rep.engine.registry_digests()
        return dead

    def fail_replica(self, replica_id: int) -> None:
        """Deterministic failure injection (tests/examples): kill one
        replica through the same broker quit -> drain -> requeue ->
        draft path the heartbeat uses.  Killing an already-dead replica
        is a no-op (like ``_on_death``); an id the fleet has never
        activated raises a descriptive ``ValueError``."""
        rep = next((r for r in self.replicas if r.replica_id == replica_id),
                   None)
        if rep is None:
            known = sorted(r.replica_id for r in self.replicas)
            waiting = sorted(r.replica_id for r in self._standby.values())
            raise ValueError(
                f"FleetRouter.fail_replica: unknown replica id "
                f"{replica_id!r} (active/dead replicas: {known}; "
                f"undrafted standbys: {waiting})")
        if not rep.alive:
            return
        self.broker.quit(rep.node.node_id, graceful=False)
        self._on_death(rep.node.node_id)

    # -- fault plane ------------------------------------------------------

    def _kill(self, rep: Replica) -> None:
        self.broker.quit(rep.node.node_id, graceful=False)
        self._on_death(rep.node.node_id)

    def _fault_tick(self) -> None:
        """Expire elapsed fault episodes, then apply this tick's faults
        from the plan.  Runs at the START of every tick so a healed
        partition can receive dispatch the same tick it heals."""
        t = self.tick_count
        for rep in self.replicas:
            if not rep.alive:
                continue
            if rep.partition_start >= 0:
                if t - rep.partition_start >= self.partition_timeout:
                    # the fleet cannot tell a long partition from a
                    # death: escalate through the crash path
                    self.stats["partition_escalations"] += 1
                    self._kill(rep)
                    continue
                if t >= rep.partitioned_until:
                    rep.partition_start = -1
                    self.stats["partition_heals"] += 1
            if rep.straggle_until and t >= rep.straggle_until:
                rep.straggle_factor, rep.straggle_until = 1.0, 0
            if rep.pressure_until and t >= rep.pressure_until:
                rep.engine.set_pool_pressure(0)
                rep.pressure_until = 0
        if self.fault_plan is None:
            return
        for f in self.fault_plan.at(t):
            rep = next((r for r in self.replicas
                        if r.replica_id == f.replica_id and r.alive), None)
            if rep is None:
                continue               # dead, or an undrafted standby
            if f.kind == "crash":
                self.stats["injected_crashes"] += 1
                self._kill(rep)
            elif f.kind == "straggle":
                rep.straggle_factor = max(rep.straggle_factor, f.factor)
                rep.straggle_until = max(rep.straggle_until, t + f.duration)
                self.stats["straggles"] += 1
            elif f.kind == "partition":
                if rep.partition_start < 0:
                    rep.partition_start = t
                rep.partitioned_until = max(rep.partitioned_until,
                                            t + f.duration)
                self.stats["partitions"] += 1
            elif f.kind == "pool_pressure":
                rep.engine.set_pool_pressure(f.pages)
                rep.pressure_until = max(rep.pressure_until, t + f.duration)
                self.stats["pool_pressure"] += 1
            elif f.kind == "corrupt":
                # every migration payload EXPORTED from this replica
                # during the episode arrives byte-flipped; the importer's
                # checksum chain must reject it (see _evacuate)
                rep.corrupt_until = max(rep.corrupt_until, t + f.duration)
                self.stats["corrupt_faults"] += 1

    def _soft_drain(self, rep: Replica) -> None:
        """The replica's observed tick latency crossed ``drain_factor``:
        move its in-flight work to healthier replicas instead of letting
        it crawl — migrating verified decode state where a compatible
        destination exists (zero re-decoded tokens), requeueing
        digest-preserving from the prompt otherwise.  Once per degraded
        episode — the flag rearms when the EWMA recovers below the
        threshold."""
        if rep.soft_drained:
            return
        rep.soft_drained = True
        self.stats["soft_drains"] += 1
        self._evacuate(rep)

    # -- stateful failover (verified KV migration + snapshots) -----------

    def _migration_dest(self, src: Replica, req: Request,
                        state: RequestState) -> Optional[Replica]:
        """Pick where a migrating request should land: healthy peers
        whose engine is migration-compatible (same weights object, same
        architecture and page geometry — ``migration_fingerprint``),
        with a free slot and enough free pages for the request's
        worst-case reservation; min-ECT among them (replica id breaks
        ties).  Under ``migration="auto"`` the winner must also beat
        re-prefill on the bytes-over-bandwidth cost model, else None."""
        cands = []
        for r in self.live_replicas():
            if r is src or not self._healthy(r):
                continue
            eng = r.engine
            if (not eng.paged
                    or eng.migration_fingerprint() != state.fingerprint
                    or not eng.can_serve(req.prompt, req.max_new)
                    or eng.n_active >= eng.slots
                    or eng.free_pages < eng.blocks_needed(len(req.prompt),
                                                          req.max_new)):
                continue
            cands.append(r)
        if not cands:
            return None
        best = min(cands, key=lambda r: (self._ect(r, req), r.replica_id))
        if (self.migration == "always"
                or self._migrate_cheaper(src, best, req, state)):
            return best
        return None

    def _migrate_cheaper(self, src: Replica, dst: Replica, req: Request,
                         state: RequestState) -> bool:
        """The migrate-vs-reprefill decision, in seconds.  Migrating
        ships the payload bytes — minus full prefix pages the
        destination's gossiped registry view says are already resident
        (the importer dedups them, so they never cross the wire) — over
        the source->destination path (latencies add, the slower link's
        inverse bandwidth binds).  Re-prefilling re-runs prompt plus
        every already-decoded token at the destination's analytic speed,
        plus ``dispatch_s`` per jitted call (chunked-prefill calls and
        one decode step per re-decoded token).  Ties migrate: equal wall
        clock with no token recompute is strictly less wasted work."""
        view = self._registry_view.get(dst.replica_id, frozenset())
        resident = sum(1 for d in state.digests if d in view)
        payload = state.payload_bytes - resident * src.engine.page_bytes
        link = LinkSpec(alpha=src.node.link.alpha + dst.node.link.alpha,
                        beta=max(src.node.link.beta, dst.node.link.beta))
        migrate_s = link.time(max(0.0, float(payload)))
        redecode = len(req.generated) + 1          # pending token rides too
        tokens = len(req.prompt) + redecode
        reprefill_s = (tokens * dst.flops_per_token / dst.node.speed
                       + (dst.engine.prefill_calls_for(req.prompt) + redecode)
                       * self.dispatch_s)
        return migrate_s <= reprefill_s

    def _reset_to_prompt(self, req: Request) -> None:
        """A migration fell through after export: mirror what
        ``drain_requests`` does to a victim so the requeue path sees the
        usual re-prefill-from-prompt shape (export already stamped the
        prefix-digest trail)."""
        req.generated = []
        req.pending = -1
        req.done = False

    def _evacuate(self, rep: Replica, *,
                  count_retry: bool = True) -> None:
        """Empty ``rep`` of in-flight work.  Each admitted request is
        exported and imported mid-decode into the best compatible peer —
        a migrated request keeps every decoded token and pays no retry.
        Everything else (no destination, cost model says re-prefill,
        verification rejected the payload, the engine queue) falls back
        to the requeue-from-prompt path, so nothing is ever dropped.  A
        ``corrupt``-faulted source flips a byte in every payload it
        exports; the importer must reject those."""
        fallbacks: List[Request] = []
        if (self.migration != "never" and rep.engine.paged
                and any(r is not rep and self._healthy(r)
                        for r in self.live_replicas())):
            for req in rep.engine.admitted_requests():
                state = rep.engine.export_state(req)
                if state is None:
                    continue            # still queued: drain handles it
                if self.tick_count < rep.corrupt_until:
                    _flip_payload(state)
                dst = self._migration_dest(rep, req, state)
                if dst is not None and dst.engine.import_state(state):
                    self._note_order(req)
                    self._submitted_at.setdefault(req.req_id,
                                                  self.tick_count)
                    self.placements.setdefault(req.req_id, []).append(
                        dst.replica_id)
                    self.stats["migrations"] += 1
                    continue
                self.stats["migration_fallbacks"] += 1
                self._reset_to_prompt(req)
                fallbacks.append(req)
        victims = rep.engine.drain_requests() + fallbacks
        if victims:
            self._requeue(victims, count_retry=count_retry)

    def _rebalance(self) -> None:
        """Load-triggered migration: when the most-loaded healthy
        replica's pending-token backlog exceeds ``rebalance_factor``x
        the least-loaded peer's, its newest-admitted request (the one
        with the most decode work still ahead) migrates off.  If the
        cost model votes against moving — or the transfer is rejected —
        the state is re-imported in place (a no-op rebalance, never a
        lost token); only a doubly-failed import falls back to
        requeue-from-prompt, paying no retry budget."""
        live = [r for r in self.live_replicas()
                if self._healthy(r) and r.engine.paged]
        if len(live) < 2:
            return
        hi = max(live, key=lambda r: (r.engine.pending_tokens,
                                      -r.replica_id))
        lo = min(live, key=lambda r: (r.engine.pending_tokens,
                                      r.replica_id))
        if (hi is lo or hi.engine.n_active == 0
                or hi.engine.pending_tokens
                <= self.rebalance_factor * max(1, lo.engine.pending_tokens)):
            return
        req = hi.engine.admitted_requests()[-1]
        fp = hi.engine.migration_fingerprint()
        if not any(r is not hi
                   and r.engine.migration_fingerprint() == fp
                   and r.engine.n_active < r.engine.slots
                   for r in live):
            return                      # nowhere compatible: stay put
        state = hi.engine.export_state(req)
        if state is None:
            return
        if self.tick_count < hi.corrupt_until:
            _flip_payload(state)
        dst = self._migration_dest(hi, req, state)
        if dst is not None:
            if dst.engine.import_state(state):
                self._note_order(req)
                self._submitted_at.setdefault(req.req_id, self.tick_count)
                self.placements.setdefault(req.req_id, []).append(
                    dst.replica_id)
                self.stats["migrations"] += 1
                self.stats["rebalances"] += 1
                return
            # the destination rejected the payload (corrupt flip): the
            # bytes are suspect, so don't re-import them locally either
            self.stats["migration_fallbacks"] += 1
            self._reset_to_prompt(req)
            self._requeue([req], count_retry=False)
            return
        if hi.engine.import_state(state):
            # moving lost the cost check: re-imported in place (counted
            # separately so imported == migrations + rebalance_holds)
            self.stats["rebalance_holds"] += 1
            return
        self.stats["migration_fallbacks"] += 1
        self._reset_to_prompt(req)
        self._requeue([req], count_retry=False)

    def _snapshot_fleet(self) -> None:
        """Record every reachable admitted request's (prefix digests,
        generated tokens) — the crash path's restore point.  Snapshots
        live at the ROUTER: they must survive the replica whose pages
        they describe."""
        for rep in self.replicas:
            if not self._reachable(rep):
                continue
            for req in rep.engine.admitted_requests():
                if req.generated:
                    self._snapshots[req.req_id] = (
                        tuple(rep.engine.prefix_digests(req.prompt)),
                        list(req.generated))

    # -- the serving loop -------------------------------------------------

    def tick(self) -> int:
        """One fleet iteration: apply/expire faults, dispatch the shared
        queue, tick every reachable replica (a straggler's engine tick
        spans ``straggle_factor`` fleet ticks; a partitioned replica's
        engine is frozen), harvest finished requests, update tick-latency
        EWMAs and soft-drain degraded replicas.  Returns the number of
        active slots across the fleet (in-flight work on partitioned or
        mid-tick replicas still counts — it is not lost)."""
        self._fault_tick()
        if (self.rebalance_every and self.migration != "never"
                and self.tick_count > 0
                and self.tick_count % self.rebalance_every == 0):
            self._rebalance()
        self._dispatch()
        n = 0
        for rep in self.replicas:
            if not rep.alive:
                continue
            if rep.partition_start >= 0:
                n += rep.engine.n_active      # frozen, not lost
                continue
            if rep.busy_ticks > 0:
                rep.busy_ticks -= 1
                n += rep.engine.n_active      # straggling mid-tick
                continue
            cost = (rep.straggle_factor
                    if self.tick_count < rep.straggle_until else 1.0)
            n += rep.engine.tick()
            self._harvest(rep)
            rep.busy_ticks = max(0, int(round(cost)) - 1)
            rep.lat_ewma += self.ewma_alpha * (cost - rep.lat_ewma)
            if rep.lat_ewma >= self.drain_factor:
                self._soft_drain(rep)
            else:
                rep.soft_drained = False
        if (self.snapshot_every
                and self.tick_count % self.snapshot_every == 0):
            self._snapshot_fleet()
        self.tick_count += 1
        return n

    def outstanding(self) -> int:
        """Requests submitted but not yet terminal (shared queue +
        every live replica's queue and slots — including partitioned
        replicas, whose in-flight work is retained)."""
        n = len(self.queue)
        for rep in self.live_replicas():
            n += len(rep.engine.queue) + rep.engine.n_active
        return n

    def _drain_outstanding(self) -> List[Request]:
        """Pull every non-terminal request out of the system (shared
        queue + live replicas), in global submission order."""
        reqs = list(self.queue)
        self.queue = []
        for rep in self.live_replicas():
            reqs.extend(rep.engine.drain_requests())
        for req in reqs:
            self._note_order(req)
        reqs.sort(key=lambda r: self._submit_order[r.req_id])
        return reqs

    def run(self, max_ticks: int = 10_000, heartbeat_every: int = 0,
            *, strict: bool = False) -> FleetResult:
        """Serve until every submitted request reached a TERMINAL
        outcome (or ``max_ticks``).  ``heartbeat_every`` > 0 runs a
        broker heartbeat round every that-many ticks, so seeded failures
        strike mid-decode.  Returns a ``FleetResult`` — completed plus
        terminally failed requests with per-request traces; partial
        results survive fleet death and deadline instead of being raised
        away.  ``strict=True`` restores the old contract: raise if
        anything failed (completed work is still on ``self.finished``)."""
        start = self.tick_count
        for t in range(max_ticks):
            if heartbeat_every and t > 0 and t % heartbeat_every == 0:
                self.heartbeat_round()
            self.tick()
            if not self.outstanding():
                break
        if self.outstanding():
            # max_ticks exhausted with work still in flight: every
            # leftover gets a terminal outcome — nothing silently drops
            outcome = ("deadline_exceeded" if self.live_replicas()
                       else "failed_unservable")
            for req in self._drain_outstanding():
                self._fail(req, outcome)
        traces = {req.req_id: self._trace(req)
                  for req in self.finished + self.failed}
        result = FleetResult(completed=list(self.finished),
                             failed=list(self.failed), traces=traces,
                             ticks=self.tick_count - start)
        if strict and self.failed:
            raise RuntimeError(
                f"FleetRouter: {len(self.failed)} requests failed "
                f"terminally ({result.outcomes()}) after "
                f"{result.ticks} ticks — strict mode refuses partial "
                f"results")
        return result

    def _trace(self, req: Request) -> dict:
        sub = self._submitted_at.get(req.req_id)
        fin = self._finished_at.get(req.req_id)
        return {
            "placements": list(self.placements.get(req.req_id, [])),
            "retries": req.retries,
            "outcome": req.outcome,
            "submitted_tick": sub,
            "finished_tick": fin,
            "latency_ticks": (fin - sub
                              if sub is not None and fin is not None
                              else None),
            "generated": len(req.generated),
        }
