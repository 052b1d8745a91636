"""Deterministic fault-injection plane for the serving fleet.

The paper's failure model — and the broker's seeded heartbeat — is
binary: a node is either healthy or dead, and recovery is a full
re-prefill on a survivor.  Real decentralized fleets mostly fail
*partially*: stragglers (thermal throttling, a contended uplink),
transient network partitions, memory pressure from a co-tenant.  This
module gives the ``FleetRouter`` a reproducible source of exactly those
faults, so every degraded-mode behavior can be asserted in tests and
benches instead of sampled from ``CompNode.reliability``.

A ``FaultPlan`` is a schedule of typed ``Fault`` records keyed by fleet
tick.  The router consumes ``plan.at(tick)`` at the START of each tick
and applies each fault to the (live) target replica:

``crash``
    The existing death path: broker quit, drain, requeue-from-prompt,
    speed-matched standby draft.  KV state is LOST.

``straggle(factor, duration)``
    The replica's engine ticks cost ``factor``x fleet clock for
    ``duration`` fleet ticks: it executes one engine tick then sits busy
    for the remainder, and its tick-latency EWMA (which scales its ECT)
    rises toward ``factor``.  Past the router's ``drain_factor`` the
    replica is soft-drained.  KV state is KEPT (victims of a soft drain
    re-prefill elsewhere, but the replica itself never loses state).

``partition(duration)``
    The replica is unreachable for ``duration`` ticks: no dispatch, no
    engine ticks, no harvest — but engine state is RETAINED.  On heal,
    in-flight work resumes mid-decode without re-prefill.  A partition
    outlasting the router's ``partition_timeout`` escalates to ``crash``
    (the fleet cannot tell a long partition from a death).

``pool_pressure(pages, duration)``
    ``pages`` paged-pool pages are withheld from NEW admissions for
    ``duration`` ticks (a co-tenant grabbed memory).  Reservation-backed
    decode of already-admitted requests is untouched — pressure can only
    backpressure the queue, never crash an in-flight request.  Engines
    holding refcount-zero registered pages (the LRU prefix hold) give
    those up first.

``corrupt(duration)``
    Every migration payload EXPORTED from the replica during the episode
    arrives with flipped bytes (a flaky uplink / bad DIMM on the wire
    path).  The importer's checksum-chain verification must reject the
    transfer — wrong content is never served — and the router falls back
    to requeue-from-prompt, exactly as if migration had never been
    attempted.  A replica that exports nothing is unaffected.

Plans are either hand-built (``FaultPlan([...])`` / ``plan.add``) for
targeted tests or drawn from a seeded RNG (``FaultPlan.seeded``) for
property tests and the chaos bench.  Equal seeds produce equal plans.

A copy of ``repro.serve.faults`` (numpy only): the port imports nothing
from the JAX package, so it keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "straggle", "partition", "pool_pressure", "corrupt")


@dataclass(frozen=True)
class Fault:
    """One typed fault striking ``replica_id`` at fleet tick ``tick``.

    ``factor`` is the straggle tick-cost multiplier; ``duration`` the
    episode length in fleet ticks (straggle / partition / pool_pressure
    / corrupt); ``pages`` the pool pages withheld (pool_pressure).
    Fields irrelevant to a kind are ignored."""
    tick: int
    replica_id: int
    kind: str
    factor: float = 4.0
    duration: int = 4
    pages: int = 2

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"Fault: unknown kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.tick < 0:
            raise ValueError(f"Fault: tick must be >= 0, got {self.tick}")
        if self.kind == "straggle" and self.factor < 1.0:
            raise ValueError(f"Fault: straggle factor must be >= 1.0, "
                             f"got {self.factor}")
        if self.kind != "crash" and self.duration < 1:
            raise ValueError(f"Fault: duration must be >= 1 tick, "
                             f"got {self.duration}")
        if self.kind == "pool_pressure" and self.pages < 1:
            raise ValueError(f"Fault: pool_pressure must withhold >= 1 "
                             f"page, got {self.pages}")


class FaultPlan:
    """An immutable-once-running schedule of faults, keyed by fleet tick.

    ``at(tick)`` returns the faults striking at that tick (insertion
    order — deterministic).  Multiple faults may share a tick, including
    several on one replica."""

    def __init__(self, faults: Iterable[Fault] = ()):
        self._by_tick: Dict[int, List[Fault]] = {}
        self._n = 0
        for f in faults:
            self.add(f)

    def add(self, fault: Fault) -> "FaultPlan":
        if not isinstance(fault, Fault):
            raise TypeError(f"FaultPlan.add: expected a Fault, "
                            f"got {type(fault).__name__}")
        self._by_tick.setdefault(fault.tick, []).append(fault)
        self._n += 1
        return self

    def at(self, tick: int) -> List[Fault]:
        # a COPY: handing out the internal per-tick list would let a
        # caller mutate the immutable-once-running schedule in place
        return list(self._by_tick.get(tick, ()))

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Fault]:
        for t in sorted(self._by_tick):
            yield from self._by_tick[t]

    def __repr__(self) -> str:
        kinds: Dict[str, int] = {}
        for f in self:
            kinds[f.kind] = kinds.get(f.kind, 0) + 1
        return f"FaultPlan({self._n} faults: {kinds})"

    @classmethod
    def seeded(cls, seed: int, *, ticks: int,
               replica_ids: Sequence[int],
               rate: float = 0.08,
               kinds: Tuple[str, ...] = FAULT_KINDS,
               max_factor: float = 4.0,
               max_duration: int = 6,
               max_pages: int = 4) -> "FaultPlan":
        """Draw a random plan: each (tick, replica) pair independently
        suffers a fault with probability ``rate``; kind uniform over
        ``kinds``, straggle factor uniform in [2, max_factor], durations
        and withheld pages uniform integers.  Same seed, same plan."""
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"FaultPlan.seeded: unknown kind {k!r}")
        rng = np.random.RandomState(seed)
        plan = cls()
        for t in range(ticks):
            for rid in replica_ids:
                if rng.random_sample() >= rate:
                    continue
                kind = kinds[rng.randint(len(kinds))]
                plan.add(Fault(
                    tick=t, replica_id=rid, kind=kind,
                    factor=float(2.0 + rng.random_sample()
                                 * max(0.0, max_factor - 2.0)),
                    duration=int(rng.randint(1, max_duration + 1)),
                    pages=int(rng.randint(1, max_pages + 1))))
        return plan
