"""Broker (paper §3.2): bridges job submitters and compnodes.

* registry with unique IDs and basic hardware info;
* periodic ping-pong heartbeats to detect offline nodes;
* a **backup pool**: a fraction of registered providers held in reserve;
* on failure of a node with unfinished tasks, a replacement is drafted
  from the backup pool (closest speed first) and the task remapped;
* job intake: DAG -> decomposer -> scheduler -> task table.

The collaboration dynamics (joins/quits) run as a deterministic
event-driven simulation (seeded numpy RNG), which is how the paper's own
evaluation treats peer variability.

A copy of ``repro.core.broker``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import DAG
from repro_torch.core.decomposer import decompose_contiguous
from repro_torch.core.dht import DHT
from repro_torch.core.perfmodel import CompNode, PerfModel
from repro_torch.core.scheduler import Schedule, Task, schedule_loadbalance, \
    tasks_from_parts


@dataclass
class Event:
    t: float
    kind: str                  # join | quit | fail | replace | reschedule
    node_id: int
    detail: str = ""


class Broker:
    def __init__(self, *, backup_fraction: float = 0.2, seed: int = 0,
                 heartbeat_s: float = 10.0):
        self.active: Dict[int, CompNode] = {}
        self.backup: Dict[int, CompNode] = {}
        # node_id -> FLOP/s, recorded at registration and kept after the
        # node dies: replacement drafting matches the DEAD node's speed,
        # and by then the node object is already popped from the pools.
        self.speeds: Dict[int, float] = {}
        self.backup_fraction = backup_fraction
        self.heartbeat_s = heartbeat_s
        self.rng = np.random.RandomState(seed)
        # separate seeded stream for backup-pool pings: active-failure
        # outcomes for a given seed stay independent of how many
        # standbys are registered (and identical to a broker that never
        # pinged backups at all)
        self._backup_rng = np.random.RandomState((seed ^ 0x9E3779B9)
                                                 & 0xFFFFFFFF)
        self.events: List[Event] = []
        self.tasks: Dict[int, Task] = {}
        self.schedule: Optional[Schedule] = None
        self.dag: Optional[DAG] = None
        self.dht: DHT = DHT([])
        self._next_id = 0
        self._t = 0.0

    # ------------------------------------------------------------------
    # membership (P1: autonomous join/quit)
    # ------------------------------------------------------------------
    def register(self, node: CompNode, pool: str = "auto") -> int:
        """Register a provider.  ``pool`` is ``"auto"`` (keep roughly
        ``backup_fraction`` of the fleet in reserve), or an explicit
        ``"active"`` / ``"backup"`` for callers that manage their own
        replica/standby split (e.g. the serving ``FleetRouter``)."""
        if pool not in ("auto", "active", "backup"):
            raise ValueError(f"Broker.register: unknown pool {pool!r} "
                             f"(expected 'auto', 'active' or 'backup')")
        if node.node_id in self.active or node.node_id in self.backup:
            raise ValueError(
                f"Broker.register: node object already registered as "
                f"{node.node_id} — each provider needs its own CompNode")
        node.node_id = self._next_id
        self._next_id += 1
        self.speeds[node.node_id] = node.speed
        n_active = len(self.active)
        n_backup = len(self.backup)
        if pool == "backup" or (
                pool == "auto" and n_active > 0
                and n_backup < self.backup_fraction * (n_active + n_backup + 1)):
            self.backup[node.node_id] = node
            kind = "backup"
        else:
            self.active[node.node_id] = node
            self.dht.join(node.node_id)
            kind = "active"
        self.events.append(Event(self._t, "join", node.node_id, kind))
        return node.node_id

    def quit(self, node_id: int, graceful: bool = True) -> None:
        node = self.active.pop(node_id, None) or self.backup.pop(node_id, None)
        if node is None:
            return
        node.online = False
        self.dht.leave(node_id)
        if self.schedule is not None:
            # a corpse must not count toward makespan
            self.schedule.loads.pop(node_id, None)
        self.events.append(Event(self._t, "quit", node_id,
                                 "graceful" if graceful else "failure"))
        if self._unfinished_on(node_id):
            self._replace(node_id)

    # ------------------------------------------------------------------
    # job intake (decompose + schedule, §3.2 / §3.8)
    # ------------------------------------------------------------------
    def submit_job(self, dag: DAG, *, n_parts: Optional[int] = None) -> Schedule:
        self.dag = dag
        nodes = list(self.active.values())
        assert nodes, "no active compnodes"
        k = n_parts or len(nodes)
        speeds = [n.speed for n in sorted(nodes, key=lambda n: -n.speed)][:k]
        parts = decompose_contiguous(dag, k, speeds=speeds)
        tasks = tasks_from_parts(dag, parts)
        self.tasks = {t.task_id: t for t in tasks}
        self.schedule = schedule_loadbalance(tasks, nodes)
        self._done: Dict[int, bool] = {t.task_id: False for t in tasks}
        return self.schedule

    def mark_done(self, task_id: int) -> None:
        self._done[task_id] = True

    def _unfinished_on(self, node_id: int) -> List[int]:
        if not self.schedule:
            return []
        return [tid for tid, nid in self.schedule.assignment.items()
                if nid == node_id and not self._done.get(tid, False)]

    # ------------------------------------------------------------------
    # fault tolerance: heartbeat + backup-pool replacement
    # ------------------------------------------------------------------
    def activate_backup(self, node_id: int, detail: str = "") -> Optional[CompNode]:
        """Move one SPECIFIC backup into the active pool (drafted by a
        caller that chose it for its own reason, e.g. the serving router
        activating the only standby whose model can run a request)."""
        sub = self.backup.pop(node_id, None)
        if sub is None:
            return None
        self.active[sub.node_id] = sub
        self.dht.join(sub.node_id)
        self.events.append(Event(self._t, "replace", sub.node_id,
                                 detail or "drafted"))
        self.dht.rebalance()
        return sub

    def draft_backup(self, dead_id: int) -> Optional[CompNode]:
        """Draft the backup whose SPEED (FLOP/s) best matches the dead
        node's recorded speed — the drafted peer inherits the dead one's
        role, so matching on throughput keeps the schedule balanced.
        (The dead node is already popped from the pools; ``self.speeds``
        keeps its registration-time speed.)  Returns the activated node,
        or None when the backup pool is empty."""
        if not self.backup:
            return None
        dead_speed = self.speeds.get(dead_id, 1.0)
        sub_id = min(self.backup,
                     key=lambda nid: abs(self.backup[nid].speed - dead_speed))
        return self.activate_backup(sub_id, f"for {dead_id}")

    def _replace(self, dead_id: int) -> Optional[int]:
        pending = self._unfinished_on(dead_id)
        if not pending:
            return None
        sub = self.draft_backup(dead_id)
        if sub is not None:
            self.events[-1].detail += f" tasks={pending}"
            for tid in pending:
                self.schedule.assignment[tid] = sub.node_id
            self.schedule.loads[sub.node_id] = (
                self.schedule.loads.get(sub.node_id, 0.0)
                + sum(self.tasks[tid].flops / sub.speed for tid in pending))
            return sub.node_id
        # no backups left: reschedule pending tasks over surviving actives,
        # seeded with their CURRENT loads and memory footprints so the
        # rebalance sees real commitments (time and bytes), and merge the
        # result back so makespan stays truthful
        self.events.append(Event(self._t, "reschedule", dead_id,
                                 f"tasks={pending} (backup pool empty)"))
        remaining = [self.tasks[tid] for tid in pending]
        survivors = list(self.active.values())
        if not survivors:
            return None
        moving = set(pending)
        init_used = {nid: [0.0, 0.0, 0.0] for nid in self.active}
        for tid, nid in self.schedule.assignment.items():
            if nid in init_used and tid not in moving:
                t = self.tasks[tid]
                init_used[nid][0] += t.gpu_bytes
                init_used[nid][1] += t.cpu_bytes
                init_used[nid][2] += t.disk_bytes
        sched = schedule_loadbalance(remaining, survivors,
                                     init_loads=self.schedule.loads,
                                     init_used=init_used)
        for tid, nid in sched.assignment.items():
            self.schedule.assignment[tid] = nid
        self.schedule.loads.update(sched.loads)
        return None

    def heartbeat_round(self) -> List[int]:
        """Ping-pong every registered node — actives AND backups — each
        failing with (1 - reliability) per round.  Standbys are not
        immortal: a dead backup is dropped from the pool so it can never
        be drafted as a replacement.  Backups draw from their own seeded
        stream, so active-failure outcomes for a given seed are stable
        regardless of backup-pool size.  Returns the list of nodes
        detected offline (actives first)."""
        self._t += self.heartbeat_s
        dead = []
        for nid, node in list(self.active.items()):
            if self.rng.random_sample() > node.reliability:
                dead.append(nid)
        for nid, node in list(self.backup.items()):
            if self._backup_rng.random_sample() > node.reliability:
                dead.append(nid)
        for nid in dead:
            self.quit(nid, graceful=False)
        return dead

    def run_sim(self, rounds: int) -> dict:
        """Run heartbeat rounds until tasks complete or fleet dies.
        Task completion is modeled by load-proportional progress."""
        failures = 0
        for _ in range(rounds):
            failures += len(self.heartbeat_round())
            if not self.active:
                break
        return {
            "rounds": rounds,
            "failures": failures,
            "replacements": sum(1 for e in self.events if e.kind == "replace"),
            "reschedules": sum(1 for e in self.events if e.kind == "reschedule"),
            "active": len(self.active),
            "backup": len(self.backup),
            "all_tasks_assigned": self.schedule is None or all(
                nid in self.active
                for tid, nid in self.schedule.assignment.items()
                if not self._done.get(tid, False)),
        }
