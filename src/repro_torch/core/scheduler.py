"""Task scheduling (paper §3.8, Eq. 2):

    min_A  max_p  Σ_{k ∈ A_p} T(G_{S_k})
    s.t.   per-peer GPU / CPU / disk memory constraints.

The assignment problem is NP-hard (it contains multiprocessor scheduling);
we solve it the way production schedulers do: LPT greedy over
heterogeneous speeds + local-search refinement (move / swap), both purely
deterministic.  For pipeline execution order, ``schedule_pipeline`` keeps
sub-DAGs contiguous and maps them onto the fastest feasible peers.

A copy of ``repro.core.scheduler``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import DAG
from repro_torch.core.perfmodel import CompNode, PerfModel


@dataclass
class Task:
    """One schedulable sub-DAG."""
    task_id: int
    op_names: Tuple[str, ...]
    flops: float
    gpu_bytes: float
    cpu_bytes: float = 0.0
    disk_bytes: float = 0.0
    in_bytes: float = 0.0           # activation arriving from the previous stage
    out_bytes: float = 0.0          # activation leaving this stage


def tasks_from_parts(dag: DAG, parts: Sequence[Sequence[str]],
                     act_multiplier: float = 2.0) -> List[Task]:
    """Build Task records from a contiguous partition.  ``act_multiplier``
    accounts for activations kept alive alongside params (fwd + grad)."""
    tasks = []
    for i, part in enumerate(parts):
        params = sum(dag[n].param_bytes for n in part)
        act = max((dag[n].out_bytes for n in part), default=0.0)
        first_args = [a for a in dag[part[0]].args] if part else []
        in_bytes = sum(dag[a].out_bytes for a in first_args)
        tasks.append(Task(
            task_id=i, op_names=tuple(part),
            flops=sum(dag[n].flops for n in part),
            gpu_bytes=params + act_multiplier * act,
            cpu_bytes=params,           # host copy for checkpoint/restart
            disk_bytes=params,
            in_bytes=in_bytes,
            out_bytes=dag[part[-1]].out_bytes if part else 0.0))
    return tasks


@dataclass
class Schedule:
    assignment: Dict[int, int]          # task_id -> node_id
    loads: Dict[int, float]             # node_id -> total time
    feasible: bool

    @property
    def makespan(self) -> float:
        return max(self.loads.values()) if self.loads else 0.0


def _fits(task: Task, node: CompNode, used: Dict[int, List[float]]) -> bool:
    g, c, d = used[node.node_id]
    return node.memory_ok(g + task.gpu_bytes, c + task.cpu_bytes,
                          d + task.disk_bytes)


def schedule_loadbalance(tasks: Sequence[Task], nodes: Sequence[CompNode],
                         refine_iters: int = 200,
                         init_loads: Optional[Dict[int, float]] = None,
                         init_used: Optional[Dict[int, Sequence[float]]] = None
                         ) -> Schedule:
    """Eq. 2 solver: LPT greedy + move/swap local search.

    ``init_loads`` seeds each node's starting load (node_id -> seconds of
    already-assigned work) and ``init_used`` its starting memory
    footprint (node_id -> [gpu, cpu, disk] bytes), so a reschedule after
    churn balances NEW tasks against survivors' existing commitments —
    time AND memory — instead of pretending every peer is idle.  The
    returned ``Schedule.loads`` includes the seed, so its makespan is the
    true fleet makespan."""
    nodes = [n for n in nodes if n.online]
    used = {n.node_id: list((init_used or {}).get(n.node_id, (0.0, 0.0, 0.0)))
            for n in nodes}
    loads = {n.node_id: float((init_loads or {}).get(n.node_id, 0.0))
             for n in nodes}
    byid = {n.node_id: n for n in nodes}
    assignment: Dict[int, int] = {}
    feasible = True

    def task_time(t: Task, n: CompNode) -> float:
        return t.flops / n.speed

    for t in sorted(tasks, key=lambda t: -t.flops):
        best = None
        for n in nodes:
            if not _fits(t, n, used):
                continue
            cand = loads[n.node_id] + task_time(t, n)
            if best is None or cand < best[0]:
                best = (cand, n)
        if best is None:                      # no feasible peer: overflow to
            feasible = False                  # least-loaded (report infeasible)
            best = (min(loads.values()), min(nodes, key=lambda n: loads[n.node_id]))
        n = best[1]
        assignment[t.task_id] = n.node_id
        loads[n.node_id] += task_time(t, n)
        used[n.node_id][0] += t.gpu_bytes
        used[n.node_id][1] += t.cpu_bytes
        used[n.node_id][2] += t.disk_bytes

    # ---- local search: move single tasks off the argmax peer --------------
    tmap = {t.task_id: t for t in tasks}
    for _ in range(refine_iters):
        worst = max(loads, key=loads.get)
        moved = False
        for tid, nid in sorted(assignment.items(),
                               key=lambda kv: -tmap[kv[0]].flops):
            if nid != worst:
                continue
            t = tmap[tid]
            for n in nodes:
                if n.node_id == worst or not _fits(t, n, used):
                    continue
                new_dst = loads[n.node_id] + task_time(t, n)
                new_src = loads[worst] - task_time(t, byid[worst])
                if max(new_dst, new_src) < loads[worst] - 1e-12:
                    assignment[tid] = n.node_id
                    loads[n.node_id] = new_dst
                    loads[worst] = new_src
                    for i, v in enumerate([t.gpu_bytes, t.cpu_bytes, t.disk_bytes]):
                        used[worst][i] -= v
                        used[n.node_id][i] += v
                    moved = True
                    break
            if moved:
                break
        if not moved:
            break
    return Schedule(assignment, loads, feasible)


def schedule_pipeline(tasks: Sequence[Task], nodes: Sequence[CompNode]
                      ) -> Schedule:
    """Contiguous pipeline mapping: stage i starts at the i-th peer of a
    speed-sorted peer list (stages are already balanced by the decomposer
    against these speeds) and skips forward, wrapping, to the next peer
    with enough free memory — cumulative across the stages a peer already
    holds.  Only when NO peer can fit a stage is it force-placed on its
    preferred peer and the schedule marked infeasible."""
    nodes = sorted([n for n in nodes if n.online], key=lambda n: -n.speed)
    used = {n.node_id: [0.0, 0.0, 0.0] for n in nodes}
    assignment, loads = {}, {n.node_id: 0.0 for n in nodes}
    feasible = len(nodes) >= len(tasks)
    for t in tasks:
        start = t.task_id % len(nodes)
        n = None
        for j in range(len(nodes)):
            cand = nodes[(start + j) % len(nodes)]
            if _fits(t, cand, used):
                n = cand
                break
        if n is None:
            feasible = False
            n = nodes[start]
        assignment[t.task_id] = n.node_id
        loads[n.node_id] += t.flops / n.speed
        used[n.node_id][0] += t.gpu_bytes
        used[n.node_id][1] += t.cpu_bytes
        used[n.node_id][2] += t.disk_bytes
    return Schedule(assignment, loads, feasible)
