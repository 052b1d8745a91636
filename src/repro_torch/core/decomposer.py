"""DAG decomposer (paper §3.1, §3.5): split the full operator DAG into
sub-DAGs that fit device memory and balance load.

Pipeline execution keeps sub-DAGs *contiguous* in topological order (the
paper runs sub-DAGs sequentially, §4).  Two partitioners:

* ``decompose_contiguous`` — K balanced contiguous cuts (DP, min–max of a
  per-block weight; exact).
* ``decompose_by_memory`` — greedy packing under a per-device memory
  budget (the "limited memory" motivation of §1 challenge 1).

A copy of ``repro.core.decomposer``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import DAG, OpNode


def _block_weights(dag: DAG, weight: Optional[Callable[[OpNode], float]]
                   ) -> List[float]:
    weight = weight or (lambda n: n.flops)
    return [weight(dag[name]) for name in dag.topo_order()]


def decompose_contiguous(dag: DAG, k: int,
                         weight: Optional[Callable[[OpNode], float]] = None,
                         speeds: Optional[Sequence[float]] = None
                         ) -> List[List[str]]:
    """Partition topo order into ``k`` contiguous sub-DAGs minimizing the
    max (weight/speed) of any part — exact O(n²k) DP.

    ``speeds``: optional per-part device speeds (heterogeneous peers, in
    assignment order); defaults to uniform.
    """
    names = dag.topo_order()
    w = _block_weights(dag, weight)
    n = len(names)
    k = min(k, n)
    speeds = list(speeds) if speeds is not None else [1.0] * k
    assert len(speeds) >= k
    prefix = [0.0]
    for x in w:
        prefix.append(prefix[-1] + x)
    seg = lambda i, j: prefix[j] - prefix[i]          # weight of [i, j)

    INF = float("inf")
    # dp[p][i] = minimal max-load splitting first i blocks into p parts
    dp = [[INF] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for p in range(1, k + 1):
        sp = speeds[p - 1]
        for i in range(1, n + 1):
            # part p covers blocks [j, i)
            for j in range(p - 1, i):
                if dp[p - 1][j] == INF:
                    continue
                cand = max(dp[p - 1][j], seg(j, i) / sp)
                if cand < dp[p][i]:
                    dp[p][i] = cand
                    cut[p][i] = j
    parts: List[List[str]] = []
    i = n
    for p in range(k, 0, -1):
        j = cut[p][i]
        parts.append(names[j:i])
        i = j
    parts.reverse()
    return [p for p in parts if p]


def decompose_by_memory(dag: DAG, mem_limits: Sequence[float],
                        act_bytes: float = 0.0) -> List[List[str]]:
    """Greedy contiguous packing: walk the topo order, open a new sub-DAG
    when the next op's parameters would exceed the current device's budget
    (params + one activation buffer).  ``mem_limits`` cycles if shorter
    than needed."""
    names = dag.topo_order()
    parts: List[List[str]] = [[]]
    used = 0.0
    li = 0
    limit = mem_limits[0]
    for name in names:
        need = dag[name].param_bytes
        if parts[-1] and used + need + act_bytes > limit:
            parts.append([])
            used = 0.0
            li += 1
            limit = mem_limits[li % len(mem_limits)]
        parts[-1].append(name)
        used += need
    return parts


def assignment_of(parts: Sequence[Sequence[str]],
                  peers: Optional[Sequence[int]] = None) -> Dict[str, int]:
    """op name -> compnode id map from a partition (identity peer order by
    default)."""
    peers = list(peers) if peers is not None else list(range(len(parts)))
    return {name: peers[i] for i, part in enumerate(parts) for name in part}


def part_stats(dag: DAG, parts: Sequence[Sequence[str]]) -> List[dict]:
    out = []
    for part in parts:
        out.append({
            "n_ops": len(part),
            "flops": sum(dag[n].flops for n in part),
            "param_bytes": sum(dag[n].param_bytes for n in part),
            "out_bytes": dag[part[-1]].out_bytes if part else 0.0,
        })
    return out
