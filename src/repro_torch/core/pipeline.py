"""Pipeline performance analysis (paper §4, Eqs. 3–4) + a discrete-event
pipeline simulator that validates the closed forms.

    T_lat(G)        = Σ_p (C_p + R_p)                         (Eq. 3)
    T_pipe(G, n_b)  = Σ_p (C_p + R_p) + (n_b − 1)·max_p max(C_p, R_p)   (Eq. 4)

C_p: compute time of peer p's sub-DAGs; R_p: receive (communication) time
of cut edges into p.  The simulator plays the GPipe-style schedule
t[p][j] = max(t[p-1][j] + r_p, t[p][j-1]) + c_p and reports the true
makespan, which the closed form approximates from above/below.

A copy of ``repro.core.pipeline``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.dag import DAG
from repro_torch.core.perfmodel import PerfModel


@dataclass
class StageTimes:
    """Per-pipeline-stage compute (C_p) and receive (R_p) seconds."""
    compute: List[float]
    receive: List[float]

    @property
    def n_stages(self) -> int:
        return len(self.compute)


def stage_times(dag: DAG, parts: Sequence[Sequence[str]],
                perf: PerfModel, peer_order: Sequence[int]) -> StageTimes:
    """Evaluate C_p and R_p for each contiguous sub-DAG on its peer."""
    assignment = {name: peer_order[i]
                  for i, part in enumerate(parts) for name in part}
    cs, rs = [], []
    for i, part in enumerate(parts):
        c, r = perf.subgraph_time(dag, part, peer_order[i], assignment)
        cs.append(c)
        rs.append(r)
    return StageTimes(cs, rs)


def latency_eq3(st: StageTimes) -> float:
    return sum(st.compute) + sum(st.receive)


def pipelined_eq4(st: StageTimes, n_batches: int) -> float:
    bottleneck = max(max(c, r) for c, r in zip(st.compute, st.receive))
    return latency_eq3(st) + (n_batches - 1) * bottleneck


def throughput_eq4(st: StageTimes, n_batches: int, batch_size: int) -> float:
    """Samples/second at steady state."""
    return n_batches * batch_size / pipelined_eq4(st, n_batches)


def simulate_pipeline(st: StageTimes, n_batches: int) -> float:
    """Discrete-event makespan of the FP pipeline.  Each stage has two
    serialized resources — its inbound link (service r_p) and its device
    (service c_p) — matching the paper's model where (n_b-1)·max(C_p,R_p)
    is the steady-state increment.  Microbatch j enters stage p's link
    once stage p-1 finished j and the link is free; compute starts when
    the transfer lands and the device is free."""
    P = st.n_stages
    prev_row = [0.0] * n_batches
    finish = 0.0
    for p in range(P):
        row = []
        link_free = 0.0
        dev_free = 0.0
        for j in range(n_batches):
            arrive = max(prev_row[j] if p else 0.0, link_free) + st.receive[p]
            link_free = arrive
            dev_free = max(arrive, dev_free) + st.compute[p]
            row.append(dev_free)
        prev_row = row
        finish = dev_free
    return finish


def bubble_fraction(st: StageTimes, n_batches: int) -> float:
    """Fraction of total device-time lost to pipeline bubbles."""
    makespan = simulate_pipeline(st, n_batches)
    busy = sum(st.compute) * n_batches
    return 1.0 - busy / (makespan * st.n_stages)


# ---------------------------------------------------------------------------
# End-to-end estimator used by the Fig. 5/6 reproduction benchmarks
# ---------------------------------------------------------------------------

def estimate_system(dag: DAG, perf: PerfModel, peer_ids: Sequence[int],
                    n_batches: int, batch_size: int,
                    weight=None) -> Dict[str, float]:
    """Partition ``dag`` across ``peer_ids`` (contiguous, speed-aware DP),
    evaluate Eq. 3/4 and the simulator, and report latency/throughput."""
    from repro_torch.core.decomposer import decompose_contiguous

    speeds = [perf.nodes[p].speed for p in peer_ids]
    parts = decompose_contiguous(dag, len(peer_ids), weight=weight,
                                 speeds=speeds)
    order = list(peer_ids)[:len(parts)]
    st = stage_times(dag, parts, perf, order)
    lat = latency_eq3(st)
    pipe = pipelined_eq4(st, n_batches)
    sim = simulate_pipeline(st, n_batches)
    return {
        "n_stages": float(len(parts)),
        "latency_s": lat,
        "pipelined_s_eq4": pipe,
        "pipelined_s_sim": sim,
        "throughput_samples_s": n_batches * batch_size / pipe,
        "throughput_samples_s_sim": n_batches * batch_size / sim,
        "bubble_fraction": bubble_fraction(st, n_batches),
        "bottleneck_s": max(max(c, r) for c, r in zip(st.compute, st.receive)),
    }
