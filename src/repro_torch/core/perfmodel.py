"""Analytic hardware performance model (paper §3.3, §3.7).

* Device catalog (Table 1 + TPU targets) with peak tensor FLOPS and
  memory capacities.
* PALEO-style per-op time:  T(f,p) = R(Pa(f)) + C(f,p) + W(f,p)
  with C = FLOPs(f) / S(p),  S(p) = S*(p) · λ_p.
* alpha-beta point-to-point communication:  T_comm(M) = α + β·M.
* λ_p fitted from short profiling runs by least squares (§3.7).

A copy of ``repro.core.perfmodel``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Sequence, Tuple

GB = 1e9


@dataclass(frozen=True)
class DeviceSpec:
    """Peak specs. ``tflops`` is the tensor-core rate the paper uses for
    its estimates (Table 1 'TFLOPS FP32 Tensor Core'; bf16 for TPUs)."""
    name: str
    tflops: float                 # peak tensor TFLOP/s
    gpu_mem: float                # bytes
    cpu_mem: float = 32 * GB
    disk: float = 512 * GB
    mem_bw: float = 500e9         # HBM/GDDR bytes/s
    price_usd: float = 0.0
    level: str = "consumer"

    @property
    def flops(self) -> float:
        return self.tflops * 1e12


# Table 1 of the paper + the TPU target used by the production mesh.
DEVICE_CATALOG: Dict[str, DeviceSpec] = {d.name: d for d in [
    DeviceSpec("rtx4090", 82.58, 24 * GB, mem_bw=1008e9, price_usd=1599, level="consumer"),
    DeviceSpec("rtx4080", 97.5, 16 * GB, mem_bw=717e9, price_usd=1199, level="consumer"),
    DeviceSpec("rtx3080", 59.5, 10 * GB, mem_bw=760e9, price_usd=699, level="consumer"),
    DeviceSpec("h100", 756.0, 80 * GB, mem_bw=3350e9, price_usd=30000, level="datacenter"),
    DeviceSpec("a100", 155.92, 80 * GB, mem_bw=2039e9, price_usd=15000, level="datacenter"),
    DeviceSpec("v100", 125.0, 32 * GB, mem_bw=900e9, price_usd=10000, level="datacenter"),
    DeviceSpec("tpu_v5e", 197.0, 16 * GB, mem_bw=819e9, price_usd=0, level="datacenter"),
]}


@dataclass(frozen=True)
class LinkSpec:
    """alpha-beta link: T(M) = alpha + beta * M  (beta = 1/bandwidth)."""
    alpha: float                  # seconds
    beta: float                   # seconds / byte

    @classmethod
    def from_bandwidth(cls, bw_bytes_per_s: float, latency_s: float = 1e-3):
        return cls(alpha=latency_s, beta=1.0 / bw_bytes_per_s)

    def time(self, message_bytes: float) -> float:
        return self.alpha + self.beta * message_bytes if message_bytes > 0 else 0.0


# Named WAN/LAN regimes used in the paper's Fig. 5/6 sweeps.
LINK_REGIMES: Dict[str, LinkSpec] = {
    "wan_10mbps": LinkSpec.from_bandwidth(10e6 / 8, 50e-3),
    "wan_100mbps": LinkSpec.from_bandwidth(100e6 / 8, 20e-3),
    "wan_1gbps": LinkSpec.from_bandwidth(1e9 / 8, 10e-3),
    "lan_10gbps": LinkSpec.from_bandwidth(10e9 / 8, 0.1e-3),
    "nvlink": LinkSpec.from_bandwidth(450e9, 5e-6),
    "tpu_ici": LinkSpec.from_bandwidth(50e9, 1e-6),
}


def fit_lambda(flops_samples: Sequence[float], time_samples: Sequence[float],
               peak_flops: float) -> float:
    """Regression-based scaling-down factor λ_p (§3.7, after PALEO).

    Model t = f / (S*·λ); least squares of t against x = f/S* through the
    origin gives 1/λ = Σ x·t / Σ x²."""
    xs = [f / peak_flops for f in flops_samples]
    num = sum(x * t for x, t in zip(xs, time_samples))
    den = sum(x * x for x in xs)
    if den <= 0 or num <= 0:
        return 1.0
    lam = den / num  # λ = 1 / c, c = num/den
    return min(1.0, lam)


@dataclass
class CompNode:
    """A computing provider (paper §3.3): device + link + collaboration
    dynamics. ``kind`` distinguishes long-lived supernodes from transient
    antnodes."""
    node_id: int
    device: DeviceSpec
    link: LinkSpec
    lam: float = 0.75             # λ_p scaling-down factor
    kind: str = "antnode"         # supernode | antnode
    reliability: float = 0.999    # per-heartbeat survival probability
    online: bool = True

    @property
    def speed(self) -> float:
        return self.device.flops * self.lam

    def compute_time(self, flops: float) -> float:
        return flops / self.speed

    def memory_ok(self, gpu_bytes: float, cpu_bytes: float = 0.0,
                  disk_bytes: float = 0.0) -> bool:
        return (gpu_bytes <= self.device.gpu_mem
                and cpu_bytes <= self.device.cpu_mem
                and disk_bytes <= self.device.disk)


class PerfModel:
    """PALEO-style op/sub-graph timing over a set of compnodes."""

    def __init__(self, nodes: Sequence[CompNode]):
        self.nodes = {n.node_id: n for n in nodes}

    def link(self, src: int, dst: int) -> LinkSpec:
        """Point-to-point link: dominated by the slower endpoint's uplink
        (alpha adds, beta takes the max ≙ min bandwidth)."""
        a, b = self.nodes[src].link, self.nodes[dst].link
        return LinkSpec(alpha=a.alpha + b.alpha, beta=max(a.beta, b.beta))

    def op_time(self, node, peer_id: int,
                parent_locs: Optional[Dict[str, int]] = None,
                parent_bytes: Optional[Dict[str, float]] = None) -> float:
        """T(f,p) = R(Pa(f)) + C(f,p) + W(f,p)  (Eq. 1)."""
        p = self.nodes[peer_id]
        c = p.compute_time(node.flops)
        w = node.out_bytes / p.device.mem_bw
        r = 0.0
        if parent_locs:
            for a in node.args:
                src = parent_locs.get(a, peer_id)
                if src != peer_id:
                    r += self.link(src, peer_id).time(
                        (parent_bytes or {}).get(a, 0.0))
        return r + c + w

    def subgraph_time(self, dag, op_names: Sequence[str], peer_id: int,
                      assignment: Optional[Dict[str, int]] = None
                      ) -> Tuple[float, float]:
        """Sequential-execution time of a sub-graph on a peer, split into
        (compute C_p, receive R_p) — the Eq. 3 terms.  The sequential sum
        is the upper end of the paper's [max_i T, Σ_i T] range."""
        comp = 0.0
        recv = 0.0
        for name in op_names:
            node = dag[name]
            p = self.nodes[peer_id]
            comp += p.compute_time(node.flops) + node.out_bytes / p.device.mem_bw
            if assignment:
                for a in node.args:
                    src = assignment.get(a, peer_id)
                    if src != peer_id:
                        recv += self.link(src, peer_id).time(dag[a].out_bytes)
        return comp, recv


def make_fleet(spec: Iterable[Tuple[str, int]], link: LinkSpec,
               lam: float = 0.75, seed: int = 0) -> list:
    """Build a homogeneous-link fleet, e.g. make_fleet([("rtx3080", 50)],
    LINK_REGIMES["wan_1gbps"])."""
    nodes = []
    nid = 0
    for dev_name, count in spec:
        for _ in range(count):
            nodes.append(CompNode(nid, DEVICE_CATALOG[dev_name], link, lam=lam))
            nid += 1
    return nodes
