"""Roofline analysis of a dry-run trace, with H100 constants — the port's
``repro.launch.roofline``.

    compute    = exec_FLOPs / (chips × peak_FLOP/s)
    memory     = HBM_bytes / (chips × HBM_bw)
    collective = Σ per-chip collective bytes / link_bw of each collective

exec_FLOPs and HBM_bytes are the analytic workload model
(``core/workload.py``, as in the JAX package).  Collective bytes are
counted by ``TraceCounter``, a dispatch mode over the ``_c10d_functional``
ops that the traced step dispatches on its per-rank (local) tensors: the
result bytes of each all-gather / all-reduce / reduce-scatter /
all-to-all / permute, per rank.  The port's layers run as a Python loop,
so every layer's collectives are dispatched and counted; the JAX
package's while-loop trip-count multiplication has no counterpart here.
``raw_cost_flops`` is one rank's FLOPs by ``FlopCounterMode``'s formulas
(matmul-like ops and the port's custom ops only); ``raw_cost_bytes`` is
the operand plus result bytes of every op on one rank's local tensors —
an unfused count, so far above what a fused program moves.  On fake
tensors the plain RWKV / Mamba recurrences (Python loops over time)
trace two steps and count them S / 2 times (``hints.repeat``); their
backward, where a training step has one, is traced and counted for those
two steps only.

Hardware constants — NVIDIA H100 SXM5 data sheet figures, not
measurements: 989e12 FLOP/s dense bf16 on the tensor cores, 3.35e12 B/s
HBM3.  Links: NVLink 4 at 450e9 B/s per GPU each way within an 8-GPU
node (900 GB/s bidirectional, NVIDIA H100 data sheet), and one
InfiniBand NDR port of 400 Gb/s = 50e9 B/s per GPU across nodes
(NVIDIA DGX H100 user guide: eight ConnectX-7 NDR ports a node).  A
collective whose group's ranks share a node (ranks r // 8 equal) runs
at the NVLink rate, any other at the InfiniBand rate.
"""
from __future__ import annotations

import weakref
from dataclasses import asdict, dataclass
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models.hints import trips

PEAK_FLOPS = 989e12          # bf16 dense per GPU
HBM_BW = 3.35e12             # bytes/s per GPU
NVLINK_BW = 450e9            # bytes/s per GPU within a node
IB_BW = 50e9                 # bytes/s per GPU across nodes
GPUS_PER_NODE = 8

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _collective_kinds() -> Dict:
    """``_c10d_functional`` op -> JAX's collective kind."""
    ops = torch.ops._c10d_functional
    table = {"all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
             "all_reduce_coalesced": "all-reduce",
             "all_reduce_coalesced_": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "broadcast": "collective-permute",
             "broadcast_": "collective-permute"}
    out = {}
    for name, kind in table.items():
        if hasattr(ops, name):
            out[getattr(ops, name).default] = kind
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _group_bw(group_name: str) -> float:
    from torch.distributed import get_process_group_ranks
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = get_process_group_ranks(_resolve_process_group(group_name))
    nodes = {r // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


class TraceCounter(TorchDispatchMode):
    """Counts, over the ops a step runs on each rank's local tensors: the
    collective bytes by kind and their link time, the FLOPs by
    ``FlopCounterMode``'s formulas (the port's custom ops register theirs),
    the operand plus result bytes of every op, and the peak of the bytes
    held live by op results (a new storage counts from the op that made
    it until its last tensor is freed; a view or an in-place result of an
    input's storage adds nothing; DTensor's own metadata runs on
    global-shape fake tensors are skipped).  A DTensor op is let through
    to DTensor first (as ``CommDebugMode`` does), so what is counted is
    what it desugars into: local ops and collectives.  Ops traced under
    ``hints.repeat(n)`` count n times.  Enter it inside the fake mode and
    around the step."""

    def __init__(self):
        super().__init__()
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.coll_s = 0.0
        self.flops = 0
        self.op_bytes = 0.0
        self.custom_calls: Dict[str, int] = {}   # the port's custom ops
        self._in_prop = 0
        self.live = 0
        self.peak = 0
        self._kinds = _collective_kinds()
        self._storages: Dict[int, list] = {}     # storage -> [bytes, refs]

    @staticmethod
    def _storage(t):
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None

    def _track(self, t: torch.Tensor, seen: set) -> None:
        st = self._storage(t)
        if st is None or st._cdata in seen:   # a view, or written in place
            return
        key = st._cdata
        ent = self._storages.get(key)
        if ent is None:
            ent = self._storages[key] = [st.nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._storages[key]

    def __enter__(self):
        # DTensor infers an op's output metadata by running it once on
        # global-shape fake tensors of the same mode; those runs are not
        # a rank's work, so they are marked and skipped
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                 "_propagate_tensor_meta")
                     if hasattr(SP, n)), None)
        self._patched = None
        if name is not None:
            orig = getattr(SP, name)
            counter = self

            def marked(*a, **k):
                counter._in_prop += 1
                try:
                    return orig(*a, **k)
                finally:
                    counter._in_prop -= 1
            setattr(SP, name, marked)
            self._patched = (SP, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        if self._patched is not None:
            cls, name, orig = self._patched
            setattr(cls, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._in_prop:
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        n = trips()
        ins, _ = tree_flatten((args, kwargs))
        outs, _ = tree_flatten(out)
        self.op_bytes += n * (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        formula = flop_registry.get(getattr(func, "_overloadpacket", None))
        if formula is not None:
            self.flops += n * formula(*args, **kwargs, out_val=out)
        if getattr(func, "namespace", None) == "repro_torch":
            name = func._overloadpacket.__name__
            self.custom_calls[name] = self.custom_calls.get(name, 0) + n
        kind = self._kinds.get(func)
        if kind is not None:
            b = n * sum(map(_nbytes, outs))
            self.coll[kind] += b
            # the group's name is the op's last string argument
            group = [a for a in ins if isinstance(a, str)][-1]
            self.coll_s += b / _group_bw(group)
        seen = {st._cdata for st in (self._storage(t) for t in ins
                                     if isinstance(t, torch.Tensor))
                if st is not None}
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._track(t, seen)
        return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    exec_flops: float            # global, analytic (incl. remat)
    hbm_bytes: float             # global, analytic traffic model
    coll_bytes: float            # global: per-rank collective bytes × chips
    model_flops: float           # useful compute (no remat/overcompute)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float          # model_flops / exec_flops
    per_chip_peak_mem: float = 0.0
    coll_detail: Optional[dict] = None
    raw_cost_flops: float = 0.0  # per rank, FlopCounterMode's formulas
    raw_cost_bytes: float = 0.0  # unfused operand + result bytes per rank
    raw_coll_bytes_static: float = 0.0

    def to_dict(self):
        return asdict(self)


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            counter: TraceCounter, exec_flops: float, hbm_bytes: float,
            model_flops: float, per_chip_peak_mem: float = 0.0) -> Roofline:
    """exec_flops / hbm_bytes: analytic global workload (the PALEO-style
    §3.7 model).  Collectives: the per-rank bytes ``counter`` saw, each at
    its group's link rate; scaled ×chips to global in ``coll_bytes``."""
    per_chip = sum(counter.coll.values())
    compute_s = exec_flops / (chips * PEAK_FLOPS)
    memory_s = hbm_bytes / (chips * HBM_BW)
    collective_s = counter.coll_s
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    detail = {k: v * chips for k, v in counter.coll.items()}
    detail["total"] = per_chip * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        exec_flops=exec_flops, hbm_bytes=hbm_bytes,
        coll_bytes=per_chip * chips, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        useful_ratio=model_flops / exec_flops if exec_flops else 0.0,
        per_chip_peak_mem=per_chip_peak_mem, coll_detail=detail,
        raw_cost_flops=float(counter.flops),
        raw_cost_bytes=float(counter.op_bytes),
        raw_coll_bytes_static=per_chip,
    )
