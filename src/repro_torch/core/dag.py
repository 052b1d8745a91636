"""FusionAI DAG intermediate representation (paper §3.5–3.6).

The IR plane: ML procedures (FP / BP / Update) are directed acyclic graphs
of operators.  Each ``OpNode`` carries the Table-2 attributes — name, op
users (forward edges), type (placeholder / variable / parametric /
non-parametric / loss), args (data dependencies), kwargs (constants) and,
after scheduling, a compnode location.  Sub-graphs (Table 3) are derived
views with inner/outer required data and outwards data computed from the
cut edges.

The IR is pure data (JSON-serializable) — execution lives in
``repro_torch.core.executor`` (the execution plane), keeping the paper's
P3–P6 decoupling: any engine that can interpret the op vocabulary can run
a sub-DAG.

A copy of ``repro.core.dag``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional, Sequence, Tuple

# Op type taxonomy (paper Table 2)
PLACEHOLDER = "placeholder"     # inputs/labels — no grad, no params
VARIABLE = "variable"           # leaf tensors that require grad
PARAMETRIC = "parametric"       # ops with trainable parameters
NONPARAM = "nonparametric"      # stateless compute ops
LOSS = "loss"                   # loss functions (DAG sinks for FP)

OP_TYPES = (PLACEHOLDER, VARIABLE, PARAMETRIC, NONPARAM, LOSS)


@dataclass
class OpNode:
    """One operator in the IR plane."""
    name: str
    op: str                                  # op vocabulary id, e.g. "attention_block"
    op_type: str = NONPARAM
    args: Tuple[str, ...] = ()               # producer op names (data deps)
    kwargs: Dict = field(default_factory=dict)   # constants / config
    # analytic workload descriptors used by the perf model & scheduler:
    flops: float = 0.0                       # forward FLOPs
    param_bytes: float = 0.0                 # parameter storage
    out_bytes: float = 0.0                   # activation output size
    # filled by the scheduler:
    compnode: Optional[int] = None

    def __post_init__(self):
        assert self.op_type in OP_TYPES, self.op_type


class DAG:
    """Operator graph with Table-2/Table-3 derived attributes."""

    def __init__(self, name: str = "dag"):
        self.name = name
        self.nodes: Dict[str, OpNode] = {}
        self._order: List[str] = []          # insertion = topological order

    # -- construction -----------------------------------------------------
    def add(self, node: OpNode) -> OpNode:
        assert node.name not in self.nodes, f"duplicate op {node.name}"
        for a in node.args:
            assert a in self.nodes, f"{node.name}: unknown arg {a} (not topological)"
        self.nodes[node.name] = node
        self._order.append(node.name)
        return node

    # -- queries ------------------------------------------------------------
    def __len__(self):
        return len(self.nodes)

    def __contains__(self, name):
        return name in self.nodes

    def __getitem__(self, name) -> OpNode:
        return self.nodes[name]

    def topo_order(self) -> List[str]:
        return list(self._order)

    def users(self, name: str) -> List[str]:
        """OP users: ops that consume this op's output (forward edges)."""
        return [n for n in self._order if name in self.nodes[n].args]

    def edges(self) -> List[Tuple[str, str]]:
        return [(a, n) for n in self._order for a in self.nodes[n].args]

    def validate(self) -> None:
        """Topological consistency + acyclicity (insertion order is topo,
        so args must precede users)."""
        seen = set()
        for n in self._order:
            for a in self.nodes[n].args:
                assert a in seen, f"edge {a}->{n} violates topo order"
            seen.add(n)

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes.values())

    def total_param_bytes(self) -> float:
        return sum(n.param_bytes for n in self.nodes.values())

    # -- Table-3 sub-graph view ---------------------------------------------
    def subgraph_attrs(self, assignment: Dict[str, int]) -> Dict[int, dict]:
        """Given op->compnode assignment, compute each sub-graph's Table-3
        attributes: nodes, inner/outer required data, outwards data and
        compnode users."""
        out: Dict[int, dict] = {}
        for name in self._order:
            node = self.nodes[name]
            k = assignment[name]
            g = out.setdefault(k, {"compnode": k, "nodes": [], "inner": set(),
                                   "outer": set(), "outwards": set(),
                                   "users": set()})
            g["nodes"].append(name)
        for name in self._order:
            k = assignment[name]
            for a in self.nodes[name].args:
                ka = assignment[a]
                if ka == k:
                    out[k]["inner"].add(a)
                else:
                    out[k]["outer"].add(a)          # data arriving from outside
                    out[ka]["outwards"].add(a)      # data leaving producer's graph
                    out[ka]["users"].add(k)
        return out

    def cut_bytes(self, assignment: Dict[str, int]) -> float:
        """Total bytes crossing sub-graph boundaries (each producer output
        counted once per remote consumer compnode, as the executor sends
        point-to-point)."""
        total = 0.0
        for name in self._order:
            src = assignment[name]
            remote = {assignment[u] for u in self.users(name)} - {src}
            total += self.nodes[name].out_bytes * len(remote)
        return total

    # -- serialization (IR plane is pure data) -------------------------------
    def to_json(self) -> str:
        return json.dumps({"name": self.name,
                           "nodes": [asdict(self.nodes[n]) for n in self._order]},
                          indent=1)

    @classmethod
    def from_json(cls, s: str) -> "DAG":
        d = json.loads(s)
        dag = cls(d["name"])
        for nd in d["nodes"]:
            nd["args"] = tuple(nd["args"])
            dag.add(OpNode(**nd))
        return dag


# ---------------------------------------------------------------------------
# DAG builders: model config -> FP DAG at Fig.-4 granularity
# ---------------------------------------------------------------------------

def build_model_dag(cfg, *, batch: int, seq: int, dtype_bytes: int = 2,
                    kind: str = "train") -> DAG:
    """Build the forward DAG of a ``ModelConfig`` at block granularity
    (embed, per-layer mixer block, per-layer FFN block, head, loss) — the
    same granularity as the paper's Fig. 4 (each transformer layer split
    into attention block and FFN block).

    Workload descriptors (flops / param_bytes / out_bytes) are analytic and
    feed the perf model (§3.7) and scheduler (§3.8).
    """
    from repro_torch.core.workload import block_workloads

    dag = DAG(f"{cfg.name}-{kind}-fp")
    tok_bytes = batch * seq * 4
    act = batch * seq * cfg.d_model * dtype_bytes

    dag.add(OpNode("input", "input", PLACEHOLDER, out_bytes=tok_bytes))
    if kind == "train":
        dag.add(OpNode("label", "label", PLACEHOLDER, out_bytes=tok_bytes))
    w = block_workloads(cfg, batch=batch, seq=seq, dtype_bytes=dtype_bytes)
    dag.add(OpNode("embed", "embedding", PARAMETRIC, args=("input",),
                   flops=0.0, param_bytes=w["embed_params"] * dtype_bytes,
                   out_bytes=act))

    prev = "embed"
    layers = list(cfg.prefix_layers) + list(cfg.period) * (
        (cfg.n_layers - len(cfg.prefix_layers)) // max(1, len(cfg.period)))
    for i, spec in enumerate(layers):
        mixer = f"L{i}.{spec.mixer}"
        dag.add(OpNode(mixer, f"{spec.mixer}_block", PARAMETRIC, args=(prev,),
                       flops=w[f"{spec.mixer}_flops"],
                       param_bytes=w[f"{spec.mixer}_params"] * dtype_bytes,
                       out_bytes=act))
        ffn = f"L{i}.{spec.ffn}"
        dag.add(OpNode(ffn, f"{spec.ffn}_ffn", PARAMETRIC, args=(mixer,),
                       flops=w[f"{spec.ffn}_flops"],
                       param_bytes=w[f"{spec.ffn}_params"] * dtype_bytes,
                       out_bytes=act))
        prev = ffn

    dag.add(OpNode("head", "unembed", PARAMETRIC, args=(prev,),
                   flops=w["head_flops"],
                   param_bytes=w["head_params"] * dtype_bytes,
                   out_bytes=batch * seq * cfg.vocab_size * dtype_bytes))
    if kind == "train":
        dag.add(OpNode("loss", "cross_entropy", LOSS, args=("head", "label"),
                       kwargs={"weight": 1.0}, out_bytes=4))
    dag.validate()
    return dag
