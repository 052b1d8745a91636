"""Weights made by the benchmark from the run's seed, and the parameter
tree the program takes.

The benchmark makes the weights itself and hands the same numbers to the
program and to the plain reference.  Each leaf is drawn on the device by
a generator of its own, seeded from (run seed, leaf path), in the type the
program holds it in: any leaf can be drawn again later (the reference, and the
training check's starting point) without keeping a copy.  The
distributions follow the port's initialisers (std 1 / sqrt(fan-in),
output projections scaled by 1 / sqrt(2 n_layers), the embedding 0.02);
RMSNorm scales, stored minus one, are drawn N(0, 0.1) so that the scale
enters the comparison.

``param_specs`` describes the port's parameter tree (paths, shapes,
dtypes) from a configuration's ``port`` section; a CPU test holds it to
``repro_torch.models.transformer.init_params``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch

NORM_STD = 0.1


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float


def layers_of(port: dict) -> List[Tuple[str, dict, int]]:
    """(path prefix, layer spec, n_periods) of each layer entry of the
    tree: the unrolled prefix layers, then the stacked period layers."""
    prefix = port.get("prefix_layers", [])
    out = [(f"prefix/{i}", s, 0) for i, s in enumerate(prefix)]
    period = port["period"]
    n_periods = (port["n_layers"] - len(prefix)) // len(period)
    if n_periods:
        out += [(f"stack/{j}", s, n_periods) for j, s in enumerate(period)]
    return out


def _layer(pre: str, spec: dict, p: dict, lead: tuple) -> List[Leaf]:
    bf, f32 = torch.bfloat16, torch.float32
    d, L = p["d_model"], p["n_layers"]
    out_scale = 1.0 / math.sqrt(2 * L)

    def dense(name, d_in, d_out, scale=1.0):
        return Leaf(f"{pre}/{name}", lead + (d_in, d_out), bf,
                    scale / math.sqrt(d_in))

    def norm(name, width):
        return Leaf(f"{pre}/{name}", lead + (width,), f32, NORM_STD)

    if (spec["mixer"], spec["ffn"]) != ("attn", "dense"):
        raise NotImplementedError(f"cardbench: layer {spec}")
    hq, hkv, hd, f = p["n_heads"], p["n_kv_heads"], p["head_dim"], p["d_ff"]
    leaves = [norm("norm1", d), norm("norm2", d),
              dense("mixer/wq", d, hq * hd), dense("mixer/wk", d, hkv * hd),
              dense("mixer/wv", d, hkv * hd),
              dense("mixer/wo", hq * hd, d, out_scale)]
    if p.get("qk_norm"):
        leaves += [norm("mixer/q_norm", hd), norm("mixer/k_norm", hd)]
    return leaves + [dense("ffn/w_gate", d, f), dense("ffn/w_up", d, f),
                     dense("ffn/w_down", f, d, out_scale)]


def param_specs(port: dict) -> List[Leaf]:
    """Every leaf of the port's parameter tree, in its flatten order."""
    d, V = port["d_model"], port["vocab_size"]
    specs = [Leaf("embed", (V, d), torch.bfloat16, 0.02),
             Leaf("final_norm", (d,), torch.float32, NORM_STD)]
    if not port.get("tie_embeddings"):
        specs.append(Leaf("lm_head", (d, V), torch.bfloat16, 1 / math.sqrt(d)))
    for pre, spec, n_periods in layers_of(port):
        specs += _layer(pre, spec, port, (n_periods,) if n_periods else ())
    return specs


def leaf_seed(seed: int, path: str) -> int:
    h = hashlib.sha256(f"{int(seed)}/{path}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_leaf(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """One leaf drawn on ``device`` from (seed, path), in its own dtype."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, leaf.path))
    t = torch.randn(leaf.shape, generator=g, dtype=leaf.dtype, device=device)
    return t.mul_(leaf.std)


def make_weights(specs: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    return {leaf.path: make_leaf(leaf, seed, device) for leaf in specs}


def tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The nested dict / tuple tree of the port from path -> tensor
    (numeric path parts index tuples)."""
    root: dict = {}
    for path, t in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}
    return fix(root)


def port_config(conf: dict):
    """The program's ``ModelConfig`` from a configuration's ``port``
    section."""
    from repro_torch.models.config import LayerSpec, ModelConfig
    p = dict(conf["port"])
    p["period"] = tuple(LayerSpec(**s) for s in p["period"])
    p["prefix_layers"] = tuple(LayerSpec(**s)
                               for s in p.get("prefix_layers", ()))
    return ModelConfig(**p)
