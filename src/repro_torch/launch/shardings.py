"""Sharding rules for every parameter / optimizer / batch / cache leaf of
the port, the rules of ``repro.launch.shardings`` (DESIGN.md §5).

Scheme: 2D — FSDP-style sharding of the contraction dim on ``data``,
tensor parallelism of head/ffn/expert dims on ``model``; batch on
(pod, data); MoE experts on ``model`` (expert parallelism); decode caches
shard kv-heads (or MLA latent / SSM state) on ``model`` and batch on
``data``, except long-context batch=1 where the *sequence* dim of caches
shards on ``data``.

A spec is a tuple with one entry per tensor dimension (JAX's
``PartitionSpec``): ``None``, a mesh axis name, or a tuple of names (the
dim split over several axes, major to minor).  ``to_placements`` turns
one into DTensor placements.  Rules are keyed on leaf path names; every
leaf gets an explicit rule (unknown names raise, so new params can't
silently replicate).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_sizes, data_axes, model_axis
from repro_torch.tree import is_leaf, leaves


class PartitionSpec(tuple):
    """A spec: one entry per dim (shorter specs are padded with None).  A
    tuple subclass, as JAX's, so a tree of specs tells a spec from a
    tuple of subtrees."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = Spec = PartitionSpec


# --- name-keyed rules: value = spec WITHOUT the stack period axis ---------
# dp = data axes tuple (e.g. ("data",)); mp = "model"

def _param_rules(dp, mp):
    dps = dp if len(dp) > 1 else dp[0] if dp else None
    return {
        # norms / small vectors: replicated
        "norm1": P(), "norm2": P(), "final_norm": P(), "norm": P(),
        "q_norm": P(), "k_norm": P(), "kv_norm": P(), "ln_x": P(),
        "norm_h": P(), "norm_e": P(),
        "mu": P(None, None), "conv_b": P(), "dt_bias": P(), "D": P(),
        "w0": P(mp), "u": P(mp, None),
        # embeddings / head
        # vocab on model, d replicated: keeps the CE-loss contraction local
        # (d-on-data head sharding partial-sums (tokens, V/16) f32 logits)
        "embed": P(mp, None), "lm_head": P(None, mp), "ext_proj": P(None, mp),
        # attention
        "wq": P(dps, mp), "wk": P(dps, mp), "wv": P(dps, mp),
        "wo": P(mp, dps),
        "bq": P(mp), "bk": P(mp), "bv": P(mp),
        # MLA
        "wq_a": P(dps, None), "wq_b": P(None, mp),
        "wkv_a": P(dps, None), "wk_b": P(None, mp), "wv_b": P(None, mp),
        # dense ffn (2D) / moe experts (3D) share names; see param_specs
        "w_gate": P(dps, mp), "w_up": P(dps, mp), "w_down": P(mp, dps),
        "router": P(dps, None),
        # mamba
        "in_proj": P(dps, mp), "conv_w": P(None, mp),
        "x_proj": P(mp, None), "dt_proj": P(None, mp),
        "A_log": P(mp, None),
        "out_proj": P(mp, dps),
        # rwkv
        "wr": P(dps, mp), "wg": P(dps, mp),
        "wA": P(dps, None), "wB": P(None, mp),
        # mtp projector
        "proj": P(dps, None),
    }


def _moe_rules(dp, mp):
    dps = dp if len(dp) > 1 else dp[0] if dp else None
    return {
        "w_gate": P(mp, dps, None), "w_up": P(mp, dps, None),
        "w_down": P(mp, None, dps),
    }


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn(path names, leaf)`` over a nested dict / tuple tree."""
    if is_leaf(tree):
        return fn(list(path), tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return type(tree)(_map_with_path(fn, v, path + (str(i),))
                      for i, v in enumerate(tree))


def param_specs(params, mesh) -> dict:
    """Tree of specs matching ``params`` (any leaves with a ``shape``)."""
    dp, mp = data_axes(mesh), model_axis(mesh)
    rules = _param_rules(dp, mp)
    moe_rules = _moe_rules(dp, mp)

    def spec_for(names, leaf):
        name = names[-1]
        in_stack = "stack" in names
        ndim = len(leaf.shape)
        if name in moe_rules and ndim - (1 if in_stack else 0) == 3:
            spec = moe_rules[name]
        elif name in rules:
            spec = rules[name]
        else:
            raise KeyError(f"no sharding rule for param {'/'.join(names)} "
                           f"shape={tuple(leaf.shape)}")
        want = ndim - (1 if in_stack else 0)
        if len(spec) < want:                  # e.g. P() for any-rank norms
            spec = P(*spec, *(None,) * (want - len(spec)))
        if in_stack:
            spec = P(None, *spec)
        return spec

    return _map_with_path(spec_for, params)


def opt_specs(opt_state, p_specs, mesh) -> dict:
    """Optimizer state: moments/master shard like params; counters
    replicate."""
    return {k: (p_specs if k in ("mu", "nu", "master", "vel") else P())
            for k in opt_state}


def batch_specs(batch, mesh, *, shard_batch: bool = True) -> dict:
    dp = data_axes(mesh)
    dps = dp if len(dp) > 1 else dp[0]

    def spec_for(names, leaf):
        b = dps if shard_batch else None
        return P(b, *(None,) * (len(leaf.shape) - 1))

    return _map_with_path(spec_for, batch)


def cache_leaf_spec(name: str, *, long_ctx: bool, dp, mp,
                    shape=None, mp_size: int = 0) -> Spec:
    """Per-leaf cache sharding (shape WITHOUT the stack period axis).

    KV caches prefer sharding kv-heads on ``model``; when the head count
    doesn't divide the axis (e.g. 8 heads on 16 ranks) they shard head_dim
    instead — otherwise the cache is re-sharded at every pinned cache
    update.

    The same name-keyed rules cover PAGED pools (k/v: (N, page, Hkv, hd),
    pos: (N, page), ckv/krope: (N, page, kr|dr)): ranks match the dense
    layouts with the block axis standing in for batch, so blocks shard on
    ``data`` and heads/latent on ``model``."""
    dps = dp if len(dp) > 1 else dp[0]
    bspec = None if long_ctx else dps
    seq = dps if long_ctx else None
    kv_spec = P(bspec, seq, mp, None)
    if shape is not None and mp_size and len(shape) == 4:
        if shape[2] % mp_size != 0 and shape[3] % mp_size == 0:
            kv_spec = P(bspec, seq, None, mp)
    table = {
        "k": kv_spec,                          # (B, T, Hkv, hd)
        "v": kv_spec,
        "pos": P(bspec, seq),                  # (B, T)
        "ckv": P(bspec, seq, mp),              # (B, T, kr)
        "krope": P(bspec, seq, mp),            # (B, T, dr)
        "h": P(bspec, mp, None),               # mamba (B, di, ds)
        "conv": P(bspec, None, mp),            # (B, K-1, di)
        "state": P(bspec, mp, None, None),     # rwkv (B, H, hd, hd)
        "shift": P(bspec, None),               # (B, d)
    }
    if name not in table:
        raise KeyError(f"no cache rule for {name}")
    return table[name]


def cache_specs(caches, mesh, *, batch_size: int) -> dict:
    """Decode caches.  Normal: batch on data, heads/state on model.
    batch=1 long-context: sequence dim on data instead."""
    dp, mp = data_axes(mesh), model_axis(mesh)
    long_ctx = batch_size == 1
    sizes = axis_sizes(mesh)

    def spec_for(names, leaf):
        in_stack = "stack" in names
        shape = tuple(leaf.shape[1:] if in_stack else leaf.shape)
        spec = cache_leaf_spec(names[-1], long_ctx=long_ctx, dp=dp, mp=mp,
                               shape=shape, mp_size=sizes[mp])
        assert len(spec) == len(shape), (names, tuple(leaf.shape), spec)
        return P(None, *spec) if in_stack else spec

    return _map_with_path(spec_for, caches)


def default_hint_rule(mesh, *, batch_size: int, decode_tp: bool = False):
    """Hint rule for ``repro_torch.models.hints``: pins cache-update
    outputs to the boundary cache sharding and places MoE dispatch
    buffers expert-parallel.

    ``decode_tp``: single-token decode steps shard the residual stream's
    hidden dim over the data axes (weight-stationary 2D TP) — otherwise
    every FSDP-sharded weight is all-gathered per decoded token."""
    dp, mp = data_axes(mesh), model_axis(mesh)
    dps = dp if len(dp) > 1 else dp[0]
    long_ctx = batch_size == 1
    sizes = axis_sizes(mesh)

    def rule(kind: str, shape) -> Optional[Spec]:
        if kind.startswith("cache/"):
            return cache_leaf_spec(kind.split("/", 1)[1],
                                   long_ctx=long_ctx, dp=dp, mp=mp,
                                   shape=shape, mp_size=sizes[mp])
        if kind == "moe_buffer":               # (G, E, C, d)
            if decode_tp:
                # align buffer's d with the expert weights' FSDP axis so
                # the expert einsum partial-sums activations instead of
                # all-gathering 100s-of-MB weights per decoded token
                return P(None, mp, None, dps)
            return P(dps, mp, None, None)
        if kind == "moe_h":                    # (G, E, C, d)
            return None if decode_tp else P(dps, mp, None, None)
        if kind in ("moe_buffer_local", "moe_h_local"):
            return None if decode_tp else P(dps, None, None, None)
        if kind == "moe_tokens":               # (T, d)
            return None if decode_tp else P(dps, None)
        if kind == "ffn_hidden":               # (B, S, d_ff)
            # train/prefill: batch on data + hidden on model (Megatron)
            return None if decode_tp else P(dps, None, mp)
        if kind == "residual":                 # (B, S, d)
            if decode_tp:
                return P(None, None, dps)
            return P(dps, None, None)
        if kind == "attn_q":                   # (B, S, Hq, hd)
            if decode_tp:                      # align with hd-sharded caches
                return P(None, None, None, mp)
            if len(shape) == 4 and shape[2] % sizes[mp] != 0:
                return None                    # MHA with 24/40 heads: a pin
                # sanitized to replicated-heads forces full-cache gathers
            return P(dps, None, mp, None)
        return None

    return rule


def arg_shardings(spec: Dict, mesh, *, decode_tp: bool) -> Dict:
    """Sanitized spec trees of every step argument, by the JAX dry-run's
    choices: params / optimizer state by rule, training batches on the
    data axes, decode and prefill operands batch-sharded unless
    ``decode_tp`` replicates the tokens, caches by ``cache_specs``, the
    engine step's scalar sampling vectors replicated."""
    shape = spec["shape"]
    p_specs = param_specs(spec["params"], mesh)
    out = {"params": to_shardings(p_specs, mesh, spec["params"])}
    if shape.kind == "train":
        out["opt_state"] = to_shardings(
            opt_specs(spec["opt_state"], p_specs, mesh), mesh,
            spec["opt_state"])
        out["batch"] = to_shardings(batch_specs(spec["batch"], mesh), mesh,
                                    spec["batch"])
        return out
    B = shape.global_batch
    shard_b = B > 1 and not decode_tp
    out["caches"] = to_shardings(cache_specs(spec["caches"], mesh,
                                             batch_size=B),
                                 mesh, spec["caches"])
    for name in ("batch", "positions", "table"):
        if name in spec:
            out[name] = to_shardings(
                batch_specs(spec[name], mesh, shard_batch=shard_b), mesh,
                spec[name])
    if "sampling" in spec:
        sm = spec["sampling"]
        out["sampling"] = {k: (to_shardings(batch_specs(v, mesh,
                                                        shard_batch=shard_b),
                                            mesh, v) if k == "seen"
                               else to_shardings(P(), mesh, v))
                           for k, v in sm.items()}
    return out


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they don't divide (e.g. 24 kv-heads on a
    16-way model axis -> replicate that dim).  Rank-pad with None."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        out.append(entry if dim % n == 0 else None)
    return P(*out)


def to_shardings(specs, mesh, tree):
    """Spec tree -> per-leaf sanitized spec tree over ``tree`` (tensors
    or anything with a ``shape``).  ``specs`` may be a PREFIX of ``tree``
    (e.g. one spec covering the {q, s} pair of an int8-quantized
    optimizer moment): the spec broadcasts over the subtree, sanitized
    per leaf."""
    if isinstance(specs, PartitionSpec):
        return _map_with_path(
            lambda _, t: sanitize_spec(specs, tuple(t.shape), mesh), tree)
    if isinstance(specs, dict):
        return {k: to_shardings(specs[k], mesh, tree[k]) for k in tree}
    return type(specs)(to_shardings(s, mesh, t) for s, t in zip(specs, tree))


def to_placements(spec: Spec, mesh) -> List:
    """DTensor placements of a (sanitized) spec: mesh axis i shards the
    tensor dim whose entry names it, or replicates.  A dim over several
    axes (("pod", "data")) is ``Shard(d)`` on each, major to minor in
    mesh order, as JAX splits it."""
    names = list(mesh.mesh_dim_names)
    placements: List = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            if not isinstance(placements[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            placements[i] = Shard(d)
    return placements


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """Per-rank shape of a tensor of ``shape`` under a sanitized spec
    (JAX's ``NamedSharding.shard_shape``)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        assert out[d] % n == 0, (shape, spec)
        out[d] //= n
    return tuple(out)


def per_chip_bytes(tree, shardings, mesh) -> int:
    """Bytes one rank holds of ``tree`` under its sanitized spec tree."""
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves(tree), spec_leaves(shardings)))


def spec_leaves(specs):
    """The specs of a spec tree in the tree's flatten order."""
    if isinstance(specs, PartitionSpec):
        yield specs
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from spec_leaves(specs[k])
    else:
        for s in specs:
            yield from spec_leaves(s)
