"""Dump the JAX package's dry-run inputs and their shardings to JSON, for
the port's spec and sharding tests: run as a script in a process of its
own (it sets XLA_FLAGS for 512 host devices before JAX loads).

    python tests/_jax_shardings_dump.py OUT.json [--opt-bits 32|8]

For every baseline (arch, shape) pair, and the paged engine-step variant
of each decode pair: every input leaf's path, shape and dtype; and on the
16x16 and 2x16x16 meshes, every leaf's sanitized partition spec and its
per-device shard shape, with the argument choices of
``repro.launch.dryrun.build_jitted``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import INPUT_SHAPES, baseline_pairs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.launch.shardings import (batch_specs, cache_specs,  # noqa: E402
                                    opt_specs, param_specs, to_shardings)
from repro.launch.specs import input_specs  # noqa: E402


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def _spec(s) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in s]


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path(kp), list(x.shape), str(x.dtype)) for kp, x in flat]


def shardings(spec, mesh):
    """{group: sanitized NamedSharding tree}, as build_jitted picks them."""
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
    decode_tp = (shape.kind == "decode"
                 and os.environ.get("REPRO_DECODE_TP", "1") == "1")
    shard_b = B > 1 and not decode_tp
    out["caches"] = to_shardings(cache_specs(spec["caches"], mesh,
                                             batch_size=B),
                                 mesh, spec["caches"])
    for name in ("batch", "positions", "table"):
        if name in spec:
            tree = spec[name] if name == "batch" else {"t": spec[name]}
            sh = to_shardings(batch_specs(tree, mesh, shard_batch=shard_b),
                              mesh, tree)
            out[name] = sh if name == "batch" else sh["t"]
    if "sampling" in spec:
        sm = spec["sampling"]
        out["sampling"] = {
            k: (to_shardings(batch_specs({"t": v}, mesh,
                                         shard_batch=shard_b),
                             mesh, {"t": v})["t"] if k == "seen"
                else to_shardings(P(), mesh, v))
            for k, v in sm.items()}
    return out


def main():
    out_path = sys.argv[1]
    if "--opt-bits" in sys.argv:
        os.environ["REPRO_OPT_BITS"] = sys.argv[sys.argv.index(
            "--opt-bits") + 1]
    pairs, skips = baseline_pairs()
    meshes = {"pod16x16": make_production_mesh(multi_pod=False),
              "pod2x16x16": make_production_mesh(multi_pod=True)}
    dump = {"pairs": [list(p) for p in pairs],
            "skips": [list(s) for s in skips],
            "input_shapes": {k: [v.name, v.seq_len, v.global_batch, v.kind]
                             for k, v in INPUT_SHAPES.items()},
            "cases": {}}
    for arch, shape in pairs:
        variants = [False] + ([True] if INPUT_SHAPES[shape].kind == "decode"
                              else [])
        for paged in variants:
            spec = input_specs(arch, shape, paged=paged)
            case = {"leaves": {}, "meshes": {}}
            groups = [g for g in ("params", "opt_state", "batch", "caches",
                                  "positions", "table", "sampling")
                      if g in spec]
            for g in groups:
                case["leaves"][g] = leaves(spec[g])
            for mname, mesh in meshes.items():
                per = {}
                for g, sh in shardings(spec, mesh).items():
                    flat, _ = jax.tree_util.tree_flatten_with_path(sh)
                    xs = jax.tree_util.tree_leaves(spec[g])
                    per[g] = [[_path(kp), _spec(s.spec),
                               list(s.shard_shape(x.shape))]
                              for (kp, s), x in zip(flat, xs)]
                case["meshes"][mname] = per
            dump["cases"][f"{arch}|{shape}|{'paged' if paged else 'dense'}"] = case
    with open(out_path, "w") as f:
        json.dump(dump, f)


if __name__ == "__main__":
    main()
