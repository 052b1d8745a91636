"""Run the JAX package's expert-parallel MoE on a 2x2 (data, model) mesh of
four host devices and dump its inputs, outputs and gradients, for the
port's EP test: run as a script in a process of its own (it sets
XLA_FLAGS for 4 host devices before JAX loads).

    python tests/_jax_moe_ep_dump.py OUT.npz ARCH:CAPACITY_FACTOR ...

For each case: the parameters of ``moe_init(PRNGKey(0), cfg)`` in
float32, the input x (float32, (4, 16, d) from numpy seed 1), and JAX's
``moe_apply_ep`` output, load-balance loss, and the gradients of
``mean(out**2)`` (group "out") and of the load-balance loss (group
"aux") with respect to every parameter and to x.  Keys are
``{case}/{name}`` and ``{case}/grads_{group}/{leaf path}``, with case
``{arch}:{factor}``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models.layers import moe_init  # noqa: E402
from repro.models.moe_ep import moe_apply_ep  # noqa: E402


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in kp)


def main():
    out_path, cases = sys.argv[1], sys.argv[2:]
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    dump = {}
    for case in cases:
        arch, cf = case.split(":")
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=float(cf))
        p = jax.tree.map(lambda v: v.astype(jnp.float32),
                         moe_init(jax.random.PRNGKey(0), cfg))
        x = np.random.RandomState(1).randn(4, 16, cfg.d_model).astype(
            np.float32)

        def run(p, x):
            return moe_apply_ep(p, x, cfg, mesh, ("data",), "model")

        losses = {"out": lambda p, x: (run(p, x)[0] ** 2).mean(),
                  "aux": lambda p, x: run(p, x)[1]}
        out, aux = jax.jit(run)(p, jnp.asarray(x))
        dump[f"{case}/x"] = x
        dump[f"{case}/out"] = np.asarray(out)
        dump[f"{case}/aux"] = np.asarray(aux)
        trees = {"params": p}
        for name, loss in losses.items():
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                p, jnp.asarray(x))
            trees[f"grads_{name}"] = {**gp, "x": gx}
        for group, tree in trees.items():
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            for kp, v in flat:
                dump[f"{case}/{group}/{_path(kp)}"] = np.asarray(v)
    np.savez(out_path, **dump)


if __name__ == "__main__":
    main()
