"""Run the JAX package's ``spmd_pipeline`` on a one-axis ("stage",) mesh of
four host devices and dump its inputs and outputs, for the port's
pipeline test: run as a script in a process of its own (it sets
XLA_FLAGS for 4 host devices before JAX loads).

    python tests/_jax_spmd_pipeline_dump.py OUT.npz

The mesh has Auto axes: ``repro.launch.mesh.make_host_mesh`` makes
Explicit ones in this JAX, on which ``spmd_pipeline``'s ``outs[-1]``
raises a sharding error.  Cases:
- "tanh": ``tanh(x @ w)`` over 4 stages, w (4, 16, 16) and 6
  microbatches x (8, 16) from numpy seed 0, float32: JAX's
  ``spmd_pipeline`` ("tanh/out") and its sequential loop ("tanh/seq").
- "model": the gpt3-24l smoke config widened to 4 layers of one period
  (one layer a stage), ``init_params(PRNGKey(0))``'s stacked layer
  ("model/p/{leaf path}": bf16 leaves as their uint16 bits, listed in
  "model/bf16"), microbatches "model/x" (6, 2, 16, d) from numpy seed 1,
  and for activations in float32 and bfloat16 JAX's ``spmd_pipeline``
  over ``layer_apply`` ("model/out_{dtype}") and JAX's ``layer_apply``
  loop ("model/seq_{dtype}"), both as float32.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core.executor import spmd_pipeline  # noqa: E402
from repro.models.config import LayerSpec  # noqa: E402
from repro.models.transformer import init_params, layer_apply  # noqa: E402

N_STAGES = 4


def model_cfg():
    """gpt3-24l smoke, 4 layers of a one-layer period: one layer a stage."""
    cfg = get_smoke_config("gpt3-24l")
    return dataclasses.replace(cfg, n_layers=N_STAGES,
                               period=(LayerSpec(cfg.period[0].mixer,
                                                 cfg.period[0].ffn),))


def _path(kp) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in kp)


def main():
    out_path = sys.argv[1]
    mesh = jax.make_mesh((N_STAGES,), ("stage",),
                         axis_types=(AxisType.Auto,))
    dump = {}

    rng = np.random.RandomState(0)
    w = (rng.randn(N_STAGES, 16, 16) * 0.3).astype(np.float32)
    xs = rng.randn(6, 8, 16).astype(np.float32)
    out = spmd_pipeline(lambda w, x: jnp.tanh(x @ w), jnp.asarray(w),
                        jnp.asarray(xs), mesh, axis="stage")
    seq = jnp.asarray(xs)
    for i in range(N_STAGES):
        seq = jnp.tanh(seq @ w[i])
    dump.update({"tanh/w": w, "tanh/xs": xs, "tanh/out": np.asarray(out),
                 "tanh/seq": np.asarray(seq)})

    cfg = model_cfg()
    spec = cfg.period[0]
    stacked = init_params(jax.random.PRNGKey(0), cfg)["stack"][0]
    bf16 = []
    for kp, leaf in jax.tree_util.tree_flatten_with_path(stacked)[0]:
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            bf16.append(_path(kp))
            a = a.view(np.uint16)
        dump[f"model/p/{_path(kp)}"] = a
    dump["model/bf16"] = np.array(bf16)
    B, S = 2, 16
    x = np.random.RandomState(1).randn(6, B, S, cfg.d_model).astype(
        np.float32)
    dump["model/x"] = x
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def stage_fn(lp, h):
        return layer_apply(lp, spec, cfg, h, pos, None)[0]

    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        xj = jnp.asarray(x).astype(dt)
        out = spmd_pipeline(stage_fn, stacked, xj, mesh, axis="stage")
        seq = []
        for m in range(x.shape[0]):
            h = xj[m]
            for i in range(N_STAGES):
                h = stage_fn(jax.tree.map(lambda a: a[i], stacked), h)
            seq.append(h)
        dump[f"model/out_{name}"] = np.asarray(out.astype(jnp.float32))
        dump[f"model/seq_{name}"] = np.asarray(
            jnp.stack(seq).astype(jnp.float32))
    np.savez(out_path, **dump)


if __name__ == "__main__":
    main()
