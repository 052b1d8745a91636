"""Where the port rounds against the JAX package in the executor's blocks:
the evidence behind ``models/layers.py::silu``, on the CPU.

    python3 scripts/silu_rounding.py

1. XLA's bf16 logistic against candidate formulas on 200,000 bf16 inputs
   (numpy seed 0, x ~ N(0, 2)): the share of outputs equal to
   ``jax.nn.sigmoid``'s.  Rounding after each of ``exp(-x)``, ``1 + .``
   and ``1 / .`` matches; a correctly rounded sigmoid does not.
2. The executor's ops ``attn_block``, ``dense_ffn`` and ``unembed`` of
   the gpt3-24l smoke config (parameters of ``PRNGKey(3)``), port against
   JAX on the same bf16 input and output cotangent: the share of
   elements equal in the output, the input cotangent and each parameter
   gradient, with the port's SwiGLU through ``F.silu`` (one rounding)
   and through ``layers.silu`` (JAX's rounding points).
Imports the JAX package (as the tests do); needs no GPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def _bf(a):
    import ml_dtypes
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def logistic_probe() -> None:
    import jax
    import jax.numpy as jnp
    x = _bf(np.random.RandomState(0).randn(200000) * 2).astype(np.float32)
    got = np.asarray(jax.nn.sigmoid(jnp.asarray(x, jnp.bfloat16)),
                     np.float32)
    r = lambda a: _bf(a).astype(np.float32)
    e = np.exp(-x.astype(np.float64)).astype(np.float32)
    cands = {
        "1 / (1 + exp(-x)), each step rounded": r(1 / r(1 + r(e))),
        "the sigmoid rounded once": r(1 / (1 + np.exp(
            -x.astype(np.float64)))),
        "0.5 + 0.5 tanh(x / 2), each step rounded": r(0.5 + r(0.5 * r(
            np.tanh(r(0.5 * x).astype(np.float64)).astype(np.float32)))),
    }
    print("XLA's bf16 logistic on 200,000 inputs, share equal to:")
    for name, v in cands.items():
        print(f"  {name:44s} {np.mean(v == got):.5f}")


def op_shares() -> None:
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    from repro.configs import get_smoke_config as jax_smoke
    from repro.core import executor as JE
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import executor_params_from_jax, tensor_from_numpy
    from repro_torch.core import executor as TE
    from repro_torch.models import layers
    from repro_torch.tree import flatten_with_paths
    torch.set_num_threads(1)
    cfg_j, cfg_t = jax_smoke("gpt3-24l"), get_smoke_config("gpt3-24l")
    B, S, d = 2, 16, cfg_t.d_model
    pos_j = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    pos_t = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    eq = lambda a, b: float(np.mean(np.asarray(a, np.float32)
                                    == np.asarray(b, np.float32)))
    rng = np.random.RandomState(0)
    cases = []
    for op, x_scale in (("attn_block", 0.02), ("dense_ffn", 0.05),
                        ("unembed", 0.1)):
        pj = jax.tree.map(np.asarray, JE.OP_IMPLS[op]["init"](
            jax.random.PRNGKey(3), cfg_j))
        x = _bf(rng.randn(B, S, d) * x_scale)
        outj, vjp = jax.vjp(lambda p, x: JE.OP_IMPLS[op]["apply"](
            p, cfg_j, x, pos_j), jax.tree.map(jnp.asarray, pj),
            jnp.asarray(x))
        ct = _bf(rng.randn(*outj.shape) * 1e-3).astype(
            np.asarray(outj).dtype)
        gpj, gxj = vjp(jnp.asarray(ct))
        cases.append((op, pj, x, ct, outj, gxj, dict(flatten_with_paths(
            jax.tree.map(np.asarray, gpj)))))

    def shares(silu):
        saved = layers.silu
        layers.silu = silu
        try:
            for op, pj, x, ct, outj, gxj, gj in cases:
                pt = executor_params_from_jax(pj, "cpu")
                xt = tensor_from_numpy(x, "cpu").requires_grad_(True)
                out = TE.OP_IMPLS[op]["apply"](pt, cfg_t, xt, pos_t)
                paths = flatten_with_paths(pt)
                g = torch.autograd.grad(out, [xt] + [t for _, t in paths],
                                        tensor_from_numpy(ct, "cpu"))
                grads = ", ".join(f"{p} {eq(gj[p], t.float()):.4f}"
                                  for (p, _), t in zip(paths, g[1:]))
                print(f"  {op:10s} output {eq(outj, out.detach().float()):.4f}"
                      f", input cotangent {eq(gxj, g[0].float()):.4f}; "
                      f"gradients {grads}")
        finally:
            layers.silu = saved

    # ffn_apply reads ``silu`` from the module's globals at call time
    print("share of elements equal to JAX's, the port's SwiGLU through "
          "F.silu:")
    shares(F.silu)
    print("... through layers.silu (JAX's rounding points):")
    shares(layers.silu)


def main() -> int:
    logistic_probe()
    op_shares()
    return 0


if __name__ == "__main__":
    sys.exit(main())
