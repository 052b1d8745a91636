"""Where the port's BP gradient of one element parts from float64: the
per-op attribution behind ``test_torch_executor.py::
test_gradients_match_jax_pullback[L0.attn]``, on the CPU.

    python3 scripts/executor_grad_bisect.py [--op L0.attn] [--leaf wk]
                                            [--at 237 51]

Builds the test's clusters (gpt3-24l smoke, 3 compnodes, the JAX
package's parameters, one FP / BP pass) and captures, in the port's bf16
run, every op's input and the cotangents at its output and input.  Then,
in float64:
- the exact gradient of the element (the whole model in float64 from the
  same parameters), beside the port's and the JAX package's;
- each op's own backward error (the port's input cotangent against the
  exact VJP of that op at the port's own input and output cotangent) and
  its own forward error (the port's output against the exact op on the
  port's input), each carried to the element through the exact model:
  the contributions add up to the port's error;
- each op's local errors beside the JAX package's op on the same input
  and cotangent (max and rms against float64), to tell a less precise op
  from bf16 rounding that went another way.
Imports the JAX package (as the tests do); needs no GPU.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "tests"), str(ROOT / "src")]

F64 = None      # torch.float64, once torch is imported


def _model(params, cfg, toks, labels):
    """The gpt3-24l smoke DAG's ops in float64, exact: {k: op k as a
    function of its input}, k = 1.. in DAG order (attention and dense
    blocks, unembed, cross entropy), and the embedding output."""
    import torch
    B, S = toks.shape
    H, hd, eps = cfg.n_heads, cfg.head_dim, cfg.norm_eps
    t = lambda a: torch.tensor(np.asarray(a, np.float32), dtype=F64)
    pos = torch.arange(S, dtype=F64)
    freq = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=F64) / hd)
    ang = pos[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    def norm(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
            1 + t(w))

    def rope(x):
        a, b = x.chunk(2, -1)
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    def attn(p, w=None):
        def f(x):
            h = norm(x, p["norm"])
            q, k, v = (h @ (w if w is not None and n == "wk" else t(p["op"][n]))
                       for n in ("wq", "wk", "wv"))
            q, k, v = (z.reshape(B, S, H, hd) for z in (q, k, v))
            s = torch.einsum("bshd,bthd->bhst", rope(q), rope(k)) * hd ** -0.5
            s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)),
                            s, -1e30)
            o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
            return x + o.reshape(B, S, H * hd) @ t(p["op"]["wo"])
        return f

    def dense(p):
        def f(x):
            h = norm(x, p["norm"])
            g = torch.nn.functional.silu(h @ t(p["op"]["w_gate"]))
            return x + (g * (h @ t(p["op"]["w_up"]))) @ t(p["op"]["w_down"])
        return f

    lbl = torch.tensor(labels).long()
    return {"attn": attn, "dense": dense,
            "head": lambda x: norm(x, params["head"]["norm"]) @ t(
                params["head"]["head"]),
            "loss": lambda lg: -torch.log_softmax(lg, -1).gather(
                -1, lbl[..., None])[..., 0].mean(),
            "embed": t(params["embed"]["embed"])[torch.tensor(toks).long()]}


def main() -> int:
    global F64
    ap = argparse.ArgumentParser()
    ap.add_argument("--op", default="L0.attn")
    ap.add_argument("--leaf", default="wk")
    ap.add_argument("--at", type=int, nargs=2, default=(237, 51))
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import torch
    import test_torch_executor as T
    from repro.core import executor as JE
    from repro_torch.core import executor as TE
    F64 = torch.float64
    torch.set_num_threads(1)
    i, j = args.at

    ref = T._jax_run("gpt3-24l", 3, 1, 42, with_grads=True)
    cfg = T.get_smoke_config("gpt3-24l")
    c = T._port_cluster("gpt3-24l", 3, ref["params"])
    names = [n for n in c.dag.topo_order()
             if c.dag[n].op_type != T.PLACEHOLDER]
    cap, seen = {}, []

    def wrap(f):
        def w(params, cfg_, x, *rest, **kw):
            k = len(seen)
            seen.append(k)
            if x.is_floating_point() and x.requires_grad:
                cap[k, "x"] = x.detach().double()
                x.register_hook(lambda g, k=k: cap.__setitem__(
                    (k, "ct_in"), g.detach().double()))
            out = f(params, cfg_, x, *rest, **kw)
            if out.requires_grad and out.ndim:
                out.register_hook(lambda g, k=k: cap.__setitem__(
                    (k, "ct_out"), g.detach().double()))
            return out
        return w

    saved = {k: v["apply"] for k, v in TE.OP_IMPLS.items()}
    for k in TE.OP_IMPLS:
        TE.OP_IMPLS[k]["apply"] = wrap(saved[k])
    pos = torch.arange(T.S, dtype=torch.int32)[None].expand(T.B, T.S)
    grads = T._grads(c, torch.from_numpy(ref["toks"]),
                     torch.from_numpy(ref["labels"]), pos)
    for k in TE.OP_IMPLS:
        TE.OP_IMPLS[k]["apply"] = saved[k]
    port = grads[args.op]["op"][args.leaf].double()
    jaxg = float(ref["grads"][args.op]["op"][args.leaf][i, j])

    P = ref["params"]
    m = _model(P, cfg, ref["toks"], ref["labels"])
    kinds = {n: c.dag[n].op for n in names}
    target = names.index(args.op)
    leaf0 = torch.tensor(np.asarray(P[args.op]["op"][args.leaf], np.float32),
                         dtype=F64)

    def fn(k, w=None):
        kind = kinds[names[k]]
        if kind in ("attn_block",):
            return m["attn"](P[names[k]], w if k == target else None)
        if kind == "dense_ffn":
            return m["dense"](P[names[k]])
        return {"unembed": m["head"], "cross_entropy": m["loss"]}[kind]

    def grad_with(inject):
        w = leaf0.clone().requires_grad_(True)
        h = m["embed"]
        for k in range(1, len(names)):
            h = fn(k, w)(h)
            if k + 1 in inject:
                h = h + inject[k + 1]
        (g,) = torch.autograd.grad(h, [w])
        return g

    exact = grad_with({})
    total = float(port[i, j] - exact[i, j])
    print(f"{args.op}/{args.leaf}[{i}, {j}]: port {float(port[i, j]):.6e}, "
          f"JAX {jaxg:.6e}, float64 {float(exact[i, j]):.6e}; port error "
          f"{total:+.4e}, JAX error {jaxg - float(exact[i, j]):+.4e}")

    # the exact forward, each boundary kept, for carrying errors back
    w = leaf0.clone().requires_grad_(True)
    xs = {1: m["embed"].clone().requires_grad_(True)}
    for k in range(1, len(names) - 1):
        xs[k + 1] = fn(k, w)(xs[k])
    xs_loss = fn(len(names) - 1)(xs[len(names) - 1])
    del xs_loss

    def carried(k, e):
        (g,) = torch.autograd.grad(xs[k], [w], grad_outputs=e,
                                   retain_graph=True)
        return float(g[i, j])

    back, fwd = 0.0, 0.0
    rows = []
    for k in range(target, len(names)):
        x = cap[k, "x"].clone().requires_grad_(True)
        leaf = leaf0.clone().requires_grad_(True)
        out = fn(k, leaf)(x)
        ct_out = (torch.ones((), dtype=F64) if k == len(names) - 1
                  else cap[k, "ct_out"])
        wrt = [x, leaf] if k == target else [x]
        gs = torch.autograd.grad(out, wrt, grad_outputs=ct_out,
                                 allow_unused=True)
        if k == target:
            own_b = float(port[i, j] - gs[1][i, j])
        else:
            own_b = carried(k, cap[k, "ct_in"] - gs[0])
        own_f = 0.0
        if k < len(names) - 1:
            f = cap[k + 1, "x"] - out.detach()
            own_f = float((grad_with({k + 1: f}) - exact)[i, j])
        back += own_b
        fwd += own_f
        rows.append((names[k], own_f, own_b))
    print("per op, its own rounding carried to the element through the "
          "exact model (forward output | backward):")
    for name, f_, b_ in rows:
        print(f"  {name:10s} {f_:+.4e} | {b_:+.4e}")
    print(f"  sum {fwd + back:+.4e} of the error {total:+.4e} "
          f"(forward {fwd:+.4e}, backward {back:+.4e})")

    # the same ops of the JAX package on the port's inputs and cotangents
    posj = jnp.broadcast_to(jnp.arange(T.S, dtype=jnp.int32)[None],
                            (T.B, T.S))
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    print("per op on the same input and output cotangent, against float64 "
          "(max, rms): forward output port | JAX; input cotangent "
          "port | JAX")
    for k in range(target, len(names) - 1):
        name = names[k]
        jp = jax.tree.map(jnp.asarray, P[name])
        xj = jnp.asarray(cap[k, "x"].float().numpy()).astype(jnp.bfloat16)
        outj, vjp = jax.vjp(lambda x: JE.OP_IMPLS[kinds[name]]["apply"](
            jp, cfg, x, posj), xj)
        (ctj,) = vjp(jnp.asarray(cap[k, "ct_out"].float().numpy()).astype(
            outj.dtype))
        x = cap[k, "x"].clone().requires_grad_(True)
        out = fn(k)(x)
        (ct,) = torch.autograd.grad(out, [x], grad_outputs=cap[k, "ct_out"])
        out, ct = out.detach().numpy(), ct.numpy()
        fp = cap[k + 1, "x"].numpy() - out
        fj = np.asarray(outj, np.float64) - out
        bp = cap[k, "ct_in"].numpy() - ct
        bj = np.asarray(ctj, np.float64) - ct
        print(f"  {name:10s} {np.abs(fp).max():.3e} {rms(fp):.3e} | "
              f"{np.abs(fj).max():.3e} {rms(fj):.3e};  "
              f"{np.abs(bp).max():.3e} {rms(bp):.3e} | "
              f"{np.abs(bj).max():.3e} {rms(bj):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
