"""The port's ``spmd_pipeline`` (``repro_torch.core.executor``) on a real
("stage",) mesh of gloo processes on the host, against the JAX package's
``spmd_pipeline`` and against sequential loops.

The JAX side is dumped once per module by ``_jax_spmd_pipeline_dump.py``
(a process of its own, 4 host devices, a mesh of Auto axes).  The port's
side runs every 4-stage case in one spawn of 4 gloo processes and the
2-stage case in one of 2; each rank saves what it returned, its stats
and its parameters' local shapes, and the tests read them.

Tolerances, with reasons:
- ``tanh(x @ w)`` over 4 stages, float32, against JAX's ``spmd_pipeline``:
  1e-6 absolute, torch's ``tanh`` and matmul against XLA's.
- The port against its own sequential loop: bit for bit (the same ops on
  the same inputs, one torch thread); every rank returns the same bits.
- The gpt3-24l smoke layers as stages against the JAX package's
  ``layer_apply`` loop on the same parameters: 2e-5 of the output's scale
  in float32 activations, 2e-2 in bf16 (the two frameworks round bf16
  activations at different places), as the port's other layer tests.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401
from _torch_gloo import init_gloo, rendezvous  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.config import LayerSpec  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

N_STAGES = 4
HERE = os.path.dirname(os.path.abspath(__file__))


def _model_cfg():
    """``_jax_spmd_pipeline_dump.model_cfg``'s config in the port."""
    cfg = get_smoke_config("gpt3-24l")
    return dataclasses.replace(cfg, n_layers=N_STAGES,
                               period=(LayerSpec(cfg.period[0].mixer,
                                                 cfg.period[0].ffn),))


def _stacked_params(jax_dump):
    """The dump's stacked layer as the port's tree (bf16 leaves from their
    bits)."""
    bf16 = set(jax_dump["model/bf16"].tolist())
    tree = {}
    for key, a in jax_dump.items():
        if not key.startswith("model/p/"):
            continue
        path = key[len("model/p/"):]
        t = torch.from_numpy(np.array(a))
        if path in bf16:
            t = t.view(torch.bfloat16)
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


def _sharded(tree, mesh, rank):
    """Each leaf as a DTensor placed Shard(0) over the stage axis, built
    from this rank's slice only."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(tree, dict):
        return {k: _sharded(v, mesh, rank) for k, v in tree.items()}
    return DTensor.from_local(tree[rank:rank + 1].contiguous(), mesh,
                              [Shard(0)], shape=tree.shape,
                              stride=tree.stride())


def _tanh_stage(w, x):
    return torch.tanh(x @ w)


def _run_cases(rank, world, jax_dump):
    """Every case of one spawn, on this rank: {case: result}."""
    from repro_torch.core.executor import spmd_pipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import layer_apply
    mesh = make_host_mesh(world, device="cpu")
    w = torch.from_numpy(jax_dump["tanh/w"])[:world]
    xs = torch.from_numpy(jax_dump["tanh/xs"])
    res = {}

    def case(name, fn):
        try:
            res[name] = fn()
        except Exception as e:  # recorded, the test reads it
            res[name] = {"error": f"{type(e).__name__}: {e}"}

    def pipe(params, x, stage_fn=_tanh_stage):
        st = {}
        out = spmd_pipeline(stage_fn, params, x, mesh, stats=st)
        return {"out": out, "stats": st}

    def sharded_tanh():
        wd = _sharded(w, mesh, rank)
        r = pipe(wd, xs)
        r["local_shape"] = tuple(wd.to_local().shape)
        return r

    case("tanh", sharded_tanh)
    if world != N_STAGES:
        return res
    case("few_micro", lambda: pipe(w, xs[:2]))
    case("one_micro", lambda: pipe(w, xs[:1]))
    b = torch.from_numpy(
        np.random.RandomState(2).randn(N_STAGES, 16).astype(np.float32))
    case("pytree", lambda: pipe(
        _sharded({"w": w, "b": b}, mesh, rank), xs,
        lambda p, x: torch.tanh(x @ p["w"] + p["b"])))
    case("wrong_axis", lambda: pipe(w[:3], xs))

    cfg = _model_cfg()
    spec = cfg.period[0]
    stacked = _sharded(_stacked_params(jax_dump), mesh, rank)
    x = torch.from_numpy(jax_dump["model/x"])
    B, S = x.shape[1:3]
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)

    def layer(lp, h):
        return layer_apply(lp, spec, cfg, h, pos, None)[0]

    for dt in (torch.float32, torch.bfloat16):
        case(f"model_{str(dt)[6:]}", lambda dt=dt: pipe(stacked, x.to(dt),
                                                        layer))
    return res


def _worker(rank, world, rdzv, dump_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    init_gloo(rdzv, rank, world)
    try:
        with np.load(dump_path) as d:
            jax_dump = {k: d[k] for k in d.files}
        res = _run_cases(rank, world, jax_dump)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_pipe") / "pipe.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "_jax_spmd_pipeline_dump.py"),
                        out], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as d:
        return out, {k: d[k] for k in d.files}


def _spawn(world, dump_path, out_dir):
    import torch.multiprocessing as mp
    mp.spawn(_worker, args=(world, rendezvous(out_dir), dump_path,
                            str(out_dir)),
             nprocs=world, join=True)
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def ranks(jax_dump, tmp_path_factory):
    """What each of the 4 stages returned, per case."""
    return _spawn(N_STAGES, jax_dump[0], tmp_path_factory.mktemp("pipe4"))


@pytest.fixture(scope="module")
def ranks2(jax_dump, tmp_path_factory):
    return _spawn(2, jax_dump[0], tmp_path_factory.mktemp("pipe2"))


def _outs(ranks, name):
    """The case's output on every rank, which must all be the same bits."""
    outs = []
    for r in ranks:
        assert "error" not in r[name], r[name]["error"]
        outs.append(r[name]["out"])
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _sequential(w, xs, stage_fn=_tanh_stage, params_at=None):
    ref = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for i in range(w.shape[0] if params_at is None else N_STAGES):
            h = stage_fn(w[i] if params_at is None else params_at(i), h)
        ref.append(h)
    return torch.stack(ref)


def test_matches_jax_spmd_pipeline(jax_dump, ranks):
    """The JAX test's own case: 4 stages, d = 16, 6 microbatches of
    (8, 16), tanh(x @ w), float32: within 1e-6 of JAX's pipeline."""
    out = _outs(ranks, "tanh")
    exp = jax_dump[1]["tanh/out"]
    assert out.shape == exp.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), exp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case,n_micro", [("tanh", 6), ("few_micro", 2),
                                          ("one_micro", 1)])
def test_equals_its_sequential_loop_bit_for_bit(jax_dump, ranks, case,
                                                n_micro):
    """Sharded (Shard(0) DTensors) and plain stacked parameters; 6, 2
    (fewer microbatches than stages) and 1 microbatch."""
    d = jax_dump[1]
    w, xs = torch.from_numpy(d["tanh/w"]), torch.from_numpy(d["tanh/xs"])
    out = _outs(ranks, case)
    assert torch.equal(out, _sequential(w, xs[:n_micro]))
    for stage, r in enumerate(ranks):
        st = r[case]["stats"]
        assert st["stage"] == stage and st["transport"] == "direct"
        assert st["stage_calls"] == n_micro     # bubble ticks skipped
        nbytes = n_micro * 8 * 16 * 4
        assert st["bytes_sent"] == (nbytes if stage < N_STAGES - 1 else 0)
        assert st["bytes_received"] == (nbytes if stage else 0)
        assert st["bytes_broadcast"] == (nbytes if stage == N_STAGES - 1
                                         else 0)


def test_each_rank_holds_its_stage_and_every_rank_gets_the_outputs(ranks):
    """Under Shard(0) a rank holds one (1, 16, 16) slice of the (4, 16, 16)
    stack; every rank returns the last stage's (6, 8, 16) outputs."""
    for r in ranks:
        assert r["tanh"]["local_shape"] == (1, 16, 16)
        assert tuple(r["tanh"]["out"].shape) == (6, 8, 16)
    _outs(ranks, "tanh")


def test_pytree_parameters(jax_dump, ranks):
    """A stage_fn parameter tree of two tensors, both Shard(0)."""
    d = jax_dump[1]
    w, xs = torch.from_numpy(d["tanh/w"]), torch.from_numpy(d["tanh/xs"])
    b = torch.from_numpy(
        np.random.RandomState(2).randn(N_STAGES, 16).astype(np.float32))
    ref = _sequential(None, xs, lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                      params_at=lambda i: {"w": w[i], "b": b[i]})
    assert torch.equal(_outs(ranks, "pytree"), ref)


def test_two_rank_mesh(jax_dump, ranks2):
    d = jax_dump[1]
    w, xs = torch.from_numpy(d["tanh/w"]), torch.from_numpy(d["tanh/xs"])
    assert torch.equal(_outs(ranks2, "tanh"), _sequential(w[:2], xs))
    for r in ranks2:
        assert r["tanh"]["local_shape"] == (1, 16, 16)
        assert r["tanh"]["stats"]["stage_calls"] == 6


def test_leading_axis_must_match_the_mesh_axis(ranks):
    for r in ranks:
        err = r["wrong_axis"].get("error", "")
        assert err.startswith("ValueError") and "leading axis is 3" in err, \
            err


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_model_layers_as_stages_match_jax_layer_apply(jax_dump, ranks,
                                                      dtype, tol):
    """gpt3-24l smoke widened to 4 layers, one a stage, with the JAX
    package's parameters, against the JAX package's ``layer_apply`` loop;
    and bit for bit against the port's own loop."""
    d = jax_dump[1]
    out = _outs(ranks, f"model_{dtype}")
    assert str(out.dtype) == f"torch.{dtype}"
    exp = d[f"model/seq_{dtype}"]
    np.testing.assert_allclose(out.float().numpy(), exp, rtol=0,
                               atol=tol * float(np.abs(exp).max()))
    from repro_torch.models.transformer import layer_apply
    cfg = _model_cfg()
    stacked = _stacked_params(d)
    x = torch.from_numpy(d["model/x"]).to(out.dtype)
    B, S = x.shape[1:3]
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    leaf_at = dict(flatten_with_paths(stacked))
    assert all(t.shape[0] == N_STAGES for t in leaf_at.values())

    def at(i):
        return {k: {n: t[i] for n, t in v.items()} if isinstance(v, dict)
                else v[i] for k, v in stacked.items()}
    ref = _sequential(None, x, lambda lp, h: layer_apply(
        lp, cfg.period[0], cfg, h, pos, None)[0], params_at=at)
    assert torch.equal(out, ref)
