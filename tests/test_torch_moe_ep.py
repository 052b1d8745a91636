"""The port's grouped MoE dispatch and expert-parallel MoE
(``repro_torch.models.layers.moe_apply`` with the ``moe_groups`` hint,
``repro_torch.models.moe_ep.moe_apply_ep``).

Grouped dispatch: with ``moe_groups`` G in {2, 4} (a hint context with no
mesh), the port's ``moe_apply`` against the JAX package's ``moe_apply``
under ``use_hints(None, ..., moe_groups=G)`` on the qwen3-moe and
deepseek-v3 smoke configs, parameters carried across by ``convert.py``.
In float32 activations the two differ by summation order only: outputs
within 2e-5 of their largest element, the load-balance loss within 1e-6
relative.  A capacity factor of 0.5 makes every group drop
assignments, so the groups' capacities are exercised (the grouped output
differs from one group's).

Expert parallelism: ``moe_apply_ep`` on a real 2x2 (data, model) mesh of
four gloo processes on the host, reached through ``moe_apply`` under the
dry-run's hints.
- Against the JAX package's ``moe_apply_ep`` on a 2x2 mesh of four host
  devices (``_jax_moe_ep_dump.py``, a process of its own), from the same
  float32 parameters and input, at the smoke configs' own capacity
  factor (1.25) and at 0.5, where both caps (the send buffer per
  destination rank and the local buffer per expert) drop assignments:
  output within one bf16 ulp (2^-8) of its largest element (token vectors
  cross the all-to-alls and the strip gather in bf16, so an f32
  difference in the last bit may round to the other bf16 neighbour), the
  load-balance loss within 1e-6 relative, and the gradients of
  ``mean(out**2)`` and of the load-balance loss, each alone, with respect
  to every parameter and to x within one bf16 ulp of each leaf's largest
  element (the same bf16 crossings, backwards; the experts' gradients of
  the load-balance loss exactly 0).
- Against the one-device ``moe_apply`` of the same parameters and bf16
  input (capacity factor 8: nothing dropped, as the JAX package's own EP
  test): output within 1e-2, aux loss within 1e-6, and every parameter's
  gradient of ``mean(out**2)`` within 1e-3.
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import hints as JH  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import hints as TH  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ARCHS = ["qwen3-moe-235b-a22b", "deepseek-v3-671b"]
BF16_ULP = 2.0 ** -8      # one bf16 ulp, relative


def _no_rule(kind, shape):
    return None


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_moe_matches_jax(arch, groups):
    # a capacity factor below 1 makes every group drop assignments
    cfg = dataclasses.replace(jax_smoke(arch), capacity_factor=0.5)
    tcfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=0.5)
    jp = JL.moe_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(1).randn(4, 8, cfg.d_model).astype(np.float32)
    with JH.use_hints(None, _no_rule, moe_groups=groups):
        ref, aux_ref = JL.moe_apply(jp, jnp.asarray(x), cfg)
    with TH.use_hints(None, _no_rule, moe_groups=groups):
        out, aux = TL.moe_apply(tp, torch.from_numpy(x), tcfg)
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)
    # per-group capacity drops other assignments than one group's would
    with TH.use_hints(None, _no_rule, moe_groups=1):
        whole, _ = TL.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert not torch.equal(whole, out)


def test_no_hint_context_is_the_one_group_path():
    """Without a context the hints are inert: ``constrain`` returns its
    argument itself, and ``moe_apply`` is the G = 1 path bit for bit."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    x = torch.randn(2, 8, cfg.d_model)
    assert TH.constrain(x, "moe_tokens") is x
    assert TH.get_mesh() is None and TH.get_extra("moe_groups", 1) == 1
    p = TL.moe_init(torch.Generator().manual_seed(0), cfg)
    a, _ = TL.moe_apply(p, x, cfg)
    with TH.use_hints(None, _no_rule, moe_groups=1):
        b, _ = TL.moe_apply(p, x, cfg)
    assert torch.equal(a, b)


def _ep_worker(rank, world, rdzv, arch, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.shardings import default_hint_rule
    torch.set_num_threads(1)
    init_gloo(rdzv, rank, world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=8.0)
        p = TL.moe_init(torch.Generator().manual_seed(0), cfg)
        x = torch.randn((4, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).to(
                            torch.bfloat16)
        R = Replicate()
        layout = {"router": [R, R], "w_gate": [R, Shard(0)],
                  "w_up": [R, Shard(0)], "w_down": [R, Shard(0)]}

        def dist_tree(tree, path=()):
            if isinstance(tree, dict):
                return {k: dist_tree(v, path + (k,)) for k, v in tree.items()}
            pl = layout.get(path[-1], [R, R]) if len(path) == 1 else [R, R]
            return distribute_tensor(tree.detach().clone(), mesh,
                                     pl).requires_grad_(True)
        dp = dist_tree(p)
        dx = distribute_tensor(x, mesh, [Shard(0), R])
        rule = default_hint_rule(mesh, batch_size=4)
        with TH.use_hints(mesh, rule, moe_ep=True, moe_groups=2):
            out, aux = TL.moe_apply(dp, dx, cfg)
        (out.float() ** 2).mean().full_tensor().backward()
        full_out = out.full_tensor()
        grads = {}
        for k, v in dp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    grads[f"{k}/{kk}"] = vv.grad.full_tensor()
            else:
                grads[k] = v.grad.full_tensor()
        if rank == 0:
            torch.save({"out": full_out, "aux": aux.full_tensor().detach(),
                        "grads": grads}, os.path.join(out_dir, "ep.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_ep_matches_one_device(arch, tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_ep_worker, args=(4, rendezvous(tmp_path), arch,
                               str(tmp_path)),
             nprocs=4, join=True)
    got = torch.load(tmp_path / "ep.pt")
    cfg = dataclasses.replace(get_smoke_config(arch), capacity_factor=8.0)
    p = TL.moe_init(torch.Generator().manual_seed(0), cfg)
    for t in _leaves(p):
        t.requires_grad_(True)
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
                        torch.bfloat16)
    ref, aux = TL.moe_apply(p, x, cfg)
    (ref.float() ** 2).mean().backward()
    err = (got["out"].float() - ref.float()).abs().max().item()
    assert err < 1e-2, err
    assert abs(float(got["aux"]) - float(aux.detach())) < 1e-6
    ref_grads = {}
    for k, v in p.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                ref_grads[f"{k}/{kk}"] = vv.grad
        else:
            ref_grads[k] = v.grad
    assert got["grads"].keys() == ref_grads.keys()
    for k, g in got["grads"].items():
        gerr = (g.float() - ref_grads[k].float()).abs().max().item()
        assert gerr < 1e-3, (k, gerr)


def _jax_ep_cases():
    out = []
    for arch in ARCHS:
        own = get_smoke_config(arch).capacity_factor
        out += [f"{arch}:{own}", f"{arch}:0.5"]
    return out


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """The JAX package's EP runs of every case (``_jax_moe_ep_dump.py``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = str(tmp_path_factory.mktemp("jax_ep") / "ep.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "..", "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(here, "_jax_moe_ep_dump.py"), out,
                        *_jax_ep_cases()],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


def _case_tree(dump, prefix):
    """{leaf path: array} under ``prefix`` as a nested dict."""
    tree = {}
    for k, v in dump.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _ep_jax_worker(rank, world, rdzv, case, params, x, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.shardings import default_hint_rule
    torch.set_num_threads(1)
    init_gloo(rdzv, rank, world)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                               "model"))
        arch, cf = case.split(":")
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  capacity_factor=float(cf))
        R = Replicate()
        experts = {"w_gate", "w_up", "w_down"}
        flat = _flat(params)
        dp = {k: distribute_tensor(torch.from_numpy(v), mesh,
                                   [R, Shard(0)] if k in experts else [R, R]
                                   ).requires_grad_(True)
              for k, v in flat.items()}
        tree = _case_tree({f"p/{k}": v for k, v in dp.items()}, "p/")
        dx = distribute_tensor(torch.from_numpy(x), mesh,
                               [Shard(0), R]).requires_grad_(True)
        rule = default_hint_rule(mesh, batch_size=x.shape[0])
        with TH.use_hints(mesh, rule, moe_ep=True):
            out, aux = TL.moe_apply(tree, dx, cfg)
        # the losses of the whole output, replicated on every rank
        losses = {"out": (out.float() ** 2).mean().full_tensor(),
                  "aux": aux.full_tensor()}
        inputs = {"x": dx, **dp}
        res = {"out": out.full_tensor().detach(),
               "aux": aux.full_tensor().detach()}
        for name, loss in losses.items():
            gs = torch.autograd.grad(loss, list(inputs.values()),
                                     retain_graph=True, allow_unused=True)
            res[f"grads_{name}"] = {
                k: (g.full_tensor() if g is not None
                    else torch.zeros(inputs[k].shape))
                for k, g in zip(inputs, gs)}
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "ep.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", _jax_ep_cases())
def test_moe_apply_ep_matches_jax(jax_ep, case, tmp_path):
    import torch.multiprocessing as mp
    params = _case_tree(jax_ep, f"{case}/params/")
    x = jax_ep[f"{case}/x"]
    mp.spawn(_ep_jax_worker, args=(4, rendezvous(tmp_path), case, params,
                                   x, str(tmp_path)), nprocs=4, join=True)
    got = torch.load(tmp_path / "ep.pt")
    ref = jax_ep[f"{case}/out"]
    err = np.abs(got["out"].numpy() - ref).max()
    assert err <= BF16_ULP * np.abs(ref).max(), (err, np.abs(ref).max())
    np.testing.assert_allclose(float(got["aux"]), float(jax_ep[f"{case}/aux"]),
                               rtol=1e-6)
    for name in ("out", "aux"):
        refs = _flat(_case_tree(jax_ep, f"{case}/grads_{name}/"))
        mine = got[f"grads_{name}"]
        assert mine.keys() == refs.keys()
        for k, g in mine.items():
            gerr = np.abs(g.numpy() - refs[k]).max()
            assert gerr <= BF16_ULP * np.abs(refs[k]).max(), (name, k, gerr)
    if case.endswith(":0.5"):
        # the caps bind: the output is not the one at the config's own
        # capacity factor, where nothing is dropped
        arch = case.split(":")[0]
        own = jax_ep[f"{arch}:{get_smoke_config(arch).capacity_factor}/out"]
        assert not np.array_equal(ref, own)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
