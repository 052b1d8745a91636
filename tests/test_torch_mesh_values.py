"""The port's sharded program computes the served one: the model's DTensor
branches (attention and the scans on each rank's shard by
``hints.LAYOUTS``, ``layers._masked_put_sharded``, ``_moe_sharded`` /
``_experts_sharded``, ``moe_ep.moe_apply_ep``,
``transformer._lookup_sharded``, ``loss._body_sharded``) run on a real
2x2 (data, model) mesh of four gloo processes on the host, with the
dry-run's argument layouts (``shardings.arg_shardings``) and hints
(``default_hint_rule``, ``moe_groups`` / ``moe_ep`` / ``decode_tp`` as
``launch/dryrun.py`` sets them), and are held to the plain one-process
path of the same smoke parameters and inputs:

- training: ``loss_fn``'s loss, cross entropy, load-balance loss and
  token accuracy, and the gradient of every parameter (MoE configs with
  expert parallelism, at capacity factor 8 where nothing is dropped, and
  with the grouped dispatch, G = 2 on both sides);
- the dense prefill step (an 8-token prompt) and two dense decode steps
  (one slot idle on the second): last-token logits and every cache leaf;
- the paged serving-engine step: an 8-token prefill chunk and two
  decode ticks (one slot idle on the second): greedy tokens and every
  pool leaf.

Activations are float32, so the two programs differ by summation order
only (partial sums of split contractions are added across ranks): logits,
caches and losses within 1e-4 of their largest element, gradients within
1e-4 of each leaf's largest element, greedy tokens and accuracy equal.
With expert parallelism the token vectors and their gradients cross the
all-to-alls and the strip gather in bf16 in every MoE layer, forward and
backward: there the bound is two bf16 ulps (2^-7) of the largest element.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401
from _torch_gloo import init_gloo, rendezvous  # noqa: E402

from repro_torch.configs import InputShape, get_smoke_config  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

# "qwen3-8b:mqa" is qwen3-8b's smoke config with one kv head: its caches
# split the head dim over the model axis (one head cannot), so its decode
# attention runs in the "dims" layout (scores all-reduced)
ARCHS = ["qwen3-8b", "qwen3-8b:mqa", "qwen3-moe-235b-a22b", "rwkv6-7b",
         "jamba-1.5-large-398b", "deepseek-v3-671b", "gemma3-12b"]
B, PROMPT, CACHE, PAGE = 4, 8, 16, 4
TOL, TOL_EP = 1e-4, 2.0 ** -7


def _cfg(arch, moe_ep):
    """The smoke config; with expert parallelism at capacity factor 8,
    where neither path drops an assignment (EP's own caps are held to the
    JAX package's in ``test_torch_moe_ep.py``)."""
    name, _, variant = arch.partition(":")
    cfg = get_smoke_config(name)
    if variant == "mqa":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if moe_ep and cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def _params(cfg):
    """The smoke parameters in float32 (activations follow the embedding's
    dtype)."""
    from repro_torch.models.transformer import init_params
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    init_params(0, cfg, device="cpu"))


def _inputs(cfg):
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (B, PROMPT + 2)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    labels[0, :2] = -1                                   # ignored labels
    return torch.from_numpy(tokens), torch.from_numpy(labels)


def _ticks():
    """(tokens slice, positions) of the prefill and the two decodes; slot
    3 idle (position -1) on the last."""
    pos = [torch.arange(PROMPT, dtype=torch.int32)[None].expand(B, -1),
           torch.full((B, 1), PROMPT, dtype=torch.int32),
           torch.full((B, 1), PROMPT + 1, dtype=torch.int32)]
    pos[2] = pos[2].clone()
    pos[2][3] = -1
    return [(slice(0, PROMPT), pos[0]), (slice(PROMPT, PROMPT + 1), pos[1]),
            (slice(PROMPT + 1, PROMPT + 2), pos[2])]


def _table():
    n_cols = CACHE // PAGE
    return torch.arange(B * n_cols, dtype=torch.int32).reshape(B, n_cols)


def _run(cfg, params, *, mesh=None, moe_ep=False):
    """Every phase's results, on the mesh (DTensors in, full tensors out)
    or plain."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.shardings import (arg_shardings,
                                              default_hint_rule,
                                              to_placements)
    from repro_torch.models import hints
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve.engine import (make_decode_step, make_engine_step,
                                          make_prefill_step)
    from repro_torch.train.step import loss_fn

    tokens, labels = _inputs(cfg)
    nb = B * CACHE // PAGE
    full = (lambda t: t.full_tensor() if isinstance(t, DTensor) else t)

    def placed(kind, **trees):
        """(trees as DTensors by the dry-run's layouts, hint context)."""
        groups = 2 if kind == "train" else 1      # the data shards
        if mesh is None:
            return trees, hints.use_hints(None, lambda k, s: None,
                                          moe_groups=groups)
        shape = InputShape(kind, PROMPT, B, kind)
        decode_tp = kind == "decode"
        sh = arg_shardings({"shape": shape, "opt_state": {}, **trees}, mesh,
                           decode_tp=decode_tp)
        out = {g: tree_map(lambda t, s: distribute_tensor(
                   t.detach().clone(), mesh, to_placements(s, mesh)),
                   trees[g], sh[g]) for g in trees}
        rule = default_hint_rule(mesh, batch_size=B, decode_tp=decode_tp)
        return out, hints.use_hints(mesh, rule, moe_groups=groups,
                                    moe_ep=moe_ep and kind == "train")

    res = {}
    # ---- training: loss, metrics, gradients ---------------------------
    batch = {"tokens": tokens[:, :PROMPT], "labels": labels}
    args, ctx = placed("train", params=params, batch=batch)
    p = args["params"]
    grads_of = [t for _, t in flatten_with_paths(p)
                if t.is_floating_point()]
    for t in grads_of:
        t.requires_grad_(True)
    with ctx, implicit_replication():
        loss, metrics = loss_fn(p, cfg, args["batch"], remat=False)
        gs = torch.autograd.grad(loss, grads_of, allow_unused=True)
    res["loss"] = full(loss).detach()
    for k, v in metrics.items():
        res[f"metric/{k}"] = full(v).detach()
    for (path, t), g in zip([(n, t) for n, t in flatten_with_paths(p)
                             if t.is_floating_point()], gs):
        res[f"grad/{path}"] = (torch.zeros(t.shape) if g is None
                               else full(g).detach())
    for t in grads_of:
        t.requires_grad_(False)

    # ---- dense prefill + decode steps -----------------------------------
    caches = init_cache(cfg, B, CACHE, dtype=torch.float32, device="cpu")
    for i, (cols, pos) in enumerate(_ticks()):
        kind = "prefill" if i == 0 else "decode"
        args, ctx = placed(kind, params=params, caches=caches,
                           batch={"tokens": tokens[:, cols]},
                           positions=pos)
        step = (make_prefill_step if i == 0 else make_decode_step)(cfg)
        with torch.no_grad(), ctx, implicit_replication():
            logits, new = step(args["params"], args["caches"],
                               args["batch"], args["positions"])
        res[f"dense/logits{i}"] = full(logits)
        caches = tree_map(full, new)
    for path, t in flatten_with_paths(caches):
        res[f"dense/cache/{path}"] = t

    # ---- the paged serving-engine step ----------------------------------
    caches = init_cache(cfg, B, CACHE, dtype=torch.float32, paged=True,
                        page_size=PAGE, num_blocks=nb, num_blocks_swa=nb,
                        device="cpu")
    seen = torch.zeros((B, cfg.vocab_size), dtype=torch.bool)
    step = make_engine_step(cfg, paged=True)
    for i, (cols, pos) in enumerate(_ticks()):
        kind = "prefill" if i == 0 else "decode"
        args, ctx = placed(kind, params=params, caches=caches,
                           batch={"tokens": tokens[:, cols]},
                           positions=pos, table=_table(),
                           sampling={"seen": seen})
        with torch.no_grad(), ctx, implicit_replication():
            nxt, new, _ = step(
                args["params"], args["caches"], args["sampling"]["seen"],
                args["batch"]["tokens"], args["positions"], args["table"],
                np.zeros((B, 2), np.uint32), np.zeros(B, np.float32),
                np.ones(B, np.float32), np.zeros(B, np.int32),
                np.ones(B, np.float32))
        res[f"paged/tokens{i}"] = full(nxt)
        caches = tree_map(full, new)
    for path, t in flatten_with_paths(caches):
        res[f"paged/cache/{path}"] = t
    return res


def _worker(rank, world, rdzv, arch, moe_ep, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    init_gloo(rdzv, rank, world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = _cfg(arch, moe_ep)
        res = _run(cfg, _params(cfg), mesh=mesh, moe_ep=moe_ep)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "mesh.pt"))
    finally:
        dist.destroy_process_group()


def _cases():
    out = []
    for arch in ARCHS:
        moe = _cfg(arch, False).n_experts > 0
        out += [(arch, True)] + ([(arch, False)] if moe else [])
    return out


@pytest.mark.parametrize("arch,moe_ep", _cases())
def test_sharded_program_matches_plain(arch, moe_ep, tmp_path):
    import torch.multiprocessing as mp
    mp.spawn(_worker, args=(4, rendezvous(tmp_path), arch, moe_ep,
                            str(tmp_path)),
             nprocs=4, join=True)
    got = torch.load(tmp_path / "mesh.pt")
    cfg = _cfg(arch, moe_ep)
    ref = _run(cfg, _params(cfg))
    assert got.keys() == ref.keys()
    tol = TOL_EP if moe_ep and cfg.n_experts else TOL
    bad = []
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if not r.is_floating_point() or k == "metric/acc":
            if not torch.equal(g, r):
                bad.append((k, "not equal"))
            continue
        err = (g - r).abs().max().item()
        if err > tol * r.abs().max().item():
            bad.append((k, err, r.abs().max().item()))
    assert not bad, "\n".join(map(str, bad))
