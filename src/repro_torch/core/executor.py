"""Execution plane (paper §3.1 P3–P6, §3.6) in PyTorch: the counterpart of
``repro.core.executor``, interpreting IR-plane sub-DAGs with PyTorch and
autograd as the ML engine.

* ``OP_IMPLS``: the op vocabulary — each op id maps to (init, apply).
  New ops plug in through ``register_op`` (P5/P6 task universality).
* ``SubDagExecutor``: one compnode's runtime.  FP runs the sub-DAG with
  autograd recording (where JAX captures a ``jax.vjp`` pullback); BP
  takes the cotangents arriving from user compnodes, runs
  ``torch.autograd.grad`` and sends cotangents to producer compnodes (the
  paper's BP-task message passing, reversed FP edges); Update applies SGD
  in place to the parametric ops it hosts.
* ``LocalCluster``: wires executors together through a ``Bus`` that
  accounts every transferred byte (validating the DAG cut-size model).
* ``spmd_pipeline``: the production mapping — the same staged execution
  as a GPipe pipeline over one axis of a ``DeviceMesh``, one process per
  stage, activations passed by point-to-point sends.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.dag import DAG, LOSS, PLACEHOLDER
from repro_torch.models import ssm
from repro_torch.models.layers import (attn_apply, attn_init, embed_init,
                                       ffn_apply, ffn_init, moe_apply,
                                       moe_init, rmsnorm, rmsnorm_init)
from repro_torch.tree import flatten_with_paths, leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# Op vocabulary (the IR-plane/execution-plane contract)
#
# init(gen, cfg, device) -> params;  apply(params, cfg, *args, positions,
# use_kernel=False) -> output.  ``use_kernel`` sends the attention blocks
# through the flash kernels (forward and backward); the
# Mamba and RWKV blocks keep their plain scans, whose kernels have no
# backward yet.
# ---------------------------------------------------------------------------

def _res_block(mixer_apply):
    def apply(params, cfg, x, positions, use_kernel=False):
        h = rmsnorm(x, params["norm"], cfg.norm_eps)
        h = mixer_apply(params, cfg, h, positions, use_kernel)
        return x + h
    return apply


def _attn(params, cfg, h, positions, use_kernel, window=0):
    out, _ = attn_apply(params["op"], h, cfg, positions=positions,
                        window=window, use_kernel=use_kernel)
    return out


def _swa(params, cfg, h, positions, use_kernel):
    return _attn(params, cfg, h, positions, use_kernel,
                 window=cfg.sliding_window)


def _mamba(params, cfg, h, positions, use_kernel):
    out, _ = ssm.mamba_apply(params["op"], h, cfg)
    return out


def _rwkv(params, cfg, h, positions, use_kernel):
    out, _ = ssm.rwkv_apply(params["op"], h, cfg)
    return out


def _dense_ffn(params, cfg, h, positions, use_kernel):
    return ffn_apply(params["op"], h)


def _moe_ffn(params, cfg, h, positions, use_kernel):
    out, _aux = moe_apply(params["op"], h, cfg)   # aux: not in the DAG's loss
    return out


_MIXER_INITS = {
    "attn_block": attn_init, "swa_block": attn_init,
    "mamba_block": ssm.mamba_init, "rwkv_block": ssm.rwkv_init,
    "dense_ffn": ffn_init, "moe_ffn": moe_init,
}

OP_IMPLS: Dict[str, dict] = {}


def register_op(op_id: str, init: Callable, apply: Callable) -> None:
    """``init(gen, cfg, device)`` draws the op's parameters (a dict of
    tensors, ``{}`` for none); ``apply(params, cfg, *args, positions,
    use_kernel=False)`` computes its output from its DAG args."""
    OP_IMPLS[op_id] = {"init": init, "apply": apply}


def _block_init(mixer_init):
    def init(gen, cfg, device):
        return {"norm": rmsnorm_init(cfg.d_model, device=device),
                "op": mixer_init(gen, cfg, device=device)}
    return init


for _op, _fn in [("attn_block", _attn), ("swa_block", _swa),
                 ("mamba_block", _mamba), ("rwkv_block", _rwkv),
                 ("dense_ffn", _dense_ffn), ("moe_ffn", _moe_ffn)]:
    register_op(_op, _block_init(_MIXER_INITS[_op]), _res_block(_fn))

register_op(
    "embedding",
    lambda gen, cfg, device: {"embed": embed_init(gen, cfg.vocab_size,
                                                  cfg.d_model, device=device)},
    lambda p, cfg, tokens, positions, use_kernel=False:
        p["embed"][tokens.long()])


def _unembed(p, cfg, x, positions, use_kernel=False):
    return (rmsnorm(x, p["norm"], cfg.norm_eps)
            @ p["head"].to(x.dtype)).float()


register_op(
    "unembed",
    lambda gen, cfg, device: {"norm": rmsnorm_init(cfg.d_model, device=device),
                              "head": embed_init(gen, cfg.d_model,
                                                 cfg.vocab_size,
                                                 device=device)},
    _unembed)


def _xent(p, cfg, logits, labels, positions, use_kernel=False):
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return nll.mean()


register_op("cross_entropy", lambda gen, cfg, device: {}, _xent)


# ---------------------------------------------------------------------------
# Message bus with byte accounting (the decentralized communicator stand-in)
# ---------------------------------------------------------------------------

class Bus:
    def __init__(self):
        self.mailboxes: Dict[int, Dict[str, torch.Tensor]] = {}
        self.bytes_sent: Dict[Tuple[int, int], float] = {}

    def send(self, src: int, dst: int, key: str, value: torch.Tensor) -> None:
        self.mailboxes.setdefault(dst, {})[key] = value
        nbytes = value.numel() * value.element_size()
        self.bytes_sent[(src, dst)] = self.bytes_sent.get((src, dst), 0.0) + nbytes

    def recv(self, dst: int, key: str) -> torch.Tensor:
        box = self.mailboxes.get(dst)
        if not box or key not in box:
            raise KeyError(
                f"Bus.recv: no message {key!r} in mailbox of dst={dst} "
                f"(available keys: {sorted(box) if box else []}) — "
                f"a DAG cut is mis-scheduled or the producer never sent")
        return box.pop(key)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_sent.values())


def _no_cotangent(t: torch.Tensor) -> torch.Tensor:
    """The BP message for an integer input (tokens, labels): it has no
    cotangent, so an empty tensor goes back under the usual key, 0 bytes
    on the Bus, as JAX's ``float0`` cotangent does."""
    return torch.empty((0,), dtype=torch.float32, device=t.device)


# ---------------------------------------------------------------------------
# Sub-DAG executor: FP / BP / Update tasks (paper §3.6)
# ---------------------------------------------------------------------------

class SubDagExecutor:
    """One compnode's runtime.  ``gen(name)`` gives each hosted op the
    generator its parameters are drawn from.  Floating parameters are
    leaves that require grad."""

    def __init__(self, compnode_id: int, dag: DAG, op_names: Sequence[str],
                 cfg, gen: Callable[[str], torch.Generator], *,
                 device: torch.device,
                 use_kernel: bool = False):
        self.compnode_id = compnode_id
        self.dag = dag
        self.op_names = list(op_names)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.params: Dict[str, dict] = {}
        for name in self.op_names:
            node = dag[name]
            if node.op in OP_IMPLS:
                self.params[name] = OP_IMPLS[node.op]["init"](gen(name), cfg,
                                                              device)
        for _, t in flatten_with_paths(self.params):
            if t.is_floating_point():
                t.requires_grad_(True)
        self._out_keys: List[str] = []
        self._saved = None

    def fp(self, bus: Bus, assignment: Dict[str, int],
           placeholders: Dict[str, torch.Tensor], positions: torch.Tensor,
           want: Optional[str] = None, *, record: bool = True
           ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """FP task: pull outer-required data from the bus, execute, push
        outwards data.  With ``record`` autograd keeps what the BP task
        needs (inference passes False).  Returns (loss, wanted-op value)."""
        my = self.compnode_id
        mine = set(self.op_names)
        ext_needed = sorted({a for n in self.op_names for a in self.dag[n].args
                             if a not in mine})
        ext_inputs = {}
        for a in ext_needed:
            t = bus.recv(my, f"fp/{a}")
            if record and t.is_floating_point():
                t = t.detach().requires_grad_(True)
            ext_inputs[a] = t
        self._out_keys = sorted({
            n for n in self.op_names
            if any(assignment[u] != my for u in self.dag.users(n))})

        values: Dict[str, torch.Tensor] = dict(ext_inputs)
        values.update(placeholders)
        loss = None
        with torch.set_grad_enabled(record):
            for name in self.op_names:
                node = self.dag[name]
                if node.op_type == PLACEHOLDER:
                    continue
                args = [values[a] for a in node.args]
                out = OP_IMPLS[node.op]["apply"](
                    self.params.get(name, {}), self.cfg, *args, positions,
                    use_kernel=self.use_kernel)
                values[name] = out
                if node.op_type == LOSS:
                    loss = out
        outs = {k: values[k] for k in self._out_keys}
        wanted = values.get(want) if want else None
        self._saved = (outs, loss, ext_inputs) if record else None
        for name, val in outs.items():
            for u in self.dag.users(name):
                dst = assignment[u]
                if dst != my:
                    bus.send(my, dst, f"fp/{name}", val.detach())
        if loss is not None:
            loss = loss.detach()
        if wanted is not None:
            wanted = wanted.detach()
        return loss, wanted

    def bp(self, bus: Bus, assignment: Dict[str, int],
           loss_cotangent: float = 1.0) -> Dict[str, dict]:
        """BP task: assemble cotangents for every sent output (from user
        compnodes, summed in sorted peer order), pull back, send
        cotangents for external inputs to their producers.  Returns the
        parameter gradients of hosted ops (None where an op's output does
        not reach what this sub-DAG sends or computes)."""
        my = self.compnode_id
        outs, loss, ext_inputs = self._saved
        self._saved = None
        roots, cts = [], []
        for name in self._out_keys:
            ct = None
            remote_peers = {assignment[u] for u in self.dag.users(name)} - {my}
            for peer in sorted(remote_peers):
                piece = bus.recv(my, f"bp/{name}/{peer}")
                ct = piece if ct is None else ct + piece
            if outs[name].requires_grad:
                roots.append(outs[name])
                cts.append(ct)
        if loss is not None:
            roots.append(loss)
            cts.append(torch.tensor(loss_cotangent, dtype=torch.float32,
                                    device=loss.device))
        paths = flatten_with_paths(self.params)
        wrt = [t for _, t in paths if t.requires_grad]
        ext_diff = [a for a, t in ext_inputs.items() if t.requires_grad]
        wrt += [ext_inputs[a] for a in ext_diff]
        grads = (torch.autograd.grad(roots, wrt, cts, allow_unused=True)
                 if roots and wrt else [None] * len(wrt))
        n_params = len(wrt) - len(ext_diff)
        ext_ct = dict(zip(ext_diff, grads[n_params:]))
        for name, t in ext_inputs.items():
            if name in ext_ct:
                ct = ext_ct[name]
                if ct is None:
                    ct = torch.zeros_like(t)
            else:
                ct = _no_cotangent(t)
            bus.send(my, assignment[name], f"bp/{name}/{my}", ct)
        it = iter(grads[:n_params])
        return unflatten(self.params, iter([next(it) if t.requires_grad
                                            else None for _, t in paths]))

    def update(self, grads: Dict[str, dict], lr: float = 1e-3) -> None:
        """Update task: plain SGD on hosted parametric ops, in place.  As
        in the JAX version, ``lr`` is rounded to each parameter's dtype
        before the multiply: ``p - lr * g`` in bf16 for bf16 params."""
        with torch.no_grad():
            for (_, p), (_, g) in zip(flatten_with_paths(self.params),
                                      flatten_with_paths(grads)):
                if g is None:
                    continue
                step = torch.tensor(lr, dtype=p.dtype, device=p.device)
                p.sub_(step * g.to(p.dtype))


class LocalCluster:
    """All compnode executors in one process, wired via a byte-accounting
    bus — the decentralized system in miniature.

    ``seed`` seeds each op's own generator by the op's position in the
    DAG, so any partition of the DAG draws the same parameters.  Runs on
    ``cuda`` unless ``device="cpu"`` is given.  ``use_kernel`` sends the
    attention blocks through the flash kernel."""

    def __init__(self, dag: DAG, parts: Sequence[Sequence[str]], cfg,
                 seed: int, peer_ids: Optional[Sequence[int]] = None, *,
                 device: DeviceLike = None, use_kernel: bool = False):
        self.dag = dag
        self.cfg = cfg
        self.device = resolve_device(device)
        self.parts = [list(p) for p in parts]
        self.peer_ids = list(peer_ids) if peer_ids else list(range(len(parts)))
        self.assignment = {n: self.peer_ids[i]
                           for i, part in enumerate(parts) for n in part}
        order = {n: i for i, n in enumerate(dag.topo_order())}
        gen = lambda name: torch.Generator(self.device).manual_seed(
            int(seed) * 1_000_003 + order[name])
        self.executors = [SubDagExecutor(self.peer_ids[i], dag, part, cfg, gen,
                                         device=self.device,
                                         use_kernel=use_kernel)
                          for i, part in enumerate(self.parts)]
        self.bus = Bus()

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32,
                            device=tokens.device)[None].expand(B, S)

    def train_step(self, tokens: torch.Tensor, labels: torch.Tensor,
                   lr: float = 1e-3) -> float:
        positions = self._positions(tokens)
        placeholders_all = {"input": tokens, "label": labels}
        loss = None
        for ex in self.executors:                      # FP in stage order
            ph = {n: placeholders_all[n] for n in ex.op_names
                  if self.dag[n].op_type == PLACEHOLDER}
            l, _ = ex.fp(self.bus, self.assignment, ph, positions)
            loss = l if l is not None else loss
        grads = {}
        for ex in reversed(self.executors):            # BP in reverse order
            grads[ex.compnode_id] = ex.bp(self.bus, self.assignment)
        for ex in self.executors:                      # Update
            ex.update(grads[ex.compnode_id], lr)
        return float(loss)

    def forward(self, tokens: torch.Tensor, want: str = "head"
                ) -> torch.Tensor:
        """Inference FP through the pipeline (no autograd); returns
        ``want``'s output (logits for an unembed-terminated DAG)."""
        positions = self._positions(tokens)
        out = None
        for ex in self.executors:
            ph = {n: tokens for n in ex.op_names
                  if self.dag[n].op_type == PLACEHOLDER}
            _, wanted = ex.fp(self.bus, self.assignment, ph, positions,
                              want=want, record=False)
            out = wanted if wanted is not None else out
        return out


# ---------------------------------------------------------------------------
# SPMD pipeline over one mesh axis: production mapping
# ---------------------------------------------------------------------------

def _stage_slice(leaf: torch.Tensor, mesh, dim: int, n_stages: int,
                 stage: int) -> torch.Tensor:
    """This rank's stage of one stacked parameter leaf."""
    if leaf.shape[0] != n_stages:
        raise ValueError(
            f"spmd_pipeline: a parameter's leading axis is {leaf.shape[0]}, "
            f"the mesh axis has {n_stages} stages")
    if not isinstance(leaf, DTensor):
        return leaf[stage]
    want = [Replicate()] * mesh.ndim
    want[dim] = Shard(0)
    if leaf.device_mesh != mesh or list(leaf.placements) != want:
        raise ValueError(
            f"spmd_pipeline: a DTensor parameter is placed "
            f"{tuple(leaf.placements)}; each stage's slice needs {tuple(want)}"
            f" on the pipeline's mesh")
    return leaf.to_local()[0]


def spmd_pipeline(stage_fn: Callable, stacked_params, x_microbatches:
                  torch.Tensor, mesh, axis: str = "stage", *,
                  stats: Optional[dict] = None) -> torch.Tensor:
    """Run a GPipe-style pipeline over the mesh axis ``axis``: the
    counterpart of ``repro.core.executor.spmd_pipeline``, called by every
    rank of ``mesh`` (one process per stage).

    ``stage_fn(params_i, x) -> y`` keeps x's shape and dtype (JAX's scan
    carry needs the same).  ``stacked_params``: a tree (dict / tuple /
    list) of tensors whose leading axis has one entry per stage.  As
    DTensors placed ``Shard(0)`` over ``axis`` (``Replicate`` on any other
    mesh dim) — JAX's ``P(axis)`` — each rank holds only its own stage's
    slice.  Plain tensors are accepted too: each rank then holds the whole
    stack, as its caller made it, and reads its own slice.
    ``x_microbatches``: (n_micro, ...); only stage 0 reads it.

    Stage i runs microbatch m at tick m + i of n_micro + n_stages - 1
    ticks, as in JAX.  Where JAX runs ``stage_fn`` on zeros or a clipped
    microbatch in the fill and drain ticks and drops the result, a rank
    here skips the ticks in which it holds no live microbatch (the outputs
    are the same): each rank calls ``stage_fn`` n_micro times, not
    n_micro + n_stages - 1.  After each tick stage i sends its output to
    stage i + 1 (JAX's ``ppermute`` by [(i, i + 1)]) with
    ``batch_isend_irecv`` on ``mesh.get_group(axis)``.  The last stage
    keeps microbatch m's output in slot m and broadcasts the
    (n_micro, ...) outputs over that group: every rank returns them.
    Forward only: the sends carry no autograd edge.

    Each rank computes on its own device: the CPU on a CPU mesh, else
    ``cuda:(global rank % device count)``, so several ranks may share a
    card.  The microbatches and parameters must already be there.  Gloo
    moves host memory, so over a gloo group CUDA tensors travel through
    pinned host buffers ("host-staged"); otherwise they are sent as they
    are ("direct").  ``stats``, if given, receives this rank's ``stage``,
    ``transport``, ``stage_calls`` and the bytes it sent, received and
    broadcast (``bytes_sent``, ``bytes_received``, ``bytes_broadcast``;
    the last counted on the broadcasting stage)."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.size(dim)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = x_microbatches.shape[0]
    device = (torch.device("cpu") if mesh.device_type == "cpu" else
              torch.device(mesh.device_type,
                           dist.get_rank() % torch.cuda.device_count()))
    params = tree_map(lambda t: _stage_slice(t, mesh, dim, n_stages, stage),
                      stacked_params)
    for t in [x_microbatches, *leaves(params)]:
        if t.device != device:
            raise ValueError(f"spmd_pipeline: a tensor is on {t.device}; "
                             f"stage {stage} computes on {device}")
    staged = device.type != "cpu" and dist.get_backend(group) == "gloo"
    shape, dtype = x_microbatches.shape[1:], x_microbatches.dtype
    st = dict(stage=stage, transport="host-staged" if staged else "direct",
              stage_calls=0, bytes_sent=0, bytes_received=0,
              bytes_broadcast=0)
    nbytes = x_microbatches[0].numel() * x_microbatches.element_size()
    succ = (dist.get_global_rank(group, stage + 1)
            if stage < n_stages - 1 else None)
    pred = dist.get_global_rank(group, stage - 1) if stage else None
    send_buf = recv_buf = None
    if staged:
        send_buf, recv_buf = (torch.empty(shape, dtype=dtype,
                                          pin_memory=True) for _ in "sr")
    outs = torch.empty((n_micro, *shape), dtype=dtype, device=device)
    x_in = None
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        recv = pred is not None and 0 <= m + 1 < n_micro
        y = None
        if 0 <= m < n_micro:
            y = stage_fn(params, x_microbatches[m] if stage == 0 else x_in)
            st["stage_calls"] += 1
            if y.shape != shape or y.dtype != dtype:
                raise ValueError(
                    f"spmd_pipeline: stage_fn returned {tuple(y.shape)} "
                    f"{y.dtype} for {tuple(shape)} {dtype}")
            if succ is None:
                outs[m] = y
        ops = []
        if y is not None and succ is not None:
            if staged:
                send_buf.copy_(y)
            ops.append(dist.P2POp(dist.isend, send_buf if staged else y,
                                  succ, group))
            st["bytes_sent"] += nbytes
        if recv:
            if not staged:
                recv_buf = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, recv_buf, pred, group))
            st["bytes_received"] += nbytes
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
        if recv:
            x_in = recv_buf.to(device) if staged else recv_buf
    buf = outs
    if staged:
        buf = torch.empty(outs.shape, dtype=dtype, pin_memory=True)
        if succ is None:
            buf.copy_(outs)
    dist.broadcast(buf, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    if succ is None:
        st["bytes_broadcast"] = buf.numel() * buf.element_size()
    if stats is not None:
        stats.update(st)
    return buf.to(device) if staged else buf
