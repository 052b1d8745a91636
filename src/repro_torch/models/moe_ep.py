"""Expert-parallel MoE over a device mesh — the port's
``repro.models.moe_ep``.

A real EP system moves only routed token vectors through all-to-alls.
Per (data, model) rank — the model axis carries experts (E_local =
E / n_mp):
 1. take my 1/n_mp strip of the local batch's tokens (sequence split);
 2. route locally (top-k);
 3. sort assignments by DESTINATION RANK into a (n_mp, C_send, d) buffer
    -> all-to-all over the model axis (token vectors + local expert ids
    travel; gates and source slots stay home);
 4. second local sort by LOCAL EXPERT into the (E_local, C_local, d)
    compute buffer -> batched expert FFN;
 5. gather back to arrival order -> reverse all-to-all;
 6. combine at the source strip (gates applied), all-gather strips over
    the model axis to rebuild the replicated residual.

The body runs on each rank's local shards of DTensor inputs (JAX's
``shard_map``) with functional collectives over the model axis's group,
differentiable through the Functions below; so it runs the same way on
a real process group (gloo across host processes, NCCL across cards)
and on the dry-run's fake one.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models import hints
from repro_torch.models.layers import silu


def _sort_dispatch(xt, keys, n_buckets: int, cap: int, payload=()):
    """Sort-based bucket dispatch.  xt: (N, d); keys: (N,) int in
    [0, n_buckets) (negative = invalid).  Returns ([buf (n_buckets, cap,
    d), *payload_bufs], order, slot, keep), where payload entries are
    (values (N,), fill) scattered alongside."""
    N, d = xt.shape
    keys_sort = torch.where(keys < 0, n_buckets, keys)   # invalid to the end
    order = torch.argsort(keys_sort, stable=True)
    sorted_k = keys_sort[order]
    first = torch.searchsorted(sorted_k, sorted_k, side="left")
    rank = torch.arange(N, device=xt.device) - first
    keep = (rank < cap) & (sorted_k < n_buckets)
    slot = torch.where(keep, sorted_k * cap + rank, n_buckets * cap)
    # kept slots are distinct; the trash row takes every dropped one with
    # one value (zeros / the fill), so the order of the writes cannot matter
    buf = torch.zeros((n_buckets * cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    buf = buf.index_put((slot,), xt[order] * keep[:, None].to(xt.dtype))
    outs = [buf[:-1].reshape(n_buckets, cap, d)]
    for pay, fill in payload:
        pbuf = torch.full((n_buckets * cap + 1,), fill, dtype=pay.dtype,
                          device=xt.device)
        pbuf = pbuf.index_put((slot,), torch.where(keep, pay[order], fill))
        outs.append(pbuf[:-1].reshape(n_buckets, cap))
    return outs, order, slot, keep


# The collectives of the body, each an autograd Function of its own over
# functional collectives waited at once: the same ops in a forward and in
# its remat recompute.  A value the body returns replicated over a group
# (a DTensor's Replicate placement) gets its gradient whole on every rank
# of that group.

# the functional collective's newer name, where torch has it
_gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all over dim 0; its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return funcol.wait_tensor(funcol.all_to_all_single(
            x.contiguous(), None, None, group))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_to_all_single(
            g.contiguous(), None, None, ctx.group)), None


class _AllGather(torch.autograd.Function):
    """All-gather over dim 0 into a value every rank of the group holds
    alike: each rank's gradient is its own rows of the incoming one,
    which every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rows, ctx.rank = x.shape[0], rank
        return funcol.wait_tensor(_gather(x.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.rows, ctx.rank
        return g[r * n:(r + 1) * n], None, None


def moe_apply_ep(p: dict, x, cfg, mesh, dp_axes: Sequence[str],
                 mp_axis: str):
    """Expert-parallel MoE.  x: (B, S, d) DTensor, batch over the data
    axes and replicated over the model axis.  Returns (out, aux) as
    DTensors (out laid out as x, aux replicated)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    names = list(mesh.mesh_dim_names)
    mi = names.index(mp_axis)
    n_mp = mesh.size(mi)
    n_dp = math.prod(mesh.size(names.index(a)) for a in dp_axes)
    E_local = E // n_mp
    B_l = B // n_dp
    T_l = B_l * S                       # tokens per data shard
    assert T_l % n_mp == 0
    T_strip = T_l // n_mp               # my token strip
    cf = cfg.capacity_factor
    c_send = -(-int(math.ceil(T_strip * K / n_mp * cf)) // 8) * 8
    c_send = min(c_send, T_strip * K)
    c_loc = -(-int(math.ceil(T_strip * K / E_local * cf)) // 8) * 8
    c_loc = min(c_loc, n_mp * c_send)

    R = Replicate()
    xpl = [Shard(0) if n in dp_axes else R for n in names]
    wpl = [Shard(0) if i == mi else R for i in range(mesh.ndim)]
    rep = [R] * mesh.ndim
    # every mesh dim divides the work (tokens over data, strips and
    # experts over model): replicated inputs' gradients are partial
    every = range(mesh.ndim)
    loc = lambda t, pl: hints.to_local(t, mesh, pl, every)
    x_l = loc(x, xpl)                                   # (B_l, S, d)
    wdt = x_l.dtype
    router = loc(p["router"], rep).float()
    wg, wu, wd = (loc(p[n], wpl).to(wdt) for n in ("w_gate", "w_up",
                                                   "w_down"))
    group = mesh.get_group(mi)
    r = mesh.get_local_rank(mi)

    xt = x_l.reshape(T_l, d)[r * T_strip:(r + 1) * T_strip]
    logits = xt.float() @ router                        # (T_strip, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1)          # (T_strip, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)

    # global load-balance aux (sums over every rank's strip)
    every_group = [mesh.get_group(i) for i in range(mesh.ndim)]
    me = hints.all_sum(probs.sum(0), every_group) / (T_l * n_dp)
    cnt = torch.zeros((E,), dtype=torch.float32, device=xt.device)
    cnt = cnt.index_add(0, eidx.reshape(-1),
                        torch.ones(eidx.numel(), device=xt.device))
    ce = hints.all_sum(cnt, every_group) / (T_l * n_dp * K)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    # ---- stage 1: bucket by destination rank, a2a ----------------------
    N = T_strip * K
    flat_e = eidx.reshape(N)
    dest = torch.div(flat_e, E_local, rounding_mode="floor")
    xt_rep = torch.repeat_interleave(xt, K, dim=0)      # token per assignment
    (send, send_le), order, slot, keep = _sort_dispatch(
        xt_rep, dest, n_mp, c_send, payload=[(flat_e % E_local, -1)])
    recv = _AllToAll.apply(send.to(torch.bfloat16).reshape(
        n_mp * c_send, d), group).to(wdt)              # (n_mp*c_send, d)
    recv_le = _AllToAll.apply(send_le.reshape(-1), group)

    # ---- stage 2: bucket by local expert, run experts -------------------
    (ebuf,), order2, slot2, _ = _sort_dispatch(recv, recv_le, E_local, c_loc)
    g = silu(torch.bmm(ebuf, wg))
    h = torch.bmm(g * torch.bmm(ebuf, wu), wd)          # (E_local, c_loc, d)

    # gather back to arrival order
    h_flat = torch.cat([h.reshape(E_local * c_loc, d),
                        torch.zeros((1, d), dtype=h.dtype, device=h.device)])
    back = torch.zeros((n_mp * c_send, d), dtype=h.dtype, device=h.device)
    back = back.index_put((order2,), h_flat[slot2])
    ret = _AllToAll.apply(back.to(torch.bfloat16), group).to(wdt)  # home

    # ---- combine at source strip: the K terms of a token in order k ----
    ret_flat = torch.cat([ret, torch.zeros((1, d), dtype=ret.dtype,
                                           device=ret.device)])
    per_assign = torch.zeros((N, d), dtype=ret.dtype, device=ret.device)
    per_assign = per_assign.index_put((order,), ret_flat[slot])
    terms = (per_assign.float() * gates.reshape(N, 1).float()).reshape(
        T_strip, K, d)
    out = torch.zeros((T_strip, d), dtype=torch.float32, device=xt.device)
    for k in range(K):
        out = out + terms[:, k]
    out = out.to(x_l.dtype)

    if "shared" in p:
        # shared expert: replicated weights, strip-local compute
        sg, su, sd = (loc(p["shared"][n], rep).to(wdt)
                      for n in ("w_gate", "w_up", "w_down"))
        out = out + (silu(xt @ sg) * (xt @ su)) @ sd

    # rebuild the replicated residual strip layout (bf16 on the wire)
    out_full = _AllGather.apply(out.to(torch.bfloat16), group, r).to(
        x_l.dtype)
    return (hints.from_local(out_full.reshape(B_l, S, d), mesh, xpl,
                             (B, S, d)),
            hints.from_local(aux, mesh, rep, ()))
