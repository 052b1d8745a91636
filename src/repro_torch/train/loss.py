"""Loss functions.  Cross entropy is computed chunked over the tokens
with a recomputed body, so the (B, S, vocab) float32 logits are never
alive at once — the counterpart of ``repro.train.loss``.  At qwen3-8b's
vocabulary (151,936) one 1,024-row chunk's float32 logits take 622 MB.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

IGNORE = -1


def _ce_of_logits(logits: torch.Tensor, labels: torch.Tensor,
                  z_coef: float):
    """logits (N,V) f32, labels (N,).  Returns (sum_nll, sum_z, n_valid)."""
    valid = labels != IGNORE
    lbl = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, lbl[:, None])[:, 0]
    nll = (lse - picked) * valid
    z = lse.square() * valid
    return nll.sum(), z_coef * z.sum(), valid.sum()


def _body_sharded(hc, head, lc, z_coef: float):
    """One chunk's (nll, z, n, hit) sums on DTensors (a dry-run on a mesh),
    Megatron-style: each rank takes its rows (where the rows are split)
    against its vocabulary shard of the head (where the head is split),
    and the log-sum-exp and the picked logits are all-reduced over the
    vocabulary shards — the (rows, vocab) float32 logits are never
    gathered.  ``hit`` counts rows whose label is the row's argmax over
    the whole vocabulary (its first maximum, as ``argmax``).  Sums come
    back partial over the row splits."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models import hints
    mesh = hints.mesh_of(hc, head)
    R = Replicate()
    hp, wp, lp, vocab, rows = [], [], [], [], []
    for i, pl in enumerate(head.placements if isinstance(head, DTensor)
                           else [R] * mesh.ndim):
        n = mesh.size(i)
        hpl = hc.placements[i] if isinstance(hc, DTensor) else R
        if (isinstance(pl, Shard) and pl.dim == 1
                and head.shape[1] % n == 0):
            hp.append(R), wp.append(Shard(1)), lp.append(R), vocab.append(i)
        elif (isinstance(hpl, Shard) and hpl.dim == 0
              and hc.shape[0] % n == 0):
            hp.append(Shard(0)), wp.append(R), lp.append(Shard(0))
            rows.append(i)
        else:
            hp.append(R), wp.append(R), lp.append(R)
    h_l = hints.to_local(hc, mesh, hp, vocab + rows)
    w_l = hints.to_local(head, mesh, wp, vocab + rows)
    lbl = hints.to_local(lc, mesh, lp)
    logits = (h_l @ w_l.to(h_l.dtype)).float()             # (rows_l, V_l)
    V_l = logits.shape[1]
    groups = [mesh.get_group(i) for i in vocab]
    # this rank's vocabulary offset (vocab split major to minor)
    off = 0
    coord = mesh.get_coordinate()
    for i in vocab:
        off = off * mesh.size(i) + coord[i]
    local_top = logits.detach().argmax(-1)
    local_max = torch.gather(logits.detach(), 1, local_top[:, None])[:, 0]
    m = local_max
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    # the row's first maximum: the least index among the shards that hold
    # the maximum (each shard's argmax is its first); the others offer V
    top = torch.where(local_max == m, local_top + off * V_l, head.shape[1])
    for g in groups:
        top = funcol.all_reduce(top, "min", g)
    se = torch.exp(logits - m[:, None]).sum(-1)
    idx = lbl.long() - off * V_l
    mine = (idx >= 0) & (idx < V_l)
    picked = torch.gather(logits, 1, idx.clamp(0, V_l - 1)[:, None])[:, 0]
    picked = picked * mine
    se, picked = hints.all_sum(se, groups), hints.all_sum(picked, groups)
    lse = m + torch.log(se)
    valid = lbl != IGNORE
    nll = ((lse - picked) * valid).sum()
    z = z_coef * (lse.square() * valid).sum()
    n = valid.sum()
    hit = ((top == lbl.long()) & valid).sum()
    out_pl = [Partial() if i in rows else R for i in range(mesh.ndim)]
    return tuple(hints.from_local(t, mesh, out_pl, ()) for t in
                 (nll, z, n, hit))


def cross_entropy_chunked(h: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          z_coef: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B,S,d); head: (d,V); labels: (B,S) with IGNORE masking.
    Returns (mean loss, accuracy: mean correct@1).  Each chunk of
    ``chunk x B`` rows (padding rows labelled IGNORE) runs under
    ``torch.utils.checkpoint``: its logits are recomputed in the backward
    pass instead of kept, as the JAX version's ``jax.checkpoint`` does."""
    B, S, d = h.shape
    N = B * S
    hf = h.reshape(N, d)
    lf = labels.reshape(N)
    c = min(chunk * max(1, B), N)
    n_chunks = -(-N // c)
    pad = n_chunks * c - N
    if pad:
        hf = F.pad(hf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad), value=IGNORE)

    def body(hc, lc):
        if isinstance(hc, DTensor) or isinstance(head, DTensor):
            return _body_sharded(hc, head, lc, z_coef)
        logits = (hc @ head.to(hc.dtype)).float()
        nll, z, n = _ce_of_logits(logits, lc, z_coef)
        hit = ((logits.argmax(-1) == lc) & (lc != IGNORE)).sum()
        return nll, z, n, hit

    s_nll = s_z = torch.zeros((), dtype=torch.float32, device=h.device)
    s_n = s_hit = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        nll, z, n, hit = checkpoint(body, hf[sl], lf[sl], use_reentrant=False)
        s_nll, s_z, s_n, s_hit = s_nll + nll, s_z + z, s_n + n, s_hit + hit
    n = s_n.clamp(min=1)
    return (s_nll + s_z) / n, s_hit / n
