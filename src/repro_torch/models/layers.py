"""Decoder layers in PyTorch: the counterparts of ``repro.models.layers``
for full-attention and sliding-window models with dense or
mixture-of-experts FFNs.

Layer math is plain functions on tensors; parameters are nested dicts of
tensors under the JAX package's key names.  Unlike the JAX package, the
cache writes (``ring_write`` and the helpers above it) update the cache
tensors IN PLACE and return them, so a serving engine keeps one copy of
its pools.  Where the JAX code reads a cache from before a write (a
sliding-window ring that a prefill chunk wraps), the port copies it
first.  The dense layers are
differentiable by autograd when they run without a cache (training);
MoE is forward only, like the reference (its ``optimization_barrier``
has no differentiation rule).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models import hints
from repro_torch.models.hints import constrain

NEG_INF = -1e30  # finite "minus infinity" keeps online softmax NaN-free


def row_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul whose output stays in x.dtype (the JAX version pins the
    output dtype the same way)."""
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers (random weights drawn on ``device`` from an explicit
# generator; ``lead`` prepends stacked axes such as n_periods)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float = 1.0, dtype=torch.bfloat16, lead=(),
               device=None) -> torch.Tensor:
    std = scale / math.sqrt(d_in)
    w = torch.randn((*lead, d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32; ``scale`` is stored minus one."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` at the JAX package's rounding points: every
    primitive of its forward (XLA's logistic is ``1 / (1 + exp(-x))``)
    and of its transposed backward rounds to the input's dtype, where
    ``F.silu`` rounds once."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        return ct * s + (ct * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU rounded where the JAX package's rounds (``_Silu``)."""
    return _Silu.apply(x)


def rmsnorm_init(d: int, lead=(), device=None) -> torch.Tensor:
    return torch.zeros((*lead, d), dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding over the two HALVES of the head dim (not
    interleaved pairs).  x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    assert d % 2 == 0, d
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=x.device) / d)
    ang = positions[..., None].float() * freq
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked (online-softmax) attention — GQA, causal, sliding-window, softcap
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, kv_pos: torch.Tensor, *, window: int = 0,
              causal: bool = True, softcap: float = 0.0, kv_chunk: int = 1024,
              scale: Optional[float] = None,
              q_extra: Optional[torch.Tensor] = None,
              k_extra: Optional[torch.Tensor] = None,
              table: Optional[torch.Tensor] = None,
              use_kernel: bool = False,
              score_groups=()) -> torch.Tensor:
    """Flash-style attention, the scan path of ``repro.models.layers``.

    q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv); q_pos
    (B, S) and kv_pos (B, T) int32, kv_pos < 0 marks invalid entries.
    Paged mode (``table`` (B, n_cols) given): k / v / kv_pos (and
    k_extra) are block pools (N, page, ...) and each online-softmax step
    gathers ``cb = kv_chunk // page`` table columns, so the float32
    accumulation order equals the dense path's whenever page | kv_chunk.

    ``use_kernel=True`` sends paged single-token causal decode (table
    given, S == 1) to ``kernels.ops.paged_attention`` — the Hopper kernel
    on CUDA tensors.  ``score_groups``: process groups over whose ranks
    the head dims are split (each rank's q / k / v and extras hold a
    slice of D and Dv): the scores are summed over them before the
    softmax.  Returns (B, S, Hq, Dv) in q.dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if hints.mesh_of(q, k, v, kv_pos, table) is not None:
        # DTensors (a dry-run on a mesh): each rank's shard, by the
        # "attention" / "paged_attention" layout of ``hints.LAYOUTS``
        return hints.local_call(
            "attention" if table is None else "paged_attention",
            lambda groups, **a: attention(
                **a, window=window, causal=causal, softcap=softcap,
                kv_chunk=kv_chunk, scale=scale, use_kernel=use_kernel,
                score_groups=groups.get("dims", ())),
            dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos, table=table,
                 q_extra=q_extra, k_extra=k_extra), {"out": (B, S, Hq, Dv)})
    if use_kernel and table is not None and S == 1 and causal:
        return ops.paged_attention(q, k, v, kv_pos, table, q_pos,
                                   scale=scale, window=window,
                                   softcap=softcap, q_extra=q_extra,
                                   k_extra=k_extra)
    qf = q.float().reshape(B, S, Hkv, G, D) * scale
    qe = None
    if q_extra is not None:
        qe = q_extra.float().reshape(B, S, Hkv, G, q_extra.shape[-1]) * scale

    if table is None:
        T = k.shape[1]
        C = min(kv_chunk, T)
        n_chunks = -(-T // C)

        def chunk_at(i):
            sl = slice(i * C, (i + 1) * C)
            kej = k_extra[:, sl] if k_extra is not None else None
            return k[:, sl], v[:, sl], kv_pos[:, sl], kej, C
    else:
        page = k.shape[1]
        n_cols = table.shape[1]
        cb = max(1, min(kv_chunk, n_cols * page) // page)
        n_chunks = -(-n_cols // cb)

        def chunk_at(i):
            tj = table[:, i * cb:(i + 1) * cb]
            if tj.shape[1] < cb:          # pad the last chunk with -1 columns
                tj = F.pad(tj, (0, cb - tj.shape[1]), value=-1)
            safe = tj.clamp(min=0).long()
            C = cb * page
            kj = k[safe].reshape(B, C, Hkv, k.shape[-1])
            vj = v[safe].reshape(B, C, Hkv, Dv)
            pj = torch.where((tj >= 0)[..., None], kv_pos[safe],
                             -1).reshape(B, C)
            kej = (k_extra[safe].reshape(B, C, Hkv, k_extra.shape[-1])
                   if k_extra is not None else None)
            return kj, vj, pj, kej, C

    m = torch.full((B, S, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hkv, G, Dv), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        kj, vj, pj, kej, C = chunk_at(i)
        if kj.shape[1] < C:               # dense ragged tail: pad like JAX
            pad = C - kj.shape[1]
            kj = F.pad(kj, (0, 0, 0, 0, 0, pad))
            vj = F.pad(vj, (0, 0, 0, 0, 0, pad))
            pj = F.pad(pj, (0, pad), value=-1)
            if kej is not None:
                kej = F.pad(kej, (0, 0, 0, 0, 0, pad))
        s = torch.einsum("bsngd,bcnd->bsngc", qf, kj.float())
        if qe is not None:
            s = s + torch.einsum("bsngd,bcnd->bsngc", qe, kej.float())
        s = hints.all_sum(s, score_groups)
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        ok = pj[:, None, :] >= 0                               # (B,1,C)
        if causal:
            ok = ok & (pj[:, None, :] <= q_pos[:, :, None])
        if window > 0:
            ok = ok & (pj[:, None, :] > q_pos[:, :, None] - window)
        okb = ok[:, :, None, None, :]
        s = torch.where(okb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked chunks: exp(NEG_INF - NEG_INF) = 1 — zero them
        p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bsngc,bcnd->bsngd", p, vj.float())
        m = m_new
    out = acc / l[..., None].clamp(min=1e-30)
    return out.reshape(B, S, Hq, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg, lead=(), device=None) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, d, hq * hd, **kw),
        "wk": dense_init(gen, d, hkv * hd, **kw),
        "wv": dense_init(gen, d, hkv * hd, **kw),
        "wo": dense_init(gen, hq * hd, d,
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }
    if cfg.attn_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=torch.float32,
                                  device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def swa_ring_blocks(window: int, page_size: int, n_cols: int) -> int:
    """Number of block-table columns a sliding-window layer cycles over:
    the smallest whole-page ring covering ``window`` positions, clamped to
    the table width."""
    return max(1, min(-(-window // page_size), n_cols))


def attn_apply(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               cache: Optional[dict] = None, window: int = 0,
               kv_chunk: int = 1024, masked_slots: bool = False,
               table=None, use_kernel: bool = False):
    """x: (B,S,d).  cache: dense {"k","v": (B,T,Hkv,D), "pos": (B,T)}, or
    a paged pool {"k","v": (N,page,Hkv,D), "pos": (N,page)} when a
    (B, n_cols) block ``table`` is given, or per-kind tables {"attn",
    "swa"}.  A sliding-window layer (``window > 0``) cycles over the first
    ``swa_ring_blocks`` table columns as ring pages, or keeps a dense
    ring of ``min(window, cache_len)`` entries.  The cache is written in
    place; returns (out, cache).  ``use_kernel``: paged single-token
    decode runs the paged-decode kernel, and self-attention with no cache
    (whose positions must be arange(S)) the flash-attention kernel."""
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = hints.reshape(q, B, S, hq, hd)
    k = hints.reshape(k, B, S, hkv, hd)
    v = hints.reshape(v, B, S, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = constrain(rope(q, positions, cfg.rope_theta), "attn_q")
    k = rope(k, positions, cfg.rope_theta)

    attn_table = None
    # a chunk written into a ring first could evict keys still inside its
    # earliest queries' windows: such a chunk attends over [the ring
    # before the write ∥ the chunk] (position masks make the union exact:
    # old entries hold older positions or -1).  The cache is written in
    # place, so the ring is copied before the write.
    old = None
    if cache is not None and table is not None:
        if isinstance(table, dict):
            table = table["swa" if window > 0 else "attn"]
        page = cache["k"].shape[1]
        if window > 0:
            nb = swa_ring_blocks(window, page, table.shape[1])
            tab, ring = table[:, :nb].contiguous(), nb * page
        else:
            tab, ring = table, 0
        if masked_slots and S > 1 and window > 0:
            old = (gather_pages(cache["k"], tab), gather_pages(cache["v"], tab),
                   gather_pos(cache["pos"], tab))       # copies
        paged_cache_update(cache, k, v, positions, tab, ring=ring)
        if old is None:
            k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
            attn_table = tab
    elif cache is not None:
        if masked_slots and S > 1 and window > 0:
            old = tuple(cache[n].clone() for n in ("k", "v", "pos"))
        full_k, full_v, kv_pos, _ = cache_update(cache, k, v, positions,
                                                 per_row=masked_slots)
        if old is None:
            if S <= cache["k"].shape[1]:
                k, v = full_k, full_v
            else:
                # a sliding-window prefill longer than the ring: the ring
                # serves later decode; attend over the sequence's own
                # keys (the window mask makes it exact)
                kv_pos = positions
    else:
        kv_pos = positions
        if use_kernel:
            # self-attention over the sequence itself (training): the
            # caller's positions are arange(S) (``transformer.forward``
            # insists), so the flash kernel's index masks are the
            # position masks
            if cfg.logits_softcap > 0.0:
                raise NotImplementedError(
                    "repro_torch: the flash kernel has no logit softcap")
            out = ops.flash_attention(*(t.transpose(1, 2).contiguous()
                                        for t in (q, k, v)),
                                      causal=True, window=window)
            out = hints.reshape(out.transpose(1, 2), B, S, hq * hd)
            return row_dot(out, p["wo"]), cache
    if old is not None:
        k = torch.cat([old[0], k.to(old[0].dtype)], dim=1)
        v = torch.cat([old[1], v.to(old[1].dtype)], dim=1)
        kv_pos = torch.cat([old[2], positions], dim=1)
        # the union in position order (unwritten entries last): the ring
        # holds its keys in slot order, which follows the chunk size, and
        # the float32 sums over a query's keys must not
        order = torch.argsort(torch.where(kv_pos < 0, torch.iinfo(
            kv_pos.dtype).max, kv_pos), dim=1, stable=True)
        kv_pos = torch.gather(kv_pos, 1, order)
        k, v = (torch.gather(t, 1, order[:, :, None, None].expand(t.shape))
                for t in (k, v))
    out = attention(q, k, v, positions, kv_pos, window=window,
                    softcap=cfg.logits_softcap, kv_chunk=kv_chunk,
                    table=attn_table, use_kernel=use_kernel)
    return row_dot(hints.reshape(out, B, S, hq * hd), p["wo"]), cache


# ---------------------------------------------------------------------------
# KV cache (linear or ring-buffer; dense per slot or a paged pool)
# ---------------------------------------------------------------------------

def cache_init(batch: int, cache_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, lead=(), device=None) -> dict:
    shape = (*lead, batch, cache_len)
    return {
        "k": torch.zeros((*shape, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((*shape, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full(shape, -1, dtype=torch.int32, device=device),
    }


def paged_cache_init(num_blocks: int, page_size: int, n_kv: int,
                     head_dim: int, dtype=torch.bfloat16, lead=(),
                     device=None) -> dict:
    """Paged KV pool: ``num_blocks`` pages of ``page_size`` positions,
    shared by all serving slots through a per-slot block table."""
    return cache_init(num_blocks, page_size, n_kv, head_dim, dtype, lead,
                      device)


def ring_write(buf: torch.Tensor, val: torch.Tensor, positions: torch.Tensor,
               per_row: bool = False, *,
               table: Optional[torch.Tensor] = None,
               ring: int = 0, kind: str = "") -> torch.Tensor:
    """Write ``val`` into ``buf`` in place; returns ``buf``.

    buf: (B, T, ...); val: (B, S, ...); positions: (B, S).  The four
    modes of the JAX version:

    * S == 1: each row with position >= 0 writes slot position % T;
    * S > 1, per_row=False: positions are contiguous and row-uniform from
      positions[0, 0]; S == T places the block by a roll, S < T writes
      the slice starting at positions[0, 0] % T (clamped to fit);
    * S > 1, per_row=True: each row writes entry i at slot
      (positions[b, 0] % T + i) % T where its position is >= 0;
    * table given (paged pool, buf (N, page, ...)): entry (b, i) writes
      ``pool[table[b, logical // page], logical % page]`` with ``logical
      = pos % ring`` on sliding-window ring pages (``ring`` > 0) and
      ``logical = pos`` otherwise; of a chunk longer than the ring (or
      the table) only the last ``cap`` entries survive.  Entries with
      position < 0, past the table or on an unallocated (-1) page are
      dropped — filtered, never clamped.

    ``kind`` names the cache leaf ("k", "pos", "ckv", ...): under sharding
    hints the value written is pinned to that leaf's layout
    (``cache/<kind>``), as the JAX version pins the updated buffer."""
    if kind:
        val = constrain(val, f"cache/{kind}")
    if table is not None:
        page = buf.shape[1]
        n_cols = table.shape[1]
        cap = ring if ring else n_cols * page
        if val.shape[1] > cap:
            val, positions = val[:, -cap:], positions[:, -cap:]
        logical = positions % cap if ring else positions
        col = torch.div(logical, page, rounding_mode="floor")
        blk = torch.gather(table, 1, col.clamp(0, n_cols - 1).long())
        ok = (positions >= 0) & (col < n_cols) & (blk >= 0)
        _masked_put(buf, blk.long() * page + logical % page, val, ok)
        return buf
    T = buf.shape[1]
    S = val.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    if S == 1:
        _masked_put(buf, rows * T + positions % T, val, positions >= 0)
        return buf
    if S > T:
        val, positions = val[:, -T:], positions[:, -T:]
        S = T
    if per_row:
        slot = (positions[:, :1] % T + torch.arange(S, device=buf.device)) % T
        _masked_put(buf, rows * T + slot, val, positions >= 0)
        return buf
    val = val.to(buf.dtype)
    # the block's start stays on the device (no host read): S == T places
    # it by a roll, S < T at slots start .. start + S - 1 with start
    # clamped to fit, as dynamic_update_slice clamps it
    p0 = positions[0, 0].long() % T
    ar = torch.arange(S if S < T else T, device=buf.device)
    if S == T:
        buf.copy_(torch.index_select(val, 1, (ar - p0) % T))
        return buf
    buf.index_copy_(1, torch.clamp(p0, max=T - S) + ar, val)
    return buf


def _masked_put(buf: torch.Tensor, dst: torch.Tensor, val: torch.Tensor,
                ok: torch.Tensor) -> None:
    """Row ``dst[j]`` of ``buf`` viewed as (rows, ...) takes ``val[j]``
    for every j with ``ok[j]``, with no host sync (a boolean filter would
    wait for the device).  A dropped entry instead writes the first kept
    entry's value to that entry's row — or, when nothing is kept, row 0's
    own value back to row 0 — so every repeated index carries identical
    values and the order of the writes cannot matter."""
    if isinstance(buf, DTensor):
        return _masked_put_sharded(buf, dst, val, ok)
    flat = buf.view((-1,) + tuple(buf.shape[2:]))
    dst, ok = dst.reshape(-1).long(), ok.reshape(-1)
    val = val.to(buf.dtype).reshape((dst.shape[0],) + tuple(flat.shape[1:]))
    any_ok = ok.any()
    # first kept entry, as a one-element index: a 0-dim index tensor
    # would be read on the host
    j0 = torch.argmax(ok.to(torch.int32)).reshape(1)
    d0 = torch.where(any_ok, dst[j0][0], 0)
    v0 = torch.where(any_ok, val[j0][0], flat[0])
    keep = ok.view((-1,) + (1,) * (val.ndim - 1))
    flat.index_put_((torch.where(ok, dst, d0),), torch.where(keep, val, v0))


def _masked_put_sharded(buf, dst, val, ok) -> None:
    """``_masked_put`` into a DTensor cache (a dry-run on a mesh): each
    rank writes, into its own shard of ``buf``, the entries whose rows it
    holds — the local masked scatter of a sharded cache update.  Every
    rank needs every entry's row and value, so ``dst`` / ``ok`` are
    replicated and ``val`` is replicated over the axes that split the
    rows, and keeps ``buf``'s layout over the others."""
    mesh = buf.device_mesh
    rep = [Replicate()] * mesh.ndim
    dst, ok = (_as_dtensor(t, mesh).redistribute(mesh, rep).to_local()
               for t in (dst, ok))
    val = _as_dtensor(val.to(buf.dtype), mesh)
    val = val.reshape((-1,) + tuple(buf.shape[2:]))
    val = val.redistribute(mesh, [
        Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2 else
        Replicate() for p in buf.placements]).to_local()
    shape, offset = _local_extent(buf)
    T = buf.shape[1]
    dst, ok = dst.reshape(-1).long(), ok.reshape(-1)
    i0 = torch.div(dst, T, rounding_mode="floor") - offset[0]
    i1 = dst % T - offset[1]
    mine = ok & (i0 >= 0) & (i0 < shape[0]) & (i1 >= 0) & (i1 < shape[1])
    local_dst = torch.where(mine, i0 * shape[1] + i1, 0)
    _masked_put(buf.to_local(), local_dst, val, mine)


def _local_extent(x):
    """(local shape, global offset) of this rank's shard of DTensor ``x``
    (even shards; a dim over several mesh dims splits major to minor)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    shape, offset = list(x.shape), [0] * x.ndim
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(i)
            offset[p.dim] = offset[p.dim] * mesh.size(i) + coord[i]
    return shape, [o * n for o, n in zip(offset, shape)]


def _as_dtensor(t, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, per_row: bool = False):
    """Write S new entries at slot = position % cache_len, in place.
    Returns (full_k, full_v, kv_pos, cache)."""
    T = cache["k"].shape[1]
    if k.shape[1] > T:
        k, v, positions = k[:, -T:], v[:, -T:], positions[:, -T:]
    ring_write(cache["k"], k, positions, per_row=per_row, kind="k")
    ring_write(cache["v"], v, positions, per_row=per_row, kind="v")
    ring_write(cache["pos"], positions, positions, per_row=per_row,
               kind="pos")
    return cache["k"], cache["v"], cache["pos"], cache


def paged_cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, table: torch.Tensor, *,
                       ring: int = 0) -> dict:
    """Scatter S new entries into the paged pool through the block table,
    in place (position -1 and unallocated pages are write no-ops);
    ``ring`` > 0: sliding-window ring pages (see ``ring_write``)."""
    ring_write(cache["k"], k, positions, table=table, ring=ring, kind="k")
    ring_write(cache["v"], v, positions, table=table, ring=ring, kind="v")
    ring_write(cache["pos"], positions, positions, table=table, ring=ring,
               kind="pos")
    return cache


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense (B, n_cols * page, ...) view of a paged pool through the
    table; unallocated (-1) pages read block 0 and must be masked by the
    caller (``gather_pos`` gives them position -1)."""
    B, n_cols = table.shape
    page = pool.shape[1]
    return pool[table.clamp(min=0).long()].reshape(
        (B, n_cols * page) + tuple(pool.shape[2:]))


def gather_pos(pos_pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Dense (B, n_cols * page) positions view; unallocated pages -> -1."""
    B, n_cols = table.shape
    page = pos_pool.shape[1]
    got = torch.where((table >= 0)[..., None],
                      pos_pool[table.clamp(min=0).long()], -1)
    return got.reshape(B, n_cols * page)


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, cfg, d_ff: Optional[int] = None, lead=(),
             device=None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(lead=lead, device=device)
    return {
        "w_gate": dense_init(gen, d, f, **kw),
        "w_up": dense_init(gen, d, f, **kw),
        "w_down": dense_init(gen, f, d,
                             scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return row_dot(constrain(g * u, "ffn_hidden"), p["w_down"])


# ---------------------------------------------------------------------------
# Mixture of Experts — sort-based dispatch (no (T,E,C) one-hot einsums)
# ---------------------------------------------------------------------------

def _expert_stack_init(gen: torch.Generator, E: int, d_in: int, d_out: int,
                       *, scale: float = 1.0, lead=(),
                       device=None) -> torch.Tensor:
    """(*lead, E, d_in, d_out) bf16 expert matrices with ``dense_init``'s
    distribution, drawn one expert at a time into the bf16 tensor: a
    full-width stack (16 x 8192 x 24576) drawn whole in float32 would
    need about 26 GB of temporaries."""
    w = torch.empty((*lead, E, d_in, d_out), dtype=torch.bfloat16,
                    device=device)
    if is_fake(w):        # shapes only (the dry-run): there is nothing to draw
        return w
    for m in w.view(-1, d_in, d_out):
        m.copy_(dense_init(gen, d_in, d_out, scale=scale, device=device))
    return w


def moe_init(gen: torch.Generator, cfg, lead=(), device=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
    kw = dict(lead=lead, device=device)
    p = {
        "router": dense_init(gen, d, e, dtype=torch.float32, **kw),
        "w_gate": _expert_stack_init(gen, e, d, f, **kw),
        "w_up": _expert_stack_init(gen, e, d, f, **kw),
        "w_down": _expert_stack_init(
            gen, e, f, d, scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(gen, cfg, cfg.d_expert * cfg.n_shared_experts,
                               **kw)
    return p


def _moe_dispatch_group(xt: torch.Tensor, gate_vals: torch.Tensor,
                        expert_idx: torch.Tensor, E: int, K: int, C: int):
    """Sort-based dispatch for ONE token group.  xt: (Tg, d);
    gate_vals / expert_idx: (Tg, K).  Returns (buf (E,C,d), slot, order,
    gates_sorted) for the gather-back: sorted assignment i is flat
    assignment ``order[i]`` (token ``order[i] // K``).

    Assignment j (token j // K) goes to row ``rank`` of its expert's
    capacity buffer, where ``rank`` counts the earlier assignments to the
    same expert in token order (a STABLE sort keeps that order); ranks
    >= C are dropped into a trash row E*C.  No step waits for the
    device: the only host value is C, computed from shapes."""
    Tg, d = xt.shape
    flat_e = expert_idx.reshape(Tg * K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_of_group = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(Tg * K, device=xt.device) - first_of_group
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)       # E*C = trash
    src_token = torch.div(order, K, rounding_mode="floor")
    # kept slots are distinct; the trash row takes every dropped one (all
    # zeros), so the order of the writes cannot matter
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((slot,), xt[src_token] * keep[:, None].to(xt.dtype))
    gates_sorted = gate_vals.reshape(Tg * K)[order] * keep
    return buf[:-1].reshape(E, C, d), slot, order, gates_sorted


def moe_capacity(T: int, cfg) -> int:
    """Per-expert buffer rows for a group of T tokens: ``capacity_factor``
    times the even share T*K/E, rounded up to a multiple of 8 and capped
    at T*K (``repro.models.layers.moe_apply``)."""
    K = cfg.top_k
    C = max(1, int(math.ceil(T * K / cfg.n_experts * cfg.capacity_factor)))
    C = -(-C // 8) * 8
    return min(C, T * K)


def _route(xt: torch.Tensor, router: torch.Tensor, K: int):
    """Router probabilities and the normalized top-k gates: (probs (T,E),
    gate_vals (T,K), expert_idx (T,K))."""
    logits = xt.float() @ router.float()                        # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)        # (T,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, expert_idx


def _expert_ffn(p: dict, buf: torch.Tensor, dtype) -> torch.Tensor:
    """The batched expert SwiGLU over an (E, rows, d) buffer."""
    g = silu(torch.bmm(buf, p["w_gate"].to(dtype)))
    u = torch.bmm(buf, p["w_up"].to(dtype))
    return torch.bmm(g * u, p["w_down"].to(dtype))              # (E,rows,d)


def _combine_group(h: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
                   gates_sorted: torch.Tensor, K: int) -> torch.Tensor:
    """One group's gather back + combine with gates: (E, C, d) expert
    outputs -> (Tg, d) float32.

    Assignment i of the sorted order is flat assignment order[i] = token
    * K + k, so writing row i at order[i] puts every (token, k) in its
    own row of a (Tg, K, d) buffer (a dropped one gets the zero trash
    row).  The K terms are then added onto 0.0 in float32 in the fixed
    order k = 0, 1, ..., K-1: no atomics, so the bits are the same in
    every run for any K.  At K = 2 this is the old scatter-add's
    0 + a + b exactly."""
    E, C, d = h.shape
    h_flat = torch.cat([h.reshape(E * C, d),
                        torch.zeros((1, d), dtype=h.dtype, device=h.device)])
    per_assign = h_flat[slot].float() * gates_sorted[:, None]
    by_token = torch.empty_like(per_assign)
    by_token[order] = per_assign
    by_token = by_token.reshape(-1, K, d)
    out = torch.zeros(by_token[:, 0].shape, dtype=torch.float32,
                      device=h.device)
    for k in range(K):
        out = out + by_token[:, k]
    return out


def _moe_groups(p: dict, xt: torch.Tensor, gate_vals, expert_idx, cfg,
                G: int) -> torch.Tensor:
    """Grouped dispatch on plain tensors: the T tokens split into G
    contiguous groups, each with its own per-expert capacity buffer; the
    experts run once over all groups' rows.  Returns (T, d) float32."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    Tg = T // G
    C = moe_capacity(Tg, cfg)
    parts = [_moe_dispatch_group(xt[g * Tg:(g + 1) * Tg],
                                 gate_vals[g * Tg:(g + 1) * Tg],
                                 expert_idx[g * Tg:(g + 1) * Tg], E, K, C)
             for g in range(G)]
    buf = torch.stack([q[0] for q in parts], dim=1)             # (E,G,C,d)
    h = _expert_ffn(p, buf.reshape(E, G * C, d), xt.dtype)
    h = h.reshape(E, G, C, d)
    return torch.cat([_combine_group(h[:, g], *parts[g][1:], K)
                      for g in range(G)])


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """Sort-based top-k MoE with grouped dispatch.  x: (B,S,d) -> (out,
    aux_loss).

    Every token of the call — idle serving rows' padding included —
    routes through the router and fills its group's per-expert capacity
    in token order; assignments beyond capacity are dropped.  Tokens
    split into ``moe_groups`` contiguous groups (a sharding-hint extra,
    the data-parallel shard count on a mesh; 1 without hints), each with
    its own capacity of the group's share, as in
    ``repro.models.layers.moe_apply``.  The experts run as batched
    matmuls over the (E, C, d) buffers.  The Switch-style aux loss is
    ``router_aux_coef * E * sum(mean prob * assignment fraction)``.  On a
    mesh with the ``moe_ep`` extra, where the shapes allow, it is
    ``models.moe_ep.moe_apply_ep`` (expert parallelism)."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    mesh = hints.get_mesh()
    if mesh is not None and hints.get_extra("moe_ep", False):
        from repro_torch.launch.mesh import axis_sizes, data_axes, model_axis
        from repro_torch.models.moe_ep import moe_apply_ep
        dp, mp = data_axes(mesh), model_axis(mesh)
        sizes = axis_sizes(mesh)
        n_mp = sizes[mp]
        n_dp = math.prod(sizes[a] for a in dp)
        if (E % n_mp == 0 and B % n_dp == 0
                and (B // n_dp) * S % n_mp == 0):
            return moe_apply_ep(p, x, cfg, mesh, dp, mp)
    G = int(hints.get_extra("moe_groups", 1))
    if T % G != 0:
        G = 1
    if hints.mesh_of(x, p["w_gate"]) is not None:
        return _moe_sharded(p, x, cfg, G)

    xt = x.reshape(T, d)
    probs, gate_vals, expert_idx = _route(xt, p["router"], K)

    # --- load-balance auxiliary loss (Switch-style) ---------------------
    me = probs.mean(dim=0)                                      # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, expert_idx.reshape(-1),
                  torch.full((T * K,), 1.0 / (T * K), device=x.device))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    if G > 1:
        out = _moe_groups(p, xt, gate_vals, expert_idx, cfg, G)
    else:
        C = moe_capacity(T, cfg)
        buf, slot, order, gates_sorted = _moe_dispatch_group(
            xt, gate_vals, expert_idx, E, K, C)
        h = _expert_ffn(p, buf, x.dtype)                        # (E,C,d)
        out = _combine_group(h, slot, order, gates_sorted, K)
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xt)
    return out.reshape(B, S, d), aux


def _moe_sharded(p: dict, x, cfg, G: int):
    """``moe_apply`` on DTensors (a dry-run on a mesh), outside expert
    parallelism.  The G token groups split over the mesh dims that hold
    the tokens split (whole groups per rank: every gather and scatter of
    the dispatch stays on the rank); with G = 1, or groups that do not
    divide, the tokens are replicated.  The (G, E, C, d) buffer is pinned
    group-local ("moe_buffer_local"), then to the rule's expert layout
    ("moe_buffer"); the experts run on each rank's slice of it
    (``_experts_sharded``); their output is pinned back ("moe_h",
    "moe_h_local") and combined on the rank; the tokens get
    "moe_tokens"."""
    from torch.distributed.tensor import Partial
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    mesh = hints.mesh_of(x, p["w_gate"])
    R = Replicate()
    xt = hints.reshape(x, T, d)
    tok = [i for i, pl in enumerate(getattr(xt, "placements", ()))
           if G > 1 and isinstance(pl, Shard) and pl.dim == 0]
    if G % math.prod(mesh.size(i) for i in tok):
        tok = []
    gpl = [Shard(0) if i in tok else R for i in range(mesh.ndim)]
    xt_l = hints.to_local(xt, mesh, gpl)
    probs, gate_vals, expert_idx = _route(
        xt_l, hints.to_local(p["router"], mesh, [R] * mesh.ndim, tok), K)

    # aux loss over all T tokens: the per-rank sums are all-reduced
    part = [Partial() if i in tok else R for i in range(mesh.ndim)]
    me = hints.to_local(hints.from_local(probs.sum(0), mesh, part, (E,)),
                        mesh, [R] * mesh.ndim) / T
    cnt = torch.zeros((E,), dtype=torch.float32, device=xt_l.device)
    cnt.index_add_(0, expert_idx.reshape(-1),
                   torch.ones(expert_idx.numel(), device=xt_l.device))
    ce = hints.to_local(hints.from_local(cnt, mesh, part, (E,)), mesh,
                        [R] * mesh.ndim) / (T * K)
    aux = hints.from_local(cfg.router_aux_coef * E * torch.sum(me * ce),
                           mesh, [R] * mesh.ndim, ())

    Gl = G // math.prod(mesh.size(i) for i in tok)
    Tg = T // G
    C = moe_capacity(Tg, cfg)
    parts = [_moe_dispatch_group(xt_l[g * Tg:(g + 1) * Tg],
                                 gate_vals[g * Tg:(g + 1) * Tg],
                                 expert_idx[g * Tg:(g + 1) * Tg], E, K, C)
             for g in range(Gl)]
    buf = hints.from_local(torch.stack([q[0] for q in parts]), mesh, gpl,
                           (G, E, C, d))
    buf = constrain(buf, "moe_buffer_local")
    buf = constrain(buf, "moe_buffer")                          # (G,E,C,d)
    h = _experts_sharded(p, buf, x.dtype)
    h = constrain(h, "moe_h")
    h = constrain(h, "moe_h_local")
    h_l = hints.to_local(h, mesh, gpl)
    out = torch.cat([_combine_group(h_l[g], *parts[g][1:], K)
                     for g in range(Gl)]).to(x.dtype)
    out = constrain(hints.from_local(out, mesh, gpl, (T, d)), "moe_tokens")
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xt)
    return hints.reshape(out, B, S, d), aux


def _experts_sharded(p: dict, buf, dtype):
    """The expert SwiGLU on each rank's slice of a (G, E, C, d) DTensor
    buffer: a mesh dim that splits E runs its experts only; one that
    splits d (decode's weight-stationary layout) contracts its slice of d
    against the matching rows of w_gate / w_up, all-reduces the partial
    sums, and keeps w_down's output split the same way; any other
    all-gathers the weights (FSDP)."""
    from torch.distributed import _functional_collectives as funcol
    mesh = buf.device_mesh
    R = Replicate()
    w_in, w_out, d_split = [], [], []
    split = [i for i, pl in enumerate(buf.placements) if isinstance(pl, Shard)]
    for i, pl in enumerate(buf.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            w_in.append(Shard(0)), w_out.append(Shard(0))
        elif isinstance(pl, Shard) and pl.dim == 3:
            w_in.append(Shard(1)), w_out.append(Shard(2)), d_split.append(i)
        else:
            w_in.append(R), w_out.append(R)
    b = buf.to_local()
    G, El, C, dl = b.shape
    wg, wu = (hints.to_local(p[n], mesh, w_in, split).to(dtype)
              for n in ("w_gate", "w_up"))
    wd = hints.to_local(p["w_down"], mesh, w_out, split).to(dtype)
    rows = b.permute(1, 0, 2, 3).reshape(El, G * C, dl)
    g, u = torch.bmm(rows, wg), torch.bmm(rows, wu)
    for i in d_split:
        g = funcol.all_reduce(g, "sum", mesh.get_group(i))
        u = funcol.all_reduce(u, "sum", mesh.get_group(i))
    h = torch.bmm(silu(g) * u, wd)
    h = h.reshape(El, G, C, -1).permute(1, 0, 2, 3)
    return hints.from_local(h, mesh, list(buf.placements), buf.shape)
