"""Decoder layers in PyTorch: the counterparts of ``repro.models.layers``
for full-attention models with dense or mixture-of-experts FFNs.

Layer math is plain functions on tensors; parameters are nested dicts of
tensors under the JAX package's key names.  Unlike the JAX package, the
cache writes (``ring_write`` and the helpers above it) update the cache
tensors IN PLACE and return them, so a serving engine keeps one copy of
its pools.  Sliding-window attention (``attn_apply`` with ``window > 0``)
waits for a later slice of the port.  The dense layers are
differentiable by autograd when they run without a cache (training);
MoE is forward only, like the reference (its ``optimization_barrier``
has no differentiation rule).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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
              use_kernel: bool = False) -> torch.Tensor:
    """Flash-style attention, the scan path of ``repro.models.layers``.

    q: (B, S, Hq, D); k: (B, T, Hkv, D); v: (B, T, Hkv, Dv); q_pos
    (B, S) and kv_pos (B, T) int32, kv_pos < 0 marks invalid entries.
    Paged mode (``table`` (B, n_cols) given): k / v / kv_pos (and
    k_extra) are block pools (N, page, ...) and each online-softmax step
    gathers ``cb = kv_chunk // page`` table columns, so the float32
    accumulation order equals the dense path's whenever page | kv_chunk.

    ``use_kernel=True`` sends paged single-token causal decode (table
    given, S == 1) to ``kernels.ops.paged_attention`` — the Hopper kernel
    on CUDA tensors.  Returns (B, S, Hq, Dv) in q.dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[-1]
    assert Hq % Hkv == 0, (Hq, Hkv)
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
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
    (B, n_cols) block ``table`` is given.  The cache is written in place;
    returns (out, cache).  ``use_kernel``: paged single-token decode runs
    the paged-decode kernel, and self-attention with no cache (whose
    positions must be arange(S)) the flash-attention kernel."""
    if window > 0:
        raise NotImplementedError(
            "repro_torch: sliding-window attention is not ported yet")
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    attn_table = None
    if cache is not None and table is not None:
        if isinstance(table, dict):
            table = table["attn"]
        paged_cache_update(cache, k, v, positions, table)
        k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
        attn_table = table
    elif cache is not None:
        full_k, full_v, kv_pos, _ = cache_update(cache, k, v, positions,
                                                 per_row=masked_slots)
        if S <= cache["k"].shape[1]:
            k, v = full_k, full_v
        else:
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
            out = out.transpose(1, 2).reshape(B, S, hq * hd)
            return row_dot(out, p["wo"]), cache
    out = attention(q, k, v, positions, kv_pos, window=window,
                    softcap=cfg.logits_softcap, kv_chunk=kv_chunk,
                    table=attn_table, use_kernel=use_kernel)
    return row_dot(out.reshape(B, S, hq * hd), p["wo"]), cache


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
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
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
      ``pool[table[b, pos // page], pos % page]``.  Entries with position
      < 0, past the table or on an unallocated (-1) page are dropped —
      filtered, never clamped.  (The JAX version's SWA ring argument
      waits for the sliding-window slice.)"""
    if table is not None:
        page = buf.shape[1]
        n_cols = table.shape[1]
        col = torch.div(positions, page, rounding_mode="floor")
        blk = torch.gather(table, 1, col.clamp(0, n_cols - 1).long())
        ok = (positions >= 0) & (col < n_cols) & (blk >= 0)
        _masked_put(buf, blk.long() * page + positions % page, val, ok)
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
    p0 = int(positions[0, 0]) % T
    if S == T:
        buf.copy_(torch.roll(val, p0, dims=1))
        return buf
    start = min(p0, T - S)          # dynamic_update_slice clamps the start
    buf[:, start:start + S] = val
    return buf


def _masked_put(buf: torch.Tensor, dst: torch.Tensor, val: torch.Tensor,
                ok: torch.Tensor) -> None:
    """Row ``dst[j]`` of ``buf`` viewed as (rows, ...) takes ``val[j]``
    for every j with ``ok[j]``, with no host sync (a boolean filter would
    wait for the device).  A dropped entry instead writes the first kept
    entry's value to that entry's row — or, when nothing is kept, row 0's
    own value back to row 0 — so every repeated index carries identical
    values and the order of the writes cannot matter."""
    flat = buf.view((-1,) + tuple(buf.shape[2:]))
    dst, ok = dst.reshape(-1).long(), ok.reshape(-1)
    val = val.to(buf.dtype).reshape((dst.shape[0],) + tuple(flat.shape[1:]))
    any_ok = ok.any()
    j0 = torch.argmax(ok.to(torch.int32))              # first kept entry
    d0 = torch.where(any_ok, dst[j0], 0)
    v0 = torch.where(any_ok, val[j0], flat[0])
    keep = ok.view((-1,) + (1,) * (val.ndim - 1))
    flat.index_put_((torch.where(ok, dst, d0),), torch.where(keep, val, v0))


def cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                 positions: torch.Tensor, per_row: bool = False):
    """Write S new entries at slot = position % cache_len, in place.
    Returns (full_k, full_v, kv_pos, cache)."""
    T = cache["k"].shape[1]
    if k.shape[1] > T:
        k, v, positions = k[:, -T:], v[:, -T:], positions[:, -T:]
    ring_write(cache["k"], k, positions, per_row=per_row)
    ring_write(cache["v"], v, positions, per_row=per_row)
    ring_write(cache["pos"], positions, positions, per_row=per_row)
    return cache["k"], cache["v"], cache["pos"], cache


def paged_cache_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       positions: torch.Tensor, table: torch.Tensor) -> dict:
    """Scatter S new entries into the paged pool through the block table,
    in place (position -1 and unallocated pages are write no-ops)."""
    ring_write(cache["k"], k, positions, table=table)
    ring_write(cache["v"], v, positions, table=table)
    ring_write(cache["pos"], positions, positions, table=table)
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
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return row_dot(g * u, p["w_down"])


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


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """Sort-based top-k MoE.  x: (B,S,d) -> (out, aux_loss).

    The reference's path on one device (one token group, G = 1): every
    token of the call — idle serving rows' padding included — routes
    through the router and fills the per-expert capacity in token order,
    and assignments beyond capacity are dropped.  The experts run as
    batched matmuls over the (E, C, d) buffer.  The Switch-style aux loss
    is ``router_aux_coef * E * sum(mean prob * assignment fraction)``.
    Expert parallelism over a mesh (``repro.models.moe_ep``) waits for
    the distributed plane."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(T, cfg)

    xt = x.reshape(T, d)
    logits = xt.float() @ p["router"].float()                   # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)        # (T,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # --- load-balance auxiliary loss (Switch-style) ---------------------
    me = probs.mean(dim=0)                                      # (E,)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device)
    ce.index_add_(0, expert_idx.reshape(-1),
                  torch.full((T * K,), 1.0 / (T * K), device=x.device))
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    buf, slot, order, gates_sorted = _moe_dispatch_group(
        xt, gate_vals, expert_idx, E, K, C)

    # --- batched expert FFN ----------------------------------------------
    g = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = torch.bmm(g * u, p["w_down"].to(x.dtype))               # (E,C,d)

    # --- gather back + combine with gates --------------------------------
    # Assignment i of the sorted order is flat assignment order[i] = token
    # * K + k, so writing row i at order[i] puts every (token, k) in its
    # own row of a (T, K, d) buffer (a dropped one gets the zero trash
    # row).  The K terms are then added onto 0.0 in float32 in the fixed
    # order k = 0, 1, ..., K-1: no atomics, so the bits are the same in
    # every run for any K.  At K = 2 this is the old scatter-add's
    # 0 + a + b exactly.
    h_flat = torch.cat([h.reshape(E * C, d),
                        torch.zeros((1, d), dtype=h.dtype, device=h.device)])
    per_assign = h_flat[slot].float() * gates_sorted[:, None]
    by_token = torch.empty_like(per_assign)
    by_token[order] = per_assign
    by_token = by_token.reshape(T, K, d)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + by_token[:, k]
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + ffn_apply(p["shared"], xt)
    return out.reshape(B, S, d), aux
