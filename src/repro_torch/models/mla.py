"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437) — the
counterpart of ``repro.models.mla``.

Two execution paths over a *latent* KV cache (rank ``kv_lora_rank`` plus a
shared ``qk_rope_dim`` rope key):

* train / prefill: decompress the latent into per-head K/V and run the
  plain blocked ``attention`` (cheap when S tokens are processed at once);
* decode: **matrix-absorbed** attention — queries are pushed through the
  K up-projection so scores are taken directly against the latent cache
  (the latent as both K and V, the rope pool as the second score
  contraction), and the output stays in latent space until the V
  up-projection.  With a block table and ``use_kernel`` this is the
  paged-decode kernel's head-tiled instance.

As in the rest of the port, cache writes update the cache tensors in
place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import hints
from repro_torch.models.hints import constrain
from repro_torch.models.layers import (attention, dense_init, gather_pages,
                                       gather_pos, ring_write, rmsnorm,
                                       rmsnorm_init, rope)


def mla_init(gen: torch.Generator, cfg, lead=(), device=None) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq_a": dense_init(gen, d, qr, **kw),
        "q_norm": rmsnorm_init(qr, **kw),
        "wq_b": dense_init(gen, qr, H * (dn + dr), **kw),
        "wkv_a": dense_init(gen, d, kr + dr, **kw),
        "kv_norm": rmsnorm_init(kr, **kw),
        "wk_b": dense_init(gen, kr, H * dn, **kw),
        "wv_b": dense_init(gen, kr, H * dv, **kw),
        "wo": dense_init(gen, H * dv, d,
                         scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def mla_cache_init(batch: int, cache_len: int, cfg, dtype=torch.bfloat16,
                   lead=(), device=None) -> dict:
    shape = (*lead, batch, cache_len)
    return {
        "ckv": torch.zeros((*shape, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((*shape, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos": torch.full(shape, -1, dtype=torch.int32, device=device),
    }


def mla_paged_cache_init(num_blocks: int, page_size: int, cfg,
                         dtype=torch.bfloat16, lead=(), device=None) -> dict:
    """Paged latent pool: block-table-addressed pages of the compressed
    (kv_lora_rank + qk_rope_dim) latent cache."""
    return mla_cache_init(num_blocks, page_size, cfg, dtype, lead, device)


def _project_q(p, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = rmsnorm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (q @ p["wq_b"].to(x.dtype)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p, x, cfg, positions):
    kr = cfg.kv_lora_rank
    kv = x @ p["wkv_a"].to(x.dtype)                             # (B,S,kr+dr)
    ckv = rmsnorm(kv[..., :kr], p["kv_norm"], cfg.norm_eps)
    krope = rope(kv[..., None, kr:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, krope


def _matmul(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ w.astype(dtype)`` with JAX's type promotion (a float32 cache
    against bfloat16 activations multiplies in float32)."""
    dt = torch.promote_types(a.dtype, dtype)
    return a.to(dt) @ w.to(dt)


def mla_apply(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: Optional[dict] = None, decode: bool = False,
              kv_chunk: int = 1024, masked_slots: bool = False,
              table=None, use_kernel: bool = False):
    """MLA block.  Returns (out, cache); the cache is written in place.
    ``masked_slots=True`` selects the per-row masked cache write (rows
    with position -1 are write no-ops).  With a (B, n_cols) block
    ``table`` the cache is a paged latent pool: writes scatter through
    the table; absorbed decode attends the pool page-wise, the naive
    prefill path gathers the dense latent view.  ``use_kernel=True`` runs
    paged absorbed decode through the paged-decode kernel (the latent
    pool is both K and V, the rope pool the second score contraction)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    scale = (dn + dr) ** -0.5

    q_nope, q_rope = _project_q(p, x, cfg, positions)
    ckv, krope = _project_kv_latent(p, x, cfg, positions)

    attn_table = None
    if isinstance(table, dict):
        # per-cache-kind block tables: MLA layers are full-attention kind
        table = table["attn"]
    if cache is not None and table is not None:
        ring_write(cache["ckv"], ckv, positions, table=table, kind="ckv")
        ring_write(cache["krope"], krope, positions, table=table,
                   kind="krope")
        ring_write(cache["pos"], positions, positions, table=table,
                   kind="pos")
        if decode:
            # pool-shaped latents flow straight into the paged attention
            ckv_all, krope_all = cache["ckv"], cache["krope"]
            kv_pos, attn_table = cache["pos"], table
        else:
            ckv_all = gather_pages(cache["ckv"], table)
            krope_all = gather_pages(cache["krope"], table)
            kv_pos = gather_pos(cache["pos"], table)
    elif cache is not None:
        for name, val in (("ckv", ckv), ("krope", krope),
                          ("pos", positions)):
            ring_write(cache[name], val, positions, per_row=masked_slots,
                       kind=name)
        ckv_all, krope_all = cache["ckv"], cache["krope"]
        kv_pos = cache["pos"]
    else:
        ckv_all, krope_all, kv_pos = ckv, krope, positions

    if decode:
        # absorbed path: score against the latent directly; the rope term
        # enters as the second contraction (q_extra / k_extra)
        wk_b = p["wk_b"].to(x.dtype).reshape(kr, H, dn)
        q_lat = torch.einsum("bshd,khd->bshk", q_nope, wk_b).contiguous()
        # align the absorbed queries' latent / rope dims with the cache
        # sharding (kr and dr live on the model axis during decode)
        q_lat = constrain(q_lat, "attn_q")
        q_rope = constrain(q_rope, "attn_q")
        v_lat = ckv_all[:, :, None, :]       # (B,T,1,kr) / pool (N,P,1,kr)
        o_lat = attention(q_lat, v_lat, v_lat, positions, kv_pos,
                          scale=scale, kv_chunk=kv_chunk, q_extra=q_rope,
                          k_extra=krope_all[:, :, None, :], table=attn_table,
                          use_kernel=use_kernel)                # (B,S,H,kr)
        wv_b = p["wv_b"].to(x.dtype).reshape(kr, H, dv)
        o = torch.einsum("bshk,khd->bshd", o_lat, wv_b)
    else:
        # naive path: decompress K/V per head
        T = ckv_all.shape[1]
        k_nope = _matmul(ckv_all, p["wk_b"], x.dtype).reshape(B, T, H, dn)
        v = _matmul(ckv_all, p["wv_b"], x.dtype).reshape(B, T, H, dv)
        k = torch.cat([k_nope, krope_all[:, :, None, :].to(k_nope.dtype)
                       .expand(B, T, H, dr)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = attention(q, k, v, positions, kv_pos, scale=scale,
                      kv_chunk=kv_chunk)
    out = hints.reshape(o, B, S, H * dv) @ p["wo"].to(o.dtype)
    return out, cache
