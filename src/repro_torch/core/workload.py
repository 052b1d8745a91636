"""Analytic per-block workload descriptors (FLOPs, params) for any
``ModelConfig`` — the numbers that feed the DAG nodes, the PALEO perf
model (§3.7), the scheduler (§3.8) and the roofline's MODEL_FLOPS term.

Forward FLOPs conventions: matmul (m,k)x(k,n) = 2mkn; causal attention
scores counted at the causal 1/2 factor; backward = 2x forward
(grad-wrt-input + grad-wrt-weight).

A copy of ``repro.core.workload``: the port imports nothing from the JAX
package, so it keeps its own.
"""
from __future__ import annotations

from typing import Dict


def block_workloads(cfg, *, batch: int, seq: int, dtype_bytes: int = 2,
                    kv_cache_len: int = 0) -> Dict[str, float]:
    """Per-block forward FLOPs and parameter counts.

    kv_cache_len > 0 switches attention score terms to decode mode
    (seq query tokens attending to a cache of that length).
    """
    d, T = cfg.d_model, batch * seq
    w: Dict[str, float] = {}

    # ---- attention (full or MLA) ---------------------------------------
    if cfg.n_heads:
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.use_mla:
            qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
            dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            params = (d * qr + qr * hq * (dn + dr) + d * (kr + dr)
                      + kr * hq * dn + kr * hq * dv + hq * dv * d)
            qk_dim, v_dim = dn + dr, dv
        else:
            params = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
            qk_dim, v_dim = hd, hd
        proj_flops = 2.0 * T * params
        if kv_cache_len:
            score_ctx = kv_cache_len
            causal_factor = 1.0
        else:
            score_ctx = seq
            causal_factor = 0.5
        score = 2.0 * batch * seq * score_ctx * hq * (qk_dim + v_dim) * causal_factor
        w["attn_params"] = params
        w["attn_flops"] = proj_flops + score
        # sliding-window attention: context capped at the window
        sw = max(1, min(cfg.sliding_window or 1, score_ctx))
        sw_score = 2.0 * batch * seq * sw * hq * (qk_dim + v_dim)
        w["swa_params"] = params
        w["swa_flops"] = proj_flops + (min(sw_score, score) if cfg.sliding_window else score)

    # ---- mamba -----------------------------------------------------------
    di, ds, dtr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
    m_params = (d * 2 * di + di * cfg.mamba_d_conv + di * (dtr + 2 * ds)
                + dtr * di + di * ds + di * d)
    scan_flops = T * di * ds * 10.0          # exp, 2 mul-adds, reduce per (di,ds)
    w["mamba_params"] = m_params
    w["mamba_flops"] = 2.0 * T * m_params + scan_flops

    # ---- rwkv6 -----------------------------------------------------------
    if cfg.d_model % cfg.rwkv_head_dim == 0:
        H, hd_r = cfg.rwkv_n_heads, cfg.rwkv_head_dim
        r_params = 5 * d * d + d * cfg.rwkv_decay_lora * 2 + H * hd_r
        w["rwkv_params"] = r_params
        w["rwkv_flops"] = 2.0 * T * r_params + T * H * hd_r * hd_r * 6.0

    # ---- FFNs ------------------------------------------------------------
    w["dense_params"] = 3.0 * d * cfg.d_ff
    w["dense_flops"] = 2.0 * T * w["dense_params"]
    if cfg.n_experts:
        e_params = cfg.n_experts * 3.0 * d * cfg.d_expert
        sh_params = cfg.n_shared_experts * 3.0 * d * cfg.d_expert
        w["moe_params"] = e_params + sh_params + d * cfg.n_experts
        w["moe_flops"] = (2.0 * T * 3.0 * d * cfg.d_expert
                          * (cfg.top_k + cfg.n_shared_experts)
                          + 2.0 * T * d * cfg.n_experts)
    # ---- embed / head ------------------------------------------------------
    w["embed_params"] = cfg.vocab_size * d
    w["head_params"] = 0.0 if cfg.tie_embeddings else cfg.vocab_size * d
    w["head_flops"] = 2.0 * T * d * cfg.vocab_size
    return w


def model_flops(cfg, *, batch: int, seq: int, kind: str = "train",
                kv_cache_len: int = 0) -> float:
    """End-to-end step FLOPs: the 'useful compute' roofline numerator.
    train = 3x forward (fwd + 2x bwd); prefill/decode = forward only."""
    w = block_workloads(cfg, batch=batch, seq=seq, kv_cache_len=kv_cache_len)
    layers = list(cfg.prefix_layers) + list(cfg.period) * (
        (cfg.n_layers - len(cfg.prefix_layers)) // max(1, len(cfg.period)))
    fwd = w["head_flops"]
    for spec in layers:
        fwd += w[f"{spec.mixer}_flops"] + w[f"{spec.ffn}_flops"]
    return 3.0 * fwd if kind == "train" else fwd


def model_flops_6nd(cfg, *, tokens: int) -> float:
    """The classic 6·N·D (dense) / 6·N_active·D (MoE) estimate."""
    return 6.0 * cfg.param_counts()["active"] * tokens


REMAT_FACTORS = {
    # fraction of the forward recomputed during backward
    "full": 1.0,          # checkpoint everything per period
    "dots": 1.0 / 3.0,    # matmul outputs saved; elementwise/norm recomputed
    "dots_no_batch": 0.5,
    "none": 0.0,
}


def step_flops(cfg, *, batch: int, seq: int, kind: str,
               kv_cache_len: int = 0, remat: bool = True,
               remat_policy: str = "full") -> float:
    """Executed FLOPs per step including rematerialization overhead
    (train = fwd + recompute·fwd + 2×fwd for bwd)."""
    fwd = model_flops(cfg, batch=batch, seq=seq, kind="prefill",
                      kv_cache_len=kv_cache_len)
    if kind == "train":
        rf = REMAT_FACTORS[remat_policy] if remat else 0.0
        return (3.0 + rf) * fwd
    return fwd


def cache_bytes(cfg, *, batch: int, cache_len: int, dtype_bytes: int = 2
                ) -> float:
    """Total decode-state bytes across all layers (KV / MLA latent / SSM)."""
    layers = list(cfg.prefix_layers) + list(cfg.period) * (
        (cfg.n_layers - len(cfg.prefix_layers)) // max(1, len(cfg.period)))
    total = 0.0
    for spec in layers:
        if spec.mixer == "attn":
            if cfg.use_mla:
                total += batch * cache_len * (cfg.kv_lora_rank
                                              + cfg.qk_rope_dim) * dtype_bytes
            else:
                total += 2 * batch * cache_len * cfg.n_kv_heads \
                    * cfg.head_dim * dtype_bytes
        elif spec.mixer == "swa":
            w = min(cfg.sliding_window or cache_len, cache_len)
            total += 2 * batch * w * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
        elif spec.mixer == "mamba":
            total += batch * cfg.mamba_d_inner * (cfg.mamba_d_state * 4
                                                  + (cfg.mamba_d_conv - 1) * dtype_bytes)
        elif spec.mixer == "rwkv":
            total += batch * cfg.d_model * cfg.rwkv_head_dim * 4 \
                + batch * cfg.d_model * dtype_bytes
    return total


def analytic_hbm_bytes(cfg, *, batch: int, seq: int, kind: str,
                       kv_cache_len: int = 0) -> float:
    """Estimated global HBM traffic per step (documented estimate, used
    for the roofline memory term; XLA's module counter can't be used
    because while-loop bodies are counted once).

    train:  params 3 reads (fwd/remat/bwd) + f32 grads W+R + Adam state
            R+W (master+mu+nu) + param write  ≈ 40·N bytes,
            activations ≈ 12 passes of n_layers·B·S·d·2B,
            logits ≈ 4·B·S·V bytes (chunked, recomputed once).
    prefill: params read + activation writes + KV write + KV re-read.
    decode:  params read (all experts touched by dense-buffer MoE
             dispatch) + full cache read + cache write.
    """
    N = cfg.param_counts()["total"]
    d = cfg.d_model
    acts = cfg.n_layers * batch * seq * d * 2.0
    if kind == "train":
        logits = 4.0 * batch * seq * cfg.vocab_size
        return 40.0 * N + 12.0 * acts + logits
    if kind == "prefill":
        cb = cache_bytes(cfg, batch=batch, cache_len=seq)
        return 2.0 * N + 4.0 * acts + 2.0 * cb
    # decode
    cb = cache_bytes(cfg, batch=batch, cache_len=kv_cache_len or seq)
    return 2.0 * N + 2.0 * cb
