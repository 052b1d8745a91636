"""Model configuration for the repro model zoo (PyTorch port).

A copy of ``repro.models.config``: the port imports nothing from the JAX
package, so it keeps its own ``ModelConfig``.  A single ``ModelConfig``
describes every architecture in the assigned pool (dense / MoE / SSM /
hybrid / VLM / audio backbones).  Layers are grouped into *stacks* of
identical repeating periods; the port's forward pass loops over the
leading period axis of the stacked parameters and caches.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

# mixer kinds
ATTN = "attn"          # full causal attention
SWA = "swa"            # sliding-window causal attention
MAMBA = "mamba"        # Mamba selective-scan block
RWKV = "rwkv"          # RWKV6 time-mix block

# ffn kinds
DENSE = "dense"
MOE = "moe"


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a repeating period."""
    mixer: str = ATTN          # attn | swa | mamba | rwkv
    ffn: str = DENSE           # dense | moe

    def __post_init__(self):
        assert self.mixer in (ATTN, SWA, MAMBA, RWKV), self.mixer
        assert self.ffn in (DENSE, MOE), self.ffn


@dataclass(frozen=True)
class StackSpec:
    """``n_periods`` repetitions of the layer tuple ``period``.

    The forward pass scans over the period axis; layers inside one period
    are unrolled (they may be heterogeneous, e.g. Jamba's 1 attn + 7 mamba).
    """
    period: Tuple[LayerSpec, ...]
    n_periods: int

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int                       # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # --- attention options -------------------------------------------------
    attn_bias: bool = False            # QKV bias (qwen1.5)
    qk_norm: bool = False              # RMSNorm on q,k per head (qwen3)
    rope_theta: float = 10_000.0
    sliding_window: int = 0            # window size for SWA layers
    logits_softcap: float = 0.0        # tanh soft-capping (gemma-style), 0=off

    # --- layer pattern ------------------------------------------------------
    # Repeating period of LayerSpecs; replicated over the depth.  Prefix
    # layers (e.g. DeepSeek's first-3-dense) are expressed via
    # ``prefix_layers`` which are unrolled before the scanned stacks.
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    prefix_layers: Tuple[LayerSpec, ...] = ()

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                  # per-expert ffn width (0 -> d_ff)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- Mamba (jamba) -------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0             # 0 -> ceil(d_model/16)

    # --- RWKV6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # --- MLA (deepseek) ------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MTP (deepseek multi-token prediction) -------------------------------
    mtp_depth: int = 0                 # number of extra future-token modules

    # --- modality frontends (stubs) ------------------------------------------
    # vlm/audio: inputs arrive as precomputed embeddings of shape
    # (batch, seq, ext_embed_dim); a learned projector maps to d_model.
    ext_embed_dim: int = 0

    # --- misc ----------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                   # citation for the config

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_expert == 0 and self.n_experts:
            object.__setattr__(self, "d_expert", self.d_ff)
        if self.mamba_dt_rank == 0:
            object.__setattr__(self, "mamba_dt_rank", max(1, math.ceil(self.d_model / 16)))
        n_pattern = len(self.prefix_layers) + len(self.period) * max(
            0, (self.n_layers - len(self.prefix_layers)) // max(1, len(self.period)))
        assert n_pattern == self.n_layers, (
            f"{self.name}: n_layers={self.n_layers} not covered by "
            f"prefix({len(self.prefix_layers)}) + k*period({len(self.period)})")

    # ------------------------------------------------------------------
    @property
    def stacks(self) -> Tuple[StackSpec, ...]:
        """Scanned stacks after the unrolled prefix."""
        n_rest = self.n_layers - len(self.prefix_layers)
        n_periods = n_rest // len(self.period)
        return (StackSpec(self.period, n_periods),) if n_periods else ()

    @property
    def is_attention_free(self) -> bool:
        layers = self.prefix_layers + self.period
        return all(l.mixer in (MAMBA, RWKV) for l in layers)

    @property
    def supports_long_decode(self) -> bool:
        """True when decode memory/compute is sub-quadratic in context:
        SSM / hybrid / sliding-window archs."""
        layers = self.prefix_layers + self.period
        return any(l.mixer in (MAMBA, RWKV, SWA) for l in layers)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    # --- parameter counting (for roofline MODEL_FLOPS) ------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d = self.d_model
        counts = {"embed": self.vocab_size * d,
                  "head": 0 if self.tie_embeddings else self.vocab_size * d}
        per_layer_total = per_layer_active = 0.0
        layers = list(self.prefix_layers) + list(self.period) * (
            (self.n_layers - len(self.prefix_layers)) // max(1, len(self.period)))
        for spec in layers:
            if spec.mixer in (ATTN, SWA):
                if self.use_mla:
                    qh = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    mix = (d * self.q_lora_rank + self.q_lora_rank * qh
                           + d * (self.kv_lora_rank + self.qk_rope_dim)
                           + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                           + self.n_heads * self.v_head_dim * d)
                else:
                    q = self.n_heads * self.head_dim
                    kv = self.n_kv_heads * self.head_dim
                    mix = d * q + 2 * d * kv + q * d
            elif spec.mixer == MAMBA:
                di, ds = self.mamba_d_inner, self.mamba_d_state
                mix = (d * 2 * di + di * self.mamba_d_conv
                       + di * (self.mamba_dt_rank + 2 * ds)
                       + self.mamba_dt_rank * di + di * ds + di * d)
            elif spec.mixer == RWKV:
                mix = 4 * d * d + d * self.rwkv_decay_lora * 2 + d * d  # r,k,v,g,o + decay lora
            else:
                raise ValueError(spec.mixer)
            if spec.ffn == MOE:
                ffn_tot = self.n_experts * 3 * d * self.d_expert \
                    + self.n_shared_experts * 3 * d * self.d_expert + d * self.n_experts
                ffn_act = (self.top_k + self.n_shared_experts) * 3 * d * self.d_expert \
                    + d * self.n_experts
            else:
                ffn_tot = ffn_act = 3 * d * self.d_ff
            per_layer_total += mix + ffn_tot
            per_layer_active += mix + ffn_act
        counts["layers_total"] = per_layer_total
        counts["layers_active"] = per_layer_active
        counts["total"] = counts["embed"] + counts["head"] + per_layer_total
        counts["active"] = counts["embed"] + counts["head"] + per_layer_active
        return counts


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family, tiny dims (2 layers, d_model<=512,
    <=4 experts)."""
    period = cfg.period
    prefix = cfg.prefix_layers
    # keep one period + (maybe) one prefix layer, so the family structure
    # (hybrid interleave, moe placement) survives in miniature.
    n_layers = len(period) + (1 if prefix else 0)
    small = dict(
        n_layers=n_layers,
        prefix_layers=prefix[:1],
        d_model=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(2, cfg.n_kv_heads) if cfg.n_kv_heads else 0,
        head_dim=64 if cfg.n_heads else 0,
        d_ff=512,
        vocab_size=512,
        n_experts=min(4, cfg.n_experts),
        top_k=min(2, cfg.top_k),
        d_expert=128 if cfg.n_experts else 0,
        n_shared_experts=min(1, cfg.n_shared_experts),
        sliding_window=64 if cfg.sliding_window else 0,
        mamba_d_state=8,
        mamba_dt_rank=16,
        rwkv_head_dim=64,
        rwkv_decay_lora=16,
        q_lora_rank=64 if cfg.q_lora_rank else 0,
        kv_lora_rank=64 if cfg.kv_lora_rank else 0,
        qk_nope_dim=32 if cfg.qk_nope_dim else 0,
        qk_rope_dim=32 if cfg.qk_rope_dim else 0,
        v_head_dim=64 if cfg.v_head_dim else 0,
        ext_embed_dim=64 if cfg.ext_embed_dim else 0,
        mtp_depth=min(1, cfg.mtp_depth),
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
