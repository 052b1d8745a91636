"""Qwen3-235B-A22B — MoE decoder: 128 experts, top-8, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-30B-A3B family card, scaled to 235B-A22B]
"""
from repro_torch.models.config import MOE, LayerSpec, ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert FFN width
    vocab_size=151936,
    period=(LayerSpec(ffn=MOE),),
    n_experts=128,
    top_k=8,
    d_expert=1536,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B (family)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2)
