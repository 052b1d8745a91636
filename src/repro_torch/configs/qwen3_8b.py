"""Qwen3-8B — dense decoder, GQA kv=8, per-head qk-norm.
[hf:Qwen/Qwen3-8B]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2)
