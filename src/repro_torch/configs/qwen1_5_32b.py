"""Qwen1.5-32B — dense decoder with QKV bias.
[hf:Qwen/Qwen1.5-0.5B family card, scaled to 32B]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,            # MHA-style GQA with kv=40
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B (family)",
)

SMOKE = reduced(CONFIG, n_layers=2,
                period=CONFIG.period * 2,
                n_kv_heads=4, n_heads=4)  # keep MHA (kv == q heads)
