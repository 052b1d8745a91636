"""Llama-3.1 405B — dense decoder, GQA kv=8, 128k vocab.
[arXiv:2407.21783]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783 (Llama 3)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2)
