"""GPT-3-style model with 24 layers and hidden size 4096 — the paper's
Fig. 6 estimation subject.  [FusionAI §4 Fig.6]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gpt3-24l",
    arch_type="dense",
    n_layers=24,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=16384,
    vocab_size=50257,
    source="FusionAI §4 Fig.6 subject (GPT-3 24L/4096)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2,
                n_kv_heads=4, n_heads=4)
