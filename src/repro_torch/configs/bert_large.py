"""BERT-Large — the paper's own Fig. 4/5 estimation subject (24 layers,
d=1024, 16 heads, ff=4096).  Used causally here (the FusionAI DAG and perf
model are attention-direction agnostic).  [Devlin et al. 2018; FusionAI §4]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="bert-large",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=30522,
    source="FusionAI §4 Fig.4/5 subject (BERT-Large)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2,
                n_kv_heads=4, n_heads=4)
