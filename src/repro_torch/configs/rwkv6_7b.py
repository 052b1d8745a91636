"""RWKV-6 "Finch" 7B — attention-free RNN with data-dependent decay.
[arXiv:2404.05892]
"""
from repro_torch.models.config import (DENSE, RWKV, LayerSpec, ModelConfig,
                                       reduced)

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    period=(LayerSpec(mixer=RWKV, ffn=DENSE),),
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
    source="arXiv:2404.05892 (RWKV-6 Finch)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2)
