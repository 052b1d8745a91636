"""MusicGen-medium — decoder-only transformer over EnCodec tokens.
The EnCodec conv codec is STUBBED per the assignment: ``input_specs``
supplies precomputed frame embeddings (ext_embed_dim=128, the EnCodec
latent width); this config is the acoustic LM backbone.
[arXiv:2306.05284]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,             # MHA
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,           # EnCodec codebook size
    ext_embed_dim=128,         # EnCodec latent dim (stub input)
    source="arXiv:2306.05284 (MusicGen)",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2,
                n_kv_heads=4, n_heads=4)
