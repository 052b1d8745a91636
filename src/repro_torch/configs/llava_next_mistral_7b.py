"""LLaVA-NeXT (Mistral-7B backbone) — VLM.  The anyres vision tower
(CLIP ViT-L/336 + 2-layer MLP projector) is STUBBED per the assignment:
``input_specs`` supplies precomputed patch embeddings (ext_embed_dim=1024,
the projector input width); this config is the language backbone that
consumes them interleaved with text tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    ext_embed_dim=1024,        # CLIP ViT-L penultimate features (stub input)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = reduced(CONFIG, n_layers=2, period=CONFIG.period * 2)
