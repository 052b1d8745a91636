"""Gemma 3 12B — dense decoder with 5:1 local:global attention, 128k
context.  [hf:google/gemma-3-1b-pt family card, scaled to 12B]
"""
from repro_torch.models.config import (ATTN, DENSE, SWA, LayerSpec,
                                       ModelConfig, reduced)

# period of 6: 5 sliding-window layers then 1 global layer
_PERIOD = tuple(LayerSpec(mixer=SWA if i < 5 else ATTN, ffn=DENSE)
                for i in range(6))

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,              # gemma3 decouples head_dim from d_model
    d_ff=15360,
    vocab_size=262144,
    period=_PERIOD,
    sliding_window=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,    # global-layer base; local layers use the same
                               # base here (single-theta simplification)
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt (family), gemma3 report",
)

SMOKE = reduced(
    CONFIG,
    period=(LayerSpec(mixer=SWA), LayerSpec(mixer=ATTN)),
    n_layers=2,
)
