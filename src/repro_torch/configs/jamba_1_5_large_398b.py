"""Jamba-1.5-Large (398B total / 94B active) — hybrid Mamba+attention MoE.

72 layers in 9 blocks of 8 (1 attention + 7 Mamba per block, 1:7
interleave), MoE (16 experts, top-2) on every second layer.
[arXiv:2403.19887 / arXiv:2408.12570]
"""
from repro_torch.models.config import (ATTN, DENSE, MAMBA, MOE, LayerSpec,
                                       ModelConfig, reduced)

# Jamba block of 8: attention at index 0; MoE on odd layers (every 2nd).
_PERIOD = tuple(
    LayerSpec(mixer=ATTN if i == 0 else MAMBA, ffn=MOE if i % 2 == 1 else DENSE)
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    period=_PERIOD,
    n_experts=16,
    top_k=2,
    d_expert=24576,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    source="arXiv:2403.19887 (Jamba), 2408.12570 (Jamba-1.5)",
)

# Reduced same-family smoke: keep the 1 attn : 3 mamba interleave + MoE on
# every 2nd layer, tiny dims.
SMOKE = reduced(
    CONFIG,
    period=tuple(LayerSpec(mixer=ATTN if i == 0 else MAMBA,
                           ffn=MOE if i % 2 == 1 else DENSE) for i in range(4)),
    n_layers=4,
)
