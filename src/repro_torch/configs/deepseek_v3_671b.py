"""DeepSeek-V3 671B — MLA + MoE (1 shared + 256 routed, top-8) + MTP.

61 layers: first 3 dense FFN, remaining 58 MoE.  Multi-head Latent
Attention with q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128;
one multi-token-prediction module.  [arXiv:2412.19437]
"""
from repro_torch.models.config import ATTN, DENSE, MOE, LayerSpec, ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,            # MLA: all heads share one latent cache
    head_dim=128,
    d_ff=18432,                # dense-layer FFN width
    vocab_size=129280,
    prefix_layers=(LayerSpec(ffn=DENSE),) * 3,
    period=(LayerSpec(mixer=ATTN, ffn=MOE),),
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    source="arXiv:2412.19437 (DeepSeek-V3)",
)

SMOKE = reduced(CONFIG, n_layers=3, prefix_layers=CONFIG.prefix_layers[:1],
                period=CONFIG.period * 2, n_heads=4, n_kv_heads=4)
