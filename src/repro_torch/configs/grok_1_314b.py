"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=0, vocab_size=131_072,
        layer_pattern=("global",),
        num_experts=8, experts_per_token=2, moe_d_ff=32_768,
        attn_softcap=30.0, final_softcap=30.0,
        ffn_kind="geglu", embed_scale=True, tie_embeddings=True,
        rope_theta=10_000.0,
        source="hf:xai-org/grok-1",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-reduced", family="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=0, vocab_size=512,
        layer_pattern=("global",),
        num_experts=4, experts_per_token=2, moe_d_ff=256,
        attn_softcap=30.0, final_softcap=30.0,
        ffn_kind="geglu", embed_scale=True,
        source="hf:xai-org/grok-1",
    )
