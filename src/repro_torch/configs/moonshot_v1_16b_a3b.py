"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) per-expert
d_ff=1408 vocab=163840, MoE 64 experts top-6 (+2 shared experts, per the
Moonlight / DeepSeek-V3 family design). [hf:moonshotai/Moonlight-16B-A3B]
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=0, vocab_size=163_840,
        layer_pattern=("global",),
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
        num_shared_experts=2, shared_d_ff=1408,
        ffn_kind="swiglu", tie_embeddings=True,
        rope_theta=50_000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-reduced", family="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=0, vocab_size=512,
        layer_pattern=("global",),
        num_experts=4, experts_per_token=2, moe_d_ff=64,
        num_shared_experts=1, shared_d_ff=64,
        ffn_kind="swiglu", rope_theta=50_000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
