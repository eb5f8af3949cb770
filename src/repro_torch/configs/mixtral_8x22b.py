"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=0, vocab_size=32_768,
        layer_pattern=("local",), sliding_window=4096,
        num_experts=8, experts_per_token=2, moe_d_ff=16_384,
        ffn_kind="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0,
        source="arXiv:2401.04088",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-reduced", family="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=0, vocab_size=512,
        layer_pattern=("local",), sliding_window=16,
        num_experts=4, experts_per_token=2, moe_d_ff=256,
        ffn_kind="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0,
        source="arXiv:2401.04088",
    )
