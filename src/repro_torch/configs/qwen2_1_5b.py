"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias. [arXiv:2407.10671]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        head_dim=128, d_ff=8960, vocab_size=151_936,
        layer_pattern=("global",), qkv_bias=True,
        ffn_kind="swiglu", tie_embeddings=True,
        rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-reduced", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("global",), qkv_bias=True,
        ffn_kind="swiglu", rope_theta=1_000_000.0,
        source="arXiv:2407.10671",
    )
