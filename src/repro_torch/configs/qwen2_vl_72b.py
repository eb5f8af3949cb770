"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution (vision tower stubbed; the LM
backbone consumes precomputed patch embeddings). [arXiv:2409.12191]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=29_568, vocab_size=152_064,
        layer_pattern=("global",), qkv_bias=True,
        mrope_sections=(16, 24, 24),  # t/h/w frequency split of head_dim/2
        ffn_kind="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0, is_vlm=True,
        source="arXiv:2409.12191",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b-reduced", family="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("global",), qkv_bias=True,
        mrope_sections=(4, 6, 6),
        ffn_kind="swiglu", tie_embeddings=False,
        rope_theta=1_000_000.0, is_vlm=True,
        source="arXiv:2409.12191",
    )
