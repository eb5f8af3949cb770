"""seamless-m4t-medium [audio]: 12L(+12L decoder) d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206 — encoder-decoder; the mel+conv audio frontend is
stubbed (encoder consumes precomputed frame embeddings).
[arXiv:2308.11596]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=4096, vocab_size=256_206,
        layer_pattern=("global",), encoder_layers=12,
        ffn_kind="gelu", tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2308.11596",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-reduced", family="audio",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("global",), encoder_layers=2,
        ffn_kind="gelu",
        source="arXiv:2308.11596",
    )
