"""recurrentgemma-2b [hybrid]: 26L (26 temporal-mixing blocks) d_model=2560
10H (MQA kv=1) d_ff=7680 vocab=256000 — RG-LRU + local attention, 2
recurrent : 1 local. [arXiv:2402.19427]

26 blocks do not divide into periods of (r, r, l), so the pattern is 13
blocks long, (r, r, l) × 4 + (r,), stacked over 2 periods: the card's 26
layers and its 2 : 1 ratio (18 recurrent, 8 local).
"""
from ..models.config import ModelConfig

_PATTERN_13 = ("recurrent", "recurrent", "local") * 4 + ("recurrent",)


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        layer_pattern=_PATTERN_13, sliding_window=2048,
        lru_width=2560, conv_width=4,
        ffn_kind="geglu", embed_scale=True, tie_embeddings=True,
        rope_theta=10_000.0,
        source="arXiv:2402.19427",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced", family="hybrid",
        num_layers=3, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("recurrent", "recurrent", "local"), sliding_window=16,
        lru_width=128, conv_width=4,
        ffn_kind="geglu", embed_scale=True,
        source="arXiv:2402.19427",
    )
