"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcapping.
[arXiv:2408.00118]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=14336, vocab_size=256_000,
        layer_pattern=("local", "global"), sliding_window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        ffn_kind="geglu", use_post_norm=True, embed_scale=True,
        rope_theta=10_000.0, tie_embeddings=True,
        source="arXiv:2408.00118",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-reduced", family="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("local", "global"), sliding_window=16,
        attn_softcap=50.0, final_softcap=30.0,
        ffn_kind="geglu", use_post_norm=True, embed_scale=True,
        source="arXiv:2408.00118",
    )
