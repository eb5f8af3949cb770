"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context, QK-norm.
[hf:google/gemma-3-1b-pt family]

For the ``long_500k`` serving shape the global layers use a 32k window
(``long_context_global_window``) — the beyond-paper windowed-global variant
documented in DESIGN.md; all other shapes use true full attention on the
global layers."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
        head_dim=256, d_ff=15360, vocab_size=262_144,
        layer_pattern=("local",) * 5 + ("global",), sliding_window=1024,
        use_qk_norm=True, ffn_kind="geglu", use_post_norm=True,
        embed_scale=True, tie_embeddings=True,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        long_context_global_window=32_768,
        source="arXiv:2503.19786 (Gemma 3); hf:google/gemma-3-1b-pt",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-reduced", family="dense",
        num_layers=6, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        layer_pattern=("local",) * 5 + ("global",), sliding_window=16,
        use_qk_norm=True, ffn_kind="geglu", use_post_norm=True,
        embed_scale=True, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        long_context_global_window=64,
        source="hf:google/gemma-3-1b-pt",
    )
