"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060]"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=50_280,
        layer_pattern=("ssm",),
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        conv_width=4, tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m-reduced", family="ssm",
        num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
        head_dim=0, d_ff=0, vocab_size=512,
        layer_pattern=("ssm",),
        ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_chunk=8,
        conv_width=4,
        source="arXiv:2405.21060",
    )
