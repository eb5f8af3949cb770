"""Architecture registry of the port.

``get(arch_id)`` / ``get_reduced(arch_id)`` return a ``ModelConfig``.
``ARCHS`` lists every architecture the JAX package supports (``SHAPES``
its assigned input shapes), and the port builds them all: dense — qwen2-1.5b (GQA, QKV bias), gemma2-9b and
gemma3-12b (local/global windows, soft-caps, post-norms, embedding scale,
QK-norm, dual RoPE theta); ssm — mamba2-780m; hybrid — recurrentgemma-2b
(RG-LRU + local attention); MoE — moonshot-v1-16b-a3b, mixtral-8x22b
(untied LM head) and grok-1-314b; VLM — qwen2-vl-72b (the patch-embedding
prefix and M-RoPE); audio — seamless-m4t-medium (encoder-decoder,
``models.encdec``).
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig
from .shapes import SHAPES, InputShape  # noqa: F401

_MODULES: Dict[str, str] = {"qwen2-1.5b": "qwen2_1_5b",
                            "gemma2-9b": "gemma2_9b",
                            "gemma3-12b": "gemma3_12b",
                            "mamba2-780m": "mamba2_780m",
                            "recurrentgemma-2b": "recurrentgemma_2b",
                            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
                            "mixtral-8x22b": "mixtral_8x22b",
                            "grok-1-314b": "grok_1_314b",
                            "qwen2-vl-72b": "qwen2_vl_72b",
                            "seamless-m4t-medium": "seamless_m4t_medium"}

ARCHS: List[str] = [
    "gemma2-9b", "grok-1-314b", "recurrentgemma-2b", "gemma3-12b",
    "qwen2-1.5b", "mixtral-8x22b", "mamba2-780m", "qwen2-vl-72b",
    "moonshot-v1-16b-a3b", "seamless-m4t-medium",
]


# the archs whose attention is sub-quadratic at 524,288 tokens (the
# reference's)
LONG_500K_ARCHS = {"mamba2-780m", "recurrentgemma-2b", "mixtral-8x22b",
                   "gemma3-12b"}


def supports_shape(arch_id: str, shape_name: str) -> bool:
    """Whether the reference assigns ``shape_name`` to ``arch_id``:
    ``long_500k`` only to the sub-quadratic archs."""
    if shape_name == "long_500k":
        return arch_id in LONG_500K_ARCHS
    return True


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCHS}")
    return import_module(f".{_MODULES[arch_id]}", __package__)


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
