"""Architecture registry of the port.

``get(arch_id)`` / ``get_reduced(arch_id)`` return a ``ModelConfig``.
``ARCHS`` lists every architecture the JAX package supports; this port
builds the dense family — qwen2-1.5b (GQA, QKV bias), gemma2-9b and
gemma3-12b (local/global windows, soft-caps, post-norms, embedding
scale, QK-norm, dual RoPE theta) — and the others raise an error that
names the ROADMAP item porting their model family.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {"qwen2-1.5b": "qwen2_1_5b",
                            "gemma2-9b": "gemma2_9b",
                            "gemma3-12b": "gemma3_12b"}

ARCHS: List[str] = [
    "gemma2-9b", "grok-1-314b", "recurrentgemma-2b", "gemma3-12b",
    "qwen2-1.5b", "mixtral-8x22b", "mamba2-780m", "qwen2-vl-72b",
    "moonshot-v1-16b-a3b", "seamless-m4t-medium",
]

# ROADMAP queue 1 item 10 ports the other model families (MoE, SSM,
# RG-LRU, enc-dec); the VLM frontend / M-RoPE and the untied LM head are
# the rest of item 8.
_NOT_PORTED = ("{arch} is not ported yet: ROADMAP.md queue 1 item 10 "
               "('Other model families') and the rest of item 8 (the VLM "
               "frontend, an untied LM head) bring its layers to "
               "repro_torch; ported: {ported}")


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCHS}")
    if arch_id not in _MODULES:
        raise NotImplementedError(_NOT_PORTED.format(
            arch=arch_id, ported=sorted(_MODULES)))
    return import_module(f".{_MODULES[arch_id]}", __package__)


def get(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
