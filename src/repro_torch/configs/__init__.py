"""Architecture registry of the port.

``get(arch_id)`` / ``get_reduced(arch_id)`` return a ``ModelConfig``.
``ARCHS`` lists every architecture the JAX package supports. The port
builds the decoder-only families: dense — qwen2-1.5b (GQA, QKV bias),
gemma2-9b and gemma3-12b (local/global windows, soft-caps, post-norms,
embedding scale, QK-norm, dual RoPE theta); ssm — mamba2-780m; hybrid —
recurrentgemma-2b (RG-LRU + local attention); MoE — moonshot-v1-16b-a3b,
mixtral-8x22b (untied LM head) and grok-1-314b. The other two raise an
error that names the ROADMAP item porting their layers.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ModelConfig

_MODULES: Dict[str, str] = {"qwen2-1.5b": "qwen2_1_5b",
                            "gemma2-9b": "gemma2_9b",
                            "gemma3-12b": "gemma3_12b",
                            "mamba2-780m": "mamba2_780m",
                            "recurrentgemma-2b": "recurrentgemma_2b",
                            "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
                            "mixtral-8x22b": "mixtral_8x22b",
                            "grok-1-314b": "grok_1_314b"}

ARCHS: List[str] = [
    "gemma2-9b", "grok-1-314b", "recurrentgemma-2b", "gemma3-12b",
    "qwen2-1.5b", "mixtral-8x22b", "mamba2-780m", "qwen2-vl-72b",
    "moonshot-v1-16b-a3b", "seamless-m4t-medium",
]

# not ported: seamless-m4t-medium (the encoder-decoder stack and the
# gelu FFN, ROADMAP queue 1 item 10) and qwen2-vl-72b (the VLM frontend
# and M-RoPE, item 8)
_NOT_PORTED = ("{arch} is not ported yet: ROADMAP.md queue 1 item 10 "
               "(the encoder-decoder stack) and item 8 (the VLM frontend, "
               "M-RoPE) bring its layers to repro_torch; ported: {ported}")


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
