"""Model configuration for every architecture family in the framework.

A single dataclass covers dense / MoE / SSM / hybrid / VLM / audio(enc-dec)
families; per-layer behaviour is driven by ``layer_pattern``, a cycle of
block kinds repeated over the depth of the network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Block pattern: cycle of kinds, each entry one of
    #   "global"    full causal attention + FFN
    #   "local"     sliding-window causal attention + FFN
    #   "recurrent" RG-LRU block + FFN
    #   "ssm"       Mamba2 (SSD) block, no FFN
    layer_pattern: Tuple[str, ...] = ("global",)
    sliding_window: int = 4096
    # long-context variant: cap "global" layers to this window when serving
    # long_500k (None = true full attention)
    long_context_global_window: Optional[int] = None

    # attention details
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None  # gemma3 uses 1e6 on globals
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl

    # FFN
    ffn_kind: str = "swiglu"  # swiglu | geglu | gelu

    # MoE (active when num_experts > 0; replaces the dense FFN)
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: int = 0

    # encoder-decoder (audio): encoder_layers > 0 => enc-dec model
    encoder_layers: int = 0

    # VLM
    is_vlm: bool = False

    # norms / embeddings
    use_post_norm: bool = False  # gemma2/3 post-attn + post-ffn norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale

    source: str = ""  # citation for the config

    # ---- derived -----------------------------------------------------------
    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.pattern_len == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {self.pattern_len}")
        return self.num_layers // self.pattern_len

    @property
    def ssm_d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_num_heads(self) -> int:
        assert self.ssm_d_inner % self.ssm_head_dim == 0
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def param_count(self) -> int:
        """Total parameters (analytic; used by the memory model + roofline)."""
        d, hd = self.d_model, self.head_dim
        n_attn = (d * (self.num_heads + 2 * self.num_kv_heads) * hd
                  + self.num_heads * hd * d)
        if self.qkv_bias:
            n_attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        n_ffn_dense = d * self.d_ff * (3 if self.ffn_kind in ("swiglu", "geglu") else 2)
        n_moe = 0
        if self.is_moe:
            per_e = d * self.moe_d_ff * (3 if self.ffn_kind in ("swiglu", "geglu") else 2)
            n_moe = self.num_experts * per_e + d * self.num_experts
            n_moe += self.num_shared_experts * d * (self.shared_d_ff or self.moe_d_ff) * 3
        di, N = self.ssm_d_inner, self.ssm_state
        H = self.ssm_num_heads if self.ssm_state else 0
        n_ssm = (d * (2 * di + 2 * N + H) + self.conv_width * (di + 2 * N)
                 + di * d + 2 * H) if self.ssm_state else 0
        w = self.lru_width
        n_rec = (d * 2 * w + self.conv_width * w + 2 * w * (w // max(self.num_heads, 1))
                 + w * d + 2 * w) if self.lru_width else 0

        total = 0
        for kind in self.layer_pattern:
            if kind in ("global", "local"):
                total += n_attn + (n_moe if self.is_moe else n_ffn_dense) + 4 * d
            elif kind == "recurrent":
                total += n_rec + n_ffn_dense + 4 * d
            elif kind == "ssm":
                total += n_ssm + 2 * d
        total *= self.num_periods
        if self.is_encdec:
            # encoder: same stack non-causal + cross-attn in decoder
            total += self.encoder_layers * (n_attn + n_ffn_dense + 4 * d)
            total += self.num_layers * (n_attn + 2 * d)  # cross attention
        total += self.vocab_size * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        per_e = self.d_model * self.moe_d_ff * (3 if self.ffn_kind in ("swiglu", "geglu") else 2)
        inactive = (self.num_experts - self.experts_per_token) * per_e * self.num_layers
        return self.param_count() - int(inactive)


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
