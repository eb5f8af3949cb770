"""Decoder-only transformer: parameter init and the full-sequence forward
for ``global`` / ``local`` attention slots (the dense family).

Layers are grouped into *periods* (one cycle of ``cfg.layer_pattern``);
every slot's parameters are stacked over periods, as in the JAX package's
tree, so the parameter trees — and the flat-buffer offsets built from
them — match leaf for leaf. The depth loop is a Python loop over periods,
with the remat lattice (``models/remat.py``) at the period boundary.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import tree
from . import attention, nn
from . import remat as remat_lib
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for features whose layers are not ported yet."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE blocks")
    if cfg.is_encdec:
        missing.append("encoder-decoder stacks")
    if cfg.is_vlm or cfg.mrope_sections is not None:
        missing.append("the VLM frontend / M-RoPE")
    if cfg.use_post_norm or cfg.embed_scale or cfg.rope_theta_global:
        missing.append("gemma-style post-norms / embed scale / dual theta")
    if not cfg.tie_embeddings:
        missing.append("an untied LM head")
    bad = sorted(set(cfg.layer_pattern) - {"global", "local"})
    if bad:
        missing.append(f"{bad} slots")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md "
            "queue 1 items 8 and 10)")


def _slot_init(gen, cfg: ModelConfig, lead, device) -> Dict[str, Any]:
    kw = dict(lead=lead, device=device)
    return {
        "pre_norm": nn.rmsnorm_init(cfg.d_model, **kw),
        "attn": attention.attn_init(gen, cfg, **kw),
        "pre_ffn_norm": nn.rmsnorm_init(cfg.d_model, **kw),
        "ffn": nn.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, **kw),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Random fp32 parameters from ``seed`` on ``device``; block leaves are
    stacked over periods (leading dim ``cfg.num_periods``). The values
    differ from the JAX package's (another generator); tests load the
    reference's parameters through ``repro_torch.weights``."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = (cfg.num_periods,)
    return {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": nn.rmsnorm_init(cfg.d_model, device=device),
        "blocks": tuple(_slot_init(gen, cfg, lead, device)
                        for _ in cfg.layer_pattern),
    }


def _apply_slot(p, cfg: ModelConfig, kind: str, x, positions, *, dtype,
                global_window=None, remat_policy: str = "none"):
    window = cfg.sliding_window if kind == "local" else global_window

    def attn_part(sp, x):
        h = nn.rmsnorm(sp["pre_norm"], x, cfg.norm_eps)
        h, _ = attention.attn_block(sp["attn"], cfg, h, positions,
                                    window=window, compute_dtype=dtype)
        return h

    x = x + remat_lib.checkpoint_block(attn_part, remat_policy)(p, x)
    h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
    return x + remat_lib.checkpoint_block(
        lambda fp, hh: nn.ffn(fp, hh, cfg.ffn_kind, compute_dtype=dtype),
        remat_policy)(p["ffn"], h)


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            dtype=torch.bfloat16, global_window=None, remat: bool = True,
            remat_policy: Optional[str] = None, return_hidden=False):
    """Full-sequence forward. tokens: (B, S) int.

    Returns (logits (B, S, V) fp32, aux_loss scalar) — the dense family
    has no auxiliary loss, so aux is 0 as in the JAX package."""
    check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)
    B, S = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = nn.embed(params["embed"], tokens, dtype)

    def period_fn(x, slot_params):
        for kind, p in zip(cfg.layer_pattern, slot_params):
            x = _apply_slot(p, cfg, kind, x, positions, dtype=dtype,
                            global_window=global_window, remat_policy=policy)
        return x

    period_fn = remat_lib.checkpoint_period(period_fn, policy)
    # unbind once: one stacked gradient per leaf in the backward, instead
    # of a zero-filled full-depth buffer per period from per-period indexing
    leaves, treedef = tree.flatten(params["blocks"])
    per_period = [torch.unbind(leaf, 0) for leaf in leaves]
    for i in range(cfg.num_periods):
        x = period_fn(x, tree.unflatten(treedef, [u[i] for u in per_period]))
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    logits = nn.unembed(params["embed"], x, torch.float32)  # tied fp32 head
    return nn.softcap(logits, cfg.final_softcap), aux
