"""Decoder-only transformer of the dense family: parameter init, the
full-sequence forward, and serving — ``prefill`` into the ring KV cache
and one-token ``decode_step`` against it.

Layers are grouped into *periods* (one cycle of ``cfg.layer_pattern``);
every slot's parameters are stacked over periods, as in the JAX package's
tree, so the parameter trees — and the flat-buffer offsets built from
them — match leaf for leaf. The depth loop is a Python loop over periods,
with the remat lattice (``models/remat.py``) at the period boundary.

``global`` and ``local`` slots carry gemma's dense features too:
post-norms after attention and FFN, the sqrt(d_model) embedding scale,
attention and final logit soft-caps, QK-norm and a separate RoPE theta
for the global layers.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import tree
from . import attention, nn
from . import remat as remat_lib
from .config import ModelConfig


def check_supported(cfg: ModelConfig) -> None:
    """Raise for features whose layers are not ported yet, naming the
    ROADMAP.md queue-1 item that ports each."""
    missing = []
    if cfg.is_moe:
        missing.append("MoE blocks (item 10)")
    if cfg.is_encdec:
        missing.append("encoder-decoder stacks (item 10)")
    bad = sorted(set(cfg.layer_pattern) - {"global", "local"})
    if bad:
        missing.append(f"{bad} slots (item 10)")
    if cfg.is_vlm or cfg.mrope_sections is not None:
        missing.append("the VLM frontend / M-RoPE (item 8)")
    if not cfg.tie_embeddings:
        missing.append("an untied LM head (item 8)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md "
            "queue 1)")


def _slot_init(gen, cfg: ModelConfig, lead, device) -> Dict[str, Any]:
    kw = dict(lead=lead, device=device)
    p = {
        "pre_norm": nn.rmsnorm_init(cfg.d_model, **kw),
        "attn": attention.attn_init(gen, cfg, **kw),
        "pre_ffn_norm": nn.rmsnorm_init(cfg.d_model, **kw),
        "ffn": nn.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, **kw),
    }
    if cfg.use_post_norm:
        p["post_norm"] = nn.rmsnorm_init(cfg.d_model, **kw)
        p["post_ffn_norm"] = nn.rmsnorm_init(cfg.d_model, **kw)
    return p


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


def _window_for(cfg: ModelConfig, kind: str, global_window: Optional[int]):
    if kind == "local":
        return cfg.sliding_window
    return global_window  # None: full attention


def _theta_for(cfg: ModelConfig, kind: str):
    if kind == "global" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _apply_slot(p, cfg: ModelConfig, kind: str, x, positions, *, dtype,
                global_window=None, remat_policy: str = "none",
                want_cache: bool = False, max_len: Optional[int] = None,
                lengths=None):
    """Returns (x, ring cache entry or None)."""
    window = _window_for(cfg, kind, global_window)

    def attn_part(sp, x):
        h = nn.rmsnorm(sp["pre_norm"], x, cfg.norm_eps)
        h, kv = attention.attn_block(sp["attn"], cfg, h, positions,
                                     window=window,
                                     rope_theta=_theta_for(cfg, kind),
                                     compute_dtype=dtype)
        if cfg.use_post_norm:
            h = nn.rmsnorm(sp["post_norm"], h, cfg.norm_eps)
        return h, kv

    if want_cache:  # serving: no autograd, so no checkpoint either
        h, kv = attn_part(p, x)
        kv = attention.ring_cache_from_full(kv[0], kv[1], positions, window,
                                            max_len, lengths=lengths)
    else:
        h = remat_lib.checkpoint_block(lambda sp, x: attn_part(sp, x)[0],
                                       remat_policy)(p, x)
        kv = None
    x = x + h
    h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
    h = remat_lib.checkpoint_block(
        lambda fp, hh: nn.ffn(fp, hh, cfg.ffn_kind, compute_dtype=dtype),
        remat_policy)(p["ffn"], h)
    if cfg.use_post_norm:
        h = nn.rmsnorm(p["post_ffn_norm"], h, cfg.norm_eps)
    return x + h, kv


def _embed(params, cfg: ModelConfig, tokens, dtype):
    return nn.embed(params["embed"], tokens, dtype, scale=cfg.embed_scale)


def _lm_head(params, cfg: ModelConfig, x):
    logits = nn.unembed(params["embed"], x, torch.float32)  # tied fp32 head
    return nn.softcap(logits, cfg.final_softcap)


def _periods(blocks):
    """Per-period views of the stacked block params, unbound once."""
    leaves, treedef = tree.flatten(blocks)
    per_period = [torch.unbind(leaf, 0) for leaf in leaves]
    return [tree.unflatten(treedef, [u[i] for u in per_period])
            for i in range(len(per_period[0]))]


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
    x = _embed(params, cfg, tokens, dtype)

    def period_fn(x, slot_params):
        for kind, p in zip(cfg.layer_pattern, slot_params):
            x, _ = _apply_slot(p, cfg, kind, x, positions, dtype=dtype,
                               global_window=global_window,
                               remat_policy=policy)
        return x

    period_fn = remat_lib.checkpoint_period(period_fn, policy)
    # unbind once: one stacked gradient per leaf in the backward, instead
    # of a zero-filled full-depth buffer per period from per-period indexing
    for slot_params in _periods(params["blocks"]):
        x = period_fn(x, slot_params)
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _lm_head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# serving: prefill → ring cache, decode steps
# ---------------------------------------------------------------------------

def supports_ragged_prefill(cfg: ModelConfig) -> bool:
    """True when a right-padded prompt batch prefills exactly: pure
    attention stacks only (causal attention never lets a real query see
    the padding after it). State-carrying blocks would run their scans
    through the padding and MoE routing would let padded tokens take
    expert capacity, so those families prefill exact-length groups."""
    return (not cfg.is_moe
            and all(k in ("global", "local") for k in cfg.layer_pattern))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, global_window: Optional[int] = None,
               device="cuda"):
    """Decode cache: a tuple with one ring per pattern slot, each leaf
    stacked over periods (leading dim P)."""
    check_supported(cfg)
    return tuple(attention.init_kv_cache(
        cfg, batch, max_len, _window_for(cfg, kind, global_window), dtype,
        lead=(cfg.num_periods,), device=device)
        for kind in cfg.layer_pattern)


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
            positions=None, dtype=torch.bfloat16, global_window=None,
            lengths=None):
    """Serving prefill: the full-sequence forward that also builds the
    decode cache (``init_cache``'s layout, in the compute dtype). Returns
    (last-token logits (B, V) fp32, cache).

    The cache is allocated once and each period's rings are written into
    it as the period ends, so a period's intermediates are freed before
    the next runs (what the memory model charges).

    ``lengths`` (B,) serves a right-padded ragged batch: the logits are
    each row's at ``lengths[b] - 1`` and the rings hold real tokens only.
    Exact only where :func:`supports_ragged_prefill`."""
    check_supported(cfg)
    B, S = tokens.shape[:2]
    if lengths is not None and not supports_ragged_prefill(cfg):
        raise ValueError(
            f"{cfg.name}: ragged (right-padded) prefill is only exact for "
            "pure-attention stacks; prefill exact-length groups instead "
            "(see transformer.supports_ragged_prefill)")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=tokens.device)
    x = _embed(params, cfg, tokens, dtype)
    cache = init_cache(cfg, B, max_len, x.dtype, global_window, x.device)
    for i, slot_params in enumerate(_periods(params["blocks"])):
        for kind, p, c in zip(cfg.layer_pattern, slot_params, cache):
            x, kv = _apply_slot(p, cfg, kind, x, positions, dtype=dtype,
                                global_window=global_window,
                                want_cache=True, max_len=max_len,
                                lengths=lengths)
            for name, leaf in c.items():
                leaf[i].copy_(kv[name])
            del kv
    if lengths is None:
        x_last = x[:, -1:]
    else:
        idx = (lengths.long() - 1).clamp(0, S - 1)
        x_last = torch.gather(x, 1, idx[:, None, None].expand(
            B, 1, x.shape[-1]))
    x = nn.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
    return _lm_head(params, cfg, x)[:, 0], cache


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, token, cache, cur_pos, *,
                dtype=torch.bfloat16, global_window=None):
    """One decode step. token: (B, 1) int; cur_pos: (B,) absolute position.

    Returns (logits (B, 1, V) fp32, cache). ``cache`` is updated in
    place, period by period (the JAX package carries it through a
    ``fori_loop`` for the same reason): no second copy of the pool is
    ever made."""
    x = _embed(params, cfg, token, dtype)
    for i, slot_params in enumerate(_periods(params["blocks"])):
        for kind, p, c in zip(cfg.layer_pattern, slot_params, cache):
            h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
            h, _ = attention.attn_decode_step(
                p["attn"], cfg, h, {k: leaf[i] for k, leaf in c.items()},
                cur_pos, window=_window_for(cfg, kind, global_window),
                rope_theta=_theta_for(cfg, kind), compute_dtype=dtype)
            if cfg.use_post_norm:
                h = nn.rmsnorm(p["post_norm"], h, cfg.norm_eps)
            x = x + h
            h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
            h = nn.ffn(p["ffn"], h, cfg.ffn_kind, compute_dtype=dtype)
            if cfg.use_post_norm:
                h = nn.rmsnorm(p["post_ffn_norm"], h, cfg.norm_eps)
            x = x + h
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), cache
