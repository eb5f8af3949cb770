"""Decoder-only transformer: the dense, MoE, SSM (Mamba2) and hybrid
(RG-LRU + local attention) families — parameter init, the full-sequence
forward, and serving: ``prefill`` into the decode cache and one-token
``decode_step`` against it.

Layers are grouped into *periods* (one cycle of ``cfg.layer_pattern``);
every slot's parameters are stacked over periods, as in the JAX package's
tree, so the parameter trees — and the flat-buffer offsets built from
them — match leaf for leaf. The depth loop is a Python loop over periods,
with the remat lattice (``models/remat.py``) at the period boundary.

A ``global`` or ``local`` slot is attention plus an FFN, or an MoE FFN
when ``cfg.is_moe``; a ``recurrent`` slot is an RG-LRU block plus an FFN;
an ``ssm`` slot is one Mamba2 block. The dense slots carry gemma's
features too: post-norms after attention and FFN, the sqrt(d_model)
embedding scale, attention and final logit soft-caps, QK-norm and a
separate RoPE theta for the global layers. A config with
``tie_embeddings=False`` has its own LM head, ``params["unembed"]``.

The VLM backbone (qwen2-vl) adds ``params["vision_proj"]``, which maps
precomputed patch embeddings (the stubbed vision tower's, width
``VISION_EMBED_DIM``) into the first positions of the sequence, and
M-RoPE over (3, B, S) position streams. Encoder-decoder configs are
``models.encdec``'s.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import tree
from . import attention, moe, nn, recurrent, ssm
from . import remat as remat_lib
from .config import ModelConfig

VISION_EMBED_DIM = 1280  # the stubbed ViT's output width (qwen2-vl card)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a config this decoder-only stack does not build: an
    encoder-decoder (``models.encdec`` builds it) or a layer kind it
    does not know."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder config: call models.encdec "
            "(init_params, forward, init_decode_cache, decode_step), not "
            "the decoder-only models.transformer")
    bad = sorted(set(cfg.layer_pattern)
                 - {"global", "local", "recurrent", "ssm"})
    if bad:
        raise ValueError(f"{cfg.name}: unknown layer kinds {bad}")


def _slot_init(gen, cfg: ModelConfig, kind: str, lead, device
               ) -> Dict[str, Any]:
    kw = dict(lead=lead, device=device)
    p = {"pre_norm": nn.rmsnorm_init(cfg.d_model, **kw)}
    if kind == "ssm":
        p["ssm"] = ssm.ssm_init(gen, cfg, **kw)
        return p
    if kind == "recurrent":
        p["rec"] = recurrent.recurrent_init(gen, cfg, **kw)
    else:
        p["attn"] = attention.attn_init(gen, cfg, **kw)
        if cfg.use_post_norm:
            p["post_norm"] = nn.rmsnorm_init(cfg.d_model, **kw)
            p["post_ffn_norm"] = nn.rmsnorm_init(cfg.d_model, **kw)
    p["pre_ffn_norm"] = nn.rmsnorm_init(cfg.d_model, **kw)
    if cfg.is_moe and kind != "recurrent":
        p["moe"] = moe.moe_init(gen, cfg, **kw)
    else:
        p["ffn"] = nn.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, **kw)
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
    params = {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, device),
        "final_norm": nn.rmsnorm_init(cfg.d_model, device=device),
        "blocks": tuple(_slot_init(gen, cfg, kind, lead, device)
                        for kind in cfg.layer_pattern),
    }
    if cfg.is_vlm:
        params["vision_proj"] = nn.dense_init(gen, VISION_EMBED_DIM,
                                              cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = nn.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                          device=device)
    return params


def _window_for(cfg: ModelConfig, kind: str, global_window: Optional[int]):
    if kind == "local":
        return cfg.sliding_window
    return global_window  # None: full attention


def _theta_for(cfg: ModelConfig, kind: str):
    if kind == "global" and cfg.rope_theta_global is not None:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _apply_slot(p, cfg: ModelConfig, kind: str, x, positions, *, dtype,
                global_window=None, mrope_positions=None,
                remat_policy: str = "none", want_cache: bool = False,
                max_len: Optional[int] = None, lengths=None):
    """Returns (x, aux loss, decode cache entry or None). Serving
    (``want_cache``) runs without autograd, so without checkpoints."""
    policy = "none" if want_cache else remat_policy
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":  # the state blocks checkpoint themselves
        h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        h, entry = ssm.ssm_block(p["ssm"], cfg, nn.seq_gathered(h),
                                 compute_dtype=dtype,
                                 return_cache=want_cache,
                                 remat_policy=policy)
        return x + nn.seq_sharded(h), aux, (entry if want_cache else None)
    if kind == "recurrent":
        h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        h, entry = recurrent.recurrent_block(p["rec"], cfg,
                                             nn.seq_gathered(h),
                                             compute_dtype=dtype,
                                             return_cache=want_cache,
                                             remat_policy=policy)
        h = nn.seq_sharded(h)
        entry = entry if want_cache else None
    else:
        window = _window_for(cfg, kind, global_window)

        def attn_part(sp, x):
            h = nn.rmsnorm(sp["pre_norm"], x, cfg.norm_eps)
            h, kv = attention.attn_block(sp["attn"], cfg, h, positions,
                                         window=window,
                                         rope_theta=_theta_for(cfg, kind),
                                         compute_dtype=dtype,
                                         mrope_positions=mrope_positions)
            if cfg.use_post_norm:
                h = nn.rmsnorm(sp["post_norm"], h, cfg.norm_eps)
            return h, kv

        if want_cache:
            h, kv = attn_part(p, x)
            entry = attention.ring_cache_from_full(
                kv[0], kv[1], positions, window, max_len, lengths=lengths)
        else:
            h = remat_lib.checkpoint_block(lambda sp, x: attn_part(sp, x)[0],
                                           policy)(p, x)
            entry = None
    x = x + h
    h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
    if "moe" in p:
        h, aux = moe.moe_block(p["moe"], cfg, h, compute_dtype=dtype,
                               remat_policy=policy)
    else:
        h = remat_lib.checkpoint_block(
            lambda fp, hh: nn.ffn(fp, hh, cfg.ffn_kind, compute_dtype=dtype),
            policy)(p["ffn"], h)
    if cfg.use_post_norm and kind != "recurrent":
        h = nn.rmsnorm(p["post_ffn_norm"], h, cfg.norm_eps)
    return x + h, aux, entry


def _embed(params, cfg: ModelConfig, tokens, dtype):
    return nn.embed(params["embed"], tokens, dtype, scale=cfg.embed_scale)


def _embed_inputs(params, cfg: ModelConfig, tokens, vision_embeds, dtype):
    """Token embeddings; for a VLM given ``vision_embeds`` (B, n_vis,
    VISION_EMBED_DIM), their projections take the first n_vis positions
    (the prefix-image layout), scaled like the tokens in their dtype."""
    x = _embed(params, cfg, tokens, dtype)
    if cfg.is_vlm and vision_embeds is not None:
        vis = nn.dense(params["vision_proj"], vision_embeds, dtype)
        if cfg.embed_scale:
            vis = vis * torch.tensor(cfg.d_model ** 0.5, dtype=vis.dtype)
        x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    return x


def _check_mrope(mrope_positions, B: int, S: int) -> None:
    """One micro-batch's streams are (3, B, S): a split batch carries the
    leaf as (N_Smu, 3, N_mu, S), built already split."""
    if (mrope_positions is not None
            and tuple(mrope_positions.shape) != (3, B, S)):
        raise ValueError(
            f"mrope_positions of shape {tuple(mrope_positions.shape)}, "
            f"expected (3, {B}, {S}) for tokens ({B}, {S}); a split batch "
            "holds it as (N_Smu, 3, N_mu, S), split before the plan's "
            "split_minibatch, which splits every leaf on axis 0")


def _lm_head(params, cfg: ModelConfig, x):
    """fp32 logits: the tied embedding, or the untied ``unembed``. On a
    mesh they are vocab-sharded over ``model`` (batch over the data
    axes), so the loss reduces over the vocab shards and no rank holds
    the full-vocab logits."""
    if cfg.tie_embeddings:
        logits = nn.unembed(params["embed"], x, torch.float32)
    else:
        logits = nn.dense(params["unembed"], x, torch.float32)
    spec = [None] * logits.dim()
    spec[0] = ("pod", "data")
    spec[-1] = "model"
    logits = nn.shard_hint(logits, *spec)
    return nn.softcap(logits, cfg.final_softcap)


def _periods(blocks):
    """Per-period views of the stacked block params, unbound once."""
    leaves, treedef = tree.flatten(blocks)
    per_period = [torch.unbind(leaf, 0) for leaf in leaves]
    return [tree.unflatten(treedef, [u[i] for u in per_period])
            for i in range(len(per_period[0]))]


def _positions(tokens):
    """The standard positions (B, S) of a token batch; beside DTensor
    tokens (a GSPMD step) a DTensor of their placements, so each rank
    builds the masks and rotations of its own samples only."""
    B, S = tokens.shape[:2]
    if not nn._is_dtensor(tokens):
        return torch.arange(S, device=tokens.device)[None].expand(B, S)
    from torch.distributed.tensor import DTensor
    local = tokens.to_local()
    pos = torch.arange(S, device=local.device)[None].expand(
        local.shape[0], S)
    return DTensor.from_local(pos, tokens.device_mesh, tokens.placements,
                              run_check=False)


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            vision_embeds=None, mrope_positions=None, dtype=torch.bfloat16,
            global_window=None, remat: bool = True,
            remat_policy: Optional[str] = None, return_hidden=False):
    """Full-sequence forward. tokens: (B, S) int; for a VLM optionally
    ``vision_embeds`` (B, n_vis, VISION_EMBED_DIM) and ``mrope_positions``
    (3, B, S).

    Returns (logits (B, S, V) fp32, aux loss scalar): the MoE router's
    load-balance losses summed over every layer (0 without MoE), as in
    the JAX package."""
    check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)
    B, S = tokens.shape[:2]
    _check_mrope(mrope_positions, B, S)
    if positions is None:
        positions = _positions(tokens)
    # sequence parallelism on a mesh: the reference measured it a win for
    # dense/hybrid/ssm stacks and a regression for MoE — gate by family
    nn.set_seq_shard(False if cfg.is_moe else None)
    if not return_hidden:
        # on a mesh, one FSDP gather of the tied table serves the lookup
        # and the head, and their summed gradient is reduce-scattered once
        params = _tied_gathered(params, cfg)
    x = nn.seq_sharded(_embed_inputs(params, cfg, tokens, vision_embeds,
                                     dtype))

    def period_fn(x, slot_params):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p in zip(cfg.layer_pattern, slot_params):
            x, aux, _ = _apply_slot(p, cfg, kind, x, positions, dtype=dtype,
                                    global_window=global_window,
                                    mrope_positions=mrope_positions,
                                    remat_policy=policy)
            aux_total = aux_total + aux
        return x, aux_total

    period_fn = remat_lib.checkpoint_period(period_fn, policy)
    # unbind once: one stacked gradient per leaf in the backward, instead
    # of a zero-filled full-depth buffer per period from per-period indexing
    auxes = []
    for slot_params in _periods(params["blocks"]):
        x, aux = period_fn(x, slot_params)
        auxes.append(aux)
    aux = torch.stack(auxes).sum()
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return _lm_head(params, cfg, x), aux


# ---------------------------------------------------------------------------
# serving: prefill → decode cache, decode steps
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
    """Decode cache: a tuple with one entry per pattern slot, each leaf
    stacked over periods (leading dim P) — a ring for attention slots,
    the state and conv tail for ``ssm`` and ``recurrent`` slots (their
    states fp32, as in the JAX package)."""
    check_supported(cfg)
    kw = dict(lead=(cfg.num_periods,), device=device)
    caches = []
    for kind in cfg.layer_pattern:
        if kind == "ssm":
            caches.append(ssm.init_ssm_cache(cfg, batch, dtype, **kw))
        elif kind == "recurrent":
            caches.append(recurrent.init_recurrent_cache(cfg, batch, dtype,
                                                         **kw))
        else:
            caches.append(attention.init_kv_cache(
                cfg, batch, max_len, _window_for(cfg, kind, global_window),
                dtype, **kw))
    return tuple(caches)


def _tied_gathered(params, cfg: ModelConfig):
    """On a mesh, the tied table gathered once (over every axis but
    ``model``) for the lookup and the head; unchanged elsewhere."""
    if not cfg.tie_embeddings:
        return params
    return {**params, "embed": {**params["embed"], "table": nn._fsdp_gather(
        params["embed"]["table"])}}


def _serving_inputs(tokens, vision_embeds, mrope_positions):
    """A GSPMD prefill's inputs laid out as the model reads them: the
    tokens and patches over the batch axes only (placed by the
    reference's ``cache_specs`` their sequence or width may be split
    over ``model``, which the lookup does not take), the M-RoPE streams
    over the batch axes on their batch dim."""
    if not nn._is_dtensor(tokens):
        return tokens, vision_embeds, mrope_positions
    batch = ("pod", "data")
    tokens = nn.shard_hint(tokens, batch, None)
    if vision_embeds is not None:
        vision_embeds = nn.shard_hint(vision_embeds, batch, None, None)
    if mrope_positions is not None:
        mrope_positions = nn.shard_hint(mrope_positions, None, batch, None)
    return tokens, vision_embeds, mrope_positions


def _cache_for(cfg: ModelConfig, batch: int, max_len: int, dtype,
               global_window, device, placed: bool):
    """``init_cache``, or on a GSPMD mesh (``placed``) the same cache as
    DTensors placed by the reference's ``cache_specs``, each rank
    allocating its block only."""
    if not placed:
        return init_cache(cfg, batch, max_len, dtype, global_window, device)
    from ..launch import sharding  # deferred: launch imports the models
    return sharding.placed_cache(
        init_cache(cfg, batch, max_len, dtype, global_window, "meta"),
        nn.current_mesh(), device)


@nn.serving_mode
def prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
            positions=None, vision_embeds=None, mrope_positions=None,
            dtype=torch.bfloat16, global_window=None, lengths=None):
    """Serving prefill: the full-sequence forward that also builds the
    decode cache (``init_cache``'s layout, the rings and conv tails in the
    compute dtype). Returns (last-token logits (B, V) fp32, cache).

    The cache is allocated once and each period's entries are written
    into it as the period ends, so a period's intermediates are freed
    before the next runs (what the memory model charges).

    ``lengths`` (B,) serves a right-padded ragged batch: the logits are
    each row's at ``lengths[b] - 1`` and the rings hold real tokens only.
    Exact only where :func:`supports_ragged_prefill`. ``vision_embeds``
    and ``mrope_positions`` as in :func:`forward`.

    Inside ``nn.use_mesh`` on DTensor params and tokens (a GSPMD
    prefill) the cache comes out placed by the reference's
    ``cache_specs``: each rank allocates and writes its own blocks."""
    check_supported(cfg)
    B, S = tokens.shape[:2]
    _check_mrope(mrope_positions, B, S)
    if lengths is not None and not supports_ragged_prefill(cfg):
        raise ValueError(
            f"{cfg.name}: ragged (right-padded) prefill is only exact for "
            "pure-attention stacks; this config has state-carrying or MoE "
            "blocks — prefill exact-length groups instead "
            "(see transformer.supports_ragged_prefill)")
    tokens, vision_embeds, mrope_positions = _serving_inputs(
        tokens, vision_embeds, mrope_positions)
    if positions is None:
        positions = _positions(tokens)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=tokens.device)
    params = _tied_gathered(params, cfg)
    nn.set_seq_shard(False if cfg.is_moe else None)
    try:
        x = nn.seq_sharded(_embed_inputs(params, cfg, tokens, vision_embeds,
                                         dtype))
        cache = _cache_for(cfg, B, max_len, x.dtype, global_window,
                           x.device, nn._is_dtensor(x))
        for i, slot_params in enumerate(_periods(params["blocks"])):
            for kind, p, c in zip(cfg.layer_pattern, slot_params, cache):
                x, _, entry = _apply_slot(
                    p, cfg, kind, x, positions, dtype=dtype,
                    global_window=global_window,
                    mrope_positions=mrope_positions, want_cache=True,
                    max_len=max_len, lengths=lengths)
                for name, leaf in c.items():
                    nn.write_period(leaf, i, entry[name])
                del entry
        if lengths is None:
            x_last = nn.last_row(x)
        else:
            idx = (lengths.long() - 1).clamp(0, S - 1)
            x_last = torch.gather(x, 1, idx[:, None, None].expand(
                B, 1, x.shape[-1]))
        x = nn.rmsnorm(params["final_norm"], x_last, cfg.norm_eps)
        return _lm_head(params, cfg, x)[:, 0], cache
    finally:
        nn.set_seq_shard(None)


@nn.serving_mode
def decode_step(params, cfg: ModelConfig, token, cache, cur_pos, *,
                dtype=torch.bfloat16, global_window=None):
    """One decode step. token: (B, 1) int; cur_pos: (B,) absolute position.

    Returns (logits (B, 1, V) fp32, cache). ``cache`` is updated in
    place, period by period (the JAX package carries it through a
    ``fori_loop`` for the same reason): no second copy of the pool is
    ever made. Attention writes its ring slot; a state slot's new state
    and conv tail are copied over the old. A cache of DTensors (placed by
    the reference's ``cache_specs`` on a GSPMD mesh, inside
    ``nn.use_mesh``) is written block by block on each rank."""
    params = _tied_gathered(params, cfg)
    x = _embed(params, cfg, token, dtype)
    for i, slot_params in enumerate(_periods(params["blocks"])):
        for kind, p, c in zip(cfg.layer_pattern, slot_params, cache):
            view = {k: nn.period(leaf, i) for k, leaf in c.items()}
            h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
            if kind == "ssm":
                h, new = ssm.ssm_decode_step(p["ssm"], cfg, h, view,
                                             compute_dtype=dtype)
            elif kind == "recurrent":
                h, new = recurrent.recurrent_decode_step(
                    p["rec"], cfg, h, view, compute_dtype=dtype)
            else:  # writes its ring slot in place
                h, new = attention.attn_decode_step(
                    p["attn"], cfg, h, view, cur_pos,
                    window=_window_for(cfg, kind, global_window),
                    rope_theta=_theta_for(cfg, kind), compute_dtype=dtype)
                if cfg.use_post_norm:
                    h = nn.rmsnorm(p["post_norm"], h, cfg.norm_eps)
            if new is not view:
                for k, leaf in c.items():
                    nn.write_period(leaf, i, new[k])
            x = x + h
            if kind == "ssm":
                continue
            h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
            if "moe" in p:
                h, _ = moe.moe_block(p["moe"], cfg, h, compute_dtype=dtype)
            else:
                h = nn.ffn(p["ffn"], h, cfg.ffn_kind, compute_dtype=dtype)
            if cfg.use_post_norm and kind != "recurrent":
                h = nn.rmsnorm(p["post_ffn_norm"], h, cfg.norm_eps)
            x = x + h
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), cache
