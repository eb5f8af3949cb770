"""Encoder-decoder transformer (the seamless-m4t family).

The modality frontend (mel spectrogram and conv feature extractor) is
stubbed, as in the JAX package: the encoder takes precomputed frame
embeddings ``(B, S_enc, d_model)``. The encoder is non-causal full
attention with RoPE; each decoder layer is causal self attention, cross
attention over the encoder's output and an FFN; the LM head is the tied
embedding in fp32, then the final soft-cap.

The parameter tree is the JAX package's: ``embed``, ``enc_layers``,
``enc_norm``, ``dec_layers`` and ``final_norm``, each layer's leaves
stacked on a leading ``(L,)`` axis. The depth loops are Python loops,
with the remat lattice (``models/remat.py``) at the layer boundary and,
under ``full``, around every block.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import attention, nn
from . import remat as remat_lib
from .config import ModelConfig
from .transformer import _periods


def _enc_layer_init(gen, cfg: ModelConfig, lead, device):
    kw = dict(lead=lead, device=device)
    return {"pre_norm": nn.rmsnorm_init(cfg.d_model, **kw),
            "attn": attention.attn_init(gen, cfg, **kw),
            "pre_ffn_norm": nn.rmsnorm_init(cfg.d_model, **kw),
            "ffn": nn.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                               **kw)}


def _dec_layer_init(gen, cfg: ModelConfig, lead, device):
    kw = dict(lead=lead, device=device)
    return {"pre_norm": nn.rmsnorm_init(cfg.d_model, **kw),
            "self_attn": attention.attn_init(gen, cfg, **kw),
            "cross_norm": nn.rmsnorm_init(cfg.d_model, **kw),
            "cross_attn": attention.attn_init(gen, cfg, **kw),
            "pre_ffn_norm": nn.rmsnorm_init(cfg.d_model, **kw),
            "ffn": nn.ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                               **kw)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Random fp32 parameters from ``seed`` on ``device``; the encoder's
    leaves stacked over ``cfg.encoder_layers``, the decoder's over
    ``cfg.num_layers``. The values differ from the JAX package's (another
    generator); tests load the reference's through ``repro_torch.weights``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": nn.embed_init(gen, cfg.vocab_size, cfg.d_model, device),
        "enc_layers": _enc_layer_init(gen, cfg, (cfg.encoder_layers,),
                                      device),
        "enc_norm": nn.rmsnorm_init(cfg.d_model, device=device),
        "dec_layers": _dec_layer_init(gen, cfg, (cfg.num_layers,), device),
        "final_norm": nn.rmsnorm_init(cfg.d_model, device=device),
    }


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def encode(params, cfg: ModelConfig, frames, *, dtype=torch.bfloat16,
           remat: bool = True, remat_policy: Optional[str] = None):
    """frames: (B, S_enc, d_model), the stubbed frontend's embeddings.
    Returns the normed encoder output (B, S_enc, d_model) in ``dtype``.
    Attention is the full (B, K, G, S, S) fp32 product, not chunked, as
    in the JAX package."""
    policy = remat_lib.resolve(remat, remat_policy)
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn_part(p, h):
        q = attention._split_heads(
            nn.dense(p["attn"]["wq"], h, dtype), H, hd)
        k = attention._split_heads(
            nn.dense(p["attn"]["wk"], h, dtype), K, hd)
        v = attention._split_heads(
            nn.dense(p["attn"]["wv"], h, dtype), K, hd)
        q = nn.apply_rope(q, positions, cfg.rope_theta)
        k = nn.apply_rope(k, positions, cfg.rope_theta)
        if nn._is_dtensor(q):  # on a mesh: the heads' (or rows') blocks
            q, k, v, out_spec = attention._head_hints(q, k, v, H, K, S)
            o = nn.shard_hint(attention._local_attention(
                q, k, v, positions, None, cfg.attn_softcap, H // K,
                causal=False), *out_spec)
        else:
            o = attention.multihead_attention(q, k, v, q_pos=positions,
                                              k_pos=positions, causal=False,
                                              softcap=cfg.attn_softcap)
        return nn.dense(p["attn"]["wo"], nn.mergeable(o, 2, 3).reshape(
            B, S, H * hd), dtype)

    def layer(x, p):
        h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        x = x + remat_lib.checkpoint_block(attn_part, policy)(p, h)
        h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
        return x + remat_lib.checkpoint_block(
            lambda fp, hh: nn.ffn(fp, hh, cfg.ffn_kind, dtype),
            policy)(p["ffn"], h)

    layer = remat_lib.checkpoint_period(layer, policy)
    x = frames.to(dtype)
    for p in _periods(params["enc_layers"]):
        x = layer(x, p)
    return nn.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _head(params, cfg: ModelConfig, x):
    x = nn.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return nn.softcap(nn.unembed(params["embed"], x, torch.float32),
                      cfg.final_softcap)


def forward(params, cfg: ModelConfig, frames, tgt_tokens, *,
            dtype=torch.bfloat16, remat: bool = True,
            remat_policy: Optional[str] = None):
    """Teacher-forced forward. frames: (B, S_enc, d_model); tgt_tokens:
    (B, S_dec) int. Returns (logits (B, S_dec, V) fp32, aux loss 0)."""
    policy = remat_lib.resolve(remat, remat_policy)
    enc_out = encode(params, cfg, frames, dtype=dtype, remat_policy=policy)
    B, S = tgt_tokens.shape
    positions = _positions(B, S, tgt_tokens.device)
    x = nn.embed(params["embed"], tgt_tokens, dtype, scale=cfg.embed_scale)

    def self_part(p, h):
        return attention.attn_block(p["self_attn"], cfg, h, positions,
                                    compute_dtype=dtype)[0]

    def cross_part(p, h, enc):
        return attention.cross_attn_block(p["cross_attn"], cfg, h,
                                          kv_src=enc, compute_dtype=dtype)[0]

    def layer(x, p, enc):
        h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        x = x + remat_lib.checkpoint_block(self_part, policy)(p, h)
        h = nn.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        x = x + remat_lib.checkpoint_block(cross_part, policy)(p, h, enc)
        h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
        return x + remat_lib.checkpoint_block(
            lambda fp, hh: nn.ffn(fp, hh, cfg.ffn_kind, dtype),
            policy)(p["ffn"], h)

    layer = remat_lib.checkpoint_period(layer, policy)
    for p in _periods(params["dec_layers"]):
        x = layer(x, p, enc_out)
    return (_head(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@nn.serving_mode
def init_decode_cache(params, cfg: ModelConfig, frames, max_len: int,
                      dtype=torch.bfloat16):
    """Runs the encoder, projects every decoder layer's cross-attention
    keys and values once, and allocates the self-attention rings:
    ``{"self": ring leaves (L, B, max_len, ...), "cross": {"k", "v"}
    (L, B, S_enc, K, hd)}``, in ``dtype``."""
    enc_out = encode(params, cfg, frames, dtype=dtype, remat=False)
    B, T = enc_out.shape[:2]
    K, hd = cfg.num_kv_heads, cfg.head_dim
    ks, vs = [], []
    for p in _periods(params["dec_layers"]):
        ks.append(nn.dense(p["cross_attn"]["wk"], enc_out, dtype).reshape(
            B, T, K, hd))
        vs.append(nn.dense(p["cross_attn"]["wv"], enc_out, dtype).reshape(
            B, T, K, hd))
    self_cache = attention.init_kv_cache(cfg, B, max_len, None, dtype,
                                         lead=(cfg.num_layers,),
                                         device=frames.device)
    return {"self": self_cache,
            "cross": {"k": torch.stack(ks), "v": torch.stack(vs)}}


@nn.serving_mode
def decode_step(params, cfg: ModelConfig, token, cache, cur_pos, *,
                dtype=torch.bfloat16):
    """One decoder token. token: (B, 1) int; cur_pos: (B,) absolute
    position. Returns (logits (B, 1, V) fp32, cache); each layer writes
    its self-attention ring slot in place (the JAX package carries the
    cache through a ``fori_loop`` for the same single copy). A cache of
    DTensors (placed by the reference's ``cache_specs`` on a GSPMD mesh,
    inside ``nn.use_mesh``) is read and written on each rank's blocks."""
    x = nn.embed(params["embed"], token, dtype, scale=cfg.embed_scale)
    cross = cache["cross"]
    for i, p in enumerate(_periods(params["dec_layers"])):
        ring = {k: nn.period(leaf, i) for k, leaf in cache["self"].items()}
        h = nn.rmsnorm(p["pre_norm"], x, cfg.norm_eps)
        h, _ = attention.attn_decode_step(p["self_attn"], cfg, h, ring,
                                          cur_pos, compute_dtype=dtype)
        x = x + h
        h = nn.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        h, _ = attention.cross_attn_block(
            p["cross_attn"], cfg, h,
            kv_cache=(nn.period(cross["k"], i), nn.period(cross["v"], i)),
            compute_dtype=dtype)
        x = x + h
        h = nn.rmsnorm(p["pre_ffn_norm"], x, cfg.norm_eps)
        x = x + nn.ffn(p["ffn"], h, cfg.ffn_kind, dtype)
    return _head(params, cfg, x), cache
