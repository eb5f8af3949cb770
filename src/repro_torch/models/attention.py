"""Attention for training and prefill: GQA with causal / sliding-window
masks, optional logit soft-capping and QK-norm, RoPE.

GQA runs through a ``(B, S, K, G, hd)`` view of the queries, softmax in
fp32, masking by an additive ``-1e30`` bias — the JAX package's
arithmetic. Decode and the ring KV cache come with the serving slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import nn
from .config import ModelConfig

Q_CHUNK = 512  # query rows per chunk of ``chunked_attention``


def attn_init(gen, cfg: ModelConfig, lead=(), device=None):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": nn.dense_init(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": nn.dense_init(gen, d, K * hd, bias=cfg.qkv_bias, **kw),
        "wv": nn.dense_init(gen, d, K * hd, bias=cfg.qkv_bias, **kw),
        "wo": nn.dense_init(gen, H * hd, d, **kw),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = nn.rmsnorm_init(hd, **kw)
        p["k_norm"] = nn.rmsnorm_init(hd, **kw)
    return p


def _mask_bias(q_pos, k_pos, window: Optional[int], causal: bool = True):
    """Additive mask bias (..., S_q, S_k) in fp32: 0 where visible, -1e30
    elsewhere."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                    dtype=torch.bool, device=dq.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def multihead_attention(q, k, v, *, q_pos, k_pos, window=None, causal=True,
                        softcap=None):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H % K == 0 (GQA).
    Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = nn.softcap(logits, softcap)
    bias = _mask_bias(q_pos, k_pos, window, causal)  # (B, S, T)
    while bias.dim() < logits.dim():
        bias = bias[:, None]
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, q_pos, k_pos, window=None, causal=True,
                      softcap=None, q_chunk=Q_CHUNK, max_chunks=32,
                      align=128):
    """Query-chunked attention: the (S, S) logits are never held whole
    (one (B, H, q_chunk, k_span) block at a time), and a chunk of a
    sliding-window layer reads only the keys it can see. Exact: each chunk
    takes a full softmax row."""
    B, S, H, hd = q.shape
    if S <= q_chunk:
        return multihead_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                   window=window, causal=causal,
                                   softcap=softcap)
    qc = max(q_chunk, -(-S // max_chunks))
    qc = -(-qc // align) * align
    outs = []
    for c0 in range(0, S, qc):
        c1 = min(c0 + qc, S)
        k1 = c1 if causal else k.shape[1]
        k0 = 0 if window is None else max(0, c0 - window + 1)
        k0 = (k0 // align) * align
        outs.append(multihead_attention(
            q[:, c0:c1], k[:, k0:k1], v[:, k0:k1],
            q_pos=q_pos[:, c0:c1], k_pos=k_pos[:, k0:k1],
            window=window, causal=causal, softcap=softcap))
    return torch.cat(outs, dim=1)


def attn_block(p, cfg: ModelConfig, x, positions, *, window=None,
               rope_theta=None, compute_dtype=None):
    """Full-sequence attention (train / prefill). x: (B, S, D).
    Returns (out (B, S, D), (k, v))."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = nn.dense(p["wq"], x, compute_dtype).reshape(B, S, H, hd)
    k = nn.dense(p["wk"], x, compute_dtype).reshape(B, S, K, hd)
    v = nn.dense(p["wv"], x, compute_dtype).reshape(B, S, K, hd)
    if cfg.use_qk_norm:
        q = nn.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = nn.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    q = nn.apply_rope(q, positions, theta)
    k = nn.apply_rope(k, positions, theta)
    out = chunked_attention(q, k, v, q_pos=positions, k_pos=positions,
                            window=window, softcap=cfg.attn_softcap)
    out = nn.dense(p["wo"], out.reshape(B, S, H * hd), compute_dtype)
    return out, (k, v)
