"""Functional NN primitives: params are nested dicts of tensors; every
layer is an ``init_*`` plus a pure apply function.

Master parameters are fp32; the compute dtype is configurable (bf16 on the
card). Layouts follow the JAX package: ``dense`` keeps ``(in, out)``
weights and computes ``x @ w``, so no weight is ever transposed.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, scale: Optional[float] = None,
               lead: Tuple[int, ...] = (), device=None):
    """``lead`` prepends stacking dims (the transformer's period axis)."""
    scale = (1.0 / math.sqrt(in_dim)) if scale is None else scale
    p = {"w": torch.randn(lead + (in_dim, out_dim), generator=gen,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros(lead + (out_dim,), device=device)
    return p


def dense(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm_init(dim: int, lead: Tuple[int, ...] = (), device=None):
    # gemma-style (1 + scale) with zero-initialised scale — not nn.RMSNorm
    return {"scale": torch.zeros(lead + (dim,), device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"])).to(dt)


def layernorm_init(dim: int, lead: Tuple[int, ...] = (), device=None):
    return {"scale": torch.ones(lead + (dim,), device=device),
            "bias": torch.zeros(lead + (dim,), device=device)}


def layernorm(p, x, eps: float = 1e-6):
    """In fp32, cast back; the bias is added after ``scale`` (no ``1 +``,
    unlike :func:`rmsnorm`)."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(dt)


def softcap(x, cap: Optional[float]):
    """tanh logit soft-capping (gemma2 / grok)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# RoPE — rotates split halves, not interleaved pairs
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    return _rotate(x, ang)


def _rotate(x, ang):
    """Rotate the split halves of x (B, S, H, hd) by angles (B, S, hd/2),
    in fp32, cast back to x's dtype."""
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multi-axis RoPE (qwen2-vl). x: (B, S, H, hd); positions: (3, B, S),
    the (t, h, w) streams. The hd/2 frequencies fall into three contiguous
    sections, ``sections`` pairs each (they sum to hd/2), and section i
    rotates by stream i's positions. Equal streams give :func:`apply_rope`."""
    hd = x.shape[-1]
    if sum(sections) * 2 != hd:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim/2 = {hd // 2}")
    freqs = torch.split(rope_freqs(hd, theta, x.device), list(sections))
    ang = torch.cat([positions[i].float()[..., None] * f
                     for i, f in enumerate(freqs)], dim=-1)  # (B, S, hd/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_init(gen, d_model: int, d_ff: int, kind: str,
             lead: Tuple[int, ...] = (), device=None):
    p = {"w_up": dense_init(gen, d_model, d_ff, lead=lead, device=device),
         "w_down": dense_init(gen, d_ff, d_model, lead=lead, device=device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, d_ff, lead=lead,
                                 device=device)
    return p


def ffn(p, x, kind: str, compute_dtype=None):
    """The gated ``swiglu`` / ``geglu`` FFN or the plain ``gelu`` one. GELU
    is the tanh approximation, the default of ``jax.nn.gelu``."""
    up = dense(p["w_up"], x, compute_dtype)
    if kind == "swiglu":
        h = F.silu(dense(p["w_gate"], x, compute_dtype)) * up
    elif kind == "geglu":
        h = F.gelu(dense(p["w_gate"], x, compute_dtype),
                   approximate="tanh") * up
    elif kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return dense(p["w_down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, device=None):
    return {"table": torch.randn((vocab, d_model), generator=gen,
                                 device=device) * 0.02}


def embed(p, tokens, compute_dtype=None, scale: bool = False):
    """``scale`` multiplies by sqrt(d_model) rounded to the compute dtype
    first, as the JAX package does (in bf16, sqrt(3584) is 59.75)."""
    # gather first, then cast: the same values as the JAX package's
    # cast-then-gather without a compute-dtype copy of the whole table
    x = F.embedding(tokens, p["table"])
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(p["table"].shape[-1]), dtype=x.dtype)
    return x


def unembed(p, x, compute_dtype=None):
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ t.T
