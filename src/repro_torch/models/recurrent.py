"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

The gated linear recurrence h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·(i_t·x_t)
is elementwise-linear in h, so a full sequence runs as a log-depth scan:
⌈log₂ S⌉ elementwise rounds over the whole (B, S, w) tensor (the JAX
package's ``lax.associative_scan``; a loop over the steps would launch
S small kernels a layer). Decode is the O(1) update.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import nn
from . import remat as remat_lib
from .config import ModelConfig
from .ssm import _conv_tail

_C = 8.0  # RG-LRU temperature constant


def recurrent_init(gen, cfg: ModelConfig, lead=(), device=None):
    d, w, W = cfg.d_model, cfg.lru_width, cfg.conv_width
    lead = tuple(lead)
    kw = dict(lead=lead, device=device)
    # Lambda so that a = exp(-c·softplus(Lambda)) lies in (0.9, 0.999)
    u = torch.rand(lead + (w,), generator=gen, device=device) * 0.099 + 0.9
    return {
        "in_x": nn.dense_init(gen, d, w, **kw),
        "in_gate": nn.dense_init(gen, d, w, **kw),
        "conv_w": torch.randn(lead + (W, w), generator=gen,
                              device=device) / math.sqrt(W),
        "conv_b": torch.zeros(lead + (w,), device=device),
        "gate_a": nn.dense_init(gen, w, w, bias=True, **kw),
        "gate_x": nn.dense_init(gen, w, w, bias=True, **kw),
        "lambda": torch.log(torch.expm1(-torch.log(u) / _C)),
        "out": nn.dense_init(gen, w, d, **kw),
    }


def _rg_lru_coeffs(p, x):
    """x: (..., w) -> (a, gated x), both fp32."""
    xf = x.float()
    r = torch.sigmoid(nn.dense(p["gate_a"], xf))
    i = torch.sigmoid(nn.dense(p["gate_x"], xf))
    log_a = -_C * F.softplus(p["lambda"]) * r
    # sqrt(1 - a^2) through expm1, stable as a -> 1
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    return torch.exp(log_a), mult * (i * xf)


def _causal_conv(x, conv_w, conv_b):
    """Depthwise causal conv (B, S, w); on a mesh on each rank's channels
    (``nn.on_channels``)."""
    return nn.on_channels(_causal_conv_plain, x, conv_w, conv_b)


def _causal_conv_plain(x, conv_w, conv_b):
    W, S = conv_w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i].to(x.dtype) for i in range(W))
    return out + conv_b.to(x.dtype)


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) along dim 1,
    in ⌈log₂ S⌉ rounds (Hillis–Steele): round ``d`` combines each step
    with the one ``d`` before it, (a_l, b_l) ∘ (a_r, b_r) = (a_l·a_r,
    b_l·a_r + b_r) — the JAX package's combine."""
    S, d = a.shape[1], 1
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1))
        d *= 2
    return b


def recurrent_block(p, cfg: ModelConfig, x, compute_dtype=None,
                    init_state=None, return_cache: bool = False,
                    remat_policy: str = "none") -> Tuple[torch.Tensor, object]:
    """Full-sequence RG-LRU block. x: (B, S, D) -> ((B, S, D), final h,
    or the decode cache entry with ``return_cache``). ``full`` checkpoints
    the block on its own, so its scan rounds are recomputed one block at
    a time."""
    fn = remat_lib.checkpoint_block(
        lambda bp, bx: _recurrent_block(bp, cfg, bx, compute_dtype,
                                        init_state, return_cache),
        remat_policy)
    return fn(p, x)


def _recurrent_block(p, cfg: ModelConfig, x, compute_dtype=None,
                     init_state=None, return_cache: bool = False):
    gate = F.gelu(nn.dense(p["in_gate"], x, compute_dtype),
                  approximate="tanh")
    xb_raw = nn.dense(p["in_x"], x, compute_dtype)
    xb = _causal_conv(xb_raw, p["conv_w"], p["conv_b"])
    a, b = _rg_lru_coeffs(p, xb)  # (B, S, w) fp32
    if init_state is not None:  # the initial state as a leading step
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([init_state.float()[:, None], b], dim=1)
    h = nn.on_channels(linear_scan, a, b)  # a scan along S, per channel
    if init_state is not None:
        h = h[:, 1:]
    h = h.to(xb.dtype)
    out = nn.dense(p["out"], h * gate, compute_dtype)
    if return_cache:
        return out, {"h": h[:, -1].float(),
                     "conv": _conv_tail(xb_raw, cfg.conv_width)}
    return out, h[:, -1].float()


def init_recurrent_cache(cfg: ModelConfig, batch: int, dtype, lead=(),
                         device=None):
    """The RG-LRU state (fp32) and the conv's last W-1 inputs (``dtype``)."""
    lead = tuple(lead)
    return {
        "h": torch.zeros(lead + (batch, cfg.lru_width), device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1,
                                    cfg.lru_width), dtype=dtype,
                            device=device),
    }


def recurrent_decode_step(p, cfg: ModelConfig, x, cache, compute_dtype=None):
    """One-token update. x: (B, 1, D). Returns (out (B, 1, D), the new
    cache entry)."""
    gate = F.gelu(nn.dense(p["in_gate"], x[:, 0], compute_dtype),
                  approximate="tanh")
    xb = nn.dense(p["in_x"], x[:, 0], compute_dtype)  # (B, w)
    win = torch.cat([cache["conv"].to(xb.dtype), xb[:, None]], dim=1)
    xb = (win * p["conv_w"].to(xb.dtype)).sum(1) + p["conv_b"].to(xb.dtype)
    a, b = _rg_lru_coeffs(p, xb)
    h = a * cache["h"] + b
    out = nn.dense(p["out"], h.to(xb.dtype) * gate, compute_dtype)[:, None]
    return out, {"h": h, "conv": win[:, 1:]}
