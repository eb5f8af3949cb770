"""Mamba2 block (SSD, state-space duality) in the chunked form.

Within a chunk of ``Q`` steps the work is dense products in fp32; a short
loop over the ``nc`` chunks carries the (H, P, N) state across them (the
JAX package runs that carry as an associative scan; over 16 chunks a
loop is the same recurrence). Decode is the O(1) recurrent update.

Shapes: d_inner = expand·d_model, P = head_dim, H = d_inner / P heads,
N = ssm_state, one B/C group shared across heads (as in mamba2-780m).

The JAX package writes the intra-chunk products as three-operand
einsums; here each is a pair of explicit products whose intermediates
stay at the size of ``x`` or of the (B, nc, Q, Q, H) decay tensor,
never larger.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import nn
from . import remat as remat_lib
from .config import ModelConfig


def ssm_init(gen, cfg: ModelConfig, lead=(), device=None):
    d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    H, W = cfg.ssm_num_heads, cfg.conv_width
    lead = tuple(lead)
    conv_dim = di + 2 * N
    kw = dict(lead=lead, device=device)
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": nn.dense_init(gen, d, 2 * di + 2 * N + H, **kw),
        "conv_w": torch.randn(lead + (W, conv_dim), generator=gen,
                              device=device) / math.sqrt(W),
        "conv_b": torch.zeros(lead + (conv_dim,), device=device),
        "A_log": torch.zeros(lead + (H,), device=device),  # A = -1 at init
        "D": torch.ones(lead + (H,), device=device),
        "dt_bias": torch.zeros(lead + (H,), device=device),
        "out_norm": nn.rmsnorm_init(di, **kw),
        "out_proj": nn.dense_init(gen, di, d, **kw),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _causal_conv(xBC, conv_w, conv_b):
    """Depthwise causal conv of width W as W shifted sums. xBC: (B, S, C);
    on a mesh on each rank's channels (``nn.on_channels``)."""
    return nn.on_channels(_causal_conv_plain, xBC, conv_w, conv_b)


def _causal_conv_plain(xBC, conv_w, conv_b):
    W, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i].to(xBC.dtype) for i in range(W))
    return F.silu(out + conv_b.to(xBC.dtype))


def _conv_tail(x_raw, W: int):
    """The last W-1 pre-conv inputs, left-padded with zeros when S < W-1."""
    tail = x_raw[:, -(W - 1):, :]
    if tail.shape[1] == W - 1:
        return tail
    return F.pad(tail, (0, 0, W - 1 - tail.shape[1], 0))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD. x: (B, S, H, P); dt: (B, S, H); A: (H,) negative;
    Bm, Cm: (B, S, N). Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:  # pad the tail: dt = 0 steps are the identity
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    f32 = torch.float32
    xc = x.to(f32).reshape(Bsz, nc, Q, H, P)
    dtc = dt.to(f32).reshape(Bsz, nc, Q, H)
    Bc = Bm.to(f32).reshape(Bsz, nc, Q, N)
    Cc = Cm.to(f32).reshape(Bsz, nc, Q, N)

    a = dtc * A  # (B, nc, Q, H) log-decay per step
    cum = torch.cumsum(a, dim=2)  # inclusive, within the chunk
    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, heads first.
    # The mask goes in before the exp: above the diagonal cum_i - cum_j
    # grows with the chunk (~180 at Q = 256) and exp overflows, and the
    # reference's where(mask, exp(seg), 0) then backpropagates 0 · inf =
    # NaN. Masking to -inf first gives the same L and a finite gradient.
    cum_h = cum.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]  # (B, nc, H, Q, Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(seg.masked_fill(~mask, -math.inf))
    xdt = xc * dtc[..., None]  # (B, nc, Q, H, P)
    xdt_h = xdt.permute(0, 1, 3, 2, 4)  # (B, nc, H, Q, P)
    G = Cc @ Bc.transpose(-1, -2)  # (B, nc, Q, Q)
    y = (G[:, :, None] * L) @ xdt_h  # (B, nc, H, Q, P)

    # chunk summary: S_c = sum_j exp(cum_last - cum_j) B_j (x_j dt_j)^T
    decay_to_end = torch.exp(cum_h[..., -1:] - cum_h)  # (B, nc, H, Q)
    states = (xdt_h * decay_to_end[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]  # (B, nc, H, P, N)
    chunk_decay = torch.exp(cum_h[..., -1])[..., None, None]  # (B,nc,H,1,1)

    # carry the state across chunks: s_in[c] enters chunk c
    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c] + states[:, c]
    s_in = torch.stack(s_in, dim=1)  # (B, nc, H, P, N)
    # inter-chunk: y_off[i] = exp(cum_i) * C_i . state_in
    y = y + (Cc[:, :, None] @ s_in.transpose(-1, -2)) \
        * torch.exp(cum_h)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)[:, :S0]
    return y.to(x.dtype), s


def _ssd(xs, dt, A, Bm, Cm, chunk: int, init_state=None):
    """:func:`ssd_chunked`; on a mesh on each rank's blocks: whole
    sequences, its samples over the batch axes and its heads (independent
    of one another) over ``model`` where they divide it. Returns (y,
    final state) as DTensors of that layout."""
    if not nn._is_dtensor(xs):
        return ssd_chunked(xs, dt, A, Bm, Cm, chunk, init_state)
    from torch.distributed.tensor import Replicate, Shard
    batch = ("pod", "data")
    heads = "model" if xs.shape[2] % nn.mesh_axis_size("model") == 0 \
        else None
    xs = nn.shard_hint(xs, batch, None, heads, None)
    dt = nn.shard_hint(dt, batch, None, heads)
    A = nn.shard_hint(nn.replicated_like(A, xs), heads)
    Bm, Cm = nn.shard_hint(Bm, batch), nn.shard_hint(Cm, batch)
    if init_state is not None:
        init_state = nn.shard_hint(nn.replicated_like(init_state, xs), batch,
                                   heads)
    state_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
                else Replicate() for p in xs.placements]
    B, S, H, P = xs.shape
    return nn.on_blocks(
        lambda *a: ssd_chunked(*a[:5], chunk, a[5]),
        xs, dt, A, Bm, Cm, init_state,
        out=[(xs.placements, xs.shape), (state_pl, (B, H, P, Bm.shape[-1]))])


def ssm_block(p, cfg: ModelConfig, x, compute_dtype=None, init_state=None,
              return_cache: bool = False, remat_policy: str = "none"
              ) -> Tuple[torch.Tensor, object]:
    """Full-sequence Mamba2 block. x: (B, S, D) -> ((B, S, D), final
    state, or the decode cache entry with ``return_cache``). ``full``
    checkpoints the block on its own."""
    fn = remat_lib.checkpoint_block(
        lambda bp, bx: _ssm_block(bp, cfg, bx, compute_dtype, init_state,
                                  return_cache), remat_policy)
    return fn(p, x)


def _ssm_block(p, cfg: ModelConfig, x, compute_dtype=None, init_state=None,
               return_cache: bool = False):
    B, S, _ = x.shape
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                   cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(cfg, nn.dense(p["in_proj"], x, compute_dtype))
    xBC_raw = xBC
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])
    y, final = _ssd(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = nn.rmsnorm(p["out_norm"],
                   nn.mergeable(y, 2, 3).reshape(B, S, di) * F.silu(z),
                   cfg.norm_eps)
    out = nn.dense(p["out_proj"], y, compute_dtype)
    if return_cache:
        return out, {"state": final,
                     "conv": _conv_tail(xBC_raw, cfg.conv_width)}
    return out, final


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, lead=(),
                   device=None):
    """The SSD state (fp32) and the conv's last W-1 inputs (``dtype``);
    ``lead`` prepends stacking dims (periods)."""
    lead = tuple(lead)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros(lead + (batch, cfg.ssm_num_heads,
                                     cfg.ssm_head_dim, cfg.ssm_state),
                             device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(p, cfg: ModelConfig, x, cache, compute_dtype=None):
    """One-token recurrent update. x: (B, 1, D). Returns (out (B, 1, D),
    the new cache entry)."""
    B = x.shape[0]
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                   cfg.ssm_head_dim)
    z, xBC, dt = _split_proj(cfg, nn.dense(p["in_proj"], x[:, 0],
                                           compute_dtype))
    win = torch.cat([cache["conv"].to(xBC.dtype), xBC[:, None, :]], dim=1)
    conv_out = (win * p["conv_w"].to(xBC.dtype)).sum(1)  # (B, C)
    xBC_c = F.silu(conv_out + p["conv_b"].to(xBC.dtype))
    xs = xBC_c[..., :di].reshape(B, H, P)
    Bm = xBC_c[..., di:di + N].float()
    Cm = xBC_c[..., di + N:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, H)
    dec = torch.exp(dt * -torch.exp(p["A_log"]))
    xdt = xs.float() * dt[..., None]  # (B, H, P)
    state = (cache["state"] * dec[..., None, None]
             + xdt[..., None] * Bm[:, None, None, :])
    y = (state @ Cm[:, None, :, None])[..., 0]  # (B, H, P)
    y = y.to(xs.dtype) + xs * p["D"].to(xs.dtype)[None, :, None]
    y = nn.rmsnorm(p["out_norm"], nn.mergeable(y, 1, 2).reshape(B, di)
                   * F.silu(z), cfg.norm_eps)
    out = nn.dense(p["out_proj"], y, compute_dtype)[:, None, :]
    return out, {"state": state, "conv": win[:, 1:, :]}
