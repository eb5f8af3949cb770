"""Mixture-of-Experts FFN: top-k routing with capacity-bounded dispatch.

Tokens are scattered into an ``(E·C + 1, D)`` buffer (``index_add``), the
experts run as one batched product over ``(E, C, D)``, and the outputs are
gathered back and combined with the renormalized router weights. A
token's slot in its expert's queue is its rank in token-major order, so
the same tokens overflow the capacity ``C`` as in the JAX package; an
overflowing token lands on the buffer's last (trash) row and contributes
nothing. Includes the load-balance auxiliary loss (Switch / GShard).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import nn
from . import remat as remat_lib
from .config import ModelConfig


def moe_init(gen, cfg: ModelConfig, lead=(), device=None):
    d, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = tuple(lead)
    kw = dict(lead=lead, device=device)

    def experts(a, b):
        return torch.randn(lead + (E, a, b), generator=gen,
                           device=device) / math.sqrt(a)

    p = {"router": nn.dense_init(gen, d, E, scale=0.02, **kw),
         "w_up": experts(d, Fd), "w_down": experts(Fd, d)}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        p["w_gate"] = experts(d, Fd)
    if cfg.num_shared_experts:
        p["shared"] = nn.ffn_init(
            gen, d, cfg.num_shared_experts * (cfg.shared_d_ff or cfg.moe_d_ff),
            cfg.ffn_kind, **kw)
    return p


def _hints(num_experts: int, capacity: int):
    """Specs of the expert tensors on a mesh: expert-parallel when E
    divides the ``model`` axis; otherwise capacity-parallel where C
    divides it (the token slot dim C over ``model``: the expert products
    are then independent per rank, where contracting a sharded d_ff
    would gather the (E, C, F) hidden), else whole. Returns (hidden
    spec, output spec)."""
    msize = nn.mesh_axis_size("model")
    if msize > 1 and num_experts % msize == 0:
        return ("model", None, None), ("model", None, None)
    if capacity % msize == 0:
        return (None, "model", None), (None, "model", None)
    return (None, None, None), (None, None, None)


def _expert_ffn(p, x, kind: str, num_experts: Optional[int] = None):
    """x: (E, C, D) -> (E, C, D), one batched product per weight; the
    gated ``swiglu`` / ``geglu`` experts or plain ``gelu`` ones (tanh
    GELU, as ``jax.nn.gelu``). ``num_experts`` (default E) picks the
    hints' layout on a mesh."""
    hid_spec, out_spec = _hints(x.shape[0] if num_experts is None
                                else num_experts, x.shape[1])
    x = nn.shard_hint(x, *out_spec)
    up = nn.shard_hint(torch.bmm(x, p["w_up"].to(x.dtype)), *hid_spec)
    if kind == "swiglu":
        h = F.silu(torch.bmm(x, p["w_gate"].to(x.dtype))) * up
    elif kind == "geglu":
        h = F.gelu(torch.bmm(x, p["w_gate"].to(x.dtype)),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    h = nn.shard_hint(h, *hid_spec)
    return nn.shard_hint(torch.bmm(h, p["w_down"].to(x.dtype)), *out_spec)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first, ties to the lower index — ``lax.top_k``'s order, which
    ``torch.topk`` does not promise."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(p, cfg: ModelConfig, xt):
    """Router and dispatch plan of tokens xt (T, D): (top-k expert ids
    (T, k), renormalized weights (T, k) fp32, keep mask (T·k,), buffer
    row per (token, choice) (T·k,), capacity C, aux loss fp32)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    probs = torch.softmax(nn.dense(p["router"], xt, torch.float32), dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True)
    # load-balance aux loss: E · sum_e (mean prob_e) · (fraction routed_e)
    ce = F.one_hot(topi, E).float().sum(1).mean(0) / k
    aux = E * torch.sum(probs.mean(0) * ce)
    C = min(max(1, int(math.ceil(T * k / E * cfg.capacity_factor))), T)
    flat_e = topi.reshape(-1)  # token-major
    in_e = F.one_hot(flat_e, E)  # (T·k, E)
    pos = (torch.cumsum(in_e, dim=0) * in_e - 1).amax(-1)  # queue position
    keep = pos < C
    idx = torch.where(keep, flat_e * C + pos,
                      torch.full_like(flat_e, E * C))  # dropped: trash row
    return topi, topv, keep, idx, C, aux


def moe_block(p, cfg: ModelConfig, x, compute_dtype=None,
              remat_policy: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (out (B, S, D), aux loss fp32 scalar).
    ``full`` checkpoints the block on its own."""
    fn = remat_lib.checkpoint_block(
        lambda bp, bx: _moe_block(bp, cfg, bx, compute_dtype), remat_policy)
    return fn(p, x)


def _moe_block(p, cfg: ModelConfig, x, compute_dtype=None):
    x = nn.seq_gathered(x)  # full-S tokens for routing and dispatch
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(B * S, D)
    if compute_dtype is not None:
        xt = xt.to(compute_dtype)
    if nn._is_dtensor(xt):
        out, aux = _dispatch_on_mesh(p, cfg, xt)
    else:
        _, topv, keep, idx, C, aux = route(p, cfg, xt)
        xs = xt.repeat_interleave(k, dim=0)  # (T·k, D)
        buf = xt.new_zeros((E * C + 1, D)).index_add(0, idx, xs)
        eout = _expert_ffn(p, buf[:E * C].reshape(E, C, D), cfg.ffn_kind, E)
        back = torch.cat([eout.reshape(E * C, D),
                          eout.new_zeros((1, D))])[idx]
        w = torch.where(keep, topv.reshape(-1), 0.0).to(xt.dtype)
        out = (back * w[:, None]).reshape(-1, k, D).sum(1)  # (T, D)
    if cfg.num_shared_experts:
        out = out + nn.ffn(p["shared"], xt, cfg.ffn_kind, compute_dtype)
    return nn.seq_sharded(out.reshape(B, S, D).to(x.dtype)), aux.float()


def _grad_summed(t, mesh, grad_placements):
    """``t`` (every rank's equal copy) as it is, its gradient summed over
    the axes ``grad_placements`` marks ``Partial`` (each rank's gradient
    is then a part of the whole)."""
    from torch.distributed.tensor import Replicate
    return nn.from_blocks(t, mesh, [Replicate()] * mesh.ndim,
                          t.shape).to_local(grad_placements=grad_placements)


def _dispatch_on_mesh(p, cfg: ModelConfig, xt):
    """The routed experts of DTensor tokens ``xt`` (T, D): (out (T, D),
    aux), both replicated. The routing runs on every token, whole on
    every rank: the capacity queues are the reference's, over the whole
    batch (DTensor's strategies for index ops on split tensors also
    differ across torch versions). Each rank then fills only its block
    of the (E, C, D) dispatch buffer — its experts, or its capacity
    slots, as :func:`_hints` splits them over ``model`` — runs its
    experts on it and combines its share of every token's output; one
    all-reduce over ``model`` sums the shares. Nothing of size
    T·k × D or of the whole buffer is held."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    E, k = cfg.num_experts, cfg.experts_per_token
    T, D = xt.shape
    xt = nn.shard_hint(xt, None, None)
    dm = xt.device_mesh
    xl = nn.whole(xt)
    _, topv, keep, idx, C, aux = route(
        {"router": {n: nn.whole(w) for n, w in p["router"].items()}}, cfg,
        xl)
    _, out_spec = _hints(E, C)
    names = list(dm.mesh_dim_names)
    dim = out_spec.index("model") if "model" in out_spec else None
    nE, nC, e0, c0 = E, C, 0, 0
    if dim is not None:
        m, r = dm.size(names.index("model")), dm.get_local_rank("model")
        if dim == 0:
            nE, e0 = E // m, r * (E // m)
        else:
            nC, c0 = C // m, r * (C // m)
    blk = [Shard(dim) if n == "model" and dim is not None else Replicate()
           for n in names]
    part = [Partial() if n == "model" and dim is not None else Replicate()
            for n in names]
    e_of, slot = idx // C, idx % C  # a dropped choice: e_of == E
    mine = keep & (e_of >= e0) & (e_of < e0 + nE) & (slot >= c0) \
        & (slot < c0 + nC)
    rows = torch.where(mine, (e_of - e0) * nC + slot - c0,
                       nE * nC).reshape(T, k)  # this block's row, or trash
    if dim is not None:  # each rank's share of the gradient is partial
        xl, topv = _grad_summed(xl, dm, part), _grad_summed(topv, dm, part)
    buf = xl.new_zeros((nE * nC + 1, D))
    for j in range(k):  # choice j of every token, token-major as route's
        buf = buf.index_add(0, rows[:, j], xl)
    eout = _expert_ffn(p, nn.from_blocks(buf[:nE * nC].reshape(nE, nC, D),
                                         dm, blk, (E, C, D)),
                       cfg.ffn_kind, E)
    el = eout.to_local().reshape(nE * nC, D)
    el = torch.cat([el, el.new_zeros((1, D))])
    w = torch.where(mine, topv.reshape(-1), 0.0).to(xl.dtype).reshape(T, k)
    share = sum(el[rows[:, j]] * w[:, j, None] for j in range(k))
    out = nn.from_blocks(share, dm, part, (T, D)).redistribute(
        dm, [Replicate()] * dm.ndim)
    return out, nn.replicated_like(aux.float(), xt)
