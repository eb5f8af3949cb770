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


def route(p, cfg: ModelConfig, xt, blocks=None):
    """Router and dispatch plan of tokens xt (T, D): (top-k expert ids
    (T, k), renormalized weights (T, k) fp32, keep mask (T·k,), buffer
    row per (token, choice) (T·k,), capacity C, aux loss fp32).

    ``blocks`` (on a mesh) makes xt one block of a batch whose tokens are
    split over ranks in token order: a function of the block's choices
    per expert (E,) and summed router probabilities (E,) that returns the
    batch's token count T, the choices per expert of the earlier blocks
    (E,), of the whole batch (E,) and the batch's summed probabilities
    (E,). Queue positions, the capacity and the aux loss are then the
    whole batch's, as if one device routed it."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    probs = torch.softmax(nn.dense(p["router"], xt, torch.float32), dim=-1)
    topv, topi = top_k(probs, k)
    topv = topv / topv.sum(-1, keepdim=True)
    flat_e = topi.reshape(-1)  # token-major
    in_e = F.one_hot(flat_e, E)  # (T·k, E)
    pos = (torch.cumsum(in_e, dim=0) * in_e - 1).amax(-1)  # queue position
    if blocks is None:
        # load-balance aux: E · sum_e (mean prob_e) · (fraction routed_e)
        ce = F.one_hot(topi, E).float().sum(1).mean(0) / k
        aux = E * torch.sum(probs.mean(0) * ce)
    else:
        T, before, counts, psum = blocks(in_e.sum(0), probs.sum(0))
        pos = pos + before[flat_e]
        aux = E * torch.sum(psum / T * (counts.float() / T / k))
    C = min(max(1, int(math.ceil(T * k / E * cfg.capacity_factor))), T)
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


def _grad_as(t, mesh, placements, grad_placements, shape):
    """``t``, this rank's block of a DTensor of whole ``shape`` laid out
    by ``placements``, as it is; its gradient taken as laid out by
    ``grad_placements`` (a ``Partial`` axis sums the ranks' gradients
    there)."""
    if list(placements) == list(grad_placements):
        return t
    return nn.from_blocks(t, mesh, placements, shape).to_local(
        grad_placements=grad_placements)


def _dispatch_on_mesh(p, cfg: ModelConfig, xt):
    """The routed experts of DTensor tokens ``xt`` (T, D): (out (T, D) in
    the tokens' layout over the batch axes, aux replicated). Each rank
    routes only its own block of the tokens — their split over the batch
    axes the input splits on (``pod``, ``data``), whole over ``model``.
    A token's queue position is its position in its block plus the
    choices of that expert in the earlier blocks (one all-gather of E
    counts), so the capacity queues, the drops and the aux loss are the
    reference's over the whole batch.

    The dispatch buffer is the logical (E, nd, Mc, c, D) of the (E, C, D)
    one: its experts over ``model`` where E divides it (expert-parallel),
    else its capacity slots where C divides it (Mc = the ``model`` size),
    else whole; its slots split in nd chunks of c over the batch axes
    where C divides (else nd = 1). Each rank fills its ``model`` block
    with its own tokens at their queue positions; a reduce-scatter over
    the batch axes (an all-reduce when nd = 1) sums the blocks, each rank
    runs its experts on its chunk, an all-gather gives back the block's
    outputs, and each rank combines its share of its own tokens' outputs;
    one all-reduce over ``model`` sums the shares. Nothing of the whole
    batch's tokens is held on a rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    E, k = cfg.num_experts, cfg.experts_per_token
    T, D = xt.shape
    dm = xt.device_mesh
    names = list(dm.mesh_dim_names)
    size = {n: dm.size(i) for i, n in enumerate(names)}
    split = [n for n, pl in zip(names, xt.placements) if n != "model"
             and isinstance(pl, Shard) and pl.dim % xt.dim() == 0]
    tok = [Shard(0) if n in split else Replicate() for n in names]
    if list(xt.placements) != tok:
        xt = xt.redistribute(dm, tok)
    nb, b = 1, 0  # blocks, and this rank's, in DTensor's nested order
    for n in split:
        nb, b = nb * size[n], b * size[n] + dm.get_local_rank(n)
    xl = xt.to_local()
    Tl = xl.shape[0]
    over = [Partial() if n in split else Replicate() for n in names]
    # the router whole; each block's routing gives a part of its gradient
    with nn.gathering_params():
        router = {n: w.redistribute(dm, [Replicate()] * dm.ndim).to_local(
            grad_placements=over) if nn._is_dtensor(w) else w
            for n, w in p["router"].items()}

    def blocks(counts, psum):
        every = nn.from_blocks(counts[None], dm, tok, (nb, E)).full_tensor()
        psum = nn.from_blocks(psum, dm, over, (E,)).full_tensor()
        return T, every[:b].sum(0), every.sum(0), psum

    _, topv, keep, idx, C, aux = route({"router": router}, cfg, xl,
                                       blocks if split else None)
    M = size.get("model", 1)
    m = dm.get_local_rank("model") if M > 1 else 0
    expert = M > 1 and E % M == 0
    capacity = not expert and M > 1 and C % M == 0
    Mc = M if capacity else 1
    nE, e0 = (E // M, m * (E // M)) if expert else (E, 0)
    nd = nb if C % (nb * Mc) == 0 else 1
    c = C // (nd * Mc)
    mpl = Shard(0) if expert else Shard(2) if capacity else Replicate()
    pre = [mpl if n == "model" else Partial() if n in split
           else Replicate() for n in names]
    post = [Shard(1) if n in split and nd > 1 else q
            if n == "model" else Replicate() for n, q in zip(names, pre)]
    full = [Replicate() if n in split else q for n, q in zip(names, pre)]
    part = [Partial() if n == "model" and (expert or capacity) else q
            for n, q in zip(names, tok)]
    e_of, s = idx // C, idx % C  # a dropped choice: e_of == E
    q = s // c
    mine = keep & (e_of >= e0) & (e_of < e0 + nE)
    if capacity:
        mine = mine & (q % Mc == m)
    rows = torch.where(mine, ((e_of - e0) * nd + q // Mc) * c + s % c,
                       nE * nd * c).reshape(Tl, k)  # this block's, or trash
    # each model rank's share of a token's output takes a part of the
    # token's gradient (the routing above took the whole)
    xd = _grad_as(xl, dm, tok, part, (T, D))
    topv = _grad_as(topv, dm, tok, part, (T, k))
    buf = xl.new_zeros((nE * nd * c + 1, D))
    for j in range(k):  # choice j of every token, token-major as route's
        buf = buf.index_add(0, rows[:, j], xd)
    shape5 = (E, nd, Mc, c, D)
    xe = nn.from_blocks(buf[:-1].view(nE, nd, 1, c, D), dm, pre,
                        shape5).redistribute(dm, post).to_local()
    wgrad = [Partial() if n in split and nd > 1 else Partial()
             if n == "model" and capacity else Shard(0)
             if n == "model" and expert else Replicate() for n in names]
    wpl = [Shard(0) if n == "model" and expert else Replicate()
           for n in names]
    with nn.gathering_params():
        wl = {n: p[n].to(xl.dtype).redistribute(dm, wpl).to_local(
            grad_placements=wgrad) for n in ("w_up", "w_gate", "w_down")
            if n in p}
    eout = _expert_ffn(wl, xe.reshape(nE, -1, D), cfg.ffn_kind)
    el = nn.from_blocks(eout.reshape(nE, -1, 1, c, D), dm, post,
                        shape5).redistribute(dm, full).to_local(
        grad_placements=[Partial() if n in split else q
                         for n, q in zip(names, full)])
    el = torch.cat([el.reshape(nE * nd * c, D), el.new_zeros((1, D))])
    w = torch.where(mine, topv.reshape(-1), 0.0).to(xl.dtype).reshape(Tl, k)
    share = sum(el[rows[:, j]] * w[:, j, None] for j in range(k))
    out = nn.from_blocks(share, dm, part, (T, D)).redistribute(dm, tok)
    return out, nn.replicated_like(aux.float(), xt)
