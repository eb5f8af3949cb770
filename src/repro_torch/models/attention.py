"""Attention: GQA with causal / sliding-window masks, optional logit
soft-capping and QK-norm, RoPE or M-RoPE, the encoder-decoder's cross
attention — and the ring-buffer KV cache of decode.

GQA runs through a ``(B, S, K, G, hd)`` view of the queries, softmax in
fp32, masking by an additive ``-1e30`` bias — the JAX package's
arithmetic. A decode cache holds ``W`` ring slots per row (``W`` the
layer's window, or ``max_len``): position ``p`` lives in slot ``p % W``,
and ``pos`` records each slot's absolute position (-1 empty).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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
                        softcap=None, k_valid=None):
    """q: (B,S,H,hd); k,v: (B,T,K,hd) with H % K == 0 (GQA); k_valid: an
    optional bool (B, T) marking the keys that may be attended.
    Returns (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().reshape(B, S, K, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = nn.softcap(logits, softcap)
    bias = nn.replicated_like(_mask_bias(q_pos, k_pos, window, causal),
                              logits)  # (B, S, T)
    while bias.dim() < logits.dim():
        bias = bias[:, None]
    logits = logits + bias
    if k_valid is not None:
        k_valid = nn.replicated_like(k_valid, logits)
        logits = logits.masked_fill(~k_valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
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
               rope_theta=None, compute_dtype=None, mrope_positions=None):
    """Full-sequence attention (train / prefill). x: (B, S, D). With
    ``cfg.mrope_sections`` and ``mrope_positions`` (3, B, S) both given,
    q and k rotate by M-RoPE, else by plain RoPE at ``positions`` (which
    the mask always reads). Returns (out (B, S, D), (k, v))."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = nn.seq_gathered(x)  # all-gather at the TP boundary
    q = _split_heads(nn.dense(p["wq"], x, compute_dtype), H, hd)
    k = _split_heads(nn.dense(p["wk"], x, compute_dtype), K, hd)
    v = _split_heads(nn.dense(p["wv"], x, compute_dtype), K, hd)
    if cfg.use_qk_norm:
        q = nn.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = nn.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = nn.apply_mrope(q, mrope_positions, theta, cfg.mrope_sections)
        k = nn.apply_mrope(k, mrope_positions, theta, cfg.mrope_sections)
    else:
        q = nn.apply_rope(q, positions, theta)
        k = nn.apply_rope(k, positions, theta)
    q, k, v, out_spec = _head_hints(q, k, v, H, K, S)
    if nn._is_dtensor(q):
        out = _local_attention(q, k, v, positions, window, cfg.attn_softcap,
                               H // K)
    else:
        out = chunked_attention(q, k, v, q_pos=positions, k_pos=positions,
                                window=window, softcap=cfg.attn_softcap)
    out = nn.shard_hint(out, *out_spec)
    out = nn.dense(p["wo"], out.reshape(B, S, H * hd), compute_dtype)
    return nn.seq_sharded(out), (k, v)  # reduce-scatter back to S-shards


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: the attention's
    gradients come out of permuted products, and DTensor views the
    gradient of the head split back to (B, S, H·hd), which a strided
    block cannot be viewed as."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_attention(q, k, v, positions, window, softcap, G: int, *,
                     k_pos=None, causal: bool = True, k_valid=None):
    """The attention of DTensors laid out by :func:`_head_hints`, run on
    each rank's blocks (it is independent per sample, per head and per
    query row): q split over the batch axes and over ``model`` on its
    heads (or, context-parallel, its rows), k / v over the batch axes
    and on their heads where those divide ``model``. A rank whose q heads
    are not a whole set of kv groups takes each q head's kv head (G = q
    heads per kv head); context-parallel rows attend to every key,
    unchunked (the mask reads their positions). The gradient of a kv
    block read by more than one rank is a partial sum over ``model``.
    ``positions`` are the queries' and, unless ``k_pos`` is given, the
    keys'; ``k_valid`` (B, T) marks the keys that may be attended (the
    attention then runs unchunked)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    qp = q.placements[mi] if mi is not None else Replicate()
    kp = k.placements[mi] if mi is not None else Replicate()
    kv_grad = list(k.placements)
    if mi is not None and kp == Replicate() and qp != Replicate():
        kv_grad[mi] = Partial()
    q_l = _ContiguousGrad.apply(q.to_local())
    k_l = _ContiguousGrad.apply(k.to_local(grad_placements=kv_grad))
    v_l = _ContiguousGrad.apply(v.to_local(grad_placements=kv_grad))
    rows = [p if isinstance(p, Shard) and p.dim % q.dim() == 0
            else Replicate() for p in q.placements]

    def local_rows(t):
        if t is None:
            return None
        return nn.replicated_like(t, q).redistribute(mesh, rows).to_local()

    pos = local_rows(positions)
    kpos = pos if k_pos is None else local_rows(k_pos)
    valid = local_rows(k_valid)
    r = mesh.get_local_rank("model") if mi is not None else 0
    if qp == Shard(2) and kp != Shard(2):  # q heads split, kv heads whole
        h = torch.arange(r * q_l.shape[2], (r + 1) * q_l.shape[2],
                         device=q_l.device)
        k_l, v_l = k_l[:, :, h // G], v_l[:, :, h // G]
    if qp == Shard(1):  # context-parallel: this rank's query rows
        n = q_l.shape[1]
        out = multihead_attention(
            q_l, k_l, v_l, q_pos=pos[:, r * n:(r + 1) * n], k_pos=kpos,
            window=window, causal=causal, softcap=softcap, k_valid=valid)
    elif valid is not None:
        out = multihead_attention(q_l, k_l, v_l, q_pos=pos, k_pos=kpos,
                                  window=window, causal=causal,
                                  softcap=softcap, k_valid=valid)
    else:
        out = chunked_attention(q_l, k_l, v_l, q_pos=pos, k_pos=kpos,
                                window=window, causal=causal,
                                softcap=softcap)
    return DTensor.from_local(out.contiguous(), mesh, q.placements,
                              run_check=False)


def _split_heads(y, n: int, hd: int):
    """(B, S, n·hd) → (B, S, n, hd). On a mesh, a projection split over
    an axis that does not divide the head count is gathered over it
    first (DTensor cannot view a dim split unevenly; the head hints that
    follow choose the layout)."""
    B, S = y.shape[:2]
    if nn._is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        last = y.dim() - 1
        pl = [Replicate() if p in (Shard(last), Shard(-1))
              and n % y.device_mesh.size(i) else p
              for i, p in enumerate(y.placements)]
        if pl != list(y.placements):
            y = y.redistribute(y.device_mesh, pl)
    return nn.grad_as_forward(y.reshape(B, S, n, hd))


def _head_hints(q, k, v, H: int, K: int, S: int):
    """The reference's attention layout on a mesh: head-sharded over
    ``model`` when the head count divides it; otherwise context-parallel
    (the query ROWS over ``model``, keys and values replicated — cheap
    under GQA) rather than the whole attention on every rank. Returns
    (q, k, v, the spec of the attention's output)."""
    msize = nn.mesh_axis_size("model")
    heads_div = msize > 1 and H % msize == 0
    qax = "model" if heads_div else None
    kax = "model" if msize > 1 and K % msize == 0 else None
    sax = None
    if not heads_div and msize > 1 and S % msize == 0 and S >= msize:
        sax = "model"  # context parallelism
    batch = ("pod", "data")
    q = nn.shard_hint(q, batch, sax, qax, None)
    k = nn.shard_hint(k, batch, None, kax, None)
    v = nn.shard_hint(v, batch, None, kax, None)
    return q, k, v, (batch, sax, qax, None)


def cross_attn_block(p, cfg: ModelConfig, x, kv_src=None, kv_cache=None,
                     src_valid=None, compute_dtype=None):
    """Encoder-decoder cross attention, no RoPE and no causal mask. The
    keys and values are ``kv_src`` (B, T, D), the encoder's output,
    projected here, or a precomputed ``kv_cache`` = (k, v), each
    (B, T, K, hd), in decode; ``src_valid`` an optional bool (B, T) of
    the frames that may be attended. Returns (out (B, S, D), (k, v))."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _split_heads(nn.dense(p["wq"], x, compute_dtype), H, hd)
    if kv_cache is None:
        T = kv_src.shape[1]
        k = _split_heads(nn.dense(p["wk"], kv_src, compute_dtype), K, hd)
        v = _split_heads(nn.dense(p["wv"], kv_src, compute_dtype), K, hd)
    else:
        k, v = kv_cache
        T = k.shape[1]
    zeros = torch.zeros((), dtype=torch.int32, device=x.device)
    q_pos, k_pos = zeros.expand(B, S), zeros.expand(B, T)
    if kv_cache is not None and nn._is_dtensor(k):  # a placed decode cache
        out = _blocks_decode(q, k, v, cfg.attn_softcap, k_valid=src_valid)
    elif nn._is_dtensor(q):
        q, k2, v2, out_spec = _head_hints(q, k, v, H, K, S)
        out = nn.shard_hint(_local_attention(
            q, k2, v2, q_pos, None, cfg.attn_softcap, H // K, k_pos=k_pos,
            causal=False, k_valid=src_valid), *out_spec)
    else:
        out = multihead_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                  causal=False, softcap=cfg.attn_softcap,
                                  k_valid=src_valid)
    out = nn.dense(p["wo"], nn.mergeable(out, 2, 3).reshape(B, S, H * hd),
                   compute_dtype)
    return out, (k, v)


# ---------------------------------------------------------------------------
# Decode: ring-buffer KV cache (bounded by the window for local layers)
# ---------------------------------------------------------------------------

def ring_len(max_len: int, window: Optional[int]) -> int:
    return max_len if window is None else min(window, max_len)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int], dtype, lead=(), device=None):
    """An empty ring cache; ``lead`` prepends stacking dims (periods)."""
    W = ring_len(max_len, window)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = tuple(lead) + (batch, W, K, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(tuple(lead) + (batch, W), -1, dtype=torch.int32,
                          device=device),
    }


def ring_cache_from_full(k, v, positions, window, max_len: int,
                         lengths=None):
    """Full-sequence prefill (k, v) → the ring layout ``attn_decode_step``
    reads. ``positions`` (B, S) follow the standard arange (slot = position
    % W); the dense layout is one static permutation along the sequence.

    ``lengths`` (B,) is the ragged layout of a right-padded batch: row
    ``b``'s ring holds its last ``min(lengths[b], W)`` real tokens and
    every other slot is empty, so padding never evicts a real key from a
    window. That is a per-row gather. ``%`` is Python's (floor) modulo,
    as ``jnp``'s: ``torch.remainder``, not ``fmod``.

    DTensor keys and values (a GSPMD prefill) are laid out on each rank's
    block, their sequence whole: the ring is built there and comes back
    split as they were (``transformer.prefill`` places it as the
    cache)."""
    if nn._is_dtensor(k):
        return _ring_from_blocks(k, v, positions, window, max_len, lengths)
    B, S, K, hd = k.shape
    W = ring_len(max_len, window)
    if lengths is not None:
        L = lengths.to(device=k.device, dtype=torch.int64)[:, None]
        j = torch.arange(W, device=k.device)[None]
        # the largest real position p <= L-1 with p = j (mod W); rows
        # shorter than W leave slots j >= L empty
        p = L - 1 - torch.remainder(L - 1 - j, W)
        src = p.clamp(0, S - 1)[..., None, None].expand(B, W, K, hd)
        return {"k": torch.gather(k, 1, src), "v": torch.gather(v, 1, src),
                "pos": p.masked_fill(p < 0, -1).to(torch.int32)}
    if S < W:  # short prefill: slots [0, S) filled, the rest empty
        pad = (0, 0, 0, 0, 0, W - S)
        return {"k": F.pad(k, pad), "v": F.pad(v, pad),
                "pos": F.pad(positions.to(torch.int32), (0, W - S),
                             value=-1)}
    # slot j holds source index S - W + ((j - S) mod W)
    src = S - W + torch.remainder(torch.arange(W, device=k.device) - S, W)
    return {"k": k.index_select(1, src), "v": v.index_select(1, src),
            "pos": positions.index_select(1, src).to(torch.int32)}


def _ring_from_blocks(k, v, positions, window, max_len: int, lengths):
    """:func:`ring_cache_from_full` of DTensor keys and values: each
    rank's ring from its own samples and heads (the sequence gathered
    first where it is split), as DTensors of the same layout."""
    from torch.distributed.tensor import Replicate, Shard
    if lengths is not None:
        raise ValueError("a ragged (right-padded) prefill on a GSPMD mesh "
                         "is not ported: prefill equal-length prompts")
    dm = k.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim % k.dim() == 1
          else p for p in k.placements]
    k, v = k.redistribute(dm, pl), v.redistribute(dm, pl)
    rows = [p if isinstance(p, Shard) and p.dim % k.dim() == 0
            else Replicate() for p in pl]
    pos = nn.replicated_like(positions, k).redistribute(dm, rows)
    shape = (k.shape[0], ring_len(max_len, window)) + tuple(k.shape[2:])
    return nn.on_blocks(
        lambda *a: ring_cache_from_full(*a, window, max_len), k, v, pos,
        out={"k": (pl, shape), "v": (pl, shape), "pos": (rows, shape[:2])})


def attn_decode_step(p, cfg: ModelConfig, x, cache, cur_pos, *, window=None,
                     rope_theta=None, compute_dtype=None):
    """One-token decode. x: (B, 1, D); cur_pos: (B,) absolute positions;
    ``cache`` one layer's ring (views into the pool are written in place).

    The new (k, v) goes to ring slot ``cur_pos % W``. As in the JAX
    package, attention sees the current token's k/v in the compute dtype
    and the older entries converted to it; the cache stores the current
    token rounded to the cache dtype. When the two dtypes differ the
    attention reads a compute-dtype copy of this layer's ring, so the
    current token is not rounded before it is attended. A ring of
    DTensors (a cache placed on a GSPMD mesh) is decoded on each rank's
    block (:func:`_ring_decode`). Returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cache["k"].shape[1]
    q = _split_heads(nn.dense(p["wq"], x, compute_dtype), H, hd)
    k = _split_heads(nn.dense(p["wk"], x, compute_dtype), K, hd)
    v = _split_heads(nn.dense(p["wv"], x, compute_dtype), K, hd)
    if cfg.use_qk_norm:
        q = nn.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = nn.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    pos2d = cur_pos[:, None]
    q = nn.apply_rope(q, pos2d, theta)
    k = nn.apply_rope(k, pos2d, theta)
    if nn._is_dtensor(cache["k"]):
        out = _ring_decode(q, k, v, cache, cur_pos, window, cfg.attn_softcap)
        out = nn.dense(p["wo"], nn.mergeable(out, 2, 3).reshape(
            B, 1, H * hd), compute_dtype)
        return out, cache

    slot = torch.remainder(cur_pos, W).long()
    bidx = torch.arange(B, device=x.device)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    cpos[bidx, slot] = cur_pos.to(torch.int32)
    if ck.dtype == k.dtype:
        ck[bidx, slot] = k[:, 0]
        cv[bidx, slot] = v[:, 0]
        keys, values = ck, cv
    else:
        keys, values = ck.to(k.dtype), cv.to(v.dtype)
        keys[bidx, slot] = k[:, 0]
        values[bidx, slot] = v[:, 0]
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
    k_valid = cpos >= 0
    if window is not None:
        k_valid &= cpos > (cur_pos[:, None] - window)
    out = multihead_attention(q, keys, values, q_pos=pos2d, k_pos=cpos,
                              window=None, causal=True,
                              softcap=cfg.attn_softcap, k_valid=k_valid)
    out = nn.dense(p["wo"], out.reshape(B, 1, H * hd), compute_dtype)
    return out, cache


# ---------------------------------------------------------------------------
# decode on a GSPMD mesh: the ring split by cache_specs
# ---------------------------------------------------------------------------

def _split_dims(t):
    """{dim: the mesh dims that split it, in the mesh's order} of a
    DTensor."""
    from torch.distributed.tensor import Shard
    out = {}
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim % t.dim(), []).append(i)
    return out


def _block_start(t, dim: int, split) -> int:
    """Where this rank's block of DTensor ``t`` starts along ``dim``
    (split over ``split[dim]``, major to minor, in equal parts)."""
    coord = t.device_mesh.get_coordinate()
    idx = 0
    for i in split.get(dim, ()):
        idx = idx * t.device_mesh.size(i) + coord[i]
    return idx * t.to_local().shape[dim]


def _all_reduce(x, op: str, mesh_dims, dm):
    """``x`` reduced (``"sum"`` / ``"max"``) over the process group of
    each of ``mesh_dims`` in turn: functional collectives, which the
    census counts and a card shared over gloo stages through the host."""
    ops = torch.ops._c10d_functional
    for i in mesh_dims:
        x = ops.wait_tensor(ops.all_reduce(
            x.contiguous(), op, dm.get_group(i).group_name))
    return x


def _write_slot(block, start: int, slot, value) -> None:
    """``block[b, slot[b] - start] = value[b]`` for the rows whose slot
    lies in this block (``start`` … ``start + W_block``); the other rows
    keep their entry. No shape depends on the data."""
    w = block.shape[1]
    rel = slot - start
    hit = (rel >= 0) & (rel < w)
    idx = rel.clamp(0, w - 1)
    b = torch.arange(block.shape[0], device=block.device)
    old = block[b, idx]
    hit = hit.reshape((-1,) + (1,) * (old.dim() - 1))
    block[b, idx] = torch.where(hit, value.to(block.dtype), old)


def _ring_decode(q, k, v, cache, cur_pos, window, softcap):
    """One-token attention against a ring of DTensors placed by the
    reference's ``cache_specs``, run on each rank's block with no gather
    of the ring (:func:`_blocks_decode`). The ring (B, W, K, hd) may be
    split on its batch (the batch axes), its slots W, its kv heads K or
    its head dim hd. The new (k, v) and position are written into the
    block of the rank that owns slot ``cur_pos % W``, at its offset there
    (every rank computes the slot; a rank that does not own it keeps its
    entry). Positions (B, W) may be split otherwise than the keys (a
    window shorter than the head dim); they are then gathered for the
    read."""
    ring, ring_v, ring_pos = cache["k"], cache["v"], cache["pos"]
    W = ring.shape[1]
    split, pos_split = _split_dims(ring), _split_dims(ring_pos)
    if split.get(0) != pos_split.get(0):
        raise ValueError("a ring's keys and positions split their batch "
                         "differently")
    k_l, v_l = _rows(k, ring, split), _rows(v, ring, split)
    cur = _rows(cur_pos, ring, split).long()
    slot = torch.remainder(cur, W)
    k0, hd0 = _block_start(ring, 2, split), _block_start(ring, 3, split)
    ck, cv = ring.to_local(), ring_v.to_local()
    nk, nh = ck.shape[2], ck.shape[3]
    k_new = k_l[:, 0, k0:k0 + nk, hd0:hd0 + nh]
    v_new = v_l[:, 0, k0:k0 + nk, hd0:hd0 + nh]
    cp = ring_pos.to_local()
    _write_slot(cp, _block_start(ring_pos, 1, pos_split), slot,
                cur.to(torch.int32))
    w0 = _block_start(ring, 1, split)
    if ck.dtype == k_new.dtype:
        _write_slot(ck, w0, slot, k_new)
        _write_slot(cv, w0, slot, v_new)
        keys, values = ck, cv
    else:
        keys, values = ck.to(k_new.dtype), cv.to(v_new.dtype)
        _write_slot(keys, w0, slot, k_new)
        _write_slot(values, w0, slot, v_new)
        _write_slot(ck, w0, slot, k_new)
        _write_slot(cv, w0, slot, v_new)
    if pos_split.get(1) == split.get(1):
        k_pos = cp
    else:  # the positions of this rank's slots, from the whole rows
        k_pos = _rows(ring_pos, ring, split)[:, w0:w0 + ck.shape[1]]
    k_valid = k_pos >= 0
    if window is not None:
        k_valid &= k_pos > (cur[:, None] - window)
    bias = _mask_bias(cur[:, None], k_pos, None, True)  # (B, 1, W)
    return _blocks_decode(q, ring, ring_v, softcap, keys=keys, values=values,
                          bias=bias, valid=k_valid)


def _rows(t, ring, split):
    """This rank's samples of ``t`` (a DTensor, or a plain tensor every
    rank holds alike), laid out as the ring's batch, every other dim
    whole: a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard
    dm = ring.device_mesh
    batch = [Shard(0) if i in split.get(0, ()) else Replicate()
             for i in range(dm.ndim)]
    return nn.replicated_like(t, ring).redistribute(dm, batch).to_local()


def _blocks_decode(q, ring, ring_v, softcap, *, keys=None, values=None,
                   bias=None, valid=None, k_valid=None):
    """One query a sample (q (B, 1, H, hd)) against keys and values of
    DTensors (B, T, K, hd) split by the reference's ``cache_specs`` — a
    decode ring, an encoder's cross cache — run on each rank's blocks
    (``keys`` / ``values`` in the compute dtype when given, else the
    blocks as they are). Each rank takes the query heads of its kv heads
    and its part of the head dim; a split head dim sums the logits over
    its axes; over split keys the softmax is split: each rank's max is
    all-reduced (max), then one all-reduce (sum) of each rank's sum of
    exponentials and weighted values, and the output is their quotient.
    ``bias`` (B, 1, T) and ``valid`` (B, T) are this rank's blocks of an
    additive mask and of the keys that may be attended; ``k_valid`` a
    whole (B, T) one. Returns the output (B, 1, H, hd), a DTensor whose
    heads and head dim are split as the keys' kv heads and head dim."""
    from torch.distributed.tensor import Replicate, Shard
    dm = ring.device_mesh
    B, T, K, hd = ring.shape
    H = q.shape[2]
    G = H // K
    split = _split_dims(ring)
    q_l = _rows(q, ring, split)
    keys = ring.to_local() if keys is None else keys
    values = ring_v.to_local() if values is None else values
    nk, nh = keys.shape[2], keys.shape[3]
    k0, hd0 = _block_start(ring, 2, split), _block_start(ring, 3, split)
    if k_valid is not None:  # this rank's samples and keys of the mask
        blk = [Shard(0) if i in split.get(0, ()) else
               Shard(1) if i in split.get(1, ()) else Replicate()
               for i in range(dm.ndim)]
        valid = nn.replicated_like(k_valid, ring).redistribute(
            dm, blk).to_local()
    qf = q_l.float().reshape(q_l.shape[0], 1, K, G, hd)
    qf = qf[:, :, k0:k0 + nk, :, hd0:hd0 + nh]
    logits = torch.einsum("bskgd,btkd->bkgst", qf, keys.float())
    logits = _all_reduce(logits, "sum", split.get(3, ()), dm) / math.sqrt(hd)
    logits = nn.softcap(logits, softcap)
    if bias is not None:
        logits = logits + bias[:, None, None]
    if valid is not None:
        logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    top = _all_reduce(logits.amax(-1, keepdim=True), "max",
                      split.get(1, ()), dm)
    e = torch.exp(logits - top)
    num = torch.einsum("bkgst,btkd->bskgd", e, values.float())
    den = e.sum(-1)  # (B, K, G, 1)
    both = _all_reduce(torch.cat([num.reshape(num.shape[0], -1),
                                  den.reshape(den.shape[0], -1)], 1),
                       "sum", split.get(1, ()), dm)
    num = both[:, :num[0].numel()].reshape(num.shape)
    den = both[:, num[0].numel():].reshape(den.shape)
    out = num / den.permute(0, 3, 1, 2)[..., None]  # (B, 1, K, G, hd)
    out = out.reshape(out.shape[0], 1, nk * G, nh).to(q_l.dtype)
    pl = [Shard(0) if i in split.get(0, ()) else
          Shard(2) if i in split.get(2, ()) else
          Shard(3) if i in split.get(3, ()) else Replicate()
          for i in range(dm.ndim)]
    return nn.from_blocks(out.contiguous(), dm, pl, (B, 1, H, hd))
