"""Functional NN primitives: params are nested dicts of tensors; every
layer is an ``init_*`` plus a pure apply function.

Master parameters are fp32; the compute dtype is configurable (bf16 on the
card). Layouts follow the JAX package: ``dense`` keeps ``(in, out)``
weights and computes ``x @ w``, so no weight is ever transposed.

The shard hints are the reference's: inside :func:`use_mesh` (the port's
``with mesh:``) on a GSPMD mesh, :func:`shard_hint` redistributes a
``torch.distributed.tensor.DTensor`` to the placements of its spec — the
counterpart of ``with_sharding_constraint`` — and the model code calls it
where the reference does. Outside a mesh, or on a plain tensor, every
hint returns its input unchanged, so the same code runs on one device.
"""
from __future__ import annotations

import contextlib
import functools
import math
import os
import sys
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# the mesh context and the shard hints
# ---------------------------------------------------------------------------

# the GSPMD mesh entered (process-wide, as the reference's mesh context:
# a checkpointed block recomputed in the backward, which may run on
# autograd's device thread, sees the mesh of the step that runs it)
_MESH = {"mesh": None}
_SEQ_STATE = {"enabled": None}  # per-forward override (set by forward())
# inside a weight's gather (process-wide, as the mesh: a recomputed block
# gathers on autograd's thread)
_GATHERING = {"depth": 0}


@contextlib.contextmanager
def use_mesh(mesh):
    """The port's ``with mesh:`` for a GSPMD ``launch.mesh.Mesh``: the
    hints act on DTensors on it while inside (the step's forward and
    backward run there). Leaving it clears the sequence-sharding
    override."""
    if getattr(mesh, "mode", None) != "gspmd":
        raise ValueError(f"use_mesh takes a GSPMD mesh, got {mesh!r}")
    outer = _MESH["mesh"]
    _MESH["mesh"] = mesh
    try:
        yield mesh
    finally:
        _MESH["mesh"] = outer
        _SEQ_STATE["enabled"] = None


def current_mesh():
    """The GSPMD mesh of the enclosing :func:`use_mesh` (or None)."""
    return _MESH["mesh"]


@contextlib.contextmanager
def gathering_params():
    """Marks the collectives run inside as a parameter's gather (FSDP's
    just-in-time gather of a weight's blocks): ``engine.CollectiveCensus``
    counts them apart as well, so a step's contract can tell a weight
    gathered over ``data`` from activations gathered there."""
    _GATHERING["depth"] += 1
    try:
        yield
    finally:
        _GATHERING["depth"] -= 1


def gathering_depth() -> int:
    """How many :func:`gathering_params` enclose the caller."""
    return _GATHERING["depth"]


def serving_mode(fn):
    """``torch.inference_mode`` around a serving function (prefill,
    decode), or ``torch.no_grad`` inside a GSPMD mesh: DTensor's views
    (the period unbinding, a cache's blocks) set version counters, which
    inference tensors do not have."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        mode = (torch.no_grad() if current_mesh() is not None
                else torch.inference_mode())
        with mode:
            return fn(*args, **kwargs)
    return wrapped


def _is_dtensor(x) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported (a
    # GSPMD mesh imports it), so a one-device run never pays its import
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard_hint(x, *axes):
    """Best-effort ``with_sharding_constraint``: inside a mesh, a DTensor
    ``x`` is redistributed to the placements of the spec ``axes`` (one
    entry per dim: an axis name, a tuple of them, or None); axis names
    absent from the mesh are dropped from the spec, so the same model code
    runs on any mesh or none at all. A plain tensor passes unchanged."""
    mesh = current_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    from ..launch import sharding  # deferred: launch imports the models
    spec = sharding.filter_spec(tuple(axes) + (None,) * (x.dim() - len(axes)),
                                mesh)
    return x.redistribute(mesh.device_mesh, sharding.placements(spec, mesh))


def replicated_like(t, x):
    """``t``, a tensor every rank computes alike (positions, a mask),
    made a replicated DTensor on the mesh of DTensor ``x`` so the two
    combine; unchanged beside a plain ``x``."""
    if not _is_dtensor(x) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def mesh_axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None or name not in mesh:
        return 1
    return mesh[name]


def set_seq_shard(enabled):
    """Override of sequence parallelism for the forward that sets it (None
    = the ``REPRO_SEQ_SHARD`` default). The reference measured it a win
    for dense/hybrid/ssm stacks and a regression for MoE stacks (dispatch
    reshard churn), so ``transformer.forward`` gates it by family. It
    holds until the next forward sets it or the mesh is left, so a
    checkpointed block recomputed in the backward shards as its forward
    did."""
    _SEQ_STATE["enabled"] = enabled


def _seq_shard_on() -> bool:
    if _SEQ_STATE["enabled"] is not None:
        return _SEQ_STATE["enabled"]
    return os.environ.get("REPRO_SEQ_SHARD", "1") != "0"


def _seq_ok(x) -> bool:
    m = mesh_axis_size("model")
    return (_seq_shard_on() and m > 1 and x.dim() >= 3
            and x.shape[1] % m == 0 and x.shape[1] >= m)


def seq_sharded(x):
    """Sequence-parallel residual stream (Korthikanti et al.): between
    blocks the activations are sharded over ``model`` on the SEQUENCE dim
    (a partial sum is reduce-scattered there). No-op when S does not
    divide (decode, S = 1)."""
    if not _seq_ok(x):
        return x
    return shard_hint(x, ("pod", "data"), "model", *([None] * (x.dim() - 2)))


def seq_gathered(x):
    """Gather the sequence dim before cross-token or TP-weight matmuls."""
    if not _seq_ok(x):
        return x
    return shard_hint(x, ("pod", "data"), *([None] * (x.dim() - 1)))


def last_row(x):
    """``x[:, -1:]``. Of a DTensor split on its sequence dim (the
    sequence-parallel stream) only each rank's last row is gathered —
    the (B, ranks, D) rows of the shards, whose last is the sequence's —
    never the whole sequence."""
    if not _is_dtensor(x):
        return x[:, -1:]
    from torch.distributed.tensor import Shard
    seq = [i for i, p in enumerate(x.placements)
           if isinstance(p, Shard) and p.dim % x.dim() == 1]
    if not seq:
        return x[:, -1:]
    rows = math.prod(x.device_mesh.size(i) for i in seq)
    shape = (x.shape[0], rows) + tuple(x.shape[2:])
    ends = on_blocks(lambda t: t[:, -1:].contiguous(), x,
                     out=(x.placements, shape))
    return ends[:, -1:]


def on_channels(fn, x, *others):
    """``fn(x, *others)`` for a function that treats the last dim of x
    (B, S, C) channel by channel (a depthwise convolution, a scan along
    the sequence). On a DTensor ``x`` it runs on each rank's blocks: x
    and every other argument of its rank laid out with their samples over
    the batch axes, their sequence whole and their channels over
    ``model`` where C divides it, a lower-rank argument (a weight (...,
    C)) split on its channels alike; the result is a DTensor of x's
    layout. A plain x runs ``fn`` as it is."""
    if not _is_dtensor(x):
        return fn(x, *others)
    ch = "model" if x.shape[-1] % mesh_axis_size("model") == 0 else None
    x = shard_hint(x, ("pod", "data"), *([None] * (x.dim() - 2)), ch)
    others = [shard_hint(replicated_like(t, x), *(
        [("pod", "data")] + [None] * (t.dim() - 2) if t.dim() == x.dim()
        else [None] * (t.dim() - 1)), ch) for t in others]
    return on_blocks(fn, x, *others, out=(x.placements, x.shape))


class _GradAsForward(torch.autograd.Function):
    """Identity whose gradient is laid out as its input was (a DTensor's
    placements): DTensor may hand a view's backward a gradient split on a
    dim the view merges, which it cannot flatten."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate
        # the gradient of a partial sum is whole on its axis
        ctx.layout = (x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        if _is_dtensor(g) and tuple(g.placements) != placements:
            g = g.redistribute(mesh, placements)
        return g


def grad_as_forward(x):
    """``x``, its gradient laid out as ``x`` is (:class:`_GradAsForward`);
    a plain tensor passes."""
    return _GradAsForward.apply(x) if _is_dtensor(x) else x


def whole(x):
    """This rank's copy of the whole of a DTensor ``x`` (gathered over
    every axis; differentiable), a plain tensor; a plain ``x`` passes."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def mergeable(x, first: int, last: int):
    """``x`` ready for a reshape that merges its dims ``first`` …
    ``last``: a DTensor split on any of them but the first is gathered
    there (DTensor would keep the merged dim in a strided split, which a
    fake tensor cannot gather later); a plain tensor passes."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard)
          and first < p.dim % x.dim() <= last else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def from_blocks(block, mesh, placements, shape):
    """The DTensor of whole ``shape`` on ``mesh`` (a ``DeviceMesh``), laid
    out by ``placements``, whose block on this rank is ``block``, taken
    as it is (a view stays one: writes to it reach its base)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def on_blocks(fn, *args, out):
    """``fn`` on this rank's blocks: each DTensor of ``args`` (laid out by
    the caller) passed as its block, anything else as it is. Each output
    becomes the DTensor :func:`from_blocks` makes of it for its
    ``(placements, shape)`` in ``out``: one pair for one output, a list
    of pairs for a tuple of outputs, a dict for a dict. Nothing here
    communicates: each rank computes its own blocks."""
    mesh = next(a.device_mesh for a in args if _is_dtensor(a))
    res = fn(*[a.to_local() if _is_dtensor(a) else a for a in args])
    if isinstance(out, dict):
        return {k: from_blocks(res[k], mesh, *o) for k, o in out.items()}
    if isinstance(out, list):
        return tuple(from_blocks(r, mesh, *o) for r, o in zip(res, out))
    return from_blocks(res, mesh, *out)


def period(leaf, i: int):
    """Period ``i`` of a stacked cache leaf, a view that writes reach the
    leaf through. A DTensor leaf (a cache placed on a GSPMD mesh; its
    period dim is never split) gives the DTensor of its block's period
    ``i``, split as the leaf one dim down."""
    if not _is_dtensor(leaf):
        return leaf[i]
    from torch.distributed.tensor import Shard
    pl = []
    for p in leaf.placements:
        if isinstance(p, Shard):
            if p.dim % leaf.dim() == 0:
                raise ValueError("a cache leaf split on its period dim")
            p = Shard(p.dim % leaf.dim() - 1)
        pl.append(p)
    return on_blocks(lambda t: t[i], leaf, out=(pl, leaf.shape[1:]))


def write_period(leaf, i: int, new) -> None:
    """Copy ``new`` over period ``i`` of a stacked cache leaf, in place.
    On a GSPMD mesh ``new`` is first laid out as the leaf's block (a
    plain ``new`` is taken as replicated), and each rank writes its own
    block."""
    if not _is_dtensor(leaf):
        leaf[i].copy_(new)
        return
    view = period(leaf, i)
    new = replicated_like(new, view)
    if list(new.placements) != list(view.placements):
        new = new.redistribute(view.device_mesh, view.placements)
    view.to_local().copy_(new.to_local())


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


def _fsdp_placements(w):
    """A DTensor's placements gathered over every axis but ``model``."""
    from torch.distributed.tensor import Replicate
    return [p if ax == "model" else Replicate()
            for ax, p in zip(w.device_mesh.mesh_dim_names, w.placements)]


def _fsdp_gather(w):
    """A DTensor weight inside a mesh, gathered over every axis but
    ``model`` (FSDP's just-in-time gather; the backward reduce-scatters
    its gradient). Left to itself DTensor may move the activations
    instead — partial sums of (B, S, d_ff) hiddens over ``data`` — which
    at full width cost far more than the weight."""
    if not _is_dtensor(w) or current_mesh() is None:
        return w
    want = _fsdp_placements(w)
    if want == list(w.placements):
        return w
    with gathering_params():
        return w.redistribute(w.device_mesh, want)


def dense(p, x, compute_dtype=None):
    if _is_dtensor(x) and x.dim() > 2:
        x = _one_leading_shard(x)
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    w = _fsdp_gather(w)
    # the product's gradient laid out as its output: a gradient split on
    # the sequence (the stream's layout after the block) cannot be
    # flattened with the batch for the weight's gradient
    y = grad_as_forward(x @ w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _one_leading_shard(x):
    """A DTensor ``x`` whose leading dims (all but the last) are split on
    more than one dim — batch over ``data`` and rows over ``model`` after
    context-parallel attention — gathered on all but the first of them:
    the product flattens the leading dims, and DTensor cannot multiply a
    flattened dim split twice."""
    from torch.distributed.tensor import Replicate, Shard
    lead = [i for i, p in enumerate(x.placements) if isinstance(p, Shard)
            and p.dim % x.dim() < x.dim() - 1]
    dims = {x.placements[i].dim % x.dim() for i in lead}
    if len(dims) < 2:
        return x
    keep = min(dims)
    pl = [Replicate() if i in lead and x.placements[i].dim % x.dim() != keep
          else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


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
    freqs = replicated_like(rope_freqs(hd, theta, x.device), positions)
    ang = positions[..., None].float() * freqs  # (B, S, hd/2)
    return _rotate(x, ang)


def _rotate(x, ang):
    """Rotate the split halves of x (B, S, H, hd) by angles (B, S, hd/2),
    in fp32, cast back to x's dtype."""
    cos = replicated_like(torch.cos(ang)[:, :, None, :], x)
    sin = replicated_like(torch.sin(ang)[:, :, None, :], x)
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
    freqs = torch.split(replicated_like(rope_freqs(hd, theta, x.device),
                                        positions), list(sections))
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


def _ffn_spec(ndim: int, last):
    spec = [None] * ndim
    spec[0] = ("pod", "data")
    spec[-1] = last
    return spec


def ffn(p, x, kind: str, compute_dtype=None):
    """The gated ``swiglu`` / ``geglu`` FFN or the plain ``gelu`` one. GELU
    is the tanh approximation, the default of ``jax.nn.gelu``. On a mesh
    the hidden stays sharded over ``model`` on d_ff and the output goes
    back to the sequence-sharded stream."""
    x = seq_gathered(x)
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
    h = shard_hint(h, *_ffn_spec(h.dim(), "model"))
    return seq_sharded(dense(p["w_down"], h, compute_dtype))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, device=None):
    return {"table": torch.randn((vocab, d_model), generator=gen,
                                 device=device) * 0.02}


def embed(p, tokens, compute_dtype=None, scale: bool = False):
    """``scale`` multiplies by sqrt(d_model) rounded to the compute dtype
    first, as the JAX package does (in bf16, sqrt(3584) is 59.75). A
    DTensor table inside a mesh is looked up by :func:`_sharded_embed`."""
    if current_mesh() is not None and _is_dtensor(p["table"]):
        return _sharded_embed(p["table"], tokens, compute_dtype, scale)
    # gather first, then cast: the same values as the JAX package's
    # cast-then-gather without a compute-dtype copy of the whole table
    x = F.embedding(tokens, p["table"])
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(p["table"].shape[-1]), dtype=x.dtype)
    return x


def _sharded_embed(table, tokens, compute_dtype, scale: bool):
    """The lookup of a DTensor table, gathered over every axis but
    ``model`` (:func:`_fsdp_gather`; the tied table the forward gathered
    for the head too is taken as it is) and looked up on each rank's
    block. With the vocab split over ``model`` (the reference's policy
    when it divides) each rank looks up the tokens of its vocab slice,
    zero elsewhere, and the rows are a partial sum over ``model`` that the
    caller's ``seq_sharded`` reduce-scatters (Megatron's vocab-parallel
    embedding); with d_model split over it, each rank looks up its
    columns of every row. ``tokens`` (a DTensor, or a plain tensor
    replicated on every rank) keep their batch placement."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = current_mesh()
    axes = list(mesh)
    mi = axes.index("model") if "model" in axes else None
    want = _fsdp_placements(table)
    if want != list(table.placements):
        if compute_dtype is not None:  # cast, then gather (the reference's
            table = table.to(compute_dtype)  # order): half the bytes in bf16
        with gathering_params():
            table = table.redistribute(mesh.device_mesh, want)
    split = want[mi] if mi is not None else Replicate()
    if _is_dtensor(tokens):
        tok_pl = list(tokens.placements)
        if split != Replicate() and tok_pl[mi] != Replicate():
            # a table split over 'model' looks up tokens whole on it
            tok_pl[mi] = Replicate()
            tokens = tokens.redistribute(mesh.device_mesh, tok_pl)
        tok = tokens.to_local()
    else:
        tok_pl, tok = [Replicate()] * len(axes), tokens
    # each rank looks rows up for its own tokens: the table's gradient is
    # a partial sum over the axes the tokens are split over, whole on the
    # axes they are replicated over, and split as the table on ``model``
    grad_pl = [Partial() if isinstance(pl, Shard) else Replicate()
               for pl in tok_pl]
    if split != Replicate():
        grad_pl[mi] = split
    t = table.to_local(grad_placements=grad_pl)
    if compute_dtype is not None:
        # the gathered tied table is cast here, on the local block: a cast
        # of the DTensor would all-reduce its partial gradient
        t = t.to(compute_dtype)
    if split == Shard(0):
        lo = mesh.coords()["model"] * t.shape[0]
        hit = (tok >= lo) & (tok < lo + t.shape[0])
        x = F.embedding(torch.where(hit, tok - lo, 0), t)
        x = x * hit[..., None].to(x.dtype)
        tok_pl[mi] = Partial()
    else:
        x = F.embedding(tok, t)
        if split != Replicate():  # d_model's columns
            tok_pl[mi] = Shard(x.dim() - 1)
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[-1]), dtype=x.dtype)
    return DTensor.from_local(x, mesh.device_mesh, tok_pl, run_check=False)


def unembed(p, x, compute_dtype=None):
    """x @ tableᵀ. On a mesh the table is gathered over every axis but
    ``model`` (:func:`_fsdp_gather`), so the logits come out split over
    the vocab with nothing to reduce (the product over a data-split
    d_model would be a partial sum of full-vocab logits)."""
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
        x = x.to(compute_dtype)
    if _is_dtensor(x) and x.dim() > 2:
        x = _one_leading_shard(x)
    return x @ _fsdp_gather(t).T
