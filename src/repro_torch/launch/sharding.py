"""The reference's divisibility-aware sharding policy, as arithmetic.

A spec (:class:`PartitionSpec`, a tuple) has one entry per dim of a
leaf: an axis name, a tuple of axis names, or None (replicated on that
dim) — what JAX's ``PartitionSpec`` holds. On a GSPMD mesh
(``launch.mesh.gspmd_mesh``) a spec becomes ``torch.distributed.tensor``
placements (:func:`placements`), and a tree of whole tensors this rank's
blocks (:func:`shard_tree`) and back (:func:`gather_tree`) — the
counterparts of the reference's ``named`` / ``with_sharding``. The specs
also serve the memory model (``core.memory_model.param_shard_ratio``)
and the batch and cache layouts (the sample dim over the batch axes).

Parameters: tensor-parallel over ``model`` on the last divisible dim,
FSDP over ``data`` on the first remaining divisible dim (leaves of two or
more dims). Stacked-per-period leaves (under ``blocks``/``enc_layers``/
``dec_layers``) never shard their leading dim. Batch leaves shard dim
``batch_dim`` over (pod, data). A dim that does not divide stays
replicated.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from . import mesh as mesh_lib

_STACKED_ROOTS = ("blocks", "enc_layers", "dec_layers")


class PartitionSpec(tuple):
    """One leaf's spec: per dim, an axis name, a tuple of them or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def spec_leaves(specs) -> List[PartitionSpec]:
    """A spec tree's specs in ``tree.leaves`` order (a spec is a tuple, so
    ``tree.leaves`` would walk into it)."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (tuple, list)):
        return [s for x in specs for s in spec_leaves(x)]
    return []


def _map_with_keys(fn: Callable, t, keys: Tuple[str, ...] = ()):
    """``fn(dict_keys, leaf)`` over a tree of dicts, tuples and lists; the
    keys are the dict keys on the leaf's path (sequence indices are not
    keys, as in the reference's ``DictKey`` filter)."""
    if isinstance(t, dict):
        return {k: _map_with_keys(fn, v, keys + (str(k),))
                for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_map_with_keys(fn, v, keys) for v in t)
    if t is None:
        return None
    return fn(keys, t)


def _map(fn: Callable, t):
    return _map_with_keys(lambda _, leaf: fn(leaf), t)


def _entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _auto_dims(shape: Tuple[int, ...], model_size: int, data_size: int,
               skip_leading: int, fsdp, fsdp_axes) -> List[Any]:
    spec: List[Any] = [None] * len(shape)
    dims = range(skip_leading, len(shape))
    if len(shape) - skip_leading < 2:
        return spec  # 1-D leaves (norm scales, biases): replicated
    # model (TP) axis: last dim divisible by the model mesh size
    for i in reversed(list(dims)):
        if model_size > 1 and shape[i] % model_size == 0 \
                and shape[i] >= model_size:
            spec[i] = mesh_lib.MODEL_AXIS
            break
    if fsdp and data_size > 1:
        for i in dims:
            if spec[i] is None and shape[i] % data_size == 0 \
                    and shape[i] >= data_size:
                spec[i] = _entry(fsdp_axes)
                break
    return spec


def param_specs(params_shapes, mesh, *, fsdp: bool = True,
                fsdp_over_pod: bool = False):
    """Spec tree for a parameter-like tree (params, gradients, optimizer
    state): leaves are anything with a ``shape``. ``fsdp_over_pod``
    extends the FSDP shard to the (pod, data) product."""
    msize = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
    dsize = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)
    fsdp_axes: Tuple[str, ...] = (mesh_lib.DATA_AXIS,)
    if fsdp_over_pod and mesh_lib.POD_AXIS in mesh:
        fsdp_axes = (mesh_lib.POD_AXIS, mesh_lib.DATA_AXIS)
        dsize *= mesh_lib.axis_size(mesh, mesh_lib.POD_AXIS)

    def spec_for(keys, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        # embedding table: shard the vocab dim (Megatron-style) when the
        # vocab divides the model axis; else the generic policy
        if list(keys[-2:]) == ["embed", "table"] and msize > 1 \
                and shape[0] % msize == 0:
            spec: List[Any] = [mesh_lib.MODEL_AXIS, None]
            if fsdp and dsize > 1 and shape[1] % dsize == 0:
                spec[1] = _entry(fsdp_axes)
            return P(*spec)
        skip = 1 if keys and keys[0] in _STACKED_ROOTS else 0
        return P(*_auto_dims(shape, msize, dsize, skip, fsdp, fsdp_axes))

    return _map_with_keys(spec_for, params_shapes)


def batch_specs(batch_shapes, mesh, *, batch_dim: int = 1):
    """Spec tree for micro-batch stacks ``(N_Sμ, micro, ...)``: dim 0 (the
    micro-batch axis) replicated, ``batch_dim`` over (pod, data) when
    divisible."""
    baxes = mesh_lib.batch_axes(mesh)
    dp = mesh_lib.data_parallel_size(mesh)

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        spec: List[Any] = [None] * len(shape)
        if len(shape) > batch_dim and dp > 1 and shape[batch_dim] % dp == 0 \
                and shape[batch_dim] >= dp:
            spec[batch_dim] = _entry(baxes)
        return P(*spec)

    return _map(spec_for, batch_shapes)


def cache_specs(cache_shapes, mesh, *, stacked: bool = True):
    """Spec tree for decode caches: leaves are (P, B, ...) — batch over
    (pod, data), the model axis on the largest divisible dim after it."""
    msize = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
    baxes = mesh_lib.batch_axes(mesh)
    dp = mesh_lib.data_parallel_size(mesh)
    bdim = 1 if stacked else 0

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        spec: List[Any] = [None] * len(shape)
        if len(shape) > bdim and dp > 1 and shape[bdim] % dp == 0 \
                and shape[bdim] >= dp:
            spec[bdim] = _entry(baxes)
        cand = [i for i in range(bdim + 1, len(shape))
                if msize > 1 and shape[i] % msize == 0 and shape[i] >= msize]
        if cand:
            spec[max(cand, key=lambda i: shape[i])] = mesh_lib.MODEL_AXIS
        return P(*spec)

    return _map(spec_for, cache_shapes)


def shard_factor(spec, mesh) -> int:
    """How many ways a spec splits its leaf over ``mesh``."""
    f = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            f *= mesh[ax]
    return f


# ---------------------------------------------------------------------------
# specs on a GSPMD mesh: placements, local shards, and back
# ---------------------------------------------------------------------------

def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> set:
    """The mesh axes a spec splits its leaf over."""
    return {ax for entry in spec for ax in _axes_of(entry)}


def filter_spec(spec, mesh) -> PartitionSpec:
    """``spec`` with the axis names ``mesh`` does not have dropped (the
    reference's ``shard_hint`` filter): an entry left with no axis is
    None, one with one axis that name."""
    out = []
    for entry in spec:
        present = tuple(a for a in _axes_of(entry) if a in mesh)
        out.append(None if not present else
                   present if len(present) > 1 else present[0])
    return P(*out)


def placements(spec, mesh) -> list:
    """The ``torch.distributed.tensor`` placements of ``spec`` on
    ``mesh``, one per mesh axis in the mesh's order: ``Shard(i)`` on an
    axis that names dim ``i``, ``Replicate()`` on one no dim names. A
    dim over two axes (``("pod", "data")``) is split over the first, then
    each part over the second — JAX's major-to-minor order, which is
    DTensor's left-to-right."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, entry in enumerate(spec):
        for ax in _axes_of(entry):
            if ax in where:
                raise ValueError(f"spec {spec!r} names axis {ax!r} twice")
            where[ax] = i
    return [Shard(where[ax]) if ax in where else Replicate() for ax in mesh]


def local_slices(shape, spec, mesh, coords: Dict[str, int]) -> tuple:
    """The index (a tuple of slices) of the block of a leaf of ``shape``
    that the rank at ``coords`` holds under ``spec``. Every sharded dim
    must divide (the policy shards only those)."""
    idx = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = _axes_of(entry)
        if not axes:
            idx.append(slice(None))
            continue
        parts, pos = 1, 0
        for ax in axes:  # major to minor
            parts *= mesh[ax]
            pos = pos * mesh[ax] + coords[ax]
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"{parts} ways (spec {spec!r})")
        size = n // parts
        idx.append(slice(pos * size, (pos + 1) * size))
    return tuple(idx)


def shard_tree(t, specs, mesh, device=None):
    """This rank's blocks of a tree of whole tensors (the reference
    format, every rank holding the same values): each leaf sliced at the
    rank's coordinates by its spec (``spec_leaves`` order), copied (to
    ``device`` when given) so that the whole leaf can be freed."""
    from .. import tree as tree_lib
    coords = mesh.coords()
    leaves, treedef = tree_lib.flatten(t)
    sl = spec_leaves(specs)
    if len(sl) != len(leaves):
        raise ValueError(f"{len(sl)} specs for {len(leaves)} leaves")
    out = []
    for leaf, spec in zip(leaves, sl):
        block = leaf[local_slices(leaf.shape, spec, mesh, coords)]
        out.append(block.to(device=device if device is not None
                            else block.device, copy=True).contiguous())
    return tree_lib.unflatten(treedef, out)


def as_dtensor(local: "torch.Tensor", spec, mesh):
    """The DTensor whose block on this rank is ``local`` under ``spec``
    (differentiable: the gradient of the DTensor reaches ``local`` in the
    same placements)."""
    from torch.distributed.tensor import DTensor
    shape = [n for n in local.shape]
    for i in range(len(shape)):
        for ax in _axes_of(spec[i] if i < len(spec) else None):
            shape[i] *= mesh[ax]
    return DTensor.from_local(local, mesh.device_mesh,
                              placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def gather_tree(t, specs, mesh):
    """The whole tensors of a tree of this rank's blocks, on every rank
    (an all-gather over each leaf's sharded axes; a collective every rank
    calls)."""
    from .. import tree as tree_lib
    leaves, treedef = tree_lib.flatten(t)
    sl = spec_leaves(specs)
    return tree_lib.unflatten(treedef, [
        as_dtensor(leaf, spec, mesh).full_tensor()
        if any(e is not None for e in spec) else leaf
        for leaf, spec in zip(leaves, sl)])


# ---------------------------------------------------------------------------
# placed trees: DTensors on a GSPMD mesh (the reference's in_shardings)
# ---------------------------------------------------------------------------

def place_tree(t, specs, mesh, device=None):
    """The DTensors of a tree of whole tensors (every rank holding the
    same values) under ``specs``: each rank keeps its block only
    (:func:`shard_tree`, on ``device`` when given)."""
    from .. import tree as tree_lib
    leaves, treedef = tree_lib.flatten(shard_tree(t, specs, mesh, device))
    return tree_lib.unflatten(treedef, [
        as_dtensor(x, spec, mesh)
        for x, spec in zip(leaves, spec_leaves(specs))])


def placed_cache(meta_cache, mesh, device):
    """An empty decode cache on a GSPMD mesh: the leaves of ``meta_cache``
    (meta tensors of the whole cache, ``transformer.init_cache(...,
    device="meta")``'s tree) as DTensors placed by
    ``cache_specs(stacked=True)``, each rank allocating its own block
    only, filled as ``init_cache`` fills them: zeros, and -1 in a ring's
    slot positions (``pos``)."""
    from .. import tree as tree_lib
    leaves, treedef = tree_lib.flatten(meta_cache)
    names = tree_lib.leaves(_map_with_keys(lambda keys, _: keys[-1],
                                           meta_cache))
    specs = spec_leaves(cache_specs(meta_cache, mesh, stacked=True))
    coords = mesh.coords()
    out = []
    for leaf, name, spec in zip(leaves, names, specs):
        idx = local_slices(leaf.shape, spec, mesh, coords)
        shape = [len(range(*s.indices(n))) for s, n in zip(idx, leaf.shape)]
        block = torch.full(shape, -1 if name == "pos" else 0,
                           dtype=leaf.dtype, device=device)
        out.append(as_dtensor(block, spec, mesh))
    return tree_lib.unflatten(treedef, out)


def full_tree(t):
    """The whole tensors of a tree of DTensors, on every rank (an
    all-gather over each leaf's split axes; a collective every rank
    calls). Plain leaves pass unchanged."""
    from torch.distributed.tensor import DTensor

    from .. import tree as tree_lib
    return tree_lib.map(lambda x: x.full_tensor()
                        if isinstance(x, DTensor) else x, t)


def local_bytes(t) -> int:
    """The bytes this rank holds of a tree of DTensors (their blocks) or
    plain tensors."""
    from .. import tree as tree_lib
    total = 0
    for x in tree_lib.leaves(t):
        x = x.to_local() if hasattr(x, "to_local") else x
        total += x.numel() * x.element_size()
    return total
