"""Flat-buffer layer: parameter trees ⇄ contiguous dtype-bucketed 1-D
buffers.

A :class:`FlatSpec` lays a tree out as one contiguous 1-D buffer per dtype
("bucket"), so the step-❹ accumulate and the step-❺ fused optimizer
kernels launch once per bucket instead of once per leaf.

Contract (the JAX package's ``engine/flat.py``):

  * **stable leaf ordering** — leaves follow ``jax.tree.flatten`` order
    (dict keys sorted, tuples in order; ``repro_torch.tree``), so the
    offsets equal the JAX spec's and a flat buffer here equals
    ``FlatSpec.flatten`` of the reference tree;
  * **dtype bucketing** — leaves sharing a dtype share a bucket, buckets in
    order of first appearance; gradient/accumulator buffers reuse the
    param partitioning in another dtype;
  * **no padded copies** — buckets are exact-sized; the kernels mask the
    ragged tail.

The flat executor keeps state flat across steps: :meth:`FlatSpec.unflatten`
returns *views* into the buffers (no copy when the dtype matches), the
model reads those views, and the kernels write the buffers in place —
the torch counterpart of the JAX package's buffer donation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from .. import tree


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one tree leaf lives inside the flat buffers."""
    bucket: int
    offset: int
    size: int
    shape: Tuple[int, ...]
    dtype: Any


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Layout of one tree as dtype-bucketed contiguous 1-D buffers."""
    treedef: Any
    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Tuple[int, ...]
    bucket_dtypes: Tuple[Any, ...]

    @classmethod
    def for_tree(cls, t) -> "FlatSpec":
        leaves, treedef = tree.flatten(t)
        buckets: dict = {}  # dtype -> bucket index (first appearance)
        fill: list = []  # elements filled per bucket so far
        slots = []
        for leaf in leaves:
            dt = leaf.dtype
            if dt not in buckets:
                buckets[dt] = len(fill)
                fill.append(0)
            b = buckets[dt]
            size = leaf.numel()
            slots.append(LeafSlot(b, fill[b], size, tuple(leaf.shape), dt))
            fill[b] += size
        return cls(treedef, tuple(slots), tuple(fill), tuple(buckets))

    @property
    def num_leaves(self) -> int:
        return len(self.slots)

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    def zeros(self, dtype, device) -> Tuple[torch.Tensor, ...]:
        """Zero accumulator buffers: the param partitioning, one dtype."""
        return tuple(torch.zeros((n,), dtype=dtype, device=device)
                     for n in self.bucket_sizes)

    def packed_zeros(self, dtype, device, tail: int = 0
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """(store, buckets): one zero 1-D buffer of every bucket's elements
        plus ``tail`` more, and the buckets as views into it, in order —
        an accumulator that one collective can reduce in place, with room
        after it for ``tail`` scalars."""
        store = torch.zeros((sum(self.bucket_sizes) + tail,), dtype=dtype,
                            device=device)
        views, off = [], 0
        for n in self.bucket_sizes:
            views.append(store[off:off + n])
            off += n
        return store, tuple(views)

    def bucket_blocks(self, kind: str = "grad_accum", *,
                      dtype: Optional[Any] = None,
                      interpret: Optional[bool] = None) -> Tuple[int, ...]:
        """Per-bucket 1-D launch blocks through the tuning cache's resolver
        (``engine.autotune``), else ``launch_config``'s. ``dtype``
        overrides the bucket dtype for the lookup (accumulator buffers
        carry ``accum_dtype``)."""
        from ..kernels import resolve_block
        return tuple(
            resolve_block(kind, dtype if dtype is not None else dt, n,
                          interpret)
            for n, dt in zip(self.bucket_sizes, self.bucket_dtypes))

    def by_bucket(self, leaves) -> list:
        """A list of leaves in tree order → one list per bucket, each in
        slot order."""
        if len(leaves) != len(self.slots):
            raise ValueError(f"tree has {len(leaves)} leaves, spec expects "
                             f"{len(self.slots)}")
        parts: list = [[] for _ in self.bucket_sizes]
        for leaf, slot in zip(leaves, self.slots):
            parts[slot.bucket].append(leaf)
        return parts

    def flatten(self, t, dtype: Optional[Any] = None
                ) -> Tuple[torch.Tensor, ...]:
        """Tree → new bucketed 1-D buffers. ``dtype`` casts every leaf
        (routing gradients into ``accum_dtype``)."""
        leaves = tree.leaves(t)
        return tuple(torch.cat([x.reshape(-1) if dtype is None
                                else x.reshape(-1).to(dtype) for x in part])
                     for part in self.by_bucket(leaves))

    def unflatten(self, buffers: Sequence[torch.Tensor], *,
                  cast: bool = True):
        """Bucketed buffers → tree of views into them (a leaf is copied
        only when ``cast`` must change its dtype). ``cast=False`` keeps the
        buffer dtype on every leaf (gradient trees in ``accum_dtype``)."""
        leaves = []
        for slot in self.slots:
            leaf = buffers[slot.bucket][
                slot.offset:slot.offset + slot.size].view(slot.shape)
            leaves.append(leaf.to(slot.dtype) if cast else leaf)
        return tree.unflatten(self.treedef, leaves)

    def buffers_of(self, t) -> Optional[Tuple[torch.Tensor, ...]]:
        """The bucket buffers a tree of views (from :meth:`unflatten`)
        reads, or None when some leaf is not a view at its slot."""
        bases = [None] * self.num_buckets
        for leaf, slot in zip(tree.leaves(t), self.slots):
            base = leaf._base
            if (base is None or base.dim() != 1
                    or base.numel() != self.bucket_sizes[slot.bucket]
                    or base.dtype != self.bucket_dtypes[slot.bucket]
                    or leaf.storage_offset() - base.storage_offset()
                    != slot.offset
                    or not leaf.is_contiguous()):
                return None
            if bases[slot.bucket] is None:
                bases[slot.bucket] = base
            elif bases[slot.bucket] is not base:
                return None
        return tuple(bases)

    def place(self, t, device) -> Tuple[Tuple[torch.Tensor, ...], Any]:
        """(new buffers on ``device``, tree of views into them), each leaf
        of ``t`` copied into its slot: no staging copy of the whole tree
        (a restore of a host state onto the card)."""
        bufs = tuple(torch.empty((n,), dtype=dt, device=device)
                     for n, dt in zip(self.bucket_sizes, self.bucket_dtypes))
        leaves = tree.leaves(t)
        self.by_bucket(leaves)  # the leaf count must be the spec's
        for leaf, slot in zip(leaves, self.slots):
            bufs[slot.bucket][slot.offset:slot.offset + slot.size].copy_(
                leaf.reshape(-1))
        return bufs, self.unflatten(bufs)

    def as_flat(self, t) -> Tuple[Tuple[torch.Tensor, ...], Any]:
        """(buffers, tree of views into them): the tree's own buffers when
        it already is a flat view tree, else new buffers (one copy)."""
        bufs = self.buffers_of(t)
        if bufs is None:
            bufs = self.flatten(t)
            t = self.unflatten(bufs)
        return bufs, t
