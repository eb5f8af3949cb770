"""Slot-pooled decode cache: the serving twin of the training engine's
planned activations.

A :class:`KVPool` owns one device-resident decode cache sized for the
plan's admitted slot count (``plan_serve`` → ``ServePlan.max_decode_slots``)
and treats its batch dimension as a pool of request *slots*: a request is
admitted by allocating a free slot and copying its prefill cache row in,
decodes in place — an attention layer writes ring slot ``pos % W``
(``attention.attn_decode_step``), an ssm or recurrent layer overwrites its
fp32 state and conv tail — and on finish returns the slot to the free
list — no zeroing, since admission overwrites the whole row.

Memory contract: the pool is allocated once (``slots *
memory_model.kv_slot_bytes``) and written in place by ``insert`` and by
every decode step; ``donate=False`` keeps the JAX package's undonated
meaning instead, a fresh pool per write (the old one stays readable, at
the cost of a second copy while both live).
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from .. import tree
from ..models import transformer
from ..models.config import ModelConfig


class PoolExhausted(RuntimeError):
    """alloc() with no free slot — the scheduler admitted past the plan."""


class KVPool:
    """Fixed-capacity pool of decode-cache slots.

    ``cache`` is ``transformer.init_cache``'s tree: one entry per pattern
    slot (a ring, or a state and conv tail), leaves stacked over periods
    with the request slot at dim 1."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int, *,
                 dtype=torch.bfloat16, global_window: Optional[int] = None,
                 donate: bool = True, device="cuda"):
        if max_slots < 1:
            raise ValueError(f"need at least one slot, got {max_slots}")
        self.max_slots = int(max_slots)
        self.donate = donate
        self.device = torch.device(device)
        self.cache = transformer.init_cache(cfg, self.max_slots, max_len,
                                            dtype, global_window, self.device)
        # LIFO free list: the slot freed last is reused first
        self._free: List[int] = list(range(self.max_slots - 1, -1, -1))

    # -- slot lifecycle -----------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.max_slots - len(self._free)

    def alloc(self) -> int:
        """Claim a free slot. Raises :class:`PoolExhausted` when the plan's
        admission bound is fully used — the scheduler must wait for an
        eviction, never grow the pool."""
        if not self._free:
            raise PoolExhausted(
                f"all {self.max_slots} decode slots in use — admission is "
                "bounded by the ServePlan; wait for an eviction")
        return self._free.pop()

    def free(self, slot: int) -> None:
        """Return a finished request's slot (reusable at once; the next
        insert overwrites the whole row)."""
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.max_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free (double evict)")
        self._free.append(slot)

    # -- data movement ------------------------------------------------------

    @torch.inference_mode()
    def insert(self, prefill_cache: Any, row: int, slot: int) -> None:
        """Copy prefill-cache row ``row`` into pool slot ``slot`` (dim 1 of
        every leaf), converted to the pool's dtype. The prefill cache must
        come from the same config, ``max_len`` and windows."""
        index = torch.full((1,), slot, dtype=torch.long, device=self.device)

        def put(pool_leaf, pre_leaf):
            src = pre_leaf[:, row:row + 1].to(pool_leaf.dtype)
            if self.donate:
                return pool_leaf.index_copy_(1, index, src)
            return pool_leaf.index_copy(1, index, src)

        self.cache = tree.map(put, self.cache, prefill_cache)

    def bytes(self) -> int:
        """Device bytes the pool holds (all leaves)."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in tree.leaves(self.cache))
