"""Graded rematerialization policies on ``torch.utils.checkpoint`` — the
compute↔memory axis the planner trades against the micro-batch size.

The lattice, in order of increasing memory savings / recompute:

  ``none``    no checkpointing: every intermediate stays live for backward.
  ``dots``    selective checkpointing per period: matmul and convolution
              outputs are saved (the expensive part to recompute),
              everything else is recomputed — the counterpart of JAX's
              ``checkpoint_dots``, which is ``dots_saveable`` and saves
              ``dot_general`` and ``conv_general_dilated``.
  ``period``  plain checkpointing per period: only the residual stream at
              each period boundary survives the forward.
  ``full``    ``period`` plus a nested checkpoint around every block inside
              the period, so the recompute working set is one block.

All checkpoints are non-reentrant (``use_reentrant=False``), so they nest
and take the parameter dicts as ordinary arguments.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as ckpt

# Lattice order == escalation order: the planner prefers the leftmost
# (cheapest-recompute) policy whose admitted micro-batch meets the target.
POLICIES = ("none", "dots", "period", "full")

# the ATen ops that ``dots`` saves: the matmuls (``x @ w`` lowers to
# mm/addmm after a view; the attention einsums lower to bmm) and the
# convolution (``F.conv2d`` reaches the policy as ``aten.convolution``,
# tests/test_torch_cnn.py)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
            torch.ops.aten.convolution.default)


def validate(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; known: {list(POLICIES)} "
            "(or 'auto' at the planner layer)")
    return policy


def policy_weight(policy: str) -> int:
    """Position on the lattice (0 = no remat): admission is monotone
    non-decreasing in it."""
    return POLICIES.index(validate(policy))


def resolve(remat: Optional[bool] = None,
            remat_policy: Optional[str] = None) -> str:
    """Collapse the (legacy bool, graded policy) pair to one policy: an
    explicit policy wins, else True → "period" and False → "none"."""
    if remat_policy is not None:
        return validate(remat_policy)
    if remat is None or remat:
        return "period"
    return "none"


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn: Callable, **kw) -> Callable:
    @functools.wraps(fn)
    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def checkpoint_period(fn: Callable, policy: str) -> Callable:
    """Wrap a period function per the policy (outer level)."""
    validate(policy)
    if policy == "dots":
        return _checkpointed(fn, context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots))
    if policy in ("period", "full"):
        return _checkpointed(fn)
    return fn


def checkpoint_block(fn: Callable, policy: str) -> Callable:
    """Wrap one block inside an already-checkpointed period: only ``full``
    nests a second checkpoint here."""
    validate(policy)
    if policy == "full":
        return _checkpointed(fn)
    return fn
