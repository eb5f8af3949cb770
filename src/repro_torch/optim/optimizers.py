"""Optimizers (functional, optax-style ``update``) and LR schedules.

The paper trains with SGD (momentum 0.9, decay 5e-4 / 1e-4) for the
classifiers and Adam for U-Net. ``torch.optim`` is not used: its Adam
folds the bias corrections in another order than the JAX package's
``(m/bc1) / (sqrt(v/bc2) + eps)``, and the flat executor needs the
arithmetic in one place it can hand to the fused kernels.

Schedules map the step counter (a 0-d int32 device tensor) to a 0-d fp32
device tensor, so the learning rate never round-trips through the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from .. import tree

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def linear_decay(lr: float, total_steps: int, end_factor: float = 0.0
                 ) -> Schedule:
    def sched(step):
        frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
        return (lr * (1.0 + (end_factor - 1.0) * frac)).float()
    return sched


def cosine_decay(lr: float, total_steps: int, warmup: int = 0,
                 min_factor: float = 0.0) -> Schedule:
    def sched(step):
        step = step.float()
        warm = (torch.clamp(step / max(warmup, 1), max=1.0)
                if warmup else 1.0)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = min_factor + (1 - min_factor) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return (lr * warm * cos).float()
    return sched


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else constant(lr)


@dataclasses.dataclass(frozen=True)
class FusedUpdateSpec:
    """Per-optimizer hook for the fused flat update path (paper step ❺).

    Describes the update arithmetic so the engine can run it through the
    in-place kernels (``kernels/fused_update.py``) on dtype-bucketed flat
    buffers instead of ``update`` + ``apply_update`` over trees. Static
    hyperparameters become kernel constants; the schedule and the
    global-norm clip give device scalars carried into the kernel.
    Consumed by ``engine.exec_core.apply_update_flat``."""
    kind: str  # "sgd" | "adam"
    schedule: Schedule
    momentum: float = 0.0
    nesterov: bool = False
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    decoupled: bool = False
    clip_norm: Optional[float] = None


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    fused: Optional[FusedUpdateSpec] = None


def _step0(params) -> torch.Tensor:
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0,
        weight_decay: float = 0.0, nesterov: bool = False) -> Optimizer:
    """SGD + momentum + (coupled) weight decay."""
    sched = _as_schedule(lr)

    def init(params):
        mom = tree.map(torch.zeros_like, params) if momentum else None
        return {"mom": mom, "step": _step0(params)}

    def update(grads, state, params):
        lr_t = sched(state["step"])
        if weight_decay:
            grads = tree.map(
                lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        if momentum:
            mom = tree.map(lambda m, g: momentum * m + g.to(m.dtype),
                           state["mom"], grads)
            eff = (tree.map(lambda g, m: g + momentum * m, grads, mom)
                   if nesterov else mom)
        else:
            mom, eff = None, grads
        updates = tree.map(lambda u: -lr_t * u.float(), eff)
        return updates, {"mom": mom, "step": state["step"] + 1}

    return Optimizer(init, update, FusedUpdateSpec(
        "sgd", sched, momentum=momentum, nesterov=nesterov,
        weight_decay=weight_decay))


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         decoupled: bool = False) -> Optimizer:
    """Adam / AdamW with the bias corrections applied as
    ``(m/bc1) / (sqrt(v/bc2) + eps)``."""
    sched = _as_schedule(lr)

    def init(params):
        return {"m": tree.map(torch.zeros_like, params),
                "v": tree.map(torch.zeros_like, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(state["step"])
        if weight_decay and not decoupled:
            grads = tree.map(
                lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree.map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.to(v_.dtype)), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m_, v_, p):
            u = (m_.float() / bc1) / (torch.sqrt(v_.float() / bc2) + eps)
            if weight_decay and decoupled:
                u = u + weight_decay * p.float()
            return -lr_t * u

        updates = tree.map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update, FusedUpdateSpec(
        "adam", sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
        decoupled=decoupled))


def adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, decoupled=True)


def memory_model_kw(optimizer: Optimizer, *, fused: bool = False) -> dict:
    """Memory-model kwargs (``opt_slots=``/``fused_update=``) for
    ``plan_mbs`` derived from the optimizer itself: the state-slot count is
    measured by calling ``init`` on a small probe tensor and counting the
    params-shaped leaves; ``fused_update`` holds only when the optimizer
    publishes a fused hook."""
    probe = torch.zeros((2, 3))
    state = optimizer.init({"p": probe})
    slots = sum(1 for leaf in tree.leaves(state)
                if getattr(leaf, "shape", None) == probe.shape)
    return {"opt_slots": slots,
            "fused_update": fused and optimizer.fused is not None}


# the reducer of squared gradient norms inside ``sharded_norm`` (None: the
# leaves are whole tensors)
_NORM = {"reduce": None}


@contextlib.contextmanager
def sharded_norm(reduce: Callable[[List[torch.Tensor]], torch.Tensor]):
    """Inside it the leaves of a gradient are one rank's blocks of a split
    model: a global norm passes the squared norm of every leaf, in tree
    order, to ``reduce``, which returns their sum over the whole model
    (each leaf counted once, however many ranks hold a replica of it)."""
    outer = _NORM["reduce"]
    _NORM["reduce"] = reduce
    try:
        yield
    finally:
        _NORM["reduce"] = outer


def norm_reducer():
    """The reducer of the enclosing :func:`sharded_norm` (or None)."""
    return _NORM["reduce"]


def clip_by_global_norm(optimizer: Optimizer, max_norm: float) -> Optimizer:
    """Scale gradients so their global norm is at most ``max_norm``. The
    fused flat path carries ``clip_norm`` in the :class:`FusedUpdateSpec`
    and applies the scale inside the update kernel instead."""
    def update(grads, state, params):
        sq = [torch.sum(torch.square(g.float())) for g in tree.leaves(grads)]
        reduce = norm_reducer()
        norm = torch.sqrt(sum(sq) if reduce is None else reduce(sq))
        scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
        grads = tree.map(lambda g: g * scale.to(g.dtype), grads)
        return optimizer.update(grads, state, params)

    # one clip scalar rides into the kernel; a double-wrapped clip cannot,
    # so it drops the hook and falls back to the reference tree update
    fused = (dataclasses.replace(optimizer.fused, clip_norm=max_norm)
             if optimizer.fused is not None
             and optimizer.fused.clip_norm is None else None)
    return Optimizer(optimizer.init, update, fused)
