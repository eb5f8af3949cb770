"""Shared normalization / accumulation / update core.

Every executor runs the paper's Algorithm 1 through these helpers, so the
numerics live in one place:

  * loss normalization (§3.4, eq. 14): either folded into the micro loss
    before differentiation ("scaled" form — loss/N_Sμ for "paper",
    Σ/N_B_valid for "exact"), or deferred to the accumulate ("raw" form —
    the unscaled micro loss's gradient is accumulated with the scale fused
    in, paper Fig. 2 step ❹, which is what kernel K1 does);
  * gradient accumulation in ``accum_dtype`` (fp32 by default);
  * the single optimizer update per mini-batch (step ❺) + shared metrics;
  * the numeric guard (the supervisor's): step ❺ behind an on-device
    finite check of the accumulator (:func:`guarded_update`,
    :func:`guarded_update_flat`).

Scales, learning rates, norms and the guard's flag stay device tensors:
nothing here syncs with the host.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from .. import optim, tree
from ..kernels import (fused_adam, fused_sgd, grad_accum_many,
                       grad_accum_tree)
from .flat import FlatSpec


def denominators(micro_batches) -> Tuple[int, torch.Tensor]:
    """(N_Sμ, N_B_valid) of a split batch: N_B_valid is the total sample
    weight when a mask is present (padding contributes 0), else N_Sμ·N_μ."""
    first = next(iter(micro_batches.values()))
    n_s = first.shape[0]
    w = micro_batches.get("sample_weight")
    total_valid = (torch.sum(w) if w is not None
                   else torch.full((), n_s * first.shape[1],
                                   dtype=torch.get_default_dtype(),
                                   device=first.device))
    return n_s, total_valid


def init_accum(params, dtype):
    """Zero gradient accumulator shaped like params, in ``accum_dtype``."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def micro_loss_fn(loss_fn: Callable, normalization: str, n_s, total_valid,
                  mb, *, defer_scale: bool = False) -> Callable:
    """The per-micro-batch loss to differentiate.

    ``defer_scale=False``: normalization folded in (Algorithm 1 line 11 for
    "paper"; the exact denominator for "exact") — accumulate with a plain
    add. ``defer_scale=True``: the raw micro loss; the 1/N_Sμ (resp.
    1/N_B_valid) scale is fused into the accumulate (:func:`deferred_scale`).
    """
    def f(p):
        if normalization == "paper":
            loss, metrics = loss_fn(p, mb)
            return (loss, metrics) if defer_scale else (loss / n_s, metrics)
        if normalization != "exact":
            raise ValueError(f"unknown normalization {normalization!r}")
        denom = 1.0 if defer_scale else total_valid
        return loss_fn(p, mb, exact_denom=denom)
    return f


def deferred_scale(normalization: str, n_s, total_valid):
    """The scale fused into the accumulate when the micro loss was raw."""
    if normalization == "paper":
        return 1.0 / n_s
    return 1.0 / total_valid


def value_and_grad(lfn: Callable, params) -> Tuple[torch.Tensor, Any, Any]:
    """(loss, metrics, grads) of ``lfn`` at ``params``. Leaves are detached
    aliases of the caller's tensors (no copy), so a tree of views into flat
    buffers stays a tree of views."""
    leaves, treedef = tree.flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    loss, metrics = lfn(tree.unflatten(treedef, req))
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(treedef, grads))


def accumulate(acc, grads, *, scale=None, fused: bool = False):
    """acc ← acc + [scale ·] grads, in the accumulator's dtype.

    ``fused=True`` routes the leaves through kernel K1, one launch per
    gradient dtype (in place on the fp32 accumulator; the scaled gradient
    is never materialized)."""
    if fused:
        return grad_accum_tree(acc, grads, 1.0 if scale is None else scale)
    if scale is None:
        return tree.map(lambda a, g: a.add_(g.to(a.dtype)), acc, grads)
    return tree.map(lambda a, g: a.add_((g * scale).to(a.dtype)), acc, grads)


def abstract_call(fn: Callable, *trees):
    """``fn(*trees)``'s outputs as meta tensors (shape and dtype, no
    storage): ``fn`` runs under a fake-tensor mode on CPU fakes of the
    inputs' shapes, so it allocates nothing and launches nothing — the
    twin of ``jax.eval_shape``. Non-tensor outputs come back as they
    are."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fakes = [tree.map(lambda t: torch.empty(tuple(t.shape),
                                                dtype=t.dtype), x)
                 for x in trees]
        out = fn(*fakes)
    leaves, treedef = tree.flatten(out)
    return tree.unflatten(treedef, [
        torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        if isinstance(x, torch.Tensor) else x for x in leaves])


def apply_update(optimizer, grads, opt_state, params):
    """Paper Fig. 2 step ❺: one optimizer update per mini-batch."""
    updates, new_opt_state = optimizer.update(grads, opt_state, params)
    new_params = tree.map(lambda p, u: p + u.to(p.dtype), params, updates)
    return new_params, new_opt_state


def accumulate_flat(acc_buffers, spec: FlatSpec, grads, *, scale=None):
    """Bucketed step ❹: K1 adds each gradient leaf, where autograd left
    it, into its slice of the flat accumulator (a view at the leaf's slot)
    — one launch per dtype bucket, no copy of the gradient. The cast to
    the accumulator's dtype happens in the kernel."""
    s = 1.0 if scale is None else scale
    acc_views = [acc_buffers[sl.bucket][sl.offset:sl.offset + sl.size]
                 for sl in spec.slots]
    for accs, gs in zip(spec.by_bucket(acc_views),
                        spec.by_bucket(tree.leaves(grads))):
        grad_accum_many(accs, gs, s)
    return acc_buffers


def apply_update_flat(optimizer, spec: FlatSpec, acc_buffers, opt_state,
                      params, *, ok=None):
    """Step ❺ over flat buffers: one in-place kernel launch per bucket.

    ``params`` (and the optimizer state trees) must be view trees of flat
    buffers (``FlatSpec.as_flat``); K2/K3/K4 write those buffers in place
    and the same view trees come back. The global-norm clip scale is
    computed from the flat accumulator and carried into the kernel.
    Optimizers without a ``fused`` hook take the reference tree update.

    ``ok`` (the guard's device flag) goes into the kernels, which write
    nothing where it is 0, and the step counter advances by it."""
    fs = getattr(optimizer, "fused", None)
    if fs is None:
        return apply_update(optimizer, spec.unflatten(acc_buffers, cast=False),
                            opt_state, params)
    gscale = 1.0
    if fs.clip_norm is not None:
        norm = global_grad_norm(acc_buffers, spec)
        gscale = torch.clamp(fs.clip_norm / (norm + 1e-12), max=1.0)
    step = opt_state["step"]
    lr_t = fs.schedule(step)
    flat_p = _buffers(spec, params)

    if fs.kind == "sgd":
        if fs.momentum:
            flat_m = _buffers(spec, opt_state["mom"])
            for p, g, m in zip(flat_p, acc_buffers, flat_m):
                fused_sgd(p, g, m, lr_t, gscale, momentum=fs.momentum,
                          weight_decay=fs.weight_decay, nesterov=fs.nesterov,
                          ok=ok)
            return params, {"mom": opt_state["mom"],
                            "step": _advance(step, ok)}
        for p, g in zip(flat_p, acc_buffers):
            fused_sgd(p, g, None, lr_t, gscale, weight_decay=fs.weight_decay,
                      ok=ok)
        return params, {"mom": None, "step": _advance(step, ok)}

    if fs.kind == "adam":
        step1 = step + 1
        bc1 = 1 - fs.b1 ** step1.float()
        bc2 = 1 - fs.b2 ** step1.float()
        flat_m = _buffers(spec, opt_state["m"])
        flat_v = _buffers(spec, opt_state["v"])
        for p, g, m, v in zip(flat_p, acc_buffers, flat_m, flat_v):
            fused_adam(p, g, m, v, lr_t, bc1, bc2, gscale, b1=fs.b1,
                       b2=fs.b2, eps=fs.eps, weight_decay=fs.weight_decay,
                       decoupled=fs.decoupled, ok=ok)
        return params, {"m": opt_state["m"], "v": opt_state["v"],
                        "step": step1 if ok is None else _advance(step, ok)}

    raise ValueError(f"unknown fused update kind {fs.kind!r}")


def _advance(step, ok):
    """The step counter after an update: +1, or +ok under the guard (a
    skipped step leaves it, and Adam's bias corrections, where they were)."""
    return step + 1 if ok is None else step + ok.to(step.dtype)


def _buffers(spec: FlatSpec, t):
    bufs = spec.buffers_of(t)
    if bufs is None:
        raise ValueError("the fused flat update writes in place: pass view "
                         "trees of flat buffers (FlatSpec.as_flat)")
    return bufs


def global_grad_norm(grads, spec: FlatSpec = None) -> torch.Tensor:
    """sqrt(Σ g²) in fp32 over a tree or a list of flat buffers, without a
    squared copy of any buffer. Under ``optim.sharded_norm`` (a GSPMD
    step: the leaves are this rank's blocks) the squares are taken leaf
    by leaf — ``spec`` maps flat buffers back to their leaves — and
    summed over the model by the reducer."""
    reduce = optim.norm_reducer()
    if reduce is None:
        return torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
            g, dtype=torch.float32)) for g in tree.leaves(grads)))
    if spec is not None:
        grads = spec.unflatten(grads, cast=False)
    return torch.sqrt(reduce([torch.square(torch.linalg.vector_norm(
        g, dtype=torch.float32)) for g in tree.leaves(grads)]))


# ---------------------------------------------------------------------------
# numeric guard
# ---------------------------------------------------------------------------

FINITE_CHUNK = 1 << 26  # elements a reduction reads at a time


def finite_all(grads) -> torch.Tensor:
    """Device scalar (bool): True iff every element of the accumulator is
    finite — a tree, or the flat executor's list of bucket buffers.

    Each leaf is read in slices of at most ``FINITE_CHUNK`` elements by
    ``torch.aminmax``, which propagates a NaN and shows an infinity at an
    end, so no temporary the size of a leaf (a bool mask of a 1.5 G
    element bucket is 1.44 GiB) is made; the flags are ANDed on the
    device and nothing is read back."""
    ok = None
    for g in tree.leaves(grads):
        flat = g.reshape(-1)
        for lo in range(0, flat.numel(), FINITE_CHUNK):
            lo_hi = torch.aminmax(flat[lo:lo + FINITE_CHUNK])
            part = torch.isfinite(lo_hi.min) & torch.isfinite(lo_hi.max)
            ok = part if ok is None else ok & part
    return torch.ones((), dtype=torch.bool) if ok is None else ok


def guarded_update(optimizer, grads, opt_state, params, ok=None):
    """Step ❺ behind the finite check: where the accumulated gradient has
    a non-finite element the update is skipped — params and optimizer
    state, the step counter included, come back as they were. ``ok``
    (a device bool) overrides the check of ``grads``: a pipeline stage
    holds a part of the gradient, and takes the flag of the whole.

    The reference's ``lax.cond`` becomes a selection on the device: the
    update runs, and leaf by leaf ``torch.where(ok, new, old)`` keeps one
    of the two, the new leaf dropped at once, so the guard adds at most
    one leaf (the largest) to the update's memory and reads nothing back.
    Returns ``(new_params, new_opt_state, ok)``."""
    if ok is None:
        ok = finite_all(grads)
    new, treedef = tree.flatten(apply_update(optimizer, grads, opt_state,
                                             params))
    old = tree.leaves((params, opt_state))
    if len(old) != len(new):
        raise ValueError(f"the update returned {len(new)} leaves for "
                         f"{len(old)}")
    for i, o in enumerate(old):
        new[i] = torch.where(ok, new[i], o)
    new_params, new_opt_state = tree.unflatten(treedef, new)
    return new_params, new_opt_state, ok


def guarded_update_flat(optimizer, spec: FlatSpec, acc_buffers, opt_state,
                        params):
    """Flat variant of :func:`guarded_update`: the check runs on the
    bucket buffers and the flag goes into K2–K4, which write nothing when
    it is 0 — the in-place update is skipped on the device."""
    if getattr(optimizer, "fused", None) is None:
        return guarded_update(optimizer, spec.unflatten(acc_buffers,
                                                        cast=False),
                              opt_state, params)
    ok = finite_all(acc_buffers)
    new_params, new_opt_state = apply_update_flat(
        optimizer, spec, acc_buffers, opt_state, params, ok=ok)
    return new_params, new_opt_state, ok


def finalize_metrics(metric_sum: Dict[str, Any], loss, grads, ok=None,
                     grad_norm=None, spec: FlatSpec = None
                     ) -> Dict[str, Any]:
    """The step's device-scalar metrics; under the guard also
    ``nonfinite`` (1.0 when the update was skipped). ``grad_norm``
    overrides the norm of ``grads`` (a pipeline stage's part); ``spec``
    is the layout of flat ``grads`` (:func:`global_grad_norm`)."""
    out = dict(metric_sum)
    out["loss"] = loss  # Σ normalized micro losses == mini-batch mean loss
    out["grad_norm"] = (global_grad_norm(grads, spec) if grad_norm is None
                        else grad_norm)
    if ok is not None:
        out["nonfinite"] = 1.0 - ok.to(torch.float32)
    return out
