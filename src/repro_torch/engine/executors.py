"""MBS executors behind one interface.

All run the same Algorithm 1 through the shared core in ``exec_core.py``;
only the strategy differs. The names are the JAX package's:

  * :class:`CompiledScanExecutor` (``compiled``) — an eager loop over the
    micro-batch axis with the normalization folded into the loss and a
    plain fp32 add (PyTorch runs eagerly; there is no scan to compile);
  * :class:`FusedAccumExecutor` (``fused``) — accumulation through kernel
    K1 over the tree's leaves, the 1/N_Sμ scale fused into the accumulate
    (paper Fig. 2 step ❹ + eq. 14);
  * :class:`FlatFusedExecutor` (``flat``) — params, optimizer state and
    the fp32 accumulator live as one flat buffer per dtype bucket
    (``engine/flat.py``); step ❹ is one K1 launch per bucket and step ❺
    one in-place K2/K3/K4 launch per bucket.

``step_split(params, opt_state, micro_batches)`` takes a pre-split batch
of device tensors ``(N_Sμ, N_μ, ...)`` and returns
``(params, opt_state, metrics)`` with device-scalar metrics.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Type

from .. import tree
from . import exec_core, flat
from .plan import MBSPlan


def _micro(micro_batches, i: int):
    return {k: v[i] for k, v in micro_batches.items()}


class _ExecutorBase:
    """Common machinery: the eager micro-batch loop and the update."""
    name = "base"
    fused = False  # raw micro losses, normalization fused into K1

    def __init__(self, loss_fn, optimizer, plan: MBSPlan):
        if not isinstance(plan, MBSPlan):
            raise TypeError(f"expected MBSPlan, got {type(plan)!r}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.plan = plan

    def _accumulated(self, params, micro_batches):
        """(grads tree in accum_dtype, loss, metric_sum) over the split."""
        plan = self.plan
        n_s, total_valid = exec_core.denominators(micro_batches)
        scale = (exec_core.deferred_scale(plan.normalization, n_s,
                                          total_valid)
                 if self.fused else None)
        acc = exec_core.init_accum(params, plan.accum_dtype)
        loss_sum, metric_sum = None, None
        for i in range(n_s):
            lfn = exec_core.micro_loss_fn(
                self.loss_fn, plan.normalization, n_s, total_valid,
                _micro(micro_batches, i), defer_scale=self.fused)
            loss, metrics, grads = exec_core.value_and_grad(lfn, params)
            acc = exec_core.accumulate(acc, grads, scale=scale,
                                       fused=self.fused)
            del grads
            loss_sum, metric_sum = _add_metrics(loss_sum, metric_sum, loss,
                                                metrics, n_s)
        if self.fused:
            loss_sum = loss_sum * scale
        return acc, loss_sum, metric_sum

    def gradients(self, params, micro_batches):
        """The accumulated normalized gradients (eq. 15–17) and the loss."""
        grads, loss, _ = self._accumulated(params, micro_batches)
        return grads, loss

    def step_split(self, params, opt_state, micro_batches):
        grads, loss, metric_sum = self._accumulated(params, micro_batches)
        new_params, new_opt = exec_core.apply_update(
            self.optimizer, grads, opt_state, params)
        return new_params, new_opt, exec_core.finalize_metrics(
            metric_sum, loss, grads)


def _add_metrics(loss_sum, metric_sum, loss, metrics, n_s):
    if loss_sum is None:
        return loss, {k: m / n_s for k, m in metrics.items()}
    return loss_sum + loss, {k: metric_sum[k] + m / n_s
                             for k, m in metrics.items()}


class CompiledScanExecutor(_ExecutorBase):
    """Eager loop + plain fp32 add (the JAX package's ``compiled``)."""
    name = "compiled"
    fused = False


class FusedAccumExecutor(_ExecutorBase):
    """Eager loop with kernel K1's fused scaled accumulate over the tree's
    leaves (one launch per gradient dtype)."""
    name = "fused"
    fused = True


class FlatFusedExecutor(_ExecutorBase):
    """Fused flat-buffer update path.

    Params and optimizer state are view trees of flat dtype-bucket buffers
    (:meth:`prepare` makes them so; :meth:`step_split` keeps them so): the
    model reads the views, K1 adds each micro-batch's gradient leaves,
    where autograd left them, into their slices of the fp32 flat
    accumulator (normalization deferred into the kernel; one launch per
    bucket, no copy of the gradient), and K2/K3/K4 write params and state
    in place — no ``updates`` tree and no fresh optimizer-state trees."""
    name = "flat"
    fused = True

    def prepare(self, params, opt_state) -> Tuple[Any, Any]:
        """Flat view trees of ``params`` and ``opt_state`` (one copy unless
        they already are); callers drop the originals to free them."""
        spec = flat.FlatSpec.for_tree(params)
        _, params = spec.as_flat(params)
        opt_state = {k: (spec.as_flat(v)[1] if k != "step" and v is not None
                         else v) for k, v in opt_state.items()}
        return params, opt_state

    def _accumulated_flat(self, params, micro_batches):
        plan = self.plan
        spec = flat.FlatSpec.for_tree(params)
        n_s, total_valid = exec_core.denominators(micro_batches)
        scale = exec_core.deferred_scale(plan.normalization, n_s,
                                         total_valid)
        device = tree.leaves(params)[0].device
        acc = spec.zeros(plan.accum_dtype, device)
        loss_sum, metric_sum = None, None
        for i in range(n_s):
            lfn = exec_core.micro_loss_fn(
                self.loss_fn, plan.normalization, n_s, total_valid,
                _micro(micro_batches, i), defer_scale=True)
            loss, metrics, grads = exec_core.value_and_grad(lfn, params)
            exec_core.accumulate_flat(acc, spec, grads, scale=scale)
            del grads
            loss_sum, metric_sum = _add_metrics(loss_sum, metric_sum, loss,
                                                metrics, n_s)
        return spec, acc, loss_sum * scale, metric_sum

    def gradients(self, params, micro_batches):
        spec, acc, loss, _ = self._accumulated_flat(params, micro_batches)
        return spec.unflatten(acc, cast=False), loss

    def step_split(self, params, opt_state, micro_batches):
        params, opt_state = self.prepare(params, opt_state)
        spec, acc, loss, metric_sum = self._accumulated_flat(
            params, micro_batches)
        new_params, new_opt = exec_core.apply_update_flat(
            self.optimizer, spec, acc, opt_state, params)
        return new_params, new_opt, exec_core.finalize_metrics(
            metric_sum, loss, acc)


EXECUTORS: Dict[str, Type] = {
    CompiledScanExecutor.name: CompiledScanExecutor,
    FusedAccumExecutor.name: FusedAccumExecutor,
    FlatFusedExecutor.name: FlatFusedExecutor,
}

# the JAX package's eager host pipeline; ROADMAP.md queue 1 item 3 ports it
_NOT_PORTED = {"streaming": "ROADMAP.md queue 1 item 3"}


def get_executor(name: str) -> Type:
    try:
        return EXECUTORS[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"executor {name!r} is not ported yet ({_NOT_PORTED[name]})"
            ) from None
        raise ValueError(f"unknown executor {name!r}; available: "
                         f"{sorted(EXECUTORS)}") from None
