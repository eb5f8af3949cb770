"""MBS executors behind one interface.

All run the same Algorithm 1 through the shared core in ``exec_core.py``;
only the strategy differs. The names are the JAX package's:

  * :class:`CompiledScanExecutor` (``compiled``) — an eager loop over the
    micro-batch axis with the normalization folded into the loss and a
    plain fp32 add (PyTorch runs eagerly; there is no scan to compile);
  * :class:`StreamingExecutor` (``streaming``) — the paper's Fig. 1
    pipeline: the compiled arithmetic over micro-batches that
    :meth:`~StreamingExecutor.step` copies host→device on a CUDA stream
    of its own, micro-batch i+1 while micro-batch i computes;
  * :class:`FusedAccumExecutor` (``fused``) — accumulation through kernel
    K1 over the tree's leaves, the 1/N_Sμ scale fused into the accumulate
    (paper Fig. 2 step ❹ + eq. 14);
  * :class:`FlatFusedExecutor` (``flat``) — params, optimizer state and
    the fp32 accumulator live as one flat buffer per dtype bucket
    (``engine/flat.py``); step ❹ is one K1 launch per bucket and step ❺
    one in-place K2/K3/K4 launch per bucket.

``step_split(params, opt_state, micro_batches)`` takes a pre-split batch
of device tensors ``(N_Sμ, N_μ, ...)`` and returns
``(params, opt_state, metrics)`` with device-scalar metrics: nothing in a
step reads a value back to the host.

``raw_accumulate(params, micro_batches)`` is the per-rank half of the
data-parallel step (``engine.ShardedExecutor``): the executor's own
accumulation strategy over a (local) split with no normalization at all
— each micro loss the raw sum of its valid per-sample losses ("exact"
with the denominator 1), K1 with scale 1 — returning the gradient sums,
the loss sum and the metric sums; the caller divides by the global valid
count after the one all-reduce.

``guard=True`` (the supervisor's, the reference's ``guard``) puts step ❺
behind an on-device finite check of the accumulated gradient: a
non-finite accumulator skips the update — params and optimizer state,
the step counter included, pass through unchanged — and the metrics
carry ``nonfinite``, a device scalar. ``flat`` hands the flag to K2–K4,
which write nothing when it is 0; the tree executors select leaf by leaf
on the device (``exec_core.guarded_update``). A guarded step reads
nothing back either. Guard off runs exactly the unguarded step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple, Type

import numpy as np
import torch

from .. import tree
from . import exec_core, faults, flat
from . import plan as plan_lib
from .plan import MBSConfig, MBSPlan
from .steptrace import Traceable


def _micro(micro_batches, i: int):
    return {k: v[i] for k, v in micro_batches.items()}


def _as_plan(plan) -> MBSPlan:
    if isinstance(plan, MBSConfig):
        return MBSPlan.from_config(plan)
    if isinstance(plan, MBSPlan):
        return plan
    raise TypeError(f"expected MBSPlan or MBSConfig, got {type(plan)!r}")


class _ExecutorBase(Traceable):
    """Common machinery: the eager micro-batch loop and the update."""
    name = "base"
    fused = False  # raw micro losses, normalization fused into K1

    def __init__(self, loss_fn, optimizer, plan, *, guard: bool = False,
                 denominators=exec_core.denominators):
        """``denominators`` gives (N_Sμ, N_B_valid) of a split batch (the
        GSPMD step counts the valid samples of the global batch)."""
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.plan = _as_plan(plan)
        self.guard = guard
        self.denominators = denominators

    def _accumulated(self, params, micro_batches, raw: bool = False):
        """(grads tree in accum_dtype, loss, metric_sum) over the split."""
        n_s, total_valid = self.denominators(micro_batches)
        return self._accumulate_over(
            params, (_micro(micro_batches, i) for i in range(n_s)), n_s,
            total_valid, raw=raw)

    def raw_accumulate(self, params, micro_batches):
        """Un-normalized sums over a (local) split batch — (grad sums,
        loss sum, metric sums) — by this executor's strategy (see the
        module doc)."""
        return self._accumulated(params, micro_batches, raw=True)

    def _accumulate_over(self, params, micros: Iterable, n_s: int,
                         total_valid, raw: bool = False):
        """Steps ❷–❹ over the ``n_s`` micro-batches ``micros`` yields;
        ``raw=True`` defers all normalization to the caller."""
        plan = self.plan
        norm = "exact" if raw else plan.normalization
        if raw:
            scale = 1.0 if self.fused else None  # plain unscaled sums
        else:
            scale = (exec_core.deferred_scale(plan.normalization, n_s,
                                              total_valid)
                     if self.fused else None)
        acc = exec_core.init_accum(params, plan.accum_dtype)
        loss_sum, metric_sum = None, None
        for mb in micros:
            lfn = exec_core.micro_loss_fn(
                self.loss_fn, norm, n_s, total_valid, mb,
                defer_scale=self.fused or raw)
            loss, metrics, grads = exec_core.value_and_grad(lfn, params)
            acc = exec_core.accumulate(acc, grads, scale=scale,
                                       fused=self.fused)
            del grads
            loss_sum, metric_sum = _add_metrics(loss_sum, metric_sum, loss,
                                                metrics, 1 if raw else n_s)
        if self.fused and not raw:
            loss_sum = loss_sum * scale
        return acc, loss_sum, metric_sum

    def gradients(self, params, micro_batches):
        """The accumulated normalized gradients (eq. 15–17) and the loss."""
        grads, loss, _ = self._accumulated(params, micro_batches)
        return grads, loss

    def step_split(self, params, opt_state, micro_batches):
        faults.on_dispatch(self.plan)
        return self._update(params, opt_state,
                            *self._accumulated(params, micro_batches))

    def _update(self, params, opt_state, grads, loss, metric_sum):
        ok = None
        if self.guard:
            new_params, new_opt, ok = exec_core.guarded_update(
                self.optimizer, grads, opt_state, params)
        else:
            new_params, new_opt = exec_core.apply_update(
                self.optimizer, grads, opt_state, params)
        return new_params, new_opt, exec_core.finalize_metrics(
            metric_sum, loss, grads, ok)


def _add_metrics(loss_sum, metric_sum, loss, metrics, n_s):
    if loss_sum is None:
        return loss, {k: m / n_s for k, m in metrics.items()}
    return loss_sum + loss, {k: metric_sum[k] + m / n_s
                             for k, m in metrics.items()}


class CompiledScanExecutor(_ExecutorBase):
    """Eager loop + plain fp32 add (the JAX package's ``compiled``)."""
    name = "compiled"
    fused = False


class StreamingExecutor(_ExecutorBase):
    """The paper's Fig. 1 pipeline: the ``compiled`` arithmetic (a plain
    add into the accumulator, as the reference's streaming step ❹ is jnp)
    over micro-batches that stream to the device.

    :meth:`step` takes a host mini-batch, splits it on the host into
    page-locked tensors and double-buffers at micro-batch granularity:
    micro-batch i+1's copy is issued on a dedicated ``torch.cuda.Stream``
    before micro-batch i computes on the current stream, and the compute
    stream waits on each copy's event just before its first use.
    :meth:`step_split` takes a split batch already on the device (the
    ``Pipeline``'s) and slices it there. ``device`` is where :meth:`step`
    stages (default: the params' device). Accumulator, loss and metrics
    stay on the device for the whole loop."""
    name = "streaming"
    fused = False

    def __init__(self, loss_fn, optimizer, plan, device=None, *,
                 guard: bool = False):
        super().__init__(loss_fn, optimizer, plan, guard=guard)
        self.device = None if device is None else torch.device(device)
        self._copy_stream = None

    def _stream(self, device):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        return self._copy_stream

    def step(self, params, opt_state, minibatch: Dict[str, np.ndarray]
             ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One mini-batch update via sequential micro-batch streaming."""
        return self._update(params, opt_state, *self.stream_accumulate(
            params, self.plan.split(minibatch)))

    def stream_accumulate(self, params, split: Dict[str, np.ndarray], *,
                          raw: bool = False):
        """Steps ❷–❹ over a split host batch, each micro-batch copied to
        the device on the copy stream while the one before it computes:
        (grads, loss, metric_sum); ``raw`` as in :meth:`raw_accumulate`
        (the data-parallel step streams its local block this way)."""
        device = (self.device if self.device is not None
                  else tree.leaves(params)[0].device)
        cuda = device.type == "cuda"
        host = plan_lib.host_tensors(split, pin=cuda)
        stream = self._stream(device) if cuda else None
        n_s = host["sample_weight"].shape[0]
        # N_B_valid from the whole mask on the device, the reduction
        # step_split makes, so the two steps agree bit for bit
        mask = plan_lib.wait_staged(*plan_lib.stage(
            {"sample_weight": host["sample_weight"]}, device, stream))
        _, total_valid = exec_core.denominators(mask)

        def put(i):
            return plan_lib.stage(_micro(host, i), device, stream)

        def micros():  # double buffer: copy i+1 while i computes
            nxt = put(0)
            for i in range(n_s):
                cur, nxt = nxt, (put(i + 1) if i + 1 < n_s else None)
                yield plan_lib.wait_staged(*cur)

        return self._accumulate_over(params, micros(), n_s, total_valid,
                                     raw=raw)


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
    updates_in_place = True

    def prepare(self, params, opt_state, device=None) -> Tuple[Any, Any]:
        """Flat view trees of ``params`` and ``opt_state`` (one copy unless
        they already are); callers drop the originals to free them. With
        ``device``, new buffers there, each leaf copied into its slot (a
        host state goes to the card without a staging copy of the tree)."""
        spec = flat.FlatSpec.for_tree(params)

        def as_flat(t):
            if device is None:
                return spec.as_flat(t)[1]
            return spec.place(t, device)[1]

        def state_leaf(k, v):
            if v is None or (k == "step" and device is None):
                return v
            return v.to(device, copy=True) if k == "step" else as_flat(v)

        return as_flat(params), {k: state_leaf(k, v)
                                 for k, v in opt_state.items()}

    def _accumulated_flat(self, params, micro_batches, raw: bool = False,
                          tail=None):
        """(spec, accumulator buckets, loss, metric_sum, store). ``raw``
        defers all normalization (scale 1, raw sums). ``tail(metrics)``
        (a count of slots) packs the buckets into one store of
        ``accum_dtype`` with that many more elements after them
        (``FlatSpec.packed_zeros``), made once the first micro-batch has
        shown its metrics; ``store`` is None without it."""
        plan = self.plan
        spec = flat.FlatSpec.for_tree(params)
        n_s, total_valid = self.denominators(micro_batches)
        norm = "exact" if raw else plan.normalization
        scale = (1.0 if raw else exec_core.deferred_scale(
            plan.normalization, n_s, total_valid))
        device = tree.leaves(params)[0].device
        store = None
        acc = None if tail else spec.zeros(plan.accum_dtype, device)
        loss_sum, metric_sum = None, None
        for i in range(n_s):
            lfn = exec_core.micro_loss_fn(
                self.loss_fn, norm, n_s, total_valid,
                _micro(micro_batches, i), defer_scale=True)
            loss, metrics, grads = exec_core.value_and_grad(lfn, params)
            if acc is None:
                store, acc = spec.packed_zeros(plan.accum_dtype, device,
                                               tail(metrics))
            exec_core.accumulate_flat(acc, spec, grads, scale=scale)
            del grads
            loss_sum, metric_sum = _add_metrics(loss_sum, metric_sum, loss,
                                                metrics, 1 if raw else n_s)
        loss = loss_sum if raw else loss_sum * scale
        return spec, acc, loss, metric_sum, store

    def raw_accumulate(self, params, micro_batches, tail=None):
        """Un-normalized flat-bucket sums over a (local) split batch:
        (spec, accumulator buckets, loss sum, metric sums, store). The
        buckets stay flat (``spec.unflatten(acc, cast=False)`` is the
        tree); with ``tail`` they are views of one store that the
        data-parallel step reduces in place."""
        return self._accumulated_flat(params, micro_batches, raw=True,
                                      tail=tail)

    def gradients(self, params, micro_batches):
        spec, acc, loss, _, _ = self._accumulated_flat(params,
                                                       micro_batches)
        return spec.unflatten(acc, cast=False), loss

    def step_split(self, params, opt_state, micro_batches):
        faults.on_dispatch(self.plan)
        params, opt_state = self.prepare(params, opt_state)
        spec, acc, loss, metric_sum, _ = self._accumulated_flat(
            params, micro_batches)
        ok = None
        if self.guard:
            new_params, new_opt, ok = exec_core.guarded_update_flat(
                self.optimizer, spec, acc, opt_state, params)
        else:
            new_params, new_opt = exec_core.apply_update_flat(
                self.optimizer, spec, acc, opt_state, params)
        return new_params, new_opt, exec_core.finalize_metrics(
            metric_sum, loss, acc, ok, spec=spec)


EXECUTORS: Dict[str, Type] = {
    CompiledScanExecutor.name: CompiledScanExecutor,
    StreamingExecutor.name: StreamingExecutor,
    FusedAccumExecutor.name: FusedAccumExecutor,
    FlatFusedExecutor.name: FlatFusedExecutor,
}


def get_executor(name: str) -> Type:
    try:
        return EXECUTORS[name]
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; available: "
                         f"{sorted(EXECUTORS)}") from None


def accumulate_gradients(loss_fn, params, micro_batches, plan, *,
                         fused: bool = False):
    """Accumulated, normalized MBS gradients and the loss — the quantity
    eq. (15)–(17) prove equal to the mini-batch gradient — by the
    ``compiled`` arithmetic, or with ``fused`` through K1."""
    ex = (FusedAccumExecutor if fused else CompiledScanExecutor)(
        loss_fn, None, plan)
    return ex.gradients(params, micro_batches)


def make_baseline_train_step(loss_fn, optimizer) -> Callable:
    """The no-MBS reference: one forward/backward over the whole
    mini-batch (the paper's "w/o MBS" columns — and what fails beyond the
    memory limit)."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = exec_core.value_and_grad(
            lambda p: loss_fn(p, batch), params)
        new_params, new_opt_state = exec_core.apply_update(
            optimizer, grads, opt_state, params)
        return new_params, new_opt_state, exec_core.finalize_metrics(
            metrics, loss, grads)
    return train_step
