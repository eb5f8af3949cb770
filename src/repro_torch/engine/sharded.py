"""Data-parallel MBS execution with the gradient sync deferred to once per
mini-batch — the JAX package's ``engine/sharded.py`` over
``torch.distributed``.

The paper fits a large global batch into one device's memory by splitting
it into micro-batches; data parallelism multiplies that across workers.
The cost to control is the gradient all-reduce: naive data-parallel
accumulation syncs every micro-batch (N_Sμ collectives a step), while
Algorithm 1 only needs the sum of all micro gradients — so the sync can
happen once per MINI-batch.

The port is SPMD: every rank runs this executor in its own process over a
``launch.mesh.Mesh`` (the world on the data axis):

  * rank r takes the contiguous block ``[r·local, (r+1)·local)`` of the
    sample dim of every batch leaf (:func:`local_block`; JAX's shard of
    device r), so it accumulates ``local_micro = micro / data_parallel``
    samples of every micro-batch;
  * the inner executor's ``raw_accumulate`` produces UN-normalized local
    sums (gradients, loss, metrics — no 1/N anywhere) by its own
    strategy: a plain add (``compiled``), K1 over the leaves (``fused``),
    K1 into flat buckets (``flat``), or micro-batches streamed to the card
    on a copy stream (``streaming``'s :meth:`~ShardedExecutor.step`);
  * all local sums — gradients, loss, metrics and the local valid-sample
    count — are summed by ONE ``all_reduce`` of one fp32 buffer
    (:func:`psum_flat`): exactly one collective per mini-batch, whatever
    N_Sμ. ``flat`` accumulates into that buffer itself (the buckets are
    views into one fp32 store with the scalars' slots after them), so its
    reduction is in place and allocates nothing;
  * the gradients are divided by the GLOBAL valid count after the
    reduction (exact semantics — the same as "paper" mode for the uniform
    splits paper mode is valid for), then the optimizer update runs on
    every rank on identical inputs (K2–K4 for ``flat``).

``defer_sync=False`` is the comparison baseline (``inner="compiled"``
only): one all-reduce per micro-batch, each carrying that micro-batch's
gradient with its loss, metrics and valid count — N_Sμ calls a step.

Every ``all_reduce`` of the package is issued by :func:`psum_flat`, which
counts it (:func:`collective_stats`); :func:`time_collectives` makes it
synchronize the device around each call, so the seconds are the
collective's own.

Scope: pure data parallelism — params and optimizer state replicated on
every rank (``plan_mbs(mesh=..., fsdp_params=False)`` budgets so). MoE
router statistics are per local micro-batch (standard data-parallel MoE),
as in the reference, so sharded MoE losses are not bitwise those of one
device.

A fault on one rank is agreed across the ranks, as the reference's one
controller sees it once: a rank whose dispatch hook or local forward and
backward raises the allocator's out-of-memory error still joins the
step's one all-reduce, with its gradient, loss, metrics and valid count
zeroed, and the reduced buffer carries one fault slot per rank (the tail
of ``flat``'s fp32 store, one more leaf of the tree path's and of each
per-micro baseline reduction). When a slot is above 0 after the sum,
every rank raises the same ``torch.OutOfMemoryError``
(``faults.agreed_oom``, naming the faulting ranks) before the update, so
every rank's supervisor degrades alike — no rank waits out the process
group's timeout, and the census stays one all-reduce a step. Reading the
slots back is one host sync a step. A rank that faults before its loss
has ever returned learns the metrics' layout from a fake-tensor trace of
the loss (``exec_core.abstract_call``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import tree
from ..launch import mesh as mesh_lib
from . import exec_core, faults, flat as flat_lib
from .executors import EXECUTORS, _as_plan, _micro, get_executor
from .plan import MBSPlan
from .steptrace import Traceable

_STATS: Dict[str, Any] = {}
_SYNC_TIMING = [False]


def reset_collective_stats() -> None:
    _STATS.clear()
    _STATS.update(calls=0, seconds=0.0, bytes=0, by_axis={}, all_gather=0,
                  reduce_scatter=0, gather_seconds=0.0, p2p={})


reset_collective_stats()


def collective_stats() -> Dict[str, Any]:
    """``calls``: all-reduces issued since the last reset; ``bytes``: what
    they reduced; ``seconds``: their host time (the collective's own on
    the CPU, or on CUDA under :func:`time_collectives`); ``by_axis``: the
    all-reduces by the mesh axes they ran over (``"data"``, ``"model"``,
    ``"data+model"``). The pipelined executor adds ``all_gather`` and
    ``reduce_scatter`` (FSDP's calls, their seconds in
    ``gather_seconds``) and ``p2p``: its point-to-point calls by
    direction and kind (``fwd_send``, ``fwd_recv``, ``bwd_send``,
    ``bwd_recv``)."""
    out = dict(_STATS)
    out["by_axis"] = dict(_STATS["by_axis"])
    out["p2p"] = dict(_STATS["p2p"])
    return out


def count_collective(kind: str, n: int = 1, seconds: float = 0.0) -> None:
    """Count ``n`` calls of a collective other than the all-reduce
    (``all_gather``, ``reduce_scatter``, or a ``p2p`` key)."""
    if kind in ("all_gather", "reduce_scatter"):
        _STATS[kind] += n
        _STATS["gather_seconds"] += seconds
    else:
        _STATS["p2p"][kind] = _STATS["p2p"].get(kind, 0) + n


def timed_call(x: torch.Tensor, fn) -> float:
    """The host seconds of the collective ``fn()`` on ``x``'s device, the
    device synchronized before and after it under
    :func:`time_collectives`."""
    sync = _SYNC_TIMING[0] and x.is_cuda
    # the syncs below run only under time_collectives (opt-in timing)
    if sync:
        torch.cuda.synchronize(x.device)  # repro: noqa(LINT001)
    t0 = time.perf_counter()
    fn()
    if sync:
        torch.cuda.synchronize(x.device)  # repro: noqa(LINT001)
    return time.perf_counter() - t0


def time_collectives(on: bool = True) -> None:
    """Synchronize the device before and after each all-reduce, so that
    its seconds exclude the compute queued before it (one host sync per
    call; off by default)."""
    _SYNC_TIMING[0] = bool(on)


def psum_flat(t, mesh, axis: str = "data"):
    """One collective for a whole tree: every leaf summed across the ranks
    of ``mesh`` by ONE ``all_reduce`` of one fp32 buffer. A tree that is a
    single contiguous 1-D fp32 tensor is reduced in place and returned;
    otherwise the leaves are concatenated (cast to fp32) and the summed
    leaves come back as views of the reduced buffer, in their dtypes.
    ``axis`` names the mesh axes ``mesh.group`` spans, for the census."""
    import torch.distributed as dist
    leaves, treedef = tree.flatten(t)
    if not leaves:
        return t
    single = (len(leaves) == 1 and leaves[0].dtype == torch.float32
              and leaves[0].dim() == 1 and leaves[0].is_contiguous())
    buf = leaves[0] if single else torch.cat(
        [x.reshape(-1).to(torch.float32) for x in leaves])
    _STATS["seconds"] += timed_call(buf, lambda: dist.all_reduce(
        buf, op=dist.ReduceOp.SUM, group=mesh.group))
    _STATS["calls"] += 1
    _STATS["bytes"] += buf.numel() * 4
    _STATS["by_axis"][axis] = _STATS["by_axis"].get(axis, 0) + 1
    if single:
        return t
    out, off = [], 0
    for x in leaves:
        n = x.numel()
        out.append(buf[off:off + n].view(x.shape).to(x.dtype))
        off += n
    return tree.unflatten(treedef, out)


def batch_partition_specs(batch, micro: int, axes: Tuple[str, ...],
                          sample_dim_from: int = 1):
    """Per-leaf spec sharding the SAMPLE dim — the first dim (at index >=
    ``sample_dim_from``; dim 0 is the micro-batch axis of a split batch)
    whose size equals the global micro-batch size — over the batch axes.
    Every leaf must have such a dim: a replicated leaf would be counted
    once by every rank's local accumulation. The VLM's split
    ``mrope_positions`` (N_Smu, 3, N_mu, S) is refused by name: at a
    micro-batch of 3 the first matching dim would be the streams'."""
    from ..launch.sharding import P
    entry = axes if len(axes) > 1 else axes[0]
    if "mrope_positions" in batch:
        raise ValueError(
            "ShardedExecutor does not shard mrope_positions: its (N_Smu, 3, "
            "N_mu, S) layout puts the streams before the sample dim; a "
            "data-parallel VLM trains text-only, as the launcher feeds it")

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        for d in range(sample_dim_from, len(shape)):
            if shape[d] == micro:
                spec = [None] * len(shape)
                spec[d] = entry
                return P(*spec)
        raise ValueError(
            f"cannot shard batch leaf of shape {shape}: no dim (>= "
            f"{sample_dim_from}) equals the global micro-batch size {micro}"
            " — ShardedExecutor requires every leaf to carry the sample dim")

    return {k: spec_for(v) for k, v in batch.items()}


def local_block(batch, micro: int, mesh, sample_dim_from: int = 1):
    """This rank's block of a global batch (numpy arrays or tensors):
    ``[r·local, (r+1)·local)`` of every leaf's sample dim (see
    :func:`batch_partition_specs`), ``local = micro / data_parallel`` —
    the shard JAX gives device r. Numpy blocks come back contiguous."""
    dp = mesh_lib.data_parallel_size(mesh)
    local = micro // dp
    lo = mesh.rank * local
    specs = batch_partition_specs(batch, micro, mesh_lib.batch_axes(mesh),
                                  sample_dim_from)
    out = {}
    for k, x in batch.items():
        d = next(i for i, e in enumerate(specs[k]) if e is not None)
        block = x[(slice(None),) * d + (slice(lo, lo + local),)]
        out[k] = (np.ascontiguousarray(block) if isinstance(block, np.ndarray)
                  else block.contiguous())
    return out


def _local_valid_count(mb, sample_dims: int = 2) -> torch.Tensor:
    """This rank's valid-sample weight (padding carries 0), summed into the
    flat all-reduce so the normalization denominator is the GLOBAL count.
    ``sample_dims``: 2 for a split ``(N_Sμ, N_μ, ...)`` batch, 1 for one
    micro-batch."""
    w = mb.get("sample_weight")
    if w is not None:
        return torch.sum(w).to(torch.float32)
    first = next(iter(mb.values()))
    n = 1.0
    for d in first.shape[:sample_dims]:
        n *= d
    return torch.full((), n, dtype=torch.float32, device=first.device)


def _oom_of(fn, *args):
    """``(fn(*args), False)``, or ``(None, True)`` when it raised the
    allocator's out-of-memory error (``faults.is_oom``); anything else
    propagates. The failed call's tensors, which its traceback holds, are
    dropped before this returns."""
    try:
        return fn(*args), False
    except Exception as exc:  # noqa: BLE001 (re-raised unless an OOM)
        if not faults.is_oom(exc):
            raise
    return None, True


def fault_slots(fault: bool, rank: int, world: int, device) -> torch.Tensor:
    """One fp32 slot per rank of a reduction's group: 1 at ``rank`` when
    this rank's step ran out of memory, else 0."""
    slots = torch.zeros((world,), dtype=torch.float32, device=device)
    if fault:
        slots[rank] = 1.0
    return slots


def raise_agreed(slots: torch.Tensor, by: str = "the step's all-reduce"
                 ) -> None:
    """After the reduction, on every rank alike: the agreed OOM
    (``faults.agreed_oom``, agreed ``by`` that reduction) when any rank's
    slot is set. One readback a step: every rank must raise before the
    update, so the agreement is read here and cannot wait for the step's
    metrics."""
    # the fault agreement's one read of the step, waived:
    hit = slots.detach().cpu() > 0  # repro: noqa(LINT001, JX003)
    bad = torch.nonzero(hit).flatten().tolist()  # repro: noqa(LINT001, JX003)
    if bad:
        raise faults.agreed_oom(bad, slots.numel(), by=by)


class ShardedExecutor(Traceable):
    """Data-parallel wrapper around an inner MBS executor (see the module
    doc). ``inner`` names the local accumulation strategy ("compiled" |
    "streaming" | "fused" | "flat").

    :meth:`step_split` and :meth:`gradients` take this rank's block of a
    split batch (what ``Pipeline(mesh=...)`` stages, or
    :meth:`stage` of a global split); :meth:`step` takes the global host
    mini-batch, as every rank draws it, and keeps its own block.

    ``guard=True`` finite-checks the globally reduced gradient — after
    the one all-reduce, so every rank sees the same flag and takes the
    same branch with no extra collective — and surfaces a ``nonfinite``
    metric for the supervisor."""
    name = "sharded"

    def __init__(self, loss_fn, optimizer, plan, *, mesh,
                 inner: str = "compiled", defer_sync: bool = True,
                 guard: bool = False):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.plan: MBSPlan = _as_plan(plan)
        self.mesh = mesh
        self.axes = mesh_lib.batch_axes(mesh)
        self.dp = mesh_lib.data_parallel_size(mesh)
        self.defer_sync = defer_sync
        self.guard = guard
        if not self.axes or self.dp < 2:
            raise ValueError(
                "ShardedExecutor needs a mesh with a (pod, data) extent of "
                f">= 2 (got {self.dp}); on one device use the inner "
                "executor directly")
        if self.plan.micro_batch_size % self.dp:
            raise ValueError(
                f"micro-batch {self.plan.micro_batch_size} does not divide "
                f"over {self.dp} data-parallel workers — build the plan "
                "with plan_mbs(mesh=...) so sizes stay divisible")
        if self.plan.normalization == "paper" and self.plan.pad:
            raise ValueError(
                'a ragged "paper" plan cannot be sharded exactly (the tail '
                "pad lands on one worker's shard) — use "
                'normalization="exact" (plan_mbs auto-upgrades ragged plans)')
        if not isinstance(inner, str):
            inner = getattr(inner, "name", inner)
        if inner not in EXECUTORS:
            raise ValueError(
                f"unknown inner executor {inner!r}; available: "
                f"{sorted(EXECUTORS)}")
        if not defer_sync and inner != "compiled":
            raise ValueError(
                "defer_sync=False is the per-micro-sync comparison baseline "
                "and only supports inner='compiled'")
        self.inner_name = inner
        self.inner = get_executor(inner)(loss_fn, optimizer, self.plan)
        self.updates_in_place = self.inner.updates_in_place
        self.device = mesh.device
        self._metrics = None  # the loss's metrics as meta tensors, once known

    # -- staging ------------------------------------------------------------

    def shard(self, split):
        """This rank's block of a global split batch (host or device)."""
        return local_block(split, self.plan.micro_batch_size, self.mesh)

    def stage(self, split):
        """This rank's block of a global split host batch, on its device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.shard(split).items()}

    def prepare(self, params, opt_state, device=None):
        """The state in the layout the inner executor trains (``flat``'s
        buffers), on ``device`` when given — as the single-device
        executors' ``prepare`` does."""
        prepare = getattr(self.inner, "prepare", None)
        if prepare is not None:
            return prepare(params, opt_state, device=device)
        if device is None:
            return params, opt_state
        return tree.map(lambda t: t.to(device, copy=True),
                        (params, opt_state))

    # -- the local half and the one sync -------------------------------------

    def _packed(self) -> bool:
        return (self.inner_name == "flat"
                and self.plan.accum_dtype == torch.float32)

    def _slots(self, fault: bool) -> torch.Tensor:
        return fault_slots(fault, self.mesh.rank, self.dp, self.device)

    def _metric_zeros(self, params, local):
        """Zero metrics in the loss's layout: learnt from a step that ran,
        else from a fake-tensor trace of the loss on one micro-batch."""
        if self._metrics is None:
            mb = {k: (torch.from_numpy(np.ascontiguousarray(v[0]))
                      if isinstance(v, np.ndarray) else v[0])
                  for k, v in local.items()}
            self._metrics = exec_core.abstract_call(
                lambda p, b: self.loss_fn(p, b)[1], params, mb)
        return tree.map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                              device=self.device),
                        self._metrics)

    def _learn_metrics(self, msum) -> None:
        if self._metrics is None:
            self._metrics = tree.map(
                lambda m: torch.empty(m.shape, dtype=m.dtype, device="meta"),
                msum)

    def _zero_sums(self, params, local):
        """A faulted rank's contribution: zero gradient sums (flat buckets
        for ``flat``, a tree otherwise), loss and metrics."""
        if self.inner_name == "flat":
            grads = flat_lib.FlatSpec.for_tree(params).zeros(
                self.plan.accum_dtype, self.device)
        else:
            grads = exec_core.init_accum(params, self.plan.accum_dtype)
        return (grads, torch.zeros((), device=self.device),
                self._metric_zeros(params, local))

    def _flat_synced(self, params, local, fault: bool = False):
        """``flat``: K1 into bucket views of one fp32 store whose tail holds
        the loss, metric, valid-count and fault slots; one in-place
        all-reduce of the store. Returns (spec, summed buckets, loss,
        metrics, valid)."""
        layout = {}

        def tail(metrics) -> int:
            layout["metrics"] = tree.flatten(metrics)
            return 2 + sum(m.numel() for m in layout["metrics"][0]) + self.dp

        out = None
        if not fault:
            out, fault = _oom_of(self.inner.raw_accumulate, params, local,
                                 tail)
        if fault:
            spec = flat_lib.FlatSpec.for_tree(params)
            msum = self._metric_zeros(params, local)
            store, acc = spec.packed_zeros(self.plan.accum_dtype,
                                           self.device, tail(msum))
            loss = valid = torch.zeros((), device=self.device)
        else:
            spec, acc, loss, msum, store = out
            self._learn_metrics(msum)
            valid = _local_valid_count(local)
        del out
        n = sum(spec.bucket_sizes)
        parts = [loss.reshape(1)] + [m.reshape(-1).to(torch.float32)
                                     for m in tree.leaves(msum)]
        parts += [valid.reshape(1), self._slots(fault)]
        store[n:] = torch.cat(parts)
        psum_flat(store, self.mesh)  # the ONE all-reduce, in place
        tail_vals = store[n:]
        raise_agreed(tail_vals[-self.dp:])
        loss = tail_vals[0]
        metric_leaves, off = [], 1
        for m in layout["metrics"][0]:
            k = m.numel()
            metric_leaves.append(tail_vals[off:off + k].view(m.shape)
                                 .to(m.dtype))
            off += k
        return (spec, acc, loss,
                tree.unflatten(layout["metrics"][1], metric_leaves),
                tail_vals[off])

    def _synced(self, params, local, fault: bool = False):
        """(grads — flat buckets for ``flat``, a tree otherwise — loss,
        metric_sum, valid), all summed across the ranks. ``fault``: this
        rank has already failed (its dispatch hook ran out of memory)."""
        if self._packed():
            _, acc, loss, msum, valid = self._flat_synced(params, local,
                                                          fault)
            return acc, loss, msum, valid
        if not self.defer_sync:
            return self._per_micro_synced(params, local, fault)
        if self.inner_name == "flat":
            def accumulate():
                _, acc, loss, msum, _ = self.inner.raw_accumulate(params,
                                                                  local)
                return tuple(acc), loss, msum
        else:
            def accumulate():
                return self.inner.raw_accumulate(params, local)
        return self._reduced(params, local, fault, accumulate,
                             lambda: _local_valid_count(local))

    def _reduced(self, params, local, fault: bool, accumulate, valid):
        """(grads, loss, metric_sum, valid) summed across the ranks by the
        ONE all-reduce of the mini-batch, the fault slots with them:
        ``accumulate()`` gives this rank's (grads, loss, metric sums) and
        ``valid()`` its valid count; a rank that faulted, before or in
        ``accumulate``, sends zeros."""
        out = None
        if not fault:
            out, fault = _oom_of(accumulate)
        if fault:
            grads, loss, msum = self._zero_sums(params, local)
            count = torch.zeros((), device=self.device)
        else:
            grads, loss, msum = out
            self._learn_metrics(msum)
            count = valid()
        del out
        *synced, slots = psum_flat(
            (grads, loss, msum, count, self._slots(fault)), self.mesh)
        raise_agreed(slots)
        return synced

    def _micro_grads(self, params, mb, n_s: int):
        lfn = exec_core.micro_loss_fn(self.loss_fn, "exact", n_s, 1.0, mb,
                                      defer_scale=True)
        return exec_core.value_and_grad(lfn, params)

    def _per_micro_synced(self, params, local, fault: bool = False):
        """The baseline deferral removes: one all-reduce per micro-batch,
        each carrying that micro-batch's gradient, loss, metrics, valid
        count and fault slots (N_Sμ collectives a step; a fault ends the
        step on every rank after the reduction that carries it)."""
        n_s = next(iter(local.values())).shape[0]
        acc = exec_core.init_accum(params, self.plan.accum_dtype)
        loss_sum = metric_sum = valid = None
        for i in range(n_s):
            mb = _micro(local, i)
            out = None
            if not fault:
                out, fault = _oom_of(self._micro_grads, params, mb, n_s)
            if fault:
                loss = v = torch.zeros((), device=self.device)
                metrics = self._metric_zeros(params, local)
                grads = tree.map(torch.zeros_like, params)
            else:
                loss, metrics, grads = out
                self._learn_metrics(metrics)
                v = _local_valid_count(mb, 1)
            del out
            grads, loss, metrics, v, slots = psum_flat(
                (grads, loss, metrics, v, self._slots(fault)), self.mesh)
            raise_agreed(slots)
            acc = exec_core.accumulate(acc, grads)
            del grads
            if loss_sum is None:
                loss_sum, metric_sum, valid = loss, metrics, v
            else:
                loss_sum = loss_sum + loss
                metric_sum = {k: metric_sum[k] + m for k, m in metrics.items()}
                valid = valid + v
        return acc, loss_sum, metric_sum, valid

    def _finalize(self, params, opt_state, grads, loss, metric_sum, valid,
                  n_s: int):
        """After the sync: normalize by the global valid count, update
        (identical on every rank), package the metrics."""
        scale = 1.0 / valid
        if self._packed():
            for g in grads:  # views of the reduced store: scale in place
                g.mul_(scale)
        else:
            grads = tree.map(lambda g: (g * scale).to(g.dtype), grads)
        loss = loss * scale
        # metrics were summed over every (rank, micro-batch) pair
        metrics = {k: m / (self.dp * n_s) for k, m in metric_sum.items()}
        ok = None
        if self.inner_name == "flat":
            spec = flat_lib.FlatSpec.for_tree(params)
            bufs = tuple(grads)
            if self.guard:
                new_params, new_opt, ok = exec_core.guarded_update_flat(
                    self.optimizer, spec, bufs, opt_state, params)
            else:
                new_params, new_opt = exec_core.apply_update_flat(
                    self.optimizer, spec, bufs, opt_state, params)
        elif self.guard:
            new_params, new_opt, ok = exec_core.guarded_update(
                self.optimizer, grads, opt_state, params)
        else:
            new_params, new_opt = exec_core.apply_update(
                self.optimizer, grads, opt_state, params)
        return new_params, new_opt, exec_core.finalize_metrics(
            metrics, loss, grads, ok)

    # -- the executor interface ---------------------------------------------

    def step_split(self, params, opt_state, micro_batches
                   ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One mini-batch over this rank's block of a split batch on the
        device."""
        _, fault = _oom_of(faults.on_dispatch, self.plan, self.mesh.rank)
        if self.inner_name == "flat":
            params, opt_state = self.prepare(params, opt_state)
        n_s = next(iter(micro_batches.values())).shape[0]
        return self._finalize(params, opt_state,
                              *self._synced(params, micro_batches, fault),
                              n_s)

    def step(self, params, opt_state, minibatch
             ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One mini-batch from the global host mini-batch: split, keep this
        rank's block and run it — ``streaming`` copies its micro-batches
        to the card on its copy stream, one while the one before
        computes; the others stage the block and run :meth:`step_split`."""
        if self.inner_name != "streaming":
            return self.step_split(params, opt_state,
                                   self.stage(self.plan.split(minibatch)))
        split = self.shard(self.plan.split(minibatch))
        _, fault = _oom_of(faults.on_dispatch, self.plan, self.mesh.rank)
        synced = self._reduced(
            params, split, fault,
            lambda: self.inner.stream_accumulate(params, split, raw=True),
            lambda: torch.sum(torch.from_numpy(split["sample_weight"])
                              .to(self.device)))
        return self._finalize(params, opt_state, *synced,
                              split["sample_weight"].shape[0])

    def gradients(self, params, micro_batches):
        """The accumulated NORMALIZED gradients and the mini-batch loss
        (eq. 15–17's quantity) under the deferred-sync schedule, from this
        rank's block; the same on every rank."""
        grads, loss, _, valid = self._synced(params, micro_batches)
        scale = 1.0 / valid
        if self.inner_name == "flat":
            spec = flat_lib.FlatSpec.for_tree(params)
            grads = spec.unflatten(tuple(grads), cast=False)
        return tree.map(lambda g: (g * scale).to(g.dtype), grads), \
            loss * scale
