"""The GSPMD step: MBS with the model itself split over a ``(data,
model)`` mesh — the JAX package's production path, where the train step
is jitted with the ``param_specs`` / ``batch_specs`` in and out
shardings and GSPMD propagates them.

The port is SPMD over ``torch.distributed.tensor``:

  * every rank holds its block of each parameter, of the fp32
    accumulator and of each optimizer moment, by the reference's
    ``launch.sharding.param_specs`` (tensor-parallel over ``model``,
    FSDP over ``data``, or over ``(pod, data)`` with ``fsdp_over_pod``;
    with ``fsdp=False``, the reference's ``--no-fsdp``, replicated over
    the batch axes): a moment is split as the parameter it belongs to,
    so the update stays elementwise on the local blocks;
  * the inner executor (``compiled``, ``fused`` or ``flat``; the
    reference's GSPMD path refuses ``streaming``, and so does this one)
    runs Algorithm 1 on those local blocks unchanged: K1 accumulates the
    local gradient blocks, K2/K4 update the local blocks in place, and
    ``flat``'s ``FlatSpec`` is built over them — all exact, as the three
    kernels are elementwise;
  * only the loss sees the mesh: each micro-batch the local blocks are
    wrapped as DTensors (``DTensor.from_local``, differentiable), the
    rank's block of the batch (its data coordinate's samples) likewise,
    and the model runs inside ``models.nn.use_mesh`` — its shard hints
    redistribute the activations, DTensor's propagation inserts the
    collectives GSPMD would, the vocab-sharded logits reduce in
    ``core.losses.sharded_nll``. The backward returns each gradient in
    its parameter's placements: reduce-scattered over ``data`` under
    FSDP, all-reduced over it for a leaf replicated there — once a
    micro-batch, inside the micro-batch loop, where the reference's
    compiled step all-reduces it too (its scan body);
  * what is global is made global: the exact normalization's valid count
    (summed over the batch axes) and the gradient norm of the clip and of
    the metrics (each rank counts the leaves it owns — a leaf replicated
    over an axis counts on that axis's first rank only — and the squares
    are summed over the world).

``guard=True`` (``--supervise``) puts step ❺ behind the finite check of
the whole accumulator, as the reference's guarded GSPMD step does
(``lax.cond`` on ``finite_all``). A rank sees only its blocks, so its
flag (1 when one of its blocks is not finite) rides the step's one
global reduction, the gradient norm's, as one more fp32 element (the
census gains no collective); a replicated leaf's blocks are equal on its
replicas, so the sum is 0 exactly when the reference's check passes. The update runs behind the flag
(K2's or K4's ``GUARD`` variant for ``flat``), so every rank skips alike
and keeps its state as it was. A one-rank out-of-memory error is agreed
too:

  * at dispatch (``faults.on_dispatch``, before any collective) the
    rank runs its share of the step's collectives as its peers do and
    sets its fault slot in the same reduction; every rank then raises
    the same ``faults.agreed_oom`` before the update;
  * inside the forward or backward, between two of the collectives
    DTensor issues, the rank posts the fault and drops its connections
    (``launch.mesh.post_fault``), its peers' collectives fail, they find
    the fault posted and drop theirs, every rank starts the world's
    groups anew (``launch.mesh.reform``, written into the mesh) and one
    reduction of the fault slots over them names the faulting ranks in
    the same ``agreed_oom`` on every rank. A failure with no fault
    posted propagates unchanged.

:class:`CollectiveCensus` counts the collectives that DTensor and the
loss issue, by kind and mesh axis. A world whose ranks share one card
over gloo moves them through the host (``launch.mesh.
host_staged_collectives``).
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import optim, tree
from ..launch import mesh as mesh_lib
from ..launch import sharding
from ..models import nn
from . import exec_core, faults
from .executors import _as_plan, get_executor
from .pipelined import _over_state
from .sharded import _oom_of, fault_slots, raise_agreed
from .steptrace import Traceable

#: the batch leaf whose sample dim is not its first (a VLM's streams)
_SAMPLE_DIM = {"mrope_positions": 1}


class GspmdExecutor(Traceable):
    """The MBS step on a GSPMD mesh (see the module doc). ``inner`` names
    the executor that runs the local blocks; ``fsdp_over_pod`` extends
    FSDP to ``(pod, data)``; ``fsdp=False`` replicates the params over
    the batch axes (tensor-parallel over ``model`` only).

    :meth:`prepare` cuts the reference-format ``(params, opt_state)``
    (whole tensors, the same on every rank) to this rank's blocks, in the
    inner executor's layout; :meth:`step_split` takes this rank's block of
    a split batch (:meth:`shard`); :meth:`gather_state` and
    :meth:`full_template` give a checkpoint the reference format."""
    name = "gspmd"

    def __init__(self, loss_fn, optimizer, plan, *, mesh, inner="flat",
                 fsdp: bool = True, fsdp_over_pod: bool = False,
                 guard: bool = False):
        if getattr(mesh, "mode", None) != "gspmd":
            raise ValueError(f"GspmdExecutor runs on a GSPMD mesh "
                             f"(launch.mesh.gspmd_mesh), got {mesh!r}")
        if inner == "streaming":
            raise ValueError(
                "the streaming executor stages host micro-batches for one "
                "device; the GSPMD step takes its batch already sharded — "
                "use --executor compiled, fused or flat on a GSPMD mesh")
        self.mesh = mesh
        self.guard = guard
        self.plan = _as_plan(plan)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.fsdp = fsdp
        self.fsdp_over_pod = fsdp_over_pod
        self.inner_name = inner
        self.inner = get_executor(inner)(self._local_loss, optimizer,
                                         self.plan,
                                         denominators=self._denominators)
        self.updates_in_place = getattr(self.inner, "updates_in_place",
                                        False)
        self._specs: Optional[List[Any]] = None
        self._owned: Optional[List[bool]] = None
        self._full = None

    # -- layout ---------------------------------------------------------------

    def param_specs(self, params):
        """The reference's spec tree of a params-shaped tree on this
        mesh."""
        return sharding.param_specs(params, self.mesh, fsdp=self.fsdp,
                                    fsdp_over_pod=self.fsdp_over_pod)

    def _learn(self, params) -> None:
        specs = sharding.spec_leaves(self.param_specs(params))
        coords = self.mesh.coords()
        self._specs = specs
        # a leaf counts towards a global norm on the ranks at coordinate 0
        # of every axis it is replicated over
        self._owned = [all(coords[ax] == 0 for ax in self.mesh
                           if ax not in sharding.spec_axes(spec))
                       for spec in specs]
        self._full = tree.map(lambda x: torch.empty(
            tuple(x.shape), dtype=x.dtype, device="meta"), params)

    def prepare(self, params, opt_state, device=None):
        """This rank's blocks of the reference-format ``(params,
        opt_state)`` (host or device), on ``device`` (default: the
        mesh's), in the inner executor's layout (``flat``'s buffers)."""
        device = self.mesh.device if device is None else torch.device(device)
        self._learn(params)
        specs = self.param_specs(params)

        def cut(t):
            return sharding.shard_tree(t, specs, self.mesh, device)

        local = (cut(params), _over_state(
            opt_state, params, cut, lambda x: x.to(device, copy=True)))
        prepare = getattr(self.inner, "prepare", None)
        return prepare(*local) if prepare is not None else local

    def full_template(self, params, opt_state):
        """The reference-format shape of this rank's ``(params,
        opt_state)`` as meta tensors (a checkpoint's template)."""
        full = self._full
        return full, _over_state(
            opt_state, params, lambda v: full,
            lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                  device="meta"))

    def local_state(self, params, opt_state):
        """Host copies of this rank's ``(params, opt_state)`` blocks and the
        reference-format template they are cut from (meta tensors): a
        supervisor's anchor when no checkpoint is written. No collective,
        and a rank's host holds its share only (the whole state of a
        16 × 16 mesh would not fit one host)."""
        host = tree.map(lambda t: t.detach().to("cpu", copy=True),
                        (params, opt_state))
        return host, self.full_template(params, opt_state)

    def place_local(self, params, opt_state, template, device=None):
        """Blocks from :meth:`local_state` on ``device`` (default: the
        mesh's), in the inner executor's layout; the layout is learnt from
        ``template``."""
        device = self.mesh.device if device is None else torch.device(device)
        self._learn(template[0])
        prepare = getattr(self.inner, "prepare", None)
        if prepare is not None:
            return prepare(params, opt_state, device=device)
        return tree.map(lambda t: t.to(device, copy=True),
                        (params, opt_state))

    def gather_tree(self, t):
        """The whole tensors of a local params-shaped tree, on the host of
        every rank (a collective)."""
        whole = sharding.gather_tree(t, self._spec_tree(t), self.mesh)
        return tree.map(lambda x: x.detach().to("cpu", copy=True), whole)

    def gather_state(self, params, opt_state):
        """The reference-format ``(params, opt_state)`` on the host of
        every rank (collective): what a checkpoint holds."""
        return (self.gather_tree(params),
                _over_state(opt_state, params, self.gather_tree,
                            lambda x: x.detach().to("cpu", copy=True)))

    def _spec_tree(self, t):
        leaves, treedef = tree.flatten(t)
        if self._specs is None or len(leaves) != len(self._specs):
            raise ValueError("call prepare on the reference-format state "
                             "first: it learns the layout")
        return self._specs

    def local_param_bytes(self, params) -> int:
        """The bytes of this rank's parameter blocks."""
        return sum(x.numel() * x.element_size() for x in tree.leaves(params))

    # -- the batch ------------------------------------------------------------

    def _batch_spec(self, key: str, ndim: int, split: bool):
        """A batch leaf's spec: its sample dim over the batch axes (dim 1
        of a split leaf, dim 0 of one micro-batch's)."""
        d = _SAMPLE_DIM.get(key, 0) + (1 if split else 0)
        spec = [None] * ndim
        spec[d] = (mesh_lib.POD_AXIS, mesh_lib.DATA_AXIS)
        return sharding.filter_spec(spec, self.mesh)

    def shard(self, split):
        """This rank's block of a global split batch (host or device):
        the samples of its data coordinate (every rank of a model line
        holds the same block), ``local_micro`` of each micro-batch."""
        coords = self.mesh.coords()
        out = {}
        for k, v in split.items():
            spec = self._batch_spec(k, v.ndim, split=True)
            out[k] = v[sharding.local_slices(v.shape, spec, self.mesh,
                                             coords)]
        return out

    def _as_dtensors(self, mb):
        return {k: sharding.as_dtensor(v, self._batch_spec(k, v.dim(), False),
                                       self.mesh)
                for k, v in mb.items()}

    def _denominators(self, micro_batches):
        """(N_Smu, N_B_valid) with the valid count of the GLOBAL batch:
        the local blocks' weights summed over the batch axes."""
        first = next(iter(micro_batches.values()))
        n_s = first.shape[0]
        w = micro_batches.get("sample_weight")
        if w is None:
            w = torch.ones(first.shape[:2], device=first.device)
        total = sharding.as_dtensor(
            w, self._batch_spec("sample_weight", w.dim(), True),
            self.mesh).sum().full_tensor()
        return n_s, total

    # -- the step -------------------------------------------------------------

    def _local_loss(self, params, mb, exact_denom=None):
        """The loss of local blocks: wrapped as DTensors, run on the mesh,
        the loss and metrics brought back replicated (plain tensors)."""
        if self._specs is None:
            raise ValueError("call prepare on the reference-format state "
                             "first: it cuts it to this rank's blocks")
        leaves, treedef = tree.flatten(params)
        p = tree.unflatten(treedef, [
            sharding.as_dtensor(x, spec, self.mesh)
            for x, spec in zip(leaves, self._specs)])
        kw = {} if exact_denom is None else {"exact_denom": exact_denom}
        loss, metrics = self.loss_fn(p, self._as_dtensors(mb), **kw)
        return _replicated(loss), {k: _replicated(v)
                                   for k, v in metrics.items()}

    def _owned_sq(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """This rank's share of Σ of squared leaf norms: the leaves it
        owns."""
        if len(sq) != len(self._owned):
            raise ValueError(f"{len(sq)} squared norms for "
                             f"{len(self._owned)} leaves")
        local = sum(s for s, own in zip(sq, self._owned) if own)
        if not torch.is_tensor(local):
            local = torch.zeros((), device=self.mesh.device)
        return local.reshape(1)

    def _world_sum(self, local: torch.Tensor) -> torch.Tensor:
        """A 1-D fp32 vector summed over the world (the step's global
        reduction)."""
        from torch.distributed.tensor import DTensor, Partial
        return DTensor.from_local(
            local, self.mesh.device_mesh, [Partial()] * len(self.mesh),
            run_check=False).full_tensor()

    def _sq_reduce(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """Σ of squared leaf norms over the whole model: each rank adds
        the leaves it owns and the sum runs over the world."""
        return self._world_sum(self._owned_sq(sq)).reshape(())

    def step_split(self, params, opt_state, micro_batches):
        """One mini-batch on this rank's blocks (see the module doc):
        ``(params, opt_state, metrics)``, metrics replicated."""
        with nn.use_mesh(self.mesh), optim.sharded_norm(self._sq_reduce):
            if self.guard:
                return self._guarded_step(params, opt_state, micro_batches)
            return self.inner.step_split(params, opt_state, micro_batches)

    def _guarded_step(self, params, opt_state, micro_batches):
        """The step under the guard (see the module doc): steps ❷–❹ by
        the inner executor on this rank's blocks, then one reduction over
        the world of the owned squared norms, the ranks' non-finite flags
        and the fault slots, then step ❺ behind the flag."""
        _, fault = _oom_of(faults.on_dispatch, self.plan, self.mesh.rank)
        inner, flat = self.inner, self.inner_name == "flat"
        if flat:
            params, opt_state = inner.prepare(params, opt_state)
        lost = None
        try:
            if flat:
                spec, acc, loss, metric_sum, _ = inner._accumulated_flat(
                    params, micro_batches)
                leaves = tree.leaves(spec.unflatten(acc, cast=False))
            else:
                spec = None
                acc, loss, metric_sum = inner._accumulated(params,
                                                           micro_batches)
                leaves = tree.leaves(acc)
        except Exception as exc:  # noqa: BLE001 (re-raised unless agreed)
            lost = faults.is_oom(exc)
            if not mesh_lib.post_fault(self.mesh, lost):
                raise
        if lost is not None:  # the failed step's tensors are gone with it
            self._agree_lost_step(lost)
        world = math.prod(self.mesh.values())
        sq = [torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
              for g in leaves]
        bad = (~exec_core.finite_all(acc)).to(torch.float32).reshape(1)
        total = self._world_sum(torch.cat([
            self._owned_sq(sq), bad.to(self.mesh.device),
            fault_slots(fault, self.mesh.rank, world, self.mesh.device)]))
        raise_agreed(total[2:])
        ok = total[1] == 0
        if flat and getattr(self.optimizer, "fused", None) is not None:
            new_params, new_opt = exec_core.apply_update_flat(
                self.optimizer, spec, acc, opt_state, params, ok=ok)
        else:
            grads = spec.unflatten(acc, cast=False) if flat else acc
            new_params, new_opt, _ = exec_core.guarded_update(
                self.optimizer, grads, opt_state, params, ok=ok)
        return new_params, new_opt, exec_core.finalize_metrics(
            metric_sum, loss, acc, ok, grad_norm=torch.sqrt(total[0]))

    def _agree_lost_step(self, fault: bool) -> None:
        """After a step lost inside its collectives (``post_fault`` true
        on every rank): the world's groups anew, then one reduction of the
        fault slots over them, and the agreed error on every rank."""
        mesh_lib.reform(self.mesh)
        world = math.prod(self.mesh.values())
        slots = fault_slots(fault, self.mesh.rank, world, self.mesh.device)
        raise_agreed(self._world_sum(slots),
                     by="the world's groups started anew")
        raise RuntimeError("a fault was posted on the store, but no rank "
                           "reports one")


def _replicated(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# the census of collectives
# ---------------------------------------------------------------------------

_KINDS = {"all_gather_into_tensor": "all_gather",
          "reduce_scatter_tensor": "reduce_scatter",
          "all_reduce": "all_reduce", "all_to_all_single": "all_to_all",
          "broadcast": "broadcast"}


# DTensor's sharding propagation derives an op's global output shape by
# running the op on fake tensors of the WHOLE shape (under the enclosing
# fake mode, or a new one): those run through a census's dispatch too, but
# no rank holds them or computes them
_SHAPE_ONLY = threading.local()


def _shape_only_depth() -> int:
    return getattr(_SHAPE_ONLY, "depth", 0)


def _mark_shape_propagation() -> None:
    """Wrap DTensor's ``ShardingPropagator._propagate_tensor_meta_non_cached``
    (once, process-wide) so a census can tell its whole-shape fake
    tensors from the rank's own; a torch without it is left as it is."""
    from torch.distributed.tensor import _sharding_prop as sp
    fn = getattr(sp.ShardingPropagator, "_propagate_tensor_meta_non_cached",
                 None)
    if fn is None or getattr(fn, "_census_marked", False):
        return

    @functools.wraps(fn)
    def marked(*args, **kwargs):
        _SHAPE_ONLY.depth = _shape_only_depth() + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _SHAPE_ONLY.depth -= 1

    marked._census_marked = True
    sp.ShardingPropagator._propagate_tensor_meta_non_cached = marked


class CollectiveCensus(TorchDispatchMode):
    """Counts the functional collectives run inside it — DTensor's
    redistributions and the loss's reductions — by kind and by the mesh
    axes of their process group (``"data"``, ``"model"``, ``"data+model"``
    …), with the bytes each moved (its input's) and the largest one's. An
    op on DTensors is handed back to DTensor first (``NotImplemented``),
    so the collectives it runs on the local blocks come through here.
    Those run inside a weight's gather (``models.nn.gathering_params``)
    are also counted apart, by kind and axis (``params_by_kind_and_axis``
    in the summary).

    ``local=True`` also counts what one rank computes: the FLOPs of its
    local matmuls (``torch.utils.flop_counter``'s formulas) and the peak
    of the live bytes of the local tensors it sees (each storage from its
    first sight until it is freed) — the dry run's per-rank numbers. The
    whole-shape fake tensors of DTensor's sharding propagation count in
    neither (:func:`_mark_shape_propagation`)."""

    def __init__(self, mesh, local: bool = False):
        super().__init__()
        self.mesh = mesh
        self.counts: Dict[str, Dict[str, int]] = {}
        self.param_counts: Dict[str, Dict[str, int]] = {}
        self.bytes: Dict[str, int] = {}
        self.largest: Dict[str, int] = {}
        self._axis_of = self._axes(mesh)
        self.flops = 0
        self._live = None
        if local:
            from .steptrace import _LiveBytes
            self._live = _LiveBytes()
            _mark_shape_propagation()

    @property
    def peak_bytes(self) -> int:
        return self._live.peak if self._live is not None else 0

    def see(self, *tensors) -> None:
        """Count ``tensors`` (the state, the batch) as live from now."""
        for t in tensors:
            if self._live is not None and isinstance(t, torch.Tensor):
                self._live.see(t)

    @staticmethod
    def _axes(mesh) -> Dict[str, str]:
        """Process group name → axis, for this mesh's groups; a group of
        another name (an equal ``DeviceMesh`` made earlier, whose layouts
        DTensor's caches keep) is told by its ranks (:meth:`_axis`)."""
        out = {}
        names = list(mesh)
        dm = mesh.device_mesh
        for ax in names:
            out[dm.get_group(ax).group_name] = ax
        if len(names) > 1:  # the whole world, when DTensor flattens
            import torch.distributed as dist
            out[dist.group.WORLD.group_name] = "+".join(names)
        return out

    def _axis(self, group_name: str) -> str:
        """The mesh axis of a process group: by name, else by its ranks
        (those of this rank's line along an axis, or the whole world);
        "other" for none of them."""
        if group_name not in self._axis_of:
            import torch.distributed as dist
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            dm = self.mesh.device_mesh
            by_ranks = {tuple(sorted(dist.get_process_group_ranks(
                dm.get_group(ax)))): ax for ax in self.mesh}
            by_ranks.setdefault(tuple(range(dist.get_world_size())),
                                "+".join(self.mesh))
            try:
                ranks = tuple(sorted(dist.get_process_group_ranks(
                    _resolve_process_group(group_name))))
            except (KeyError, RuntimeError, ValueError):
                ranks = None
            self._axis_of[group_name] = by_ranks.get(ranks, "other")
        return self._axis_of[group_name]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        pkt = getattr(func, "_overloadpacket", None)
        if self._live is not None and not _shape_only_depth():
            from torch.utils.flop_counter import flop_registry
            from .steptrace import _tensors
            for t in _tensors(args) + _tensors(out):
                self._live.see(t)
            if pkt in flop_registry:
                self.flops += flop_registry[pkt](*args, **kwargs,
                                                 out_val=out)
        ns = getattr(pkt, "__module__", "") or ""
        name = getattr(pkt, "__name__", "")
        if "_c10d_functional" in ns and name in _KINDS:
            kind = _KINDS[name]
            group = args[-1] if isinstance(args[-1], str) else kwargs.get(
                "group_name", "")
            axis = self._axis(group)
            for counts in ((self.counts, self.param_counts)
                           if nn.gathering_depth() else (self.counts,)):
                by = counts.setdefault(kind, {})
                by[axis] = by.get(axis, 0) + 1
            inp = args[0]
            n = inp.numel() * inp.element_size()
            self.bytes[kind] = self.bytes.get(kind, 0) + n
            self.largest[kind] = max(self.largest.get(kind, 0), n)
        return out

    def summary(self) -> Dict[str, Any]:
        return {"by_kind_and_axis": {k: dict(v) for k, v in
                                     sorted(self.counts.items())},
                "params_by_kind_and_axis": {
                    k: dict(v) for k, v in sorted(self.param_counts.items())},
                "bytes_by_kind": dict(sorted(self.bytes.items())),
                "largest_by_kind": dict(sorted(self.largest.items())),
                "calls": sum(sum(v.values()) for v in self.counts.values())}
