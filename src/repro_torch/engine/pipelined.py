"""Pipeline-parallel MBS execution: 1F1B over the mesh's ``model`` axis,
composed with data parallelism — the JAX package's ``engine/pipelined.py``
over ``torch.distributed``.

The paper's micro-batches are the currency of pipeline schedules: a 1F1B
schedule streams the :class:`~.plan.MBSPlan`'s ``num_micro_batches``
through ``stages`` model shards with at most ``stages`` micro-batches in
flight on a stage — which is why ``plan_mbs(pipeline=True)`` budgets
stage-local activations × warmup depth instead of whole-model
activations.

Schedule (closed form, host-side tables, the reference's exactly):

    t_f(s, i) = s + i                  i <= S-1-s   (warmup)
              = 2 i + s                otherwise    (steady 1F1B)
    t_b(s, j) = 2 S - 1 - s + 2 j
    ticks     T = 2 (M + S - 1)

Realization. The reference traces one SPMD program in which every device
runs a masked forward and a masked backward each tick. The port is MIMD:
rank ``r`` of a ``(data, model)`` mesh is stage ``s = r % S`` of replica
``d = r // S`` (``launch.mesh.pipeline_mesh``) and runs only its own
work, in the tables' tick order:

  * the prelude (embedding) only on stage 0, the finale (head + loss) only
    on stage S-1; a stage's forward runs under ``no_grad`` and keeps its
    INPUT carry, and its backward recomputes the stage from that carry
    with autograd (the reference's stage-level remat, which
    ``memory_model.pipeline_activation_bytes_per_sample`` charges). The
    last stage only keeps its input at its forward tick: its backward,
    the next tick, computes the loss;
  * stage boundaries are ``isend``/``irecv`` to the neighbouring rank —
    activations forward, cotangents back — posted at the tick the
    neighbour sends and waited on only when the value is consumed, so no
    order of blocking calls can deadlock at S >= 3. On gloo a CUDA tensor
    goes through a host copy (one call per logical transfer still);
  * stage gradients accumulate in ``accum_dtype`` with a plain add
    (``exec_core.accumulate``), as the reference's: the pipelined path
    launches no kernel of ``repro_torch.kernels``.

Collectives a mini-batch (``defer_sync=True``, no FSDP), the census that
``engine.collective_stats`` keeps:

  * the point-to-point calls: stage s sends M activations when s < S-1
    and M cotangents when s > 0, and receives as many from the other side
    (``p2p``: ``fwd_send``, ``fwd_recv``, ``bwd_send``, ``bwd_recv``);
  * exactly ONE data-axis all-reduce of the stage gradients (``psum_flat``
    over the stage's replicas; a data axis of one rank has nothing to sum
    and issues none);
  * exactly ONE (data+model) all-reduce over the world: the shared
    parameters' gradients (embedding, final norm, head; a tied embedding
    gets both ends' contributions), the loss and metrics of the last
    stage, its valid-sample count, the stage gradients' squared norm (for
    ``grad_norm`` and the guard's flag) and one fault slot per rank.

``defer_sync=False`` is the per-micro baseline: one data-axis all-reduce
of each backward's gradients (M a step), then one model-axis all-reduce
of the shared gradients before the (data+model) one.

``fsdp=True`` shards the stage-local parameters (and the shared ones)
over the data axis per ``launch.sharding.param_specs`` with the model
entries stripped (the model axis is spent on stages): the step gathers
them once (``all_gather_into_tensor``, or its successor
``all_gather_single``) and reduces their gradients with
``reduce_scatter_tensor`` (``reduce_scatter_single``); leaves the policy leaves whole take one
data-axis all-reduce, and the shared gradients one model-axis
all-reduce first. The (data+model) all-reduce then carries the scalars.

A fault on one rank is agreed as in ``engine.ShardedExecutor``: a rank
whose dispatch hook or stage work runs out of memory finishes its share
of the schedule's sends and receives with zero tensors (the reference's
masked work), joins every all-reduce with zero contributions and sets its
fault slot; after the (data+model) all-reduce every rank raises the same
``torch.OutOfMemoryError`` before the update.

State. Between steps a rank holds its stage's slice of the stacked block
leaves (``num_layers / stages`` periods; under FSDP its data shard of
them) and the shared leaves, and the optimizer state of the same leaves
(:meth:`prepare` cuts them from the reference-format tree,
:meth:`gather_state` puts the reference-format tree back together on the
host, collectively, for checkpoints; :meth:`full_template` is its shape).
The update runs on each rank over its leaves — elementwise, so a slice of
the reference's update on the recombined tree — and writes the new
values into the state's own buffers (the reference's donation): every
leaf keeps its storage across steps. ``guard=True`` skips the update on
every rank alike from the world-reduced flag. An optimizer that clips by
the global norm is refused: a stage sees a part of the gradient.

``trace_step`` and ``measure_step`` (``engine.steptrace``) stand in for
the reference's jaxpr and HLO tools: one real step, recorded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import tree
from ..launch import mesh as mesh_lib
from ..launch import sharding
from . import exec_core, faults
from .executors import _as_plan, _micro
from .plan import MBSPlan
from .sharded import (_local_valid_count, _oom_of, count_collective,
                      fault_slots, local_block, psum_flat, raise_agreed,
                      timed_call)
from .steptrace import Traceable


def schedule_1f1b(stages: int, micros: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side 1F1B tick tables (see the module doc for the closed form).

    Returns ``(fwd, bwd, recv, ticks)``: ``fwd[t, s]`` / ``bwd[t, s]`` is
    the micro-batch stage ``s`` runs forward/backward at tick ``t`` (−1 =
    idle); ``recv[t, s]`` is the micro whose activation stage ``s``
    receives from ``s−1`` at the END of tick ``t`` (−1 on stage 0)."""
    if stages < 1 or micros < 1:
        raise ValueError(f"need stages >= 1 and micros >= 1, got "
                         f"({stages}, {micros})")
    ticks = 2 * (micros + stages - 1)
    fwd = -np.ones((ticks, stages), np.int32)
    bwd = -np.ones((ticks, stages), np.int32)
    for s in range(stages):
        for i in range(micros):
            t = s + i if i <= stages - 1 - s else 2 * i + s
            fwd[t, s] = i
        for j in range(micros):
            bwd[2 * stages - 1 - s + 2 * j, s] = j
    recv = -np.ones((ticks, stages), np.int32)
    recv[:, 1:] = fwd[:, :-1]
    return fwd, bwd, recv, ticks


def p2p_counts(stages: int, micros: int, stage: int) -> Dict[str, int]:
    """The point-to-point calls stage ``stage`` issues in one mini-batch of
    ``micros`` micro-batches, from the schedule's tables: one send of each
    forward's output (all stages but the last) and of each backward's
    input cotangent (all but the first), and their receives."""
    fwd, bwd, recv, _ = schedule_1f1b(stages, micros)
    sends_f = int((fwd[:, stage] >= 0).sum()) if stage < stages - 1 else 0
    sends_b = int((bwd[:, stage] >= 0).sum()) if stage > 0 else 0
    recvs_f = int((recv[:, stage] >= 0).sum())
    recvs_b = (int((bwd[:, stage + 1] >= 0).sum())
               if stage < stages - 1 else 0)
    return {"fwd_send": sends_f, "fwd_recv": recvs_f, "bwd_send": sends_b,
            "bwd_recv": recvs_b}


@dataclasses.dataclass(frozen=True)
class StagedLoss:
    """A loss function split for pipeline execution.

    The params tree holds ONE subtree (``params[stacked_key]``) whose
    leaves all carry a leading ``num_layers`` dim; everything else is
    "shared" (embedding, head, final norm). The three callables factor the
    loss as ``finale(shared, stage_fn^S(.., prelude(shared, mb)), mb)``:

      prelude(shared, mb) -> x        stage 0's entry (embedding); the
                                      output tree is the carry every stage
                                      maps to itself;
      stage_fn(stage_params, x) -> x  one stage: leaves lead with
                                      ``num_layers // stages``;
      finale(shared, x, mb)           -> (raw_loss_sum, metrics): the RAW
                                      loss SUM (``exact_denom=1``); the
                                      executor divides by the global valid
                                      count after its all-reduce.
    """
    num_layers: int
    prelude: Callable[[Any, Any], Any]
    stage_fn: Callable[[Any, Any], Any]
    finale: Callable[[Any, Any, Any], Tuple[torch.Tensor, Dict[str, Any]]]
    stacked_key: str = "blocks"

    def partition(self, params, stages: int) -> Tuple[Any, Any]:
        """(shared, staged): staged leaves reshaped (L, ...) -> (stages,
        L/stages, ...) (views; stage s is ``leaf[s]``)."""
        if self.num_layers % stages:
            raise ValueError(
                f"pipeline stage count {stages} does not divide the block "
                f"stack ({self.num_layers} layers) — pick a model axis "
                "that divides the layer count evenly")
        per = self.num_layers // stages
        shared = {k: v for k, v in params.items() if k != self.stacked_key}
        staged = tree.map(lambda a: a.reshape((stages, per) + a.shape[1:]),
                          params[self.stacked_key])
        return shared, staged

    def combine(self, shared, staged):
        """Inverse of :meth:`partition`: the params-shaped tree."""
        stacked = tree.map(
            lambda a: a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:]),
            staged)
        out = dict(shared)
        out[self.stacked_key] = stacked
        return out


def _strip_model(spec) -> Tuple:
    """Drop ``model`` entries from a spec (the model axis is spent on the
    pipeline's stages, not tensor parallelism)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != mesh_lib.MODEL_AXIS)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(None if e == mesh_lib.MODEL_AXIS else e)
    return tuple(out)


def _data_dim(spec) -> Optional[int]:
    """The dim a (model-stripped) spec shards over ``data``, or None."""
    for d, e in enumerate(spec):
        if e == mesh_lib.DATA_AXIS or (isinstance(e, tuple)
                                       and mesh_lib.DATA_AXIS in e):
            return d
    return None


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class PipelinedExecutor(Traceable):
    """1F1B pipeline + data-parallel executor (see the module doc) over a
    ``(data, model)`` mesh from ``launch.mesh.pipeline_mesh``: the model
    axis runs ``stages`` stages, the data axis replicates the schedule
    over ``local_micro`` samples of every micro-batch. ``fsdp=True``
    shards params over the data axis with a gather a step."""
    name = "pipelined"
    updates_in_place = True

    def __init__(self, staged: StagedLoss, optimizer, plan, *, mesh,
                 defer_sync: bool = True, fsdp: bool = False,
                 guard: bool = False):
        self.staged = staged
        self.optimizer = optimizer
        self.plan: MBSPlan = _as_plan(plan)
        self.mesh = mesh
        self.dp = mesh_lib.data_parallel_size(mesh)
        self.stages = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        self.defer_sync = defer_sync
        self.fsdp = fsdp
        self.guard = guard
        if self.stages < 2:
            raise ValueError(
                "PipelinedExecutor needs a mesh model axis of >= 2 stages "
                f"(got {self.stages}); for pure data parallelism use "
                "ShardedExecutor")
        if staged.num_layers % self.stages:
            raise ValueError(
                f"pipeline stage count {self.stages} does not divide the "
                f"block stack ({staged.num_layers} layers) — pick a model "
                "axis that divides the layer count evenly")
        if self.plan.pipeline_stages > 1 \
                and self.plan.pipeline_stages != self.stages:
            raise ValueError(
                f"plan was admitted for {self.plan.pipeline_stages} "
                f"pipeline stages but the mesh's model axis is "
                f"{self.stages} — rebuild the plan with this mesh")
        if self.plan.micro_batch_size % self.dp:
            raise ValueError(
                f"micro-batch {self.plan.micro_batch_size} does not divide "
                f"over {self.dp} data-parallel workers — build the plan "
                "with plan_mbs(mesh=...) so sizes stay divisible")
        if self.plan.normalization == "paper" and self.plan.pad:
            raise ValueError(
                'a ragged "paper" plan cannot be pipelined exactly (the '
                "tail pad lands on one worker's shard) — use "
                'normalization="exact" (plan_mbs auto-upgrades ragged plans)')
        if fsdp and not defer_sync:
            raise ValueError(
                "defer_sync=False is the per-micro-sync comparison baseline "
                "and does not compose with fsdp=True (reduce_scatter "
                "already replaces the deferred all-reduce)")
        fused = getattr(optimizer, "fused", None)
        if fused is not None and fused.clip_norm is not None:
            raise ValueError(
                "an optimizer that clips by the global gradient norm cannot "
                "update a pipeline stage alone (its norm is the stage's); "
                "clip outside the pipelined executor")
        self.stage_index = mesh.rank % self.stages
        self.replica = mesh.rank // self.stages
        self.device = mesh.device
        # this rank's lines of the mesh, as meshes psum_flat and
        # local_block take: its stage's replicas, its replica's stages
        self.data_mesh = mesh_lib.Mesh(
            {mesh_lib.DATA_AXIS: self.dp, mesh_lib.MODEL_AXIS: 1},
            rank=self.replica, group=mesh.groups.get(mesh_lib.DATA_AXIS),
            device=self.device, backend=mesh.backend)
        self.model_mesh = mesh_lib.Mesh(
            {mesh_lib.DATA_AXIS: 1, mesh_lib.MODEL_AXIS: self.stages},
            rank=self.stage_index, group=mesh.groups.get(mesh_lib.MODEL_AXIS),
            device=self.device, backend=mesh.backend)
        self._layout = None  # set by prepare: treedefs and FSDP dims
        self._templates: Dict[Any, Any] = {}  # carry, metrics by mb shape

    # -- staging ------------------------------------------------------------

    def shard(self, split):
        """This rank's block of a global split batch: its replica's
        ``local_micro`` samples of every micro-batch (host or device)."""
        return local_block(split, self.plan.micro_batch_size, self.data_mesh)

    def stage(self, split):
        """This rank's block of a global split host batch, on its device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.shard(split).items()}

    # -- the state's layout -------------------------------------------------

    def _param_dims(self, shared, staged):
        """(shared dims, staged dims): per leaf, the dim sharded over the
        data axis (None: whole). Non-FSDP: none. FSDP: the reference's
        policy on the stage-LOCAL shapes under a stacked root (the layer
        dim never shards), model entries stripped."""
        if not self.fsdp:
            return ([None] * len(tree.leaves(shared)),
                    [None] * len(tree.leaves(staged)))
        view = tree.map(lambda x: torch.empty(tuple(x.shape[1:]),
                                              device="meta"), staged)
        policy = sharding.param_specs({"blocks": view, "shared": shared},
                                      dict(self.mesh), fsdp=True)
        sh = [_data_dim(_strip_model(sp))
              for sp in sharding.spec_leaves(policy["shared"])]
        st = [_data_dim(_strip_model(sp))
              for sp in sharding.spec_leaves(policy["blocks"])]
        return sh, st

    def _split_local(self, t):
        """(shared leaves, staged leaves) of a local params-shaped tree."""
        key = self.staged.stacked_key
        shared = {k: v for k, v in t.items() if k != key}
        return tree.leaves(shared), tree.leaves(t[key])

    def _join_local(self, sh_leaves, st_leaves):
        sh_def, st_def = self._layout["treedefs"]
        out = tree.unflatten(sh_def, list(sh_leaves))
        out[self.staged.stacked_key] = tree.unflatten(st_def, list(st_leaves))
        return out

    def _cut(self, x, dim):
        """This rank's data shard of ``x`` on ``dim`` (None: all of it)."""
        if dim is None:
            return x
        n = x.shape[dim] // self.dp
        return x.narrow(dim, self.replica * n, n)

    def _localize(self, t, device):
        """This rank's copy of a reference-format params-shaped tree."""
        shared, staged = self.staged.partition(t, self.stages)
        sh_dims, st_dims = self._layout["dims"]
        s = self.stage_index
        sh = [self._cut(x, d).to(device, copy=True)
              for x, d in zip(tree.leaves(shared), sh_dims)]
        st = [self._cut(x[s], d).to(device, copy=True)
              for x, d in zip(tree.leaves(staged), st_dims)]
        return self._join_local(sh, st)

    def prepare(self, params, opt_state, device=None):
        """This rank's state from the reference-format ``(params,
        opt_state)`` (host or device): its stage's slice of the stacked
        leaves, the shared leaves (FSDP: the data shard of each), copied
        to ``device`` (default: the mesh's). Every params-shaped subtree
        of ``opt_state`` is cut alike; its other leaves (the step) are
        copied."""
        device = self.device if device is None else torch.device(device)
        key = self.staged.stacked_key
        for x in tree.leaves(params[key]):
            if x.shape[0] != self.staged.num_layers:
                raise ValueError(
                    f"prepare takes the reference-format state (stacked "
                    f"leaves of {self.staged.num_layers} layers), got a "
                    f"leaf of {tuple(x.shape)}")
        shared, staged = self.staged.partition(params, self.stages)
        self._layout = {
            "treedefs": (tree.flatten(shared)[1], tree.flatten(staged)[1]),
            "dims": self._param_dims(shared, staged),
            "full": tree.map(lambda x: torch.empty(tuple(x.shape),
                                                   dtype=x.dtype,
                                                   device="meta"), params)}
        return (self._localize(params, device),
                _over_state(opt_state, params,
                            lambda v: self._localize(v, device),
                            lambda x: x.to(device, copy=True)))

    def full_template(self, params, opt_state):
        """The reference-format shape of this rank's ``(params,
        opt_state)`` as meta tensors (a checkpoint's template)."""
        full = self._layout["full"]
        return full, _over_state(
            opt_state, params, lambda v: full,
            lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                  device="meta"))

    def gather_tree(self, t):
        """The reference-format tree of a local params-shaped tree (params,
        gradients, a moment), on the host of every rank: the data shards
        gathered (FSDP), then the stages (collective over the mesh)."""
        sh_dims, st_dims = self._layout["dims"]
        sh, st = self._split_local(t)
        host = lambda x: x.detach().to("cpu", copy=True)  # noqa: E731
        sh = [host(self._gather(x, d, self.data_mesh))
              for x, d in zip(sh, sh_dims)]
        st = [host(self._gather(self._gather(x, d, self.data_mesh), 0,
                                self.model_mesh))
              for x, d in zip(st, st_dims)]
        shared = tree.unflatten(self._layout["treedefs"][0], sh)
        staged = tree.unflatten(self._layout["treedefs"][1], st)
        out = dict(shared)
        out[self.staged.stacked_key] = staged
        return out

    def gather_state(self, params, opt_state):
        """The reference-format ``(params, opt_state)`` on the host of
        every rank (collective): what a checkpoint holds."""
        return (self.gather_tree(params),
                _over_state(opt_state, params, self.gather_tree,
                            lambda x: x.detach().to("cpu", copy=True)))

    def state_shardings(self, params, opt_state):
        """The per-rank layout of the reference-format ``(params,
        opt_state)``, as spec trees: a stacked leaf (and its moments) is
        split over ``model`` on its layer dim (FSDP: and over ``data`` on
        its dim), a shared leaf replicated (FSDP: split over ``data``)."""
        shared, staged = self.staged.partition(params, self.stages)
        sh_dims, st_dims = self._param_dims(shared, staged)

        def spec(ndim, dim, lead=None):
            entries = [None] * ndim
            if lead is not None:
                entries[0] = lead
            if dim is not None:
                entries[dim] = mesh_lib.DATA_AXIS
            return sharding.P(*entries)

        sh = [spec(x.dim(), d) for x, d in zip(tree.leaves(shared), sh_dims)]
        st = [spec(x.dim() - 1, d, mesh_lib.MODEL_AXIS)
              for x, d in zip(tree.leaves(staged), st_dims)]
        specs = dict(tree.unflatten(tree.flatten(shared)[1], sh))
        specs[self.staged.stacked_key] = tree.unflatten(
            tree.flatten(params[self.staged.stacked_key])[1], st)
        return specs, _over_state(opt_state, params, lambda v: specs,
                                  lambda x: sharding.P())

    def donated_state_bytes(self, params, opt_state) -> int:
        """The bytes of one rank's ``(params, opt_state)`` under
        :meth:`state_shardings`: a stacked leaf counts 1/stages (FSDP: and
        1/data on its dim), a replicated leaf whole — the buffers the
        update writes in place."""
        p_specs, o_specs = self.state_shardings(params, opt_state)
        total = 0
        for t, specs in ((params, p_specs), (opt_state, o_specs)):
            for x, sp in zip(tree.leaves(t), sharding.spec_leaves(specs)):
                total += _nbytes(x) // sharding.shard_factor(
                    sp, dict(self.mesh))
        return total

    # -- collectives (counted) ----------------------------------------------

    def _host_staged(self, x) -> bool:
        """gloo takes a CUDA tensor only through a host copy."""
        return x.is_cuda and self.mesh.backend == "gloo"

    def _gather(self, x, dim, line) -> torch.Tensor:
        """``all_gather_into_tensor`` of ``x`` along ``dim`` over the
        mesh line ``line`` (None dim, or a line of one rank: ``x``)."""
        import torch.distributed as dist
        n = math.prod(line.values())
        if dim is None or n < 2:
            return x
        src = x.detach().contiguous()
        if self._host_staged(src):  # gloo's transport is this host copy
            src = src.cpu()  # repro: noqa(LINT001, JX003)
        out = torch.empty((n * src.numel(),), dtype=src.dtype,
                          device=src.device)
        gather = getattr(dist, "all_gather_single",
                         getattr(dist, "all_gather_into_tensor", None))
        secs = timed_call(x, lambda: gather(out, src.reshape(-1),
                                            group=line.group))
        count_collective("all_gather", seconds=secs)
        parts = out.view((n,) + tuple(src.shape)).unbind(0)
        return torch.cat(parts, dim=dim).to(x.device)

    def _scatter(self, g, dim) -> torch.Tensor:
        """``reduce_scatter_tensor`` (sum) of a full gradient over the data
        axis along ``dim``: this rank's shard of the sum."""
        import torch.distributed as dist
        moved = g.movedim(dim, 0).contiguous()
        if self._host_staged(moved):  # gloo's transport is this host copy
            moved = moved.cpu()  # repro: noqa(LINT001, JX003)
        out = torch.empty((moved.shape[0] // self.dp,) + moved.shape[1:],
                          dtype=moved.dtype, device=moved.device)
        scatter = getattr(dist, "reduce_scatter_single",
                          getattr(dist, "reduce_scatter_tensor", None))
        secs = timed_call(g, lambda: scatter(
            out, moved, op=dist.ReduceOp.SUM, group=self.data_mesh.group))
        count_collective("reduce_scatter", seconds=secs)
        return out.movedim(0, dim).to(g.device)

    def _send(self, t, peer: int, kind: str, outbox: List) -> None:
        """``isend`` of a carry-shaped tree to global rank ``peer``; the
        work and its buffers wait in ``outbox`` until the step's end."""
        import torch.distributed as dist
        for x in tree.leaves(t):
            buf = x.detach().contiguous()
            if self._host_staged(buf):  # gloo's transport is this host copy
                buf = buf.cpu()  # repro: noqa(LINT001, JX003)
            outbox.append((dist.isend(buf, peer, tag=_TAGS[kind]), buf))
        count_collective(kind)

    def _post_recv(self, template, peer: int, kind: str):
        """Post the ``irecv`` of a carry-shaped tree from global rank
        ``peer``: (works, buffers), consumed by :meth:`_take`."""
        import torch.distributed as dist
        works, bufs = [], []
        on_host = self.device.type == "cuda" and self.mesh.backend == "gloo"
        for m in tree.leaves(template):
            buf = torch.empty(m.shape, dtype=m.dtype,
                              device="cpu" if on_host else self.device)
            works.append(dist.irecv(buf, peer, tag=_TAGS[kind]))
            bufs.append(buf)
        count_collective(kind)
        return works, bufs

    def _take(self, posted, template):
        works, bufs = posted
        for w in works:
            w.wait()
        return tree.unflatten(tree.flatten(template)[1],
                              [b.to(self.device) for b in bufs])

    # -- one stage's work ---------------------------------------------------

    def _templates_for(self, shared, split):
        """(carry, metrics) as meta trees for this split's micro-batch
        shape, from a fake-tensor trace of the prelude and the finale."""
        mb = _micro(split, 0)
        key = tuple((k, tuple(v.shape)) for k, v in sorted(mb.items()))
        if key not in self._templates:
            spec = self.staged
            carry = exec_core.abstract_call(spec.prelude, shared, mb)
            metrics = exec_core.abstract_call(
                lambda sh, x, b: spec.finale(sh, x, b)[1], shared, carry, mb)
            self._templates[key] = (carry, metrics)
        return self._templates[key]

    def _zeros(self, template):
        return tree.map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                              device=self.device), template)

    def _forward(self, shared, stage_p, x_in, mb):
        """A stage's forward (stage 0 from the micro-batch), no graph."""
        with torch.no_grad():
            x = self.staged.prelude(shared, mb) if x_in is None else x_in
            return self.staged.stage_fn(stage_p, x)

    def _backward(self, shared, stage_p, x_in, mb, dy):
        """Recompute the stage from its input with autograd and pull the
        cotangent ``dy`` (the loss's 1 on the last stage) back: (stage
        grads, shared grads (None where unused), input cotangent, raw
        loss, metrics)."""
        spec = self.staged
        first = x_in is None
        last = dy is None
        sp_l, sp_def = tree.flatten(stage_p)
        sp_req = [p.detach().requires_grad_() for p in sp_l]
        sh_l, sh_def = tree.flatten(shared)
        sh_req = ([p.detach().requires_grad_() for p in sh_l]
                  if first or last else sh_l)
        sh_t = tree.unflatten(sh_def, sh_req)
        inputs = list(sp_req) + (list(sh_req) if first or last else [])
        if first:
            x = spec.prelude(sh_t, mb)
            x_req = []
        else:
            xl, xdef = tree.flatten(x_in)
            x_req = [v.detach().requires_grad_() for v in xl]
            x = tree.unflatten(xdef, x_req)
            inputs += x_req
        y = spec.stage_fn(tree.unflatten(sp_def, sp_req), x)
        loss = torch.zeros((), device=self.device)
        metrics = {}
        if last:
            loss, metrics = spec.finale(sh_t, y, mb)
            outs, couts = [loss], None
        else:
            outs, couts = tree.leaves(y), tree.leaves(dy)
        grads = torch.autograd.grad(outs, inputs, couts, allow_unused=True)
        n_sp = len(sp_req)
        g_sp = [torch.zeros_like(p) if g is None else g
                for p, g in zip(sp_req, grads[:n_sp])]
        g_sh = (list(grads[n_sp:n_sp + len(sh_req)]) if first or last
                else [None] * len(sh_l))
        dx = None
        if not first:
            dx = tree.unflatten(tree.flatten(x_in)[1],
                                list(grads[len(grads) - len(x_req):]))
        return (tree.unflatten(sp_def, g_sp), g_sh, dx, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    def _schedule(self, shared, stage_p, split, fault: bool):
        """This rank's share of the 1F1B tables over ``split`` (its local
        block): (stage grad sums, shared grad sums, raw loss sum, metric
        sums, fault). After a fault the rank's sends carry zeros and its
        work is skipped; it still waits on every receive."""
        S, s = self.stages, self.stage_index
        n_s = next(iter(split.values())).shape[0]
        fwd, bwd, _, ticks = schedule_1f1b(S, n_s)
        carry_t, metrics_t = self._templates_for(shared, split)
        accum = self.plan.accum_dtype
        acc_stage = exec_core.init_accum(stage_p, accum)
        acc_shared = [None] * len(tree.leaves(shared))
        loss_acc = torch.zeros((), device=self.device)
        metric_acc = tree.map(lambda m: torch.zeros(m.shape, device=self.device),
                              metrics_t)
        ends = s == 0 or s == S - 1  # the stages that use shared leaves
        prev, nxt = self.mesh.rank - 1, self.mesh.rank + 1
        resid: Dict[int, Any] = {}
        arriving: Dict[int, Any] = {}
        cots: Dict[int, Any] = {}
        outbox: List = []
        for t in range(ticks):
            # post this tick's receives: the neighbours send them now
            if s > 0 and fwd[t, s - 1] >= 0:
                arriving[int(fwd[t, s - 1])] = self._post_recv(
                    carry_t, prev, "fwd_recv")
            if s < S - 1 and bwd[t, s + 1] >= 0:
                cots[int(bwd[t, s + 1])] = self._post_recv(
                    carry_t, nxt, "bwd_recv")
            j = int(bwd[t, s])
            if j >= 0:
                mb = _micro(split, j)
                x_in = resid.pop(j) if s > 0 else None
                dy = self._take(cots.pop(j), carry_t) if s < S - 1 else None
                out = None
                if not fault:
                    out, fault = _oom_of(self._backward, shared, stage_p,
                                         x_in, mb, dy)
                if fault:
                    dx = self._zeros(carry_t) if s > 0 else None
                    if not self.defer_sync:  # zeros join the reduction
                        g_sp = tree.map(torch.zeros_like, stage_p)
                        g_sh = ([torch.zeros_like(p)
                                 for p in tree.leaves(shared)]
                                if ends else [])
                else:
                    g_sp, g_sh, dx, loss, metrics = out
                    g_sh = ([torch.zeros_like(p) if g is None else g
                             for p, g in zip(tree.leaves(shared), g_sh)]
                            if ends else [])
                    loss_acc = loss_acc + loss.float()
                    metric_acc = {k: metric_acc[k] + metrics[k].float()
                                  for k in metric_acc}
                del out, x_in, dy
                if not self.defer_sync:  # the per-micro baseline
                    g_sp, g_sh = self._data_sum((g_sp, g_sh))
                if not fault:
                    acc_stage = exec_core.accumulate(acc_stage, g_sp)
                    for k, g in enumerate(g_sh):
                        g = g.to(accum)
                        acc_shared[k] = (g if acc_shared[k] is None
                                         else acc_shared[k].add_(g))
                g_sp = g_sh = None
                if s > 0:
                    self._send(dx, prev, "bwd_send", outbox)
                del dx
            i = int(fwd[t, s])
            if i >= 0:
                x_in = None
                if s > 0:
                    x_in = self._take(arriving.pop(i), carry_t)
                    resid[i] = x_in
                if s < S - 1:
                    y = None
                    if not fault:
                        y, fault = _oom_of(self._forward, shared, stage_p,
                                           x_in, _micro(split, i))
                    if fault:
                        y = self._zeros(carry_t)
                    self._send(y, nxt, "fwd_send", outbox)
                    del y
                del x_in
        for work, _ in outbox:
            work.wait()
        acc_shared = [torch.zeros(p.shape, dtype=accum, device=self.device)
                      if a is None or fault else a
                      for p, a in zip(tree.leaves(shared), acc_shared)]
        if fault:
            acc_stage = exec_core.init_accum(stage_p, accum)
            loss_acc = torch.zeros((), device=self.device)
            metric_acc = self._zeros(metric_acc)
        return acc_stage, acc_shared, loss_acc, metric_acc, fault

    def _data_sum(self, t):
        """One data-axis all-reduce of a tree (none on a line of one)."""
        if self.dp < 2:
            return t
        return psum_flat(t, self.data_mesh, axis=mesh_lib.DATA_AXIS)

    # -- the step -----------------------------------------------------------

    def _synced(self, params, split, fault: bool = False):
        """(normalized local grads, loss, metrics, grad_norm, ok): the
        schedule, then the gradient reductions (see the module doc). ``ok``
        is the guard's flag (None without the guard)."""
        sh_dims, st_dims = self._layout["dims"]
        sh_l, st_l = self._split_local(params)
        if self.fsdp:
            sh_l = [self._gather(x, d, self.data_mesh)
                    for x, d in zip(sh_l, sh_dims)]
            st_l = [self._gather(x, d, self.data_mesh)
                    for x, d in zip(st_l, st_dims)]
        sh_def, st_def = self._layout["treedefs"]
        shared = tree.unflatten(sh_def, sh_l)
        stage_p = tree.unflatten(st_def, st_l)
        acc_stage, acc_shared, loss, msum, fault = self._schedule(
            shared, stage_p, split, fault)
        del shared, stage_p, sh_l, st_l
        g_st = tree.leaves(acc_stage)
        s0, d0 = self.stage_index == 0, self.replica == 0
        last = self.stage_index == self.stages - 1
        sq = torch.zeros((), device=self.device)  # Σ g² this rank adds
        bad = torch.zeros((), device=self.device)  # non-finite grads seen
        if self.fsdp:
            whole = [k for k, d in enumerate(st_dims) if d is None]
            summed = self._data_sum([g_st[k] for k in whole])
            for k, g in zip(whole, summed):
                g_st[k] = g
            g_st = [g if d is None else self._scatter(g, d)
                    for g, d in zip(g_st, st_dims)]
            acc_shared = psum_flat(acc_shared, self.model_mesh,
                                   axis=mesh_lib.MODEL_AXIS)
            whole = [k for k, d in enumerate(sh_dims) if d is None]
            summed = self._data_sum([acc_shared[k] for k in whole])
            for k, g in zip(whole, summed):
                acc_shared[k] = g
            acc_shared = [g if d is None else self._scatter(g, d)
                          for g, d in zip(acc_shared, sh_dims)]
            # a shard counts once; a leaf held whole on several ranks, on
            # one of them
            for g, d in zip(g_st, st_dims):
                if d is not None or d0:
                    sq = sq + _sq(g)
            for g, d in zip(acc_shared, sh_dims):
                if s0 and (d is not None or d0):
                    sq = sq + _sq(g)
            if self.guard:
                bad = bad + (~exec_core.finite_all(g_st + acc_shared)).float()
            valid = _local_valid_count(split) if last and not fault else \
                torch.zeros((), device=self.device)
            loss, msum, valid, sq, bad, slots = psum_flat(
                (loss, msum, valid, sq, bad, self._slots(fault)), self.mesh,
                axis="data+model")
        else:
            if self.defer_sync:
                g_st = self._data_sum(g_st)  # the ONE data-axis all-reduce
            else:  # per-micro: the data axis was summed each backward;
                # the shared contributions still cross the stages
                acc_shared = psum_flat(acc_shared, self.model_mesh,
                                       axis=mesh_lib.MODEL_AXIS)
            if d0:
                sq = sq + sum(_sq(g) for g in g_st)
            if self.guard:
                bad = bad + (~exec_core.finite_all(g_st)).float()
            valid = _local_valid_count(split) if last and not fault else \
                torch.zeros((), device=self.device)
            shared_part = acc_shared if self.defer_sync else []
            # the ONE (data+model) all-reduce
            shared_part, loss, msum, valid, sq, bad, slots = psum_flat(
                (shared_part, loss, msum, valid, sq, bad,
                 self._slots(fault)), self.mesh, axis="data+model")
            if self.defer_sync:
                acc_shared = shared_part
            sq = sq + sum(_sq(g) for g in acc_shared)
            if self.guard:
                bad = bad + (~exec_core.finite_all(acc_shared)).float()
        raise_agreed(slots)
        scale = 1.0 / valid
        grads = self._join_local(
            [(g * scale).to(g.dtype) for g in acc_shared],
            [(g * scale).to(g.dtype) for g in g_st])
        n_s = next(iter(split.values())).shape[0]
        metrics = {k: m / (self.dp * n_s) for k, m in msum.items()}
        ok = (bad == 0) if self.guard else None
        return grads, loss * scale, metrics, torch.sqrt(sq) * scale, ok

    def _slots(self, fault: bool) -> torch.Tensor:
        return fault_slots(fault, self.mesh.rank, self.dp * self.stages,
                           self.device)

    def make_train_step(self) -> Callable:
        """``(params, opt_state, split) -> (params, opt_state, metrics)``
        over this rank's state and block: :meth:`step_split`."""
        return self.step_split

    def step_split(self, params, opt_state, micro_batches
                   ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One mini-batch over this rank's block of a split batch on the
        device; the update writes into the state's own buffers."""
        if self._layout is None:
            raise ValueError("PipelinedExecutor.step_split takes the state "
                             "prepare() made (this rank's layout)")
        _, fault = _oom_of(faults.on_dispatch, self.plan, self.mesh.rank)
        grads, loss, metrics, gnorm, ok = self._synced(
            params, micro_batches, fault)
        if self.guard:
            new_p, new_o, ok = exec_core.guarded_update(
                self.optimizer, grads, opt_state, params, ok=ok)
        else:
            new_p, new_o = exec_core.apply_update(self.optimizer, grads,
                                                  opt_state, params)
        out = exec_core.finalize_metrics(metrics, loss, grads, ok,
                                         grad_norm=gnorm)
        del grads
        # write the update into the state's buffers, leaf by leaf
        new, _ = tree.flatten((new_p, new_o))
        del new_p, new_o
        for i, old in enumerate(tree.leaves((params, opt_state))):
            old.copy_(new[i])
            new[i] = None
        return params, opt_state, out

    def step(self, params, opt_state, minibatch
             ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One mini-batch from the global host mini-batch."""
        return self.step_split(params, opt_state,
                               self.stage(self.plan.split(minibatch)))

    def gradients(self, params, micro_batches):
        """This rank's accumulated NORMALIZED gradients (its layout:
        :meth:`gather_tree` recombines them) and the mini-batch loss under
        the 1F1B schedule."""
        grads, loss, _, _, _ = self._synced(params, micro_batches)
        return grads, loss


_TAGS = {"fwd_send": 0, "fwd_recv": 0, "bwd_send": 1, "bwd_recv": 1}


def _over_state(opt_state, params, shaped: Callable, other: Callable):
    """``opt_state`` with ``shaped`` applied to each subtree shaped like
    ``params`` (a moment) and ``other`` to each leaf of the rest (the
    step); a None entry stays None."""
    p_def = tree.flatten(params)[1]
    return {k: None if v is None
            else shaped(v) if tree.flatten(v)[1] == p_def
            else tree.map(other, v)
            for k, v in opt_state.items()}


def _sq(g) -> torch.Tensor:
    return torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
