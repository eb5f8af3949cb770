"""The port's side of the pipeline-parallel conformance cases, run on
every rank of a ``repro_torch.launch.world.LocalWorld`` (gloo ranks on
the CPU).

This module imports no JAX and nothing of the JAX package: the ranks are
spawned processes that import it by name. Each case takes numpy inputs
(the reference's parameters and batches), builds this rank's ``(data,
model)`` mesh over the world (``launch.mesh.pipeline_mesh``), runs the
port's ``PipelinedExecutor`` and returns numpy results in the reference's
format (``gather_tree`` / ``gather_state``), with the collective census
the case's step issued (``engine.collective_stats``).
"""
import numpy as np
import torch

from repro_torch import engine, tree, weights
from repro_torch.core import losses
from repro_torch.engine import faults
from repro_torch.launch import mesh as mesh_lib

from torch_mesh_cases import TINY_OPT, make_opt, to_np

STAGED_NUM_LAYERS = 4


def staged_spec() -> engine.StagedLoss:
    """``conftest.staged_spec`` in PyTorch: tanh(x @ w_in), then the
    stacked ``mid`` layers, then a cross-entropy head (raw sum)."""
    def prelude(shared, mb):
        return torch.tanh(mb["x"] @ shared["w_in"])

    def stage_fn(stage_p, x):
        for w in stage_p.unbind(0):
            x = torch.tanh(x @ w)
        return x

    def finale(shared, x, mb):
        logits = x @ shared["w_out"]
        return losses.cross_entropy(
            logits, mb["y"], sample_weight=mb.get("sample_weight"),
            exact_denom=1.0), {}

    return engine.StagedLoss(num_layers=STAGED_NUM_LAYERS, prelude=prelude,
                             stage_fn=stage_fn, finale=finale,
                             stacked_key="mid")


def leaked_modules(mesh):
    """The JAX and JAX-package modules loaded on this rank once this
    module (the pipelined executor) is loaded and a pipeline mesh built
    (none should be)."""
    import sys
    mesh_lib.pipeline_mesh(mesh, 1, mesh_lib.world_size())
    return sorted(k for k in sys.modules if k.startswith("jax")
                  or k == "repro" or k.startswith("repro."))


def _tensors(split_np):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in split_np.items()}


def _executor(mesh, plan, data, stages, spec=None, opt_spec=TINY_OPT, **kw):
    pmesh = mesh_lib.pipeline_mesh(mesh, data, stages)
    return engine.PipelinedExecutor(spec or staged_spec(),
                                    make_opt(opt_spec), plan, mesh=pmesh,
                                    **kw)


def _state(ex, params_np):
    params = weights.from_reference(params_np, "cpu")
    return ex.prepare(params, ex.optimizer.init(params))


def _census():
    st = engine.collective_stats()
    return {"all_reduce": st["calls"], "by_axis": st["by_axis"],
            "all_gather": st["all_gather"],
            "reduce_scatter": st["reduce_scatter"], "p2p": st["p2p"]}


def gradients(mesh, data, stages, plan, params_np, split_np, fsdp=False):
    """The normalized gradients (reference format) and loss of the 1F1B
    schedule over the global split (this rank keeps its block), and the
    census of the step's collectives."""
    ex = _executor(mesh, plan, data, stages, fsdp=fsdp)
    params, _ = _state(ex, params_np)
    engine.reset_collective_stats()
    g, loss = ex.gradients(params, ex.shard(_tensors(split_np)))
    census = _census()
    return to_np(ex.gather_tree(g)), float(loss), census


def step(mesh, data, stages, plan, params_np, split_np, fsdp=False,
         defer_sync=True):
    """One pipelined step: (params, optimizer state, metrics, census),
    the state in the reference's format."""
    ex = _executor(mesh, plan, data, stages, fsdp=fsdp,
                   defer_sync=defer_sync)
    params, state = _state(ex, params_np)
    engine.reset_collective_stats()
    params, state, m = ex.step_split(params, state,
                                     ex.shard(_tensors(split_np)))
    census = _census()
    p, s = ex.gather_state(params, state)
    return (to_np(p), to_np({k: v for k, v in s.items() if v is not None}),
            {k: float(v) for k, v in m.items()}, census)


def trajectory(mesh, data, stages, plan, params_np, splits_np):
    """The losses of one step per split (the golden staged trajectory)."""
    ex = _executor(mesh, plan, data, stages)
    params, state = _state(ex, params_np)
    out = []
    for split_np in splits_np:
        params, state, m = ex.step_split(params, state,
                                         ex.shard(_tensors(split_np)))
        out.append(float(m["loss"]))
    return out


def aliasing(mesh, data, stages, plan, params_np, split_np, fsdp=False):
    """The donation contract: this rank's state bytes beside
    ``donated_state_bytes`` of the reference-format state, and whether
    the update kept every leaf's storage."""
    ex = _executor(mesh, plan, data, stages, fsdp=fsdp)
    full = weights.from_reference(params_np, "cpu")
    full_state = ex.optimizer.init(full)
    floor = ex.donated_state_bytes(full, full_state)
    params, state = ex.prepare(full, full_state)
    leaves = tree.leaves((params, state))
    held = sum(x.numel() * x.element_size() for x in leaves)
    ptrs = [x.data_ptr() for x in leaves]
    params, state, _ = ex.step_split(params, state,
                                     ex.shard(_tensors(split_np)))
    kept = [x.data_ptr() for x in tree.leaves((params, state))] == ptrs
    return held, floor, kept


def staged_lm(mesh, data, stages, cfg, plan, params_np, split_np):
    """``steps.make_staged_loss`` of a transformer config, pipelined: the
    normalized gradients (reference format) and the loss, in fp32."""
    from repro_torch.launch import steps
    spec = steps.make_staged_loss(cfg, torch.float32,
                                  remat_policy=plan.remat_policy)
    ex = _executor(mesh, plan, data, stages, spec=spec,
                   opt_spec=("sgd", {"lr": 0.05, "momentum": 0.9,
                                     "weight_decay": 5e-4}))
    params, _ = _state(ex, params_np)
    g, loss = ex.gradients(params, ex.shard(_tensors(split_np)))
    return to_np(ex.gather_tree(g)), float(loss)


def launcher_mesh(mesh, spec):
    """The launcher's ``build_mesh`` for ``--mesh spec`` on this rank:
    (axes, data extent, model extent, the ranks of its data and model
    lines), or the error's words."""
    import argparse
    import torch.distributed as dist
    from repro_torch.launch import train
    args = argparse.Namespace(mesh=spec, multi_pod=False, fsdp=False)
    try:
        m = train.build_mesh(args, "cpu")
    except ValueError as e:
        return str(e)
    lines = [dist.get_process_group_ranks(m.groups[a])
             for a in (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS)
             if a in m.groups]
    return (dict(m), mesh_lib.data_parallel_size(m),
            mesh_lib.axis_size(m, mesh_lib.MODEL_AXIS), lines)


PLAN_FIELDS = ("mini_batch_size", "micro_batch_size", "num_micro_batches",
               "pad", "normalization", "remat_policy", "data_parallel",
               "local_micro", "pipeline_stages")


class _SplitDataset:
    """Host mini-batches from a list (batch ``i`` = ``batches[i]``)."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, batch_size, seed):
        return {k: v.copy() for k, v in self.batches[seed].items()}


def supervised(mesh, data, stages, plan, specs, params_np, batches_np,
               sharded=False):
    """A supervised run under the fault plan ``specs`` over a
    ``PipelinedExecutor`` (or, with ``sharded``, a data-parallel
    ``ShardedExecutor`` of the staged loss's flat twin): the records, the
    faults fired, the final plan, the losses, the final state (reference
    format), the all-reduces of each completed step and the seconds."""
    import time
    spec = staged_spec()
    if sharded:
        def loss_fn(p, mb, exact_denom=None):
            x = spec.stage_fn(p["mid"], spec.prelude(p, mb))
            logits = x @ p["w_out"]
            return losses.cross_entropy(
                logits, mb["y"], sample_weight=mb.get("sample_weight"),
                exact_denom=exact_denom), {}
        pmesh = mesh
    else:
        pmesh = mesh_lib.pipeline_mesh(mesh, data, stages)
    ds = _SplitDataset(batches_np)
    calls = []

    def build(p):
        if sharded:
            ex = engine.ShardedExecutor(loss_fn, make_opt(TINY_OPT), p,
                                        mesh=pmesh, guard=True)
        else:
            ex = engine.PipelinedExecutor(spec, make_opt(TINY_OPT), p,
                                          mesh=pmesh, guard=True)

        def step_fn(params, state, batch):
            engine.reset_collective_stats()
            out = ex.step_split(params, state, batch)
            calls.append(engine.collective_stats()["calls"])
            return out
        return ex, step_fn, engine.Pipeline(ds, p, prefetch=0, device="cpu",
                                            sharding=ex.shard)

    sup = engine.Supervisor(build, plan, log_fn=None,
                            writer=mesh.rank == 0)
    full = weights.from_reference(params_np, "cpu")
    state = make_opt(TINY_OPT).init(full)
    ex = sup.executor
    params, state = (ex.prepare(full, state) if not sharded
                     else (full, state))
    t0 = time.perf_counter()
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        params, state, _ = sup.fit(params, state, len(batches_np))
    seconds = time.perf_counter() - t0
    if not sharded:
        params, state = sup.executor.gather_state(params, state)
    return {"records": [(r.kind, r.step, r.action, r.steps_lost)
                        for r in sup.records],
            "fired": list(fp.fired),
            "plan": {f: getattr(sup.plan, f) for f in PLAN_FIELDS},
            "history": dict(sup.history), "params": to_np(params),
            "opt_state": to_np({k: v for k, v in state.items()
                                if v is not None}),
            "calls": calls, "seconds": seconds}


def bundle_step(mesh, arch, mini, n_micro):
    """``steps.build_train_step`` of reduced ``arch`` on a 1 × 2 pipeline
    mesh (fp32, seq 32): one step of the bundle's ``fn`` from the
    executor's ``prepare``, and one of the single-device ``compiled``
    bundle on the same batch — the two losses."""
    from repro_torch import configs
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    cfg = configs.get_reduced(arch)
    shape = InputShape("tiny", "train", 32, mini)
    kw = dict(num_microbatches=n_micro, dtype=torch.float32,
              budget_bytes=1 << 34, device="cpu")
    batch = LMDataset(cfg.vocab_size, 32, seed=0).batch(mini, 0)
    out = []
    for m in (mesh_lib.pipeline_mesh(mesh, 1, 2), None):
        bundle = steps.build_train_step(cfg, shape, mesh=m, **kw)
        params = steps.init_params(cfg, seed=0, device="cpu")
        state = bundle.optimizer.init(params)
        if m is not None:
            ex = bundle.fn.__self__
            params, state = ex.prepare(params, state)
            split = ex.stage(bundle.plan.split(batch))
        else:
            split = bundle.plan.device_split(batch, "cpu")
        _, _, metrics = bundle.fn(params, state, split)
        out.append(float(metrics["loss"]))
    return out
