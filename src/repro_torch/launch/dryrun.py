"""Dry run of one (architecture × input shape) step: the step the launcher
would run, built by ``launch.steps.build_step`` and run once under a
``FakeTensorMode`` — shapes and dtypes only, so nothing is allocated on
either device, full-size configurations included. The reference
compiles the same step for its production mesh; the port runs it on one
device, or with ``--mesh production`` (``--multi-pod``) as one rank of
the production GSPMD mesh: a fake world of 256 (512) ranks in this
process, the state cut to the rank's blocks (:func:`_production`) — a
train step, or a prefill or decode step placed as the reference's dry
run places it (the params by ``param_specs``, the cache and the tokens
by ``cache_specs``; :func:`_production_serve`).

What it reports (one JSON line; the reference's keys where they carry a
meaning):

  * ``memory`` — the step's live-bytes peak (``engine.steptrace``: every
    storage counted from its allocation to its release), split into the
    arguments alive before the step and the temporaries above them, and
    the state bytes the step updated in place — the counterpart of the
    compiled step's ``memory_analysis()``;
  * ``raw_cost_analysis`` — the step's FLOPs (``torch.utils.flop_counter.
    FlopCounterMode``: matmuls, convolutions and attention) and the bytes
    its ops read and write, the whole mini-batch's. ``corrected`` carries
    the same totals under the reference's keys, with the FLOPs of one
    period of the layer pattern from two one-micro-batch probes at 1 and
    2 periods, and their linear extrapolation to the whole step beside
    the total;
  * ``per_device`` / ``oracle`` — the planner's report: the plan
    (``plan_mbs``), ``memory_model.estimate`` at its micro size beside
    the measured peak, ``max_minibatch_without_mbs``;
  * ``pipeline`` — for a ``--mesh DATA:MODEL`` spec with MODEL > 1, the
    closed-form 1F1B census and the per-stage bytes (the step itself runs
    only on one device);
  * ``contract`` (``--check``) — the analysis suite's checks over this
    run (``analysis.check_bundle``; on the production mesh
    ``analysis.check_gspmd_rank``: the census's collectives and HLO003,
    the rules that read one process's op trace refused by name).

An eager step needs no trip counts: its micro-batch loop runs every
micro-batch. But a fake tensor op costs about a fifth of a millisecond
of host time, and a full-size step of N_Smu micro-batches runs hundreds
of thousands of them, so by default the step runs its first one and its
first two micro-batches (the plan's size) and the difference is carried
to all N — exact, as the micro-batches repeat one another op for op:
X(N) = X(1) + (N − 1) · (X(2) − X(1)) for the FLOPs, bytes, ops and
kernel calls, and the peak is the second's (the live set after each
micro-batch is the same from the first on). ``run_dryrun(...,
unrolled=True)`` runs all N; the tests hold the two equal for every
executor.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      [--reduced] [--microbatches 8] [--executor flat] [--budget GB] \\
      [--check] [--no-probe] [--device cuda|cpu] [--json] [--out DIR]
      [--mesh production] [--multi-pod] [--no-fsdp]

Exit codes (shared with ``python -m repro_torch.analysis``): 0 ok, 1 tool
error (a refused mesh; an op whose output shape depends on the data,
which a fake tensor cannot run — named; ``--check`` rules the run
cannot feed, named), 2 the peak over ``--budget``, 3 contract findings
(``--check``). The production mesh is gated as one device is: its
budget on the rank's peak. The step runs for the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import torch

from .. import configs, engine, optim, tree
from ..analysis.findings import (EXIT_BUDGET, EXIT_CONTRACT, EXIT_ERROR,
                                 EXIT_OK)
from ..core import memory_model
from ..engine import steptrace
from . import mesh as mesh_lib, sharding, steps

#: the planner's budget on a device that has none of its own (the CPU):
#: one H100's memory, the card the dry run stands in for
CARD_BYTES = 80 * 10 ** 9


class DataDependentOp(RuntimeError):
    """The step reached an op whose output shape depends on tensor
    values, which no fake tensor can run."""


def _fakes(meta_tree, device):
    """Fake tensors of ``meta_tree``'s shapes and dtypes on ``device``
    (inside the caller's ``FakeTensorMode``)."""
    return tree.map(lambda m: torch.empty(tuple(m.shape), dtype=m.dtype,
                                          device=device)
                    if isinstance(m, torch.Tensor) else m, meta_tree)


def _fake_step(bundle, device, micros: Optional[int] = None):
    """Run ``bundle``'s step once on fake arguments: (StepRun or trace,
    FLOPs). A train bundle's state is first put in its executor's layout
    (``prepare``), as the launcher does; ``micros`` cuts its split batch
    to that many micro-batches of the plan's size."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException,
                                               FakeTensorMode)
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FakeTensorMode(allow_non_fake_inputs=False):
            args = _fakes(bundle.arg_shapes, device)
            if bundle.kind == "train":
                prepare = getattr(bundle.runner, "prepare", None)
                params, opt_state, batch = args
                if micros is not None:
                    batch = {k: v[:micros] for k, v in batch.items()}
                if prepare is not None:
                    params, opt_state = prepare(params, opt_state)
                del args
                with FlopCounterMode(display=False) as fc:
                    run = steptrace.measure(bundle.fn, params, opt_state,
                                            batch)
                return run, fc.get_total_flops()
            with FlopCounterMode(display=False) as fc:
                trace = steptrace.record(bundle.fn, *args, device="cpu")
            return trace, fc.get_total_flops()
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        raise DataDependentOp(
            f"{bundle.kind} step of this config reaches an op whose output "
            f"shape depends on the data, which a fake tensor cannot run: "
            f"{e}") from None


def _probe_cfg(cfg, periods: int):
    kw = {"num_layers": cfg.pattern_len * periods}
    if cfg.is_encdec:
        kw["encoder_layers"] = (cfg.encoder_layers // cfg.num_periods
                                ) * periods
    return dataclasses.replace(cfg, **kw)


def cost_probes(cfg, shape, num_microbatches: int, device, *,
                step_kw) -> Dict[str, Any]:
    """FLOPs of one period of the layer pattern in one micro-batch (the
    planner's size): the difference of two fake steps of that
    micro-batch at 1 and 2 periods."""
    pshape = (dataclasses.replace(
        shape, global_batch=-(-shape.global_batch // num_microbatches))
        if shape.kind == "train" else shape)
    flops = {}
    for P in (1, 2):
        bundle = steps.build_step(_probe_cfg(cfg, P), pshape,
                                  num_microbatches=1, **step_kw)
        _, flops[P] = _fake_step(bundle, device)
    per_period = flops[2] - flops[1]
    return {"flops_probe_1_period": flops[1],
            "flops_probe_2_periods": flops[2],
            "flops_per_period": per_period}


def _kernel_calls(trace) -> Dict[str, int]:
    """The step's calls of each kernel wrapper, by kernel."""
    calls: Dict[str, int] = {}
    for c in trace.kernels:
        calls[c.name] = calls.get(c.name, 0) + 1
    return calls


def _production(cfg, shape, *, multi_pod: bool, pinned, device,
                step_kw, fsdp: bool = True) -> Dict[str, Any]:
    """One rank's view of the step on the production mesh: a fake
    world of 256 (512 with the pod axis) ranks in this process (every
    collective returns at once), the step built for the GSPMD mesh
    (``fsdp_over_pod`` with the pod axis, as the reference's dry run;
    ``fsdp=False`` replicates the params over the batch axes, and a
    prefill or decode shape ignores it, as the reference's does),
    its state cut to rank 0's blocks and run under a ``FakeTensorMode``
    — nothing allocated. A prefill or decode shape goes to
    :func:`_production_serve`. The census
    (``engine.CollectiveCensus(local=True)``) counts the rank's local
    FLOPs, the peak of its live local bytes and its collectives by kind
    and axis; the first micro-batch and the first two are run and the
    difference carried to all N, as for one device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    world = 512 if multi_pod else 256
    mesh_lib.fake_world(world, rank=0)
    try:
        mesh = mesh_lib.make_production_mesh(
            multi_pod=multi_pod, world_mesh=mesh_lib.Mesh(
                {mesh_lib.DATA_AXIS: world, mesh_lib.MODEL_AXIS: 1},
                device=device, backend="fake"))
        if shape.kind != "train":
            return _production_serve(cfg, shape, mesh, world, device,
                                     step_kw)
        over_pod = multi_pod and fsdp
        bundle = steps.build_step(cfg, shape, num_microbatches=pinned,
                                  mesh=mesh, fsdp=fsdp,
                                  fsdp_over_pod=over_pod, **step_kw)
        ex, plan = bundle.runner, bundle.plan
        runs = []
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the whole shape, which the census would count; a
        # first step fills its cache and is not counted
        for micros in [1] + sorted({1, min(2, plan.num_micro_batches)}):
            with FakeTensorMode(allow_non_fake_inputs=False):
                params, opt_state, batch = _fakes(bundle.arg_shapes, device)
                batch = {k: v[:micros] for k, v in batch.items()}
                params, opt_state = ex.prepare(params, opt_state)
                local_bytes = ex.local_param_bytes(params)
                census = engine.CollectiveCensus(mesh, local=True)
                census.see(*tree.leaves((params, opt_state, batch)))
                with census:
                    bundle.fn(params, opt_state, batch)
                runs.append(census)
                del params, opt_state, batch
        n = plan.num_micro_batches
        one, two = runs[1], runs[-1]
        collectives = _census_report(one, two, n)
        return {
            "world": world, "mesh": dict(mesh), "rank": mesh.rank,
            "coords": mesh.coords(), "kind": "train",
            "fsdp": fsdp, "fsdp_over_pod": over_pod,
            "local_param_bytes": local_bytes,
            "flops": (one.flops + (n - 1) * (two.flops - one.flops)
                      if two is not one else one.flops),
            "peak_bytes": two.peak_bytes, "collectives": collectives,
            "plan": plan.describe(), "num_micro_batches": n,
            "local_micro": plan.local_micro,
            "remat_policy": plan.remat_policy, "bundle": bundle}
    finally:
        mesh_lib.shutdown()


def _census_report(one, two, n: int) -> Dict[str, Any]:
    """The collectives of ``n`` repeats from a census of the first
    (``one``) and of the first two (``two``; ``one`` again for n = 1)."""
    def extend(a, b):
        return a + (n - 1) * (b - a) if two is not one else a

    def by_kind(c1, c2):
        kinds = {}
        for kind in sorted(set(c1) | set(c2)):
            axes = set(c1.get(kind, {})) | set(c2.get(kind, {}))
            kinds[kind] = {ax: extend(c1.get(kind, {}).get(ax, 0),
                                      c2.get(kind, {}).get(ax, 0))
                           for ax in sorted(axes)}
        return kinds

    kinds = by_kind(one.counts, two.counts)
    return {"by_kind_and_axis": kinds,
            "params_by_kind_and_axis": by_kind(one.param_counts,
                                               two.param_counts),
            "bytes_by_kind": {k: extend(one.bytes.get(k, 0),
                                        two.bytes.get(k, 0))
                              for k in sorted(set(one.bytes)
                                              | set(two.bytes))},
            "largest_by_kind": {k: max(one.largest.get(k, 0),
                                       two.largest.get(k, 0))
                                for k in sorted(set(one.largest)
                                                | set(two.largest))},
            "calls": sum(sum(v.values()) for v in kinds.values())}


def _production_serve(cfg, shape, mesh, world: int, device, step_kw
                      ) -> Dict[str, Any]:
    """One rank's prefill or decode on the production mesh
    (``steps.GspmdServe``: the params placed by ``param_specs``, the
    cache and the tokens by ``cache_specs``, as the reference's dry
    run places them), run twice under a ``FakeTensorMode``: the first
    fills DTensor's propagation cache, the second runs under the census
    (its FLOPs, the peak of its live local bytes, its collectives by kind
    and axis). The local bytes of the params and of the cache (a decode's
    input, a prefill's output) are the rank's blocks."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bundle = steps.build_step(cfg, shape, mesh=mesh,
                              remat_policy=step_kw.get("remat_policy"))
    serve = bundle.runner
    census = None
    for counted in (False, True):
        with FakeTensorMode(allow_non_fake_inputs=False):
            placed = serve.prepare(*_fakes(bundle.arg_shapes, device))
            param_bytes = sharding.local_bytes(placed[0])
            run = engine.CollectiveCensus(mesh, local=counted)
            run.see(*[x.to_local() for x in tree.leaves(placed)])
            before = steptrace.state_storages(
                [x.to_local() for x in tree.leaves(placed[2])]
                if bundle.kind == "decode" else [])
            with run:
                out = bundle.fn(*placed)
            if counted:
                census = run
            cache = (out[1] if isinstance(out, tuple) else None)
            cache_bytes = (sharding.local_bytes(cache)
                           if cache is not None else 0)
            kept = (steptrace.state_storages(
                [x.to_local() for x in tree.leaves(cache)]) == before
                if bundle.kind == "decode" else None)
            logits = out[0] if isinstance(out, tuple) else out
            logits_local = tuple(logits.to_local().shape)
            del placed, out, cache, logits
    return {
        "world": world, "mesh": dict(mesh), "rank": mesh.rank,
        "coords": mesh.coords(), "kind": bundle.kind,
        "fsdp": True, "fsdp_over_pod": False,
        "local_param_bytes": param_bytes,
        "local_cache_bytes": cache_bytes, "cache_kept": kept,
        "logits_local_shape": list(logits_local),
        "flops": census.flops, "peak_bytes": census.peak_bytes,
        "collectives": _census_report(census, census, 1),
        "bundle": bundle}


def _production_report(arch, shape_name, cfg, shape, g, device, t_step,
                       plan_budget, executor, verbose, budget_bytes=None,
                       check=False):
    """The production run's report: the one-device report's keys where
    one rank gives them, its ``budget`` gate on the rank's peak and, with
    ``check``, ``analysis.check_gspmd_rank`` over the rank's census
    (JX004 in the step's placement) and peak against ``estimate(mesh=,
    fsdp_params=)`` of that placement. A prefill or decode rank's report
    is :func:`_production_serve_report`'s."""
    if g["kind"] != "train":
        return _production_serve_report(arch, shape_name, g, device, t_step,
                                         verbose, budget_bytes, check)
    bundle = g.pop("bundle")
    plan = bundle.plan
    mm_kw = dict(remat_policy=plan.remat_policy, act_bytes=2,
                 **optim.memory_model_kw(bundle.optimizer,
                                         fused=executor == "flat"))
    est = memory_model.estimate(cfg, shape.seq_len, mesh=g["mesh"],
                                fsdp_params=g["fsdp"], **mm_kw)
    peak = g["peak_bytes"]
    modeled = est.total(plan.local_micro)
    contract = None
    if check:
        from .. import analysis
        contract = analysis.check_gspmd_rank(
            g["collectives"], g["mesh"], peak_bytes=peak,
            modeled_bytes=modeled, fsdp=g["fsdp"]).to_dict()
    result = {
        "arch": arch, "shape": shape_name, "mesh": list(g["mesh"].values()),
        "axes": list(g["mesh"]), "mesh_dims": list(g["mesh"].items()),
        "kind": "train", "num_devices": g["world"], "device": device.type,
        "num_microbatches": g["num_micro_batches"],
        "remat_policy": plan.remat_policy,
        "remat_policy_auto": plan.auto_policy,
        "per_device": {
            "data_parallel": plan.data_parallel,
            "local_micro": plan.local_micro,
            "micro_batch_global": plan.micro_batch_size,
            "budget_bytes": plan_budget,
            "analytic_bytes_at_local_micro": modeled,
            "params_bytes": est.params_bytes, "plan": plan.describe()},
        "oracle": {"local_micro": plan.local_micro,
                   "modeled_bytes": modeled, "measured_bytes": peak,
                   "model_error_pct": (round(100.0 * (modeled - peak) / peak,
                                             2) if peak else None)},
        "gspmd": g,
        "budget": ({"budget_bytes": budget_bytes,
                    "measured_peak_bytes": peak,
                    "over_budget": peak > budget_bytes}
                   if budget_bytes is not None else None),
        "contract": contract,
        "raw_cost_analysis": {"flops": float(g["flops"])},
        "memory": {"peak_bytes_est": peak,
                   "source": "live local tensor bytes of one rank"},
        "step_s": round(t_step, 2), "skipped": False}
    if verbose:
        print(json.dumps(result))
    return result


def _production_serve_report(arch, shape_name, g, device, t_step,
                             verbose, budget_bytes=None, check=False):
    """A prefill or decode rank's report: the one-device report's keys
    where one rank gives them, the ``budget`` gate on the rank's peak
    and, with ``check``, ``analysis.check_gspmd_serve_rank`` over its
    census and its cache's storages."""
    g.pop("bundle")
    peak = g["peak_bytes"]
    contract = None
    if check:
        from .. import analysis
        contract = analysis.check_gspmd_serve_rank(
            g["collectives"], g["mesh"], kind=g["kind"],
            cache_kept=g["cache_kept"]).to_dict()
    result = {
        "arch": arch, "shape": shape_name, "mesh": list(g["mesh"].values()),
        "axes": list(g["mesh"]), "mesh_dims": list(g["mesh"].items()),
        "kind": g["kind"], "num_devices": g["world"], "device": device.type,
        "per_device": {"params_bytes": g["local_param_bytes"],
                       "cache_bytes": g["local_cache_bytes"]},
        "gspmd": g,
        "budget": ({"budget_bytes": budget_bytes,
                    "measured_peak_bytes": peak,
                    "over_budget": peak > budget_bytes}
                   if budget_bytes is not None else None),
        "contract": contract,
        "raw_cost_analysis": {"flops": float(g["flops"])},
        "memory": {"peak_bytes_est": peak,
                   "source": "live local tensor bytes of one rank"},
        "step_s": round(t_step, 2), "skipped": False}
    if verbose:
        print(json.dumps(result))
    return result


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               num_microbatches: Optional[int] = 8,
               reduced: bool = False, probe: bool = True,
               verbose: bool = True, remat: bool = True,
               remat_policy: Optional[str] = None,
               cfg_overrides: Optional[dict] = None,
               executor: str = "compiled",
               budget_bytes: Optional[int] = None, check: bool = False,
               mesh_spec: Optional[str] = None, device="cuda",
               calibrate: str = "off", tuning_cache: Optional[str] = None,
               unrolled: bool = False,
               plan_budget_bytes: Optional[int] = None,
               fsdp: bool = True) -> Dict[str, Any]:
    """Dry-run one combo and return its report (printed as one JSON line
    when ``verbose``). ``budget_bytes`` is the over-budget gate (exit 2
    in :func:`main`); the planner plans against ``plan_budget_bytes``,
    by default the card's memory (on the CPU, ``CARD_BYTES``).
    ``unrolled`` runs every micro-batch of the step instead of extending
    the first two (see the module doc). ``mesh_spec="production"`` (or
    ``multi_pod``) dry-runs the step on the production GSPMD mesh
    (:func:`_production`); there ``fsdp=False`` (``--no-fsdp``)
    replicates a train step's params over the batch axes. Elsewhere, and
    on serve shapes, ``fsdp`` changes nothing: the one-device step and
    its probes hold whole params, and a pipelined mesh's report follows
    the pipeline's own default, as the reference's dry run ignores its
    specs there."""
    device = torch.device(device)
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = configs.SHAPES[shape_name]
    if not configs.supports_shape(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic attention"}
    dims = (1, 1)
    production = multi_pod or mesh_spec == "production"
    if mesh_spec and not production:
        data, _, model = mesh_spec.partition(":")
        dims = (int(data), int(model))
    mesh = (mesh_lib.make_host_mesh(data=dims[0], model=dims[1])
            if dims != (1, 1) else None)
    pipelined = shape.kind == "train" and dims[1] > 1
    plan_budget = plan_budget_bytes or (
        memory_model.device_memory_bytes(device) if device.type == "cuda"
        else CARD_BYTES)
    pinned = (num_microbatches if num_microbatches is not None
              and num_microbatches > 0 else None)
    step_kw: Dict[str, Any] = {}
    if shape.kind == "train":
        step_kw = dict(remat=remat, remat_policy=remat_policy,
                       executor=executor, budget_bytes=plan_budget,
                       device=device, calibrate=calibrate,
                       tuning_cache=tuning_cache)
    t0 = time.perf_counter()
    if production:
        g = _production(cfg, shape, multi_pod=multi_pod, pinned=pinned,
                        device=device, step_kw=step_kw, fsdp=fsdp)
        return _production_report(arch, shape_name, cfg, shape, g, device,
                                  time.perf_counter() - t0, plan_budget,
                                  executor, verbose,
                                  budget_bytes=budget_bytes, check=check)
    bundle = steps.build_step(cfg, shape, num_microbatches=pinned,
                              **step_kw)
    plan = bundle.plan
    n_micro = plan.num_micro_batches if plan is not None else None
    measured = n_micro
    if plan is not None and not unrolled and n_micro > 2:
        # the micro-batches of a step repeat exactly: run 1 and 2 of them
        # and extend the difference to all N (see the module doc)
        one, f1 = _fake_step(bundle, device, micros=1)
        out, f2 = _fake_step(bundle, device, micros=2)
        measured = 2
        flops = f1 + (n_micro - 1) * (f2 - f1)
        nbytes = one.trace.bytes_accessed + (n_micro - 1) * (
            out.trace.bytes_accessed - one.trace.bytes_accessed)
        n_ops = len(one.trace.ops) + (n_micro - 1) * (
            len(out.trace.ops) - len(one.trace.ops))
        k1, k2 = _kernel_calls(one.trace), _kernel_calls(out.trace)
        kernel_calls = {k: k1.get(k, 0) + (n_micro - 1)
                        * (k2.get(k, 0) - k1.get(k, 0))
                        for k in sorted(set(k1) | set(k2))}
        del one
    else:
        out, flops = _fake_step(bundle, device)
    t_step = time.perf_counter() - t0
    run = out if isinstance(out, steptrace.StepRun) else None
    trace = run.trace if run is not None else out
    if measured == n_micro:
        nbytes, n_ops = trace.bytes_accessed, len(trace.ops)
        kernel_calls = _kernel_calls(trace)
    peak = trace.peak_live_bytes
    state_bytes, kept = run.kept_bytes() if run is not None else (0, 0)

    per_device = oracle = pipeline_rep = grad_sync = None
    if plan is not None:
        mm_kw = dict(remat_policy=plan.remat_policy, act_bytes=2,
                     **optim.memory_model_kw(bundle.optimizer,
                                             fused=executor == "flat"))
        est = memory_model.estimate(cfg, shape.seq_len, **mm_kw)
        micro = plan.micro_batch_size
        without = memory_model.max_minibatch_without_mbs(
            cfg, shape.seq_len, budget_bytes=plan_budget, **mm_kw)
        per_device = {
            "data_parallel": 1, "local_micro": micro,
            "micro_batch_global": micro, "budget_bytes": plan_budget,
            "analytic_bytes_at_local_micro": est.total(micro),
            "params_bytes": est.params_bytes,
            "activation_bytes_per_local_sample":
                est.activation_bytes_per_sample,
            "max_minibatch_without_mbs": without,
            "plan": plan.describe()}
        modeled = est.total(micro)
        oracle = {"local_micro": micro, "modeled_bytes": modeled,
                  "measured_bytes": peak,
                  "model_error_pct": (round(100.0 * (modeled - peak) / peak,
                                            2) if peak else None)}
        census = trace.collective_census().get("all_reduce", {})
        grad_sync = {"allreduce_ops": census.get("count", 0),
                     "allreduce_bytes": census.get("bytes", 0),
                     "num_microbatches": n_micro}
        if mesh is not None:
            mesh_plan = engine.plan_mbs(
                shape.global_batch, num_microbatches=pinned, model_cfg=cfg,
                seq_len=shape.seq_len, budget_bytes=plan_budget,
                device=device, remat=remat,
                remat_policy=plan.remat_policy, mesh=mesh,
                fsdp_params=pipelined, pipeline=pipelined)
            mest = memory_model.estimate(
                cfg, shape.seq_len, mesh=mesh, fsdp_params=pipelined,
                pipeline=pipelined, remat_policy=mesh_plan.remat_policy)
            per_device.update({
                "data_parallel": mesh_plan.data_parallel,
                "local_micro": mesh_plan.local_micro,
                "micro_batch_global": mesh_plan.micro_batch_size,
                "analytic_bytes_at_local_micro":
                    mest.total(mesh_plan.local_micro),
                "mesh_plan": mesh_plan.describe()})
            if pipelined:
                stages, M = dims[1], mesh_plan.num_micro_batches
                fwd, bwd, _, ticks = engine.schedule_1f1b(stages, M)
                pipeline_rep = {
                    "stages": stages, "data_parallel": dims[0],
                    "periods_per_stage": cfg.num_periods // stages,
                    "num_micro_batches": M, "ticks": int(ticks),
                    "in_flight_micro_batches": min(stages, M),
                    "per_stage": {
                        "params_bytes": mest.params_bytes,
                        "activation_bytes_per_sample":
                            mest.activation_bytes_per_sample,
                        "bytes_at_local_micro":
                            mest.total(mesh_plan.local_micro)},
                    "expected_collectives": {
                        "p2p_by_stage": [engine.p2p_counts(stages, M, s)
                                         for s in range(stages)],
                        "all_reduce_data_axis": 1 if dims[0] > 1 else 0,
                        "all_reduce_data_model": 1}}

    over_budget = budget_bytes is not None and peak > budget_bytes
    contract = None
    if check:
        from .. import analysis
        contract = analysis.check_bundle(
            bundle, run=run,
            modeled_bytes=oracle["modeled_bytes"] if oracle else None
        ).to_dict()

    result = {
        "arch": arch, "shape": shape_name, "mesh": list(dims),
        "axes": [mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS],
        "kind": bundle.kind, "num_devices": 1, "device": device.type,
        "num_microbatches": n_micro,
        "remat_policy": plan.remat_policy if plan is not None else None,
        "remat_policy_auto": plan.auto_policy if plan is not None else None,
        "per_device": per_device,
        "gradient_sync": grad_sync,
        "pipeline": pipeline_rep,
        "oracle": oracle,
        "budget": ({"budget_bytes": budget_bytes,
                    "measured_peak_bytes": peak,
                    "over_budget": over_budget}
                   if budget_bytes is not None else None),
        "contract": contract,
        "raw_cost_analysis": {"flops": float(flops),
                              "bytes accessed": float(nbytes)},
        "memory": {
            "argument_bytes": trace.base_live_bytes,
            "temp_bytes": peak - trace.base_live_bytes,
            "alias_bytes": kept, "state_bytes": state_bytes,
            "peak_bytes_est": peak, "source": "live tensor bytes"},
        "collectives_raw_once": trace.collective_census(),
        "ops": n_ops, "micro_batches_run": measured,
        "kernel_calls": kernel_calls,
        "step_s": round(t_step, 2),
        "skipped": False,
    }
    if probe:
        corr = cost_probes(cfg, shape, n_micro or 1, device,
                           step_kw=step_kw)
        corr.update({"flops_per_device": float(flops),
                     "bytes_per_device": float(nbytes),
                     "collectives": {}, "collective_bytes_total": 0})
        result["corrected"] = corr
    if verbose:
        print(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--shape", required=True, choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (a train step's "
                         "FSDP over (pod, data))")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate a train step's params over the data "
                         "axis of the production mesh (no per-micro-batch "
                         "weight all-gathers; only for models whose "
                         "optimizer state fits)")
    ap.add_argument("--mesh", default=None, metavar="DATA:MODEL",
                    help="report the mesh-aware plan (and, with MODEL > 1, "
                         "the 1F1B census and per-stage bytes) for this "
                         "host mesh; 'production' runs the step as one "
                         "rank of the 16x16 GSPMD mesh")
    ap.add_argument("--microbatches", type=int, default=8,
                    help="N_Smu for train shapes; 0 = auto micro-batch "
                         "size from the memory model")
    ap.add_argument("--executor", choices=sorted(engine.EXECUTORS),
                    default="compiled")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (full width)")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy",
                    choices=["auto", "none", "dots", "period", "full"],
                    default=None)
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="MoE capacity factor override")
    ap.add_argument("--budget", type=float, default=None, metavar="GB",
                    help="per-device budget in GiB; exits 2 when the "
                         "step's peak exceeds it")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="the planner's per-device budget in GiB "
                         "(default: the card's memory)")
    ap.add_argument("--calibrate", choices=["off", "auto", "force"],
                    default="off",
                    help="the planner's memory oracle (on the card)")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH")
    ap.add_argument("--check", action="store_true",
                    help="run the contract checks "
                         "(repro_torch.analysis.check_bundle) over this "
                         "run's step; findings exit 3")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the device the step's "
                         "fake tensors stand on")
    ap.add_argument("--json", action="store_true",
                    help="print the JSON report to stdout also when "
                         "--out is set")
    ap.add_argument("--out", default=None, help="directory for the JSON "
                                                "artifact")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available here; pass "
                 "--device cpu to run on the CPU")

    overrides = {}
    if args.layers is not None:
        overrides["num_layers"] = args.layers
    if args.capacity_factor is not None:
        overrides["capacity_factor"] = args.capacity_factor
    budget_bytes = (int(args.budget * 1024 ** 3)
                    if args.budget is not None else None)
    try:
        res = run_dryrun(args.arch, args.shape, multi_pod=args.multi_pod,
                         num_microbatches=args.microbatches,
                         reduced=args.reduced, probe=not args.no_probe,
                         verbose=args.out is None or args.json,
                         remat=not args.no_remat,
                         remat_policy=args.remat_policy,
                         cfg_overrides=overrides or None,
                         executor=args.executor, budget_bytes=budget_bytes,
                         check=args.check, mesh_spec=args.mesh,
                         device=device, calibrate=args.calibrate,
                         tuning_cache=args.tuning_cache,
                         fsdp=not args.no_fsdp,
                         plan_budget_bytes=(
                             int(args.hbm_budget_gb * 1024 ** 3)
                             if args.hbm_budget_gb else None))
    except (NotImplementedError, ValueError, DataDependentOp) as e:
        print(f"dryrun: {args.arch} / {args.shape}: {e}", file=sys.stderr)
        return EXIT_ERROR
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = ("multi" if args.multi_pod else "production"
               if args.mesh == "production" else "single")
        path = os.path.join(args.out,
                            f"{args.arch}__{args.shape}__{tag}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {path}")

    # the exit-code contract shared with ``python -m repro_torch.analysis``
    exit_code = EXIT_OK
    b = res.get("budget")
    if b and b["over_budget"]:
        print(f"BUDGET EXCEEDED: peak "
              f"{b['measured_peak_bytes'] / 1024 ** 3:.2f} GiB > budget "
              f"{b['budget_bytes'] / 1024 ** 3:.2f} GiB "
              f"({args.arch} / {args.shape}) — raise --budget or shrink the "
              "micro-batch", file=sys.stderr)
        exit_code = EXIT_BUDGET
    contract = res.get("contract")
    if contract and contract.get("findings"):
        for f in contract["findings"]:
            print(f"CONTRACT: [{f.get('rule')}] {f.get('message')}",
                  file=sys.stderr)
        if exit_code == EXIT_OK:
            exit_code = EXIT_CONTRACT
    refused = (contract or {}).get("context", {}).get("refused")
    if refused:
        for rule, why in refused.items():
            print(f"CONTRACT: [{rule}] not checked on this mesh: {why}",
                  file=sys.stderr)
        if exit_code == EXIT_OK:
            exit_code = EXIT_ERROR
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
