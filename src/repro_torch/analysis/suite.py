"""The contract-check suite over real (config × executor × mesh ×
remat-policy) combinations — what ``python -m repro_torch.analysis``
runs, and what ``launch/dryrun.py --check`` calls into (the reference's
``analysis/suite.py``).

Targets are REAL shipped configurations at analysis scale (reduced model
configs, sequence 32, mini-batch 32 in 4 micro-batches, the reference's
geometry), built from seed 0 and run for one real step through the
executor the launcher would build: the point is to check the actual
machinery, not toy stand-ins. The step runs once under the recorder
(``engine.steptrace.measure``); the trace rules (JX) and the step rules
(HLO) read that one run.

Meshes: ``"single"`` (this process), ``"host"`` (a ``launch.world``
``LocalWorld`` of ``ranks`` spawned processes on the data axis: the
sharded deferred-sync contract) and ``"DATA:MODEL"`` (a world of
DATA × MODEL ranks; MODEL > 1 runs the 1F1B pipeline's contracts). In a
world every rank checks its own step and the reports are merged.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch

from .. import configs, engine, optim, tree
from ..core import memory_model
from ..engine import exec_core
from ..launch import mesh as mesh_lib, steps
from . import lint as lint_mod, step_checks, trace_checks
from .findings import Report

#: analysis-scale geometry (the reference's): small enough to run in
#: seconds, micro size divisible by the test worlds
ANALYSIS_SEQ = 32
ANALYSIS_BATCH = 32
ANALYSIS_MICROS = 4

#: default HLO003 tolerance: the uncalibrated analytic model is far from
#: an eager step's peak at reduced sizes, so the tripwire is an
#: order-of-magnitude gate, not a calibration test (the reference's 16)
MEMORY_TOLERANCE = 16.0


class Target:
    """One analyzable training configuration: ``build(executor, mesh,
    remat_policy, device)`` returns its artifacts (see
    :func:`_build_transformer`)."""

    def __init__(self, name: str, build: Callable, *, remat_capable: bool,
                 stageable: bool = False):
        self.name = name
        self.build = build
        self.remat_capable = remat_capable
        #: factors into prelude/stage/finale for the pipelined path —
        #: decoder-only stacks only
        self.stageable = stageable


def _build_transformer(arch: str, executor: str, mesh, remat_policy,
                       device):
    cfg = configs.get_reduced(arch)
    optimizer = steps.make_optimizer(cfg)
    pipelined = (mesh is not None
                 and mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS) > 1)
    mm_kw = optim.memory_model_kw(optimizer, fused=executor == "flat")
    plan = engine.plan_mbs(
        ANALYSIS_BATCH, num_microbatches=ANALYSIS_MICROS, model_cfg=cfg,
        seq_len=ANALYSIS_SEQ, remat=remat_policy != "none",
        remat_policy=remat_policy, mesh=mesh, pipeline=pipelined,
        fsdp_params=pipelined or mesh is None, device=device, **mm_kw)
    params = steps.init_params(cfg, seed=0, device=device)
    batch = steps.family_batch(cfg, ANALYSIS_SEQ, ANALYSIS_BATCH)
    modeled = memory_model.estimate(
        cfg, ANALYSIS_SEQ, remat_policy=plan.remat_policy, mesh=mesh,
        fsdp_params=pipelined or mesh is None, pipeline=pipelined,
        **mm_kw).total(plan.local_micro if mesh is not None
                       else plan.micro_batch_size)
    built = dict(loss_fn=steps.make_loss_fn(cfg, torch.bfloat16,
                                            remat_policy=plan.remat_policy),
                 optimizer=optimizer, plan=plan, params=params,
                 batch=batch, modeled_bytes=modeled)
    if pipelined:
        built["staged"] = steps.make_staged_loss(
            cfg, torch.bfloat16, remat_policy=plan.remat_policy)
    return built


def _build_resnet(executor: str, mesh, remat_policy, device):
    import numpy as np
    from ..configs import resnet50
    from ..core import losses
    from ..models import cnn

    del remat_policy  # the CNN loss has no checkpoint lattice: always none
    rcfg = resnet50.reduced()
    params, state = cnn.resnet_init(
        0, num_classes=rcfg.num_classes, stage_sizes=rcfg.stage_sizes,
        width=rcfg.width, device=device)
    optimizer = optim.sgd(1e-2, momentum=0.9, weight_decay=5e-4)
    plan = engine.plan_mbs(ANALYSIS_BATCH, num_microbatches=ANALYSIS_MICROS,
                           remat=False, mesh=mesh, fsdp_params=mesh is None,
                           device=device)

    def loss_fn(p, b, exact_denom=None):
        # frozen BN (paper §4.2.2 eval-mode semantics): state closed over
        logits, _ = cnn.resnet_forward(p, state, b["image"],
                                       stage_sizes=rcfg.stage_sizes,
                                       train=False)
        return losses.cross_entropy(
            logits, b["label"], sample_weight=b.get("sample_weight"),
            exact_denom=exact_denom), {}

    rng = np.random.default_rng(0)
    n, s, c = ANALYSIS_BATCH, rcfg.image_size, rcfg.in_channels
    batch = {"image": rng.standard_normal((n, s, s, c), np.float32),
             "label": rng.integers(0, rcfg.num_classes, n).astype(np.int32)}
    return dict(loss_fn=loss_fn, optimizer=optimizer, plan=plan,
                params=params, batch=batch, modeled_bytes=None)


TARGETS: Dict[str, Target] = {
    "qwen2_reduced": Target(
        "qwen2_reduced",
        functools.partial(_build_transformer, "qwen2-1.5b"),
        remat_capable=True, stageable=True),
    "mamba2_reduced": Target(
        "mamba2_reduced",
        functools.partial(_build_transformer, "mamba2-780m"),
        remat_capable=True, stageable=True),
    "resnet50": Target(
        "resnet50", _build_resnet, remat_capable=False),
}


def resolve_mesh(mesh: Any, ranks: int = 2):
    """``None``/``"single"`` → None (one process); ``"host"`` → ``(ranks,
    1)``; ``"DATA:MODEL"`` → ``(DATA, MODEL)``; a tuple passes through."""
    if mesh is None or mesh == "single":
        return None
    if mesh == "host":
        return (int(ranks), 1)
    if isinstance(mesh, str):
        if mesh == "production":
            raise ValueError(
                "the contract suite has no production mesh: the "
                "reference's resolve_mesh takes 'single', 'host' and "
                "'DATA:MODEL' only; the production mesh's contract gate is "
                "the dry run's (launch.dryrun --mesh production --check)")
        data, _, model = mesh.partition(":")
        if not (data.isdigit() and model.isdigit()):
            raise ValueError(f"bad mesh spec {mesh!r}: 'single', 'host' "
                             "or 'DATA:MODEL'")
        return (int(data), int(model))
    return tuple(mesh)


def make_executor(built: Dict[str, Any], executor: str, mesh):
    """The executor for one built target: pipelined on a mesh with a
    model axis, sharded on a data axis, else the named one."""
    if built.get("staged") is not None:
        return engine.PipelinedExecutor(
            built["staged"], built["optimizer"], built["plan"], mesh=mesh)
    if mesh is not None:
        return engine.ShardedExecutor(built["loss_fn"], built["optimizer"],
                                      built["plan"], mesh=mesh,
                                      inner=executor)
    return engine.get_executor(executor)(built["loss_fn"],
                                         built["optimizer"], built["plan"])


def _state(ex, built, device):
    """(params, opt_state, split) as the launcher hands them to the step:
    in the executor's layout (``prepare``), the split staged on the
    device (this rank's block on a mesh)."""
    params = built["params"]
    opt_state = built["optimizer"].init(params)
    plan = built["plan"]
    if isinstance(ex, (engine.ShardedExecutor, engine.PipelinedExecutor)):
        params, opt_state = ex.prepare(params, opt_state)
        split = ex.stage(plan.split(built["batch"]))
    else:
        if hasattr(ex, "prepare"):
            params, opt_state = ex.prepare(params, opt_state)
        split = steps.device_split(plan, built["batch"], device)
    return params, opt_state, split


def _context(target, executor, plan, dims) -> Dict[str, Any]:
    return {"target": target, "executor": executor,
            "mesh": "single" if dims is None else
            f"dp={dims[0]}" + (f",pp={dims[1]}" if dims[1] > 1 else ""),
            "remat_policy": plan.remat_policy,
            "num_micro_batches": int(plan.num_micro_batches)}


#: the measured-step layer (``step_checks``), which ``hlo=False`` skips
HLO_RULES = ("HLO001", "HLO002", "HLO003", "HLO004", "HLO005")


def check_step(target: str, executor: str, *, mesh=None, dims=None,
               remat_policy: Optional[str] = None, device="cpu",
               memory_tolerance: float = MEMORY_TOLERANCE,
               hlo: bool = True) -> Report:
    """Build one target, run one recorded step on this process (a rank of
    ``mesh`` when given) and check it. ``hlo=False`` records the step
    only (``trace_step``) and runs the trace rules (JX) without the
    measured layer (HLO001–HLO005, named in ``context["skipped_rules"]``),
    as the reference's ``--no-hlo`` skips its compile."""
    spec = TARGETS[target]
    if remat_policy is None:
        remat_policy = "period" if spec.remat_capable else "none"
    built = spec.build(executor, mesh, remat_policy, device)
    plan = built["plan"]
    ex = make_executor(built, executor, mesh)
    params, opt_state, split = _state(ex, built, device)
    if hlo:
        run = ex.measure_step(params, opt_state, split)
        trace = run.trace
    else:
        run, trace = None, ex.trace_step(params, opt_state, split)
    report = Report(context=_context(target, executor, plan, dims))
    ctx = f"{target}/{executor}"
    n_micro = int(plan.num_micro_batches)
    sync = "none" if mesh is None else "deferred"
    if built.get("staged") is not None:
        stages = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        world = stages * mesh_lib.data_parallel_size(mesh)
        mb = {k: v[0] for k, v in split.items()}
        shared = {k: v for k, v in params.items()
                  if k != built["staged"].stacked_key}
        carry = exec_core.abstract_call(built["staged"].prelude, shared, mb)
        per = len(tree.leaves(carry))
        report.merge(trace_checks.check_pipelined_step(
            trace, plan, params, stages=stages, rank=mesh.rank, world=world,
            leaves_per_transfer=per, expect_sync=sync))
        if hlo:
            max_p2p = per * sum(engine.p2p_counts(
                stages, n_micro, mesh.rank % stages).values())
            report.extend(step_checks.check_pipeline_step(
                run, expect=sync, n_micro=n_micro, stages=stages,
                rank=mesh.rank, world=world, max_p2p=max_p2p,
                context=ctx), "HLO005")
    else:
        report.merge(trace_checks.check_train_step(
            trace, plan, params, expect_sync=sync))
        if hlo:
            report.extend(step_checks.check_gradient_sync(
                run, expect=sync, n_micro=n_micro, context=ctx), "HLO004")
    report.context["kernel_launches"] = sum(
        1 for c in trace.kernels if c.launched and c.device == "cuda")
    if not hlo:
        report.context["skipped_rules"] = list(HLO_RULES)
        return report
    report.extend(step_checks.check_aliasing(
        run, in_place=ex.updates_in_place, n_micro=n_micro, context=ctx),
        "HLO001")
    report.extend(step_checks.check_unexpected_ops(run, context=ctx),
                  "HLO002")
    report.extend(step_checks.check_memory_model(
        run, built["modeled_bytes"], tolerance=memory_tolerance,
        context=ctx), "HLO003")
    report.context["peak_bytes"] = run.peak_bytes
    report.context["peak_source"] = run.peak_source
    return report


def _rank_check(mesh, target, executor, dims, remat_policy,
                memory_tolerance, hlo=True):
    """One rank of a world: its own step's report, as a dict."""
    if dims[1] > 1:
        mesh = mesh_lib.pipeline_mesh(mesh, dims[0], dims[1])
    rep = check_step(target, executor, mesh=mesh, dims=dims,
                     remat_policy=remat_policy, device=mesh.device,
                     memory_tolerance=memory_tolerance, hlo=hlo)
    return rep.to_dict()


def _from_dict(d: Dict[str, Any]) -> Report:
    from .findings import Finding
    rep = Report(context=dict(d["context"]),
                 checks_run=list(d["checks_run"]))
    rep.findings = [Finding(**f) for f in d["findings"]]
    return rep


def run_suite(target: str = "qwen2_reduced", *, executor: str = "flat",
              mesh: Any = None, remat_policy: Optional[str] = None,
              lint: bool = True, memory_tolerance: float = MEMORY_TOLERANCE,
              device="cpu", ranks: int = 2, world=None,
              hlo: bool = True) -> Report:
    """One configuration's step, recorded and checked by every applicable
    rule (and the lint, once). On a mesh the step runs on every rank of
    a ``LocalWorld`` (``world``, or one of ``DATA × MODEL`` ranks started
    here) and each rank's findings are merged, tagged with the rank.
    ``hlo=False`` (``--no-hlo``) runs the trace rules and the lint only
    (:func:`check_step`)."""
    spec = TARGETS[target]
    dims = resolve_mesh(mesh, ranks)
    if dims is not None and dims[1] > 1 and not spec.stageable:
        return Report(context={
            "target": target, "executor": executor,
            "mesh": f"dp={dims[0]},pp={dims[1]}",
            "skipped": "target does not factor into pipeline stages "
                       "(decoder-only stacks only)"})
    if dims is None or dims[0] * dims[1] < 2:
        report = check_step(target, executor, remat_policy=remat_policy,
                            device=device, memory_tolerance=memory_tolerance,
                            hlo=hlo)
    else:
        from ..launch.world import LocalWorld
        n = dims[0] * dims[1]
        own = world is None
        if own:
            world = LocalWorld(n, device=str(torch.device(device).type),
                               timeout_s=300)
        elif world.n != n:
            raise ValueError(f"mesh {dims} needs {n} ranks; the world has "
                             f"{world.n}")
        try:
            dicts = world.run(_rank_check, target, executor, dims,
                              remat_policy, memory_tolerance, hlo)
        finally:
            if own:
                world.close()
        report = _from_dict(dicts[0])
        for r, d in enumerate(dicts[1:], 1):
            other = _from_dict(d)
            for f in other.findings:
                report.findings.append(type(f)(
                    f.rule, f.severity, f"rank {r}: {f.message}",
                    f.location, f.details))
        report.context["ranks"] = n
    if lint:
        report.extend(lint_mod.lint_repo(), "LINT")
    return report


def check_bundle(bundle, *, run=None, modeled_bytes: Optional[int] = None,
                 lint: bool = False,
                 memory_tolerance: float = MEMORY_TOLERANCE) -> Report:
    """Contract checks over a ``launch/steps.StepBundle``'s step — the
    ``dryrun --check`` entry. ``run`` is the caller's recorded step (a
    ``StepRun``, a dry run's included): the trace rules read its trace,
    HLO001 its storages (for an executor that updates in place) and
    HLO003 its peak."""
    report = Report(context={"kind": bundle.kind,
                             "executor": bundle.executor or "?"})
    if bundle.kind == "train" and bundle.plan is not None and run is not None:
        ex = bundle.runner
        report.merge(trace_checks.check_train_step(
            run.trace, bundle.plan, bundle.arg_shapes[0], expect_sync="none"))
        report.extend(step_checks.check_aliasing(
            run, in_place=getattr(ex, "updates_in_place", False),
            n_micro=int(bundle.plan.num_micro_batches),
            context=bundle.kind), "HLO001")
        report.extend(step_checks.check_memory_model(
            run, modeled_bytes, tolerance=memory_tolerance,
            context=bundle.kind), "HLO003")
    if lint:
        report.extend(lint_mod.lint_repo(), "LINT")
    return report


#: the rules one rank of a production dry run cannot feed, and why
GSPMD_REFUSED = {
    rule: ("it reads the recorded op trace of one process's step; a "
           "production rank's step runs as DTensor ops on a fake world, "
           "which the recorder (engine.steptrace) does not follow")
    for rule in ("JX001", "JX002", "JX003")}
GSPMD_REFUSED["HLO001"] = (
    "it reads the state's storages across a recorded step, which a "
    "production rank's DTensor step does not give")


def check_gspmd_rank(collectives: Dict[str, Any], mesh, *, peak_bytes: int,
                     modeled_bytes: Optional[int],
                     memory_tolerance: float = MEMORY_TOLERANCE,
                     fsdp: bool = True) -> Report:
    """``dryrun --check`` on the production mesh, over what one rank's
    run gives: its census of collectives (JX004's GSPMD form in the
    params' placement, ``trace_checks.check_gspmd_collectives``: FSDP's
    reduce-scatter, or with ``fsdp=False`` an all-reduce over the batch
    axes and no weight gathered over them) and its peak against
    ``modeled_bytes``, the caller's ``memory_model.estimate(mesh=,
    fsdp_params=fsdp)`` (HLO003). The rules it cannot feed are named in
    ``context["refused"]``, never passed."""
    report = Report(context={"kind": "train", "mesh": dict(mesh),
                             "fsdp": fsdp,
                             "refused": dict(GSPMD_REFUSED)})
    report.extend(trace_checks.check_gspmd_collectives(collectives, mesh,
                                                       fsdp=fsdp),
                  "JX004")
    report.extend(step_checks.check_memory_model(
        int(peak_bytes), modeled_bytes, tolerance=memory_tolerance,
        context="train"), "HLO003")
    return report


#: the rules one prefill or decode rank of a production dry run cannot
#: feed, and why
GSPMD_SERVE_REFUSED = {
    **{rule: GSPMD_REFUSED[rule] for rule in ("JX001", "JX002", "JX003")},
    "SRV002": ("the serve memory model (memory_model.serve_estimate) "
               "plans data-parallel slots of a whole model, not a rank's "
               "blocks of a cache split over the production mesh")}


def check_gspmd_serve_rank(collectives: Dict[str, Any], mesh, *, kind: str,
                           cache_kept: Optional[bool]) -> Report:
    """``dryrun --check`` of a prefill or decode rank on the production
    mesh: JX004's GSPMD form over its census (collectives on the mesh's
    axes only; no gradients, so no reduce-scatter is asked for) and, for
    decode, SRV001 over its cache (every block written in place). The
    rules it cannot feed are named in ``context["refused"]``."""
    from . import serve_checks
    report = Report(context={"kind": kind, "mesh": dict(mesh),
                             "refused": dict(GSPMD_SERVE_REFUSED)})
    report.extend(trace_checks.check_gspmd_collectives(
        collectives, mesh, train=False), "JX004")
    if kind == "decode":
        report.extend(serve_checks.check_cache_kept(
            bool(cache_kept), context="decode"), "SRV001")
    else:
        report.context["refused"]["SRV001"] = (
            "a prefill builds its cache; there is no pool to keep")
    return report
