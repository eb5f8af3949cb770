"""Training launcher of the port — the JAX package's ``launch/train.py``
on one device or a data-parallel world of ranks.

Plans the batch geometry (``--microbatches`` pins N_Sμ; without it the
memory model sizes the micro-batch against the device's memory or
``--hbm-budget-gb``, corrected by the tuning cache's measured fit under
``--calibrate auto`` and measured anew under ``--calibrate force``),
builds the executor and drives it through the async
input pipeline: ``LMDataset`` batches are drawn and plan-split in a
background worker (batch ``i`` with seed ``i``), staged host→device on a
copy stream (double-buffered at mini-batch granularity), and the
``Trainer`` owns the step loop — metrics read back one step late,
periodic checkpointing, ``--resume``. It runs on CUDA unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --steps 4 --executor compiled|streaming|fused|flat \
      --device cpu [--ckpt-dir /tmp/ckpt --ckpt-every 2 [--resume]]

On the card, ``--calibrate force --tuning-cache PATH`` (no
``--microbatches``) measures the step's peak at micro-batches 1, 2 and 4
before it plans.

With ``--supervise`` the runtime (executor and pipeline) is built through
the rebuild factory :func:`make_build` and driven by
:class:`engine.Supervisor` instead of the bare Trainer: the executors run
with the on-device finite guard, an out-of-memory step degrades the plan
(remat escalation, then a calibrated or halved micro-batch; with
``--hbm-budget-gb`` the failure is recorded as a negative bound in the
tuning cache) and resumes from the last completed state, non-finite
steps are retried or skipped per ``--on-nan``, and the supervisor's
give-ups exit with the reference's codes: 41 restart budget
(``--max-restarts``) exceeded, 42 nothing left to degrade, 43 too many
non-finite steps in a row, 44 a non-finite step under ``--on-nan halt``
(40 is their base class).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --steps 4 --device cpu --supervise [--max-restarts 3] \
      [--on-nan skip|halt]

Data parallelism: under torchrun every rank runs this launcher, and
``--mesh host`` (the default: the whole world on the data axis) or an
explicit ``--mesh DATA:1`` with DATA the world size routes the step
through :class:`engine.ShardedExecutor` (per-rank accumulation of
``local_micro`` samples of every micro-batch with ``--executor``'s
strategy, ONE gradient all-reduce per mini-batch). Each rank runs on
``cuda:LOCAL_RANK`` over NCCL when the host has a card for every rank,
or all on ``cuda:0`` over gloo when they share one card (each capped at
an equal share of its memory, which is also its planning budget); the
chosen backend is printed. Rank 0 plans (``plan_mbs(mesh=...)``, budget
per device) and broadcasts the plan, every rank draws the same global
mini-batch and stages its own block, rank 0 alone prints metrics and
writes checkpoints, and every rank restores the same file on
``--resume``. ``--report PATH`` writes each rank's numbers (losses,
readback clocks, all-reduce census and seconds, kernel launches, peak
memory beside the per-device estimate) to ``PATH.rank<r>.json``.

  torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \
      --arch qwen2-1.5b --reduced --steps 4 --mesh 2:1 --executor flat \
      [--device cpu]

Pipeline parallelism: ``--mesh DATA:MODEL`` with MODEL > 1 (and DATA ×
MODEL the world size) routes the step through
:class:`engine.PipelinedExecutor`, as the reference's launcher does —
rank ``r`` is stage ``r % MODEL`` of replica ``r // MODEL``, the block
stack is cut into MODEL stages of a 1F1B schedule over the plan's
micro-batches (``plan_mbs(pipeline=True)``), and ``--executor`` is
ignored. ``--fsdp`` (accepted only on such a mesh, with the reference's
parse-time error otherwise) also shards params over the data axis. Each
rank holds its stage's leaves; checkpoints stay in the reference's
format: every rank gathers the whole state, rank 0 writes it, and each
rank restores its own slice. ``--supervise`` composes with both.

  torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \
      --arch qwen2-1.5b --reduced --steps 4 --mesh 1:2 [--device cpu]

A VLM (``--arch qwen2-vl-72b``) trains text-only, as the JAX package's
launcher feeds it: no patch embeddings, plain RoPE. An encoder-decoder
(``--arch seamless-m4t-medium``) is refused before anything is
allocated: its loss reads frames, which ``LMDataset`` does not make (the
reference's launcher fails on the same batch).

The production meshes: ``--mesh production`` (``--multi-pod``) on a
world of exactly 256 (512) ranks is the reference's GSPMD mesh, 16×16
(2×16×16): params, gradients and optimizer state split by its
``param_specs`` (tensor-parallel over ``model``, FSDP over ``data``;
over ``(pod, data)`` with ``--multi-pod``), the activations by the
model's shard hints, ``--executor`` (``compiled``, ``fused`` or
``flat``; ``streaming`` is refused, as the reference refuses it) run on
each rank's blocks by :class:`engine.GspmdExecutor`. At any other world
size it exits naming the size it needs. ``--supervise`` composes with it
as with the other meshes: the finite flag is reduced over the whole
mesh before the update, and a one-rank out-of-memory error is agreed by
every rank, also one raised between two of the model's collectives
(``engine.GspmdExecutor``'s module doc); checkpoints are the reference's
format.

Not ported: ``--no-donate``. The
launcher keeps no reference to the initial params and optimizer state
once the Trainer (or the Supervisor) has them, so an executor whose
update makes new trees (``compiled``, ``fused``, ``streaming``) frees
them after the first step; ``flat`` trains its initial buffers in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from .. import configs, engine, kernels, optim
from ..core import memory_model
from ..data import LMDataset
from . import mesh as mesh_lib
from . import steps

GIB = 1024 ** 3

ENCDEC_NOTE = (
    "--arch {arch} is an encoder-decoder: its loss reads frames and target "
    "tokens (mb['frames'], mb['tgt_tokens']), but this launcher's "
    "LMDataset yields tokens only, as the JAX package's launcher's does "
    "(so neither launcher trains it); drive an executor with "
    "launch.steps.family_batch instead")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth to this many layers "
                         "(default: the config's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mini-batch", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="pin N_Smu (default: auto micro-batch size from "
                         "the memory model)")
    ap.add_argument("--executor", choices=sorted(engine.EXECUTORS),
                    default="compiled")
    ap.add_argument("--normalization", choices=["paper", "exact"],
                    default="paper")
    ap.add_argument("--remat-policy",
                    choices=["auto", "none", "dots", "period", "full"],
                    default="auto",
                    help="activation-checkpoint grade; auto = the planner "
                         "picks it jointly with the micro-batch size")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="memory budget for auto micro-batch sizing "
                         "(default: the device's total memory)")
    ap.add_argument("--calibrate", choices=["off", "auto", "force"],
                    default="auto",
                    help="measured admission (engine.autotune): auto = "
                         "use a cached memory correction when one exists "
                         "(analytic otherwise); force = run the probe "
                         "steps now on the card and persist the fit; off "
                         "= analytic only")
    ap.add_argument("--tuning-cache", default=None, metavar="PATH",
                    help="tuning-cache JSON path (default: "
                         "$REPRO_TORCH_TUNING_CACHE or "
                         "~/.cache/repro-torch-tuning/tuning.json); also "
                         "feeds the kernels' tuned launch blocks")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (0: only at the end)")
    ap.add_argument("--ckpt-keep", type=int, default=None, metavar="K",
                    help="keep only the newest K committed checkpoints "
                         "(default: keep all)")
    ap.add_argument("--resume", action="store_true",
                    help="restore params+opt state from the latest "
                         "checkpoint in --ckpt-dir and continue from its "
                         "step")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the fault-tolerant Supervisor: guarded "
                         "executors, OOM degrade-and-resume, bounded "
                         "retries; give-ups exit 40-44")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="OOM re-plan budget for the whole run "
                         "(--supervise only)")
    ap.add_argument("--on-nan", choices=["skip", "halt"], default="skip",
                    help="non-finite-gradient policy: bounded retry then "
                         "skip behind a circuit breaker, or halt at once "
                         "(--supervise only)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="host batches buffered by the input pipeline "
                         "(0: synchronous)")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="host",
                    help="'host' (every rank of the world on the data "
                         "axis) or an explicit 'DATA:MODEL' axis spec such "
                         "as '2:1' (MODEL > 1: 1F1B pipeline stages); "
                         "'production': the 16x16 GSPMD mesh (256 ranks)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params over the data axis of a pipelined "
                         "'DATA:MODEL' mesh (MODEL > 1)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh (512 ranks; FSDP "
                         "over (pod, data))")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write this rank's run report (JSON) to "
                         "PATH.rank<r>.json (PATH on one process), with the "
                         "all-reduces timed on their own")
    return ap


def default_optimizer(args) -> optim.Optimizer:
    return optim.sgd(args.lr, momentum=0.9, weight_decay=5e-4)


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def build_config(args):
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def memory_kw(args, optimizer) -> dict:
    """The memory model's kwargs for the launcher's plans. The flat
    executor updates in place, so its plan drops the step-❺ transient —
    when the optimizer publishes a fused hook."""
    return dict(act_bytes=4 if args.dtype == "float32" else 2,
                remat=not args.reduced,
                **optim.memory_model_kw(optimizer,
                                        fused=args.executor == "flat"))


FSDP_NOTE = ("--fsdp applies to the pipelined path: pass an explicit "
             "'DATA:MODEL' mesh spec with MODEL > 1")


def build_mesh(args, device_type: str):
    """This rank's mesh under torchrun (None for a single process with the
    default ``--mesh host``): the data-parallel one, or with MODEL > 1 the
    pipeline mesh and its axis groups. Refuses what is not ported, naming
    the ROADMAP item that holds it, ``--fsdp`` off a pipeline mesh, and a
    spec that does not cover the world."""
    if args.mesh == "production" or args.multi_pod:
        if args.fsdp:
            raise ValueError(FSDP_NOTE)
        if args.executor == "streaming":
            raise ValueError(
                "--executor streaming supports single-device and "
                "data-parallel host meshes (via the ShardedExecutor); "
                "production/multi-pod/pipelined meshes need a compiled "
                "executor")
        need = 512 if args.multi_pod else 256
        if mesh_lib.world_size() != need:
            mesh_lib.make_production_mesh(multi_pod=args.multi_pod)  # raises
        return mesh_lib.make_production_mesh(
            multi_pod=args.multi_pod,
            world_mesh=mesh_lib.init_world(device_type))
    world = mesh_lib.world_size()
    data, model = (world, 1) if args.mesh == "host" else \
        mesh_lib.parse_mesh_spec(args.mesh, world)
    if args.fsdp and model < 2:
        raise ValueError(FSDP_NOTE)
    if data * model != world:
        raise ValueError(f"mesh spec {args.mesh!r} puts {data * model} "
                         f"ranks on the mesh but the world has {world}: "
                         "give every rank of the world a place on the mesh")
    if world == 1:
        return None
    return mesh_lib.init_world(device_type, model=model)


def _data_parallel(mesh) -> bool:
    return (mesh is not None and mesh.mode == "data"
            and mesh_lib.data_parallel_size(mesh) > 1)


def _pipelined(mesh) -> bool:
    return mesh is not None and mesh.mode == "pipeline" and \
        mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS) > 1


def _gspmd(mesh) -> bool:
    return mesh is not None and mesh.mode == "gspmd"


def _on_mesh(mesh) -> bool:
    """A plan for this mesh is per device (data-parallel, pipelined or
    GSPMD)."""
    return _data_parallel(mesh) or _pipelined(mesh) or _gspmd(mesh)


def plan_budget(args, device, mesh=None) -> Optional[int]:
    """The per-device planning budget: ``--hbm-budget-gb``, else the
    host's memory on the CPU, else the card's (None: ``plan_mbs`` reads
    it) — or the rank's share of it when ranks share the card."""
    if args.hbm_budget_gb:
        return int(args.hbm_budget_gb * GIB)
    if device.type == "cpu":
        return host_memory_bytes()
    if mesh is not None and mesh.memory_fraction < 1.0:
        return int(memory_model.device_memory_bytes(device)
                   * mesh.memory_fraction)
    return None  # the card's own memory


def build_plan(cfg, args, optimizer, device, mesh=None) -> engine.MBSPlan:
    """The launcher's batch geometry (:func:`memory_kw`, :func:`plan_budget`).
    On a data-parallel or pipeline ``mesh`` the plan is per device with
    params not FSDP-sharded (``fsdp_params=False``, the reference
    launcher's host-mesh plan); a pipeline mesh plans with
    ``pipeline=True``; a GSPMD mesh with the params split
    (``fsdp_params=True``)."""
    on = _on_mesh(mesh)
    return engine.plan_mbs(
        args.mini_batch, num_microbatches=args.microbatches,
        model_cfg=cfg, seq_len=args.seq,
        budget_bytes=plan_budget(args, device, mesh), device=device,
        normalization=args.normalization, remat_policy=args.remat_policy,
        calibrate=args.calibrate, tuning_cache=args.tuning_cache,
        executor=args.executor, mesh=mesh if on else None,
        fsdp_params=not on or _gspmd(mesh), pipeline=_pipelined(mesh),
        **memory_kw(args, optimizer))


def build_executor(cfg, plan, args, optimizer, guard: bool = False,
                   mesh=None):
    """``--executor``'s executor; with a data-parallel ``mesh`` it is the
    inner strategy of a :class:`engine.ShardedExecutor` (per-rank
    accumulation, one gradient all-reduce per mini-batch); on a pipeline
    mesh it is the :class:`engine.PipelinedExecutor` of
    ``steps.make_staged_loss`` (``--executor`` ignored)."""
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    if _pipelined(mesh):
        staged = steps.make_staged_loss(cfg, dtype=dtype,
                                        remat_policy=plan.remat_policy)
        return engine.PipelinedExecutor(staged, optimizer, plan, mesh=mesh,
                                        fsdp=args.fsdp, guard=guard)
    loss_fn = steps.make_loss_fn(cfg, dtype=dtype,
                                 remat_policy=plan.remat_policy)
    if _data_parallel(mesh):
        return engine.ShardedExecutor(loss_fn, optimizer, plan, mesh=mesh,
                                      inner=args.executor, guard=guard)
    if _gspmd(mesh):
        return engine.GspmdExecutor(loss_fn, optimizer, plan, mesh=mesh,
                                    inner=args.executor, guard=guard,
                                    fsdp_over_pod=args.multi_pod)
    return engine.get_executor(args.executor)(loss_fn, optimizer, plan,
                                              guard=guard)


def make_build(cfg, args, ds, optimizer, device, guard: bool = False,
               mesh=None):
    """``plan -> (executor, step_fn, pipeline)``: every executor's
    ``step_split`` over a Pipeline that stages whole split mini-batches to
    ``device`` (the streaming executor slices micro-batches there) — on a
    data-parallel mesh, this rank's block of each (the
    ``ShardedExecutor``'s ``shard``). The Supervisor calls it again for
    each degraded plan; ``guard=True`` (the supervised mode) gives the
    executors the finite guard."""
    def build(plan):
        executor = build_executor(cfg, plan, args, optimizer, guard=guard,
                                  mesh=mesh)
        pipeline = engine.Pipeline(
            ds, plan, prefetch=args.prefetch, device=device,
            sharding=executor.shard if _on_mesh(mesh) else None)
        return executor, executor.step_split, pipeline
    return build


def make_plan_ctx(cfg, args, optimizer, device, mesh=None
                  ) -> Dict[str, object]:
    """The Supervisor's planning context: what :func:`build_plan` knows, so
    an OOM re-plan goes through the same ``plan_mbs`` the launcher used,
    and the observed failure lands under the same tuning-cache key. The
    budget is the one asked for (None: the re-plan halves instead)."""
    on = _on_mesh(mesh)
    return dict(
        model_cfg=cfg, seq_len=args.seq,
        budget_bytes=(int(args.hbm_budget_gb * GIB) if args.hbm_budget_gb
                      else None),
        device=device, executor=args.executor, mesh=mesh if on else None,
        tuning_cache=args.tuning_cache,
        mm_kw=dict(memory_kw(args, optimizer),
                   fsdp_params=not on or _gspmd(mesh),
                   pipeline=_pipelined(mesh)))


def run_trainer(trainer, state: Dict[str, object], args,
                quiet: bool = False):
    """Resume (when asked) + fit. ``state`` holds the initial
    ``"params"`` and ``"opt_state"``; both are popped from it and handed
    to ``Trainer.fit`` without a local name, so once the first step has
    made new trees no frame keeps the initial ones alive. ``quiet``: the
    ranks of a data-parallel world but rank 0 print nothing."""
    say = (lambda *a, **k: None) if quiet else print
    start = 0
    if args.resume:
        restored = trainer.restore(state["params"], state["opt_state"])
        if restored is not None:
            state["params"], state["opt_state"], start = restored
            rec = trainer.ckpt_log[-1]
            say(f"resumed from step {start} ({rec['seconds']:.2f}s)",
                flush=True)
        else:
            say("no checkpoint to resume from; starting fresh", flush=True)
        del restored
    params, opt_state, last = trainer.fit(state.pop("params"),
                                          state.pop("opt_state"), args.steps,
                                          start_step=start)
    if args.ckpt_dir:
        saves = [r for r in trainer.ckpt_log if r["op"] == "save"]
        say(f"checkpointed to {args.ckpt_dir}: "
            + ", ".join(f"step {r['step']} {r['bytes']} B in "
                        f"{r['seconds']:.2f}s" for r in saves), flush=True)
    stats = trainer.pipeline.stats
    say(f"input-wait fraction {stats.input_wait_fraction:.3f} "
        f"({stats.wait_s:.2f}s of {stats.elapsed_s:.2f}s, "
        f"{stats.retries} producer retries)", flush=True)
    return params, opt_state, last


def run_supervised(supervisor, state: Dict[str, object], args,
                   quiet: bool = False):
    """Resume (when asked) + supervised fit, with the initial state popped
    from ``state`` as :func:`run_trainer` does. A supervisor give-up
    becomes the process's exit status (40–44), so an orchestrator can
    tell "shrink the job" (42) from "look at the data" (43). ``quiet`` as
    in :func:`run_trainer`."""
    say = (lambda *a, **k: None) if quiet else print
    start = 0
    if args.resume:
        restored = supervisor.restore(state["params"], state["opt_state"])
        if restored is not None:
            state["params"], state["opt_state"], start = restored
            say(f"resumed from step {start}", flush=True)
        else:
            say("no checkpoint to resume from; starting fresh", flush=True)
        del restored
    try:
        params, opt_state, last = supervisor.fit(
            state.pop("params"), state.pop("opt_state"), args.steps,
            start_step=start)
    except engine.SupervisorError as e:
        print(f"[supervisor] giving up: {e}", flush=True)
        sys.exit(e.exit_code)
    rep = supervisor.report()
    say(f"[supervisor] done: restarts={rep['restarts']} "
        f"steps_lost={rep['steps_lost']} "
        f"plan: micro={rep['plan']['micro_batch_size']} "
        f"remat={rep['plan']['remat_policy']}", flush=True)
    say("[supervisor] anchors (host copies of the state): "
        + ", ".join(f"step {a['step']} {a['bytes']} B in "
                    f"{a['seconds']:.2f}s" for a in rep["anchors"]),
        flush=True)
    if args.ckpt_dir:
        say(f"checkpointed to {args.ckpt_dir}", flush=True)
    stats = supervisor.pipeline.stats
    say(f"input-wait fraction {stats.input_wait_fraction:.3f} "
        f"({stats.wait_s:.2f}s of {stats.elapsed_s:.2f}s, "
        f"{stats.retries} producer retries)", flush=True)
    return params, opt_state, last


def write_report(path: str, mesh, plan, cfg, args, history, base: dict,
                 device) -> str:
    """This rank's run report (see ``--report``); returns the file."""
    rank = 0 if mesh is None else mesh.rank
    if mesh is not None:
        root, ext = os.path.splitext(path)
        path = f"{root}.rank{rank}{ext or '.json'}"
    on = _on_mesh(mesh)
    est = memory_model.estimate(
        cfg, args.seq, remat_policy=plan.remat_policy,
        mesh=mesh if on else None, fsdp_params=not on or _gspmd(mesh),
        pipeline=_pipelined(mesh),
        **memory_kw(args, default_optimizer(args)))
    stats = engine.collective_stats()
    counts = kernels.launch_counts()

    def since(now, then):
        if isinstance(now, dict):
            return {k: since(v, then.get(k, 0)) for k, v in now.items()}
        return now - then
    cuda = device.type == "cuda"
    rep = {
        "rank": rank, "world": mesh_lib.world_size(),
        "backend": None if mesh is None else mesh.backend,
        "device": str(device),
        "card": torch.cuda.get_device_name(device) if cuda else None,
        "memory_fraction": 1.0 if mesh is None else mesh.memory_fraction,
        "plan": plan.describe(), "local_micro": plan.local_micro,
        "num_micro_batches": plan.num_micro_batches,
        "history": history,
        "mesh": None if mesh is None else dict(mesh),
        "all_reduce": since(stats, base["collectives"]),
        "launches": {k: counts[k] - base["launches"].get(k, 0)
                     for k in counts},
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None),
        "peak_reserved_bytes": (torch.cuda.max_memory_reserved(device)
                                if cuda else None),
        "estimate_bytes": est.total(plan.local_micro)}
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return path


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available here; pass "
                 "--device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.calibrate == "force" and device.type != "cuda":
        ap.error("--calibrate force measures the step's peak on the card; "
                 "on the CPU use --calibrate auto or off")
    if build_config(args).is_encdec:
        ap.error(ENCDEC_NOTE.format(arch=args.arch))
    import torch.distributed as dist
    joined = dist.is_available() and dist.is_initialized()
    try:
        mesh = build_mesh(args, device.type)
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    try:
        return _run(args, device if mesh is None else mesh.device, mesh)
    finally:
        if mesh is not None and not joined:
            mesh_lib.shutdown()


def _run(args, device, mesh) -> Dict[str, object]:
    if args.tuning_cache:
        # one cache serves both halves: the planner's memory correction
        # and the kernels' tuned launch blocks (the active cache)
        engine.set_cache_path(args.tuning_cache)
    rank0 = mesh is None or mesh.rank == 0
    if mesh is not None and rank0:
        where = ("as data x model pipeline stages" if _pipelined(mesh)
                 else "as a GSPMD mesh (tensor and FSDP sharding)"
                 if _gspmd(mesh) else "on the data axis")
        print(f"[mesh] {mesh_lib.world_size()} ranks {where} "
              f"({dict(mesh)}), backend {mesh.backend}, rank 0 on {device}"
              + (f", ranks sharing the card, each capped at "
                 f"{mesh.memory_fraction:.3f} of its memory"
                 if mesh.memory_fraction < 1.0 else ""), flush=True)
    base = {"collectives": engine.collective_stats(),
            "launches": kernels.launch_counts()}
    if args.report:
        engine.time_collectives(True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    cfg = build_config(args)
    opt = default_optimizer(args)
    # rank 0 plans and every rank takes its plan: one plan on all ranks
    plan = mesh_lib.broadcast_object(
        build_plan(cfg, args, opt, device, mesh) if rank0 else None, mesh)
    if rank0:
        print(plan.describe(), flush=True)
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=0)
    build = make_build(cfg, args, ds, opt, device, guard=args.supervise,
                       mesh=mesh)
    log = {} if rank0 else {"log_fn": None}
    if args.supervise:
        supervisor = engine.Supervisor(
            build, plan,
            config=engine.SupervisorConfig(max_restarts=args.max_restarts,
                                           on_nan=args.on_nan),
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            ckpt_keep=args.ckpt_keep, log_every=args.log_every,
            plan_ctx=make_plan_ctx(cfg, args, opt, device, mesh),
            writer=rank0, **log)
        executor = supervisor.executor
    else:
        executor, step_fn, pipeline = build(plan)
    # the initial state lives only in ``state`` until run_trainer hands
    # it to the Trainer: an executor whose update makes new trees then
    # frees it after the first step
    state = {"params": steps.init_params(cfg, seed=0, device=device)}
    if _pipelined(mesh):  # this rank's stage of the whole, then its state
        state["params"], _ = executor.prepare(state["params"], {})
    state["opt_state"] = opt.init(state["params"])
    if getattr(executor, "prepare", None) is not None \
            and not _pipelined(mesh):
        state["params"], state["opt_state"] = executor.prepare(
            state["params"], state["opt_state"])
    if args.supervise:
        del executor
        params, opt_state, _ = run_supervised(supervisor, state, args,
                                              quiet=not rank0)
        history = [{"step": s, **m} for s, m in
                   sorted(supervisor.metrics.items())]
        out = {"plan": supervisor.plan, "config": cfg, "history": history,
               "params": params, "opt_state": opt_state,
               "pipeline": supervisor.pipeline.stats, "checkpoints": [],
               "supervisor": supervisor.report()}
    else:
        trainer = engine.Trainer(step_fn, pipeline, ckpt_dir=args.ckpt_dir,
                                 ckpt_every=args.ckpt_every,
                                 ckpt_keep=args.ckpt_keep,
                                 log_every=args.log_every, writer=rank0,
                                 layout=(executor if _pipelined(mesh)
                                         or _gspmd(mesh) else None), **log)
        params, opt_state, _ = run_trainer(trainer, state, args,
                                           quiet=not rank0)
        history = trainer.history
        out = {"plan": plan, "config": cfg, "history": history,
               "params": params, "opt_state": opt_state,
               "pipeline": pipeline.stats, "checkpoints": trainer.ckpt_log}
    if mesh is not None and rank0:
        stats = engine.collective_stats()
        calls = stats["calls"] - base["collectives"]["calls"]
        print(f"[mesh] all-reduce: {calls} calls in {len(history)} steps "
              f"({calls / max(len(history), 1):.2f} a step), "
              f"{stats['bytes'] - base['collectives']['bytes']} B reduced",
              flush=True)
        if _pipelined(mesh):
            print(f"[mesh] rank 0 by axis {stats['by_axis']}, "
                  f"point-to-point {stats['p2p']}, all-gather "
                  f"{stats['all_gather']}, reduce-scatter "
                  f"{stats['reduce_scatter']}", flush=True)
    if args.report:
        engine.time_collectives(False)
        out["report"] = write_report(args.report, mesh, out["plan"], cfg,
                                     args, history, base, device)
    out["mesh"] = mesh
    return out


if __name__ == "__main__":
    main()
