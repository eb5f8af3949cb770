"""Training launcher of the port — the single-device part of the JAX
package's ``launch/train.py``.

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

The reference's ``--mesh``, ``--fsdp`` and ``--no-donate`` (ROADMAP.md
queue 1 item 11) are not ported. The launcher keeps no reference to the
initial params and optimizer state once the Trainer (or the Supervisor)
has them, so an executor whose update makes new trees (``compiled``,
``fused``, ``streaming``) frees them after the first step; ``flat``
trains its initial buffers in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from .. import configs, engine, optim
from ..data import LMDataset
from ..models import transformer
from . import steps

GIB = 1024 ** 3


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


def build_plan(cfg, args, optimizer, device) -> engine.MBSPlan:
    """The launcher's batch geometry (:func:`memory_kw`). On the CPU the
    budget defaults to the host's memory."""
    if args.hbm_budget_gb:
        budget = int(args.hbm_budget_gb * GIB)
    elif device.type == "cpu":
        budget = host_memory_bytes()
    else:
        budget = None  # the card's own memory
    return engine.plan_mbs(
        args.mini_batch, num_microbatches=args.microbatches,
        model_cfg=cfg, seq_len=args.seq, budget_bytes=budget, device=device,
        normalization=args.normalization, remat_policy=args.remat_policy,
        calibrate=args.calibrate, tuning_cache=args.tuning_cache,
        executor=args.executor, **memory_kw(args, optimizer))


def build_executor(cfg, plan, args, optimizer, guard: bool = False):
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    loss_fn = steps.make_loss_fn(cfg, dtype=dtype,
                                 remat_policy=plan.remat_policy)
    return engine.get_executor(args.executor)(loss_fn, optimizer, plan,
                                              guard=guard)


def make_build(cfg, args, ds, optimizer, device, guard: bool = False):
    """``plan -> (executor, step_fn, pipeline)``: every executor's
    ``step_split`` over a Pipeline that stages whole split mini-batches to
    ``device`` (the streaming executor slices micro-batches there). The
    Supervisor calls it again for each degraded plan; ``guard=True`` (the
    supervised mode) gives the executors the finite guard."""
    def build(plan):
        executor = build_executor(cfg, plan, args, optimizer, guard=guard)
        pipeline = engine.Pipeline(ds, plan, prefetch=args.prefetch,
                                   device=device)
        return executor, executor.step_split, pipeline
    return build


def make_plan_ctx(cfg, args, optimizer, device) -> Dict[str, object]:
    """The Supervisor's planning context: what :func:`build_plan` knows, so
    an OOM re-plan goes through the same ``plan_mbs`` the launcher used,
    and the observed failure lands under the same tuning-cache key. The
    budget is the one asked for (None: the re-plan halves instead)."""
    return dict(
        model_cfg=cfg, seq_len=args.seq,
        budget_bytes=(int(args.hbm_budget_gb * GIB) if args.hbm_budget_gb
                      else None),
        device=device, executor=args.executor,
        tuning_cache=args.tuning_cache, mm_kw=memory_kw(args, optimizer))


def run_trainer(trainer, state: Dict[str, object], args):
    """Resume (when asked) + fit. ``state`` holds the initial
    ``"params"`` and ``"opt_state"``; both are popped from it and handed
    to ``Trainer.fit`` without a local name, so once the first step has
    made new trees no frame keeps the initial ones alive."""
    start = 0
    if args.resume:
        restored = trainer.restore(state["params"], state["opt_state"])
        if restored is not None:
            state["params"], state["opt_state"], start = restored
            rec = trainer.ckpt_log[-1]
            print(f"resumed from step {start} ({rec['seconds']:.2f}s)",
                  flush=True)
        else:
            print("no checkpoint to resume from; starting fresh", flush=True)
        del restored
    params, opt_state, last = trainer.fit(state.pop("params"),
                                          state.pop("opt_state"), args.steps,
                                          start_step=start)
    if args.ckpt_dir:
        saves = [r for r in trainer.ckpt_log if r["op"] == "save"]
        print(f"checkpointed to {args.ckpt_dir}: "
              + ", ".join(f"step {r['step']} {r['bytes']} B in "
                          f"{r['seconds']:.2f}s" for r in saves), flush=True)
    stats = trainer.pipeline.stats
    print(f"input-wait fraction {stats.input_wait_fraction:.3f} "
          f"({stats.wait_s:.2f}s of {stats.elapsed_s:.2f}s, "
          f"{stats.retries} producer retries)", flush=True)
    return params, opt_state, last


def run_supervised(supervisor, state: Dict[str, object], args):
    """Resume (when asked) + supervised fit, with the initial state popped
    from ``state`` as :func:`run_trainer` does. A supervisor give-up
    becomes the process's exit status (40–44), so an orchestrator can
    tell "shrink the job" (42) from "look at the data" (43)."""
    start = 0
    if args.resume:
        restored = supervisor.restore(state["params"], state["opt_state"])
        if restored is not None:
            state["params"], state["opt_state"], start = restored
            print(f"resumed from step {start}", flush=True)
        else:
            print("no checkpoint to resume from; starting fresh", flush=True)
        del restored
    try:
        params, opt_state, last = supervisor.fit(
            state.pop("params"), state.pop("opt_state"), args.steps,
            start_step=start)
    except engine.SupervisorError as e:
        print(f"[supervisor] giving up: {e}", flush=True)
        sys.exit(e.exit_code)
    rep = supervisor.report()
    print(f"[supervisor] done: restarts={rep['restarts']} "
          f"steps_lost={rep['steps_lost']} "
          f"plan: micro={rep['plan']['micro_batch_size']} "
          f"remat={rep['plan']['remat_policy']}", flush=True)
    print("[supervisor] anchors (host copies of the state): "
          + ", ".join(f"step {a['step']} {a['bytes']} B in "
                      f"{a['seconds']:.2f}s" for a in rep["anchors"]),
          flush=True)
    if args.ckpt_dir:
        print(f"checkpointed to {args.ckpt_dir}", flush=True)
    stats = supervisor.pipeline.stats
    print(f"input-wait fraction {stats.input_wait_fraction:.3f} "
          f"({stats.wait_s:.2f}s of {stats.elapsed_s:.2f}s, "
          f"{stats.retries} producer retries)", flush=True)
    return params, opt_state, last


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
    if args.tuning_cache:
        # one cache serves both halves: the planner's memory correction
        # and the kernels' tuned launch blocks (the active cache)
        engine.set_cache_path(args.tuning_cache)
    cfg = build_config(args)
    opt = default_optimizer(args)
    plan = build_plan(cfg, args, opt, device)
    print(plan.describe(), flush=True)
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=0)
    build = make_build(cfg, args, ds, opt, device, guard=args.supervise)
    if args.supervise:
        supervisor = engine.Supervisor(
            build, plan,
            config=engine.SupervisorConfig(max_restarts=args.max_restarts,
                                           on_nan=args.on_nan),
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            ckpt_keep=args.ckpt_keep, log_every=args.log_every,
            plan_ctx=make_plan_ctx(cfg, args, opt, device))
        executor = supervisor.executor
    else:
        executor, step_fn, pipeline = build(plan)
    # the initial state lives only in ``state`` until run_trainer hands
    # it to the Trainer: an executor whose update makes new trees then
    # frees it after the first step
    state = {"params": transformer.init_params(cfg, seed=0, device=device)}
    state["opt_state"] = opt.init(state["params"])
    if isinstance(executor, engine.FlatFusedExecutor):
        state["params"], state["opt_state"] = executor.prepare(
            state["params"], state["opt_state"])
    if args.supervise:
        del executor
        params, opt_state, _ = run_supervised(supervisor, state, args)
        return {"plan": supervisor.plan, "config": cfg,
                "history": [{"step": s, **m} for s, m in
                            sorted(supervisor.metrics.items())],
                "params": params, "opt_state": opt_state,
                "pipeline": supervisor.pipeline.stats, "checkpoints": [],
                "supervisor": supervisor.report()}
    trainer = engine.Trainer(step_fn, pipeline, ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every,
                             ckpt_keep=args.ckpt_keep,
                             log_every=args.log_every)
    params, opt_state, _ = run_trainer(trainer, state, args)
    return {"plan": plan, "config": cfg, "history": trainer.history,
            "params": params, "opt_state": opt_state,
            "pipeline": pipeline.stats, "checkpoints": trainer.ckpt_log}


if __name__ == "__main__":
    main()
