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
before it plans. The reference's ``--supervise`` (ROADMAP.md queue 1
item 12), ``--mesh``, ``--fsdp`` and ``--no-donate`` (item 11) are not
ported. The launcher keeps no reference to the initial params and
optimizer state once the Trainer has them, so an executor whose update
makes new trees (``compiled``, ``fused``, ``streaming``) frees them after
the first step; ``flat`` trains its initial buffers in place.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
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


def build_plan(cfg, args, optimizer, device) -> engine.MBSPlan:
    """The launcher's batch geometry. The flat executor updates in place,
    so its plan drops the step-❺ transient — when the optimizer publishes
    a fused hook. On the CPU the budget defaults to the host's memory."""
    if args.hbm_budget_gb:
        budget = int(args.hbm_budget_gb * GIB)
    elif device.type == "cpu":
        budget = host_memory_bytes()
    else:
        budget = None  # the card's own memory
    return engine.plan_mbs(
        args.mini_batch, num_microbatches=args.microbatches,
        model_cfg=cfg, seq_len=args.seq, budget_bytes=budget, device=device,
        normalization=args.normalization,
        act_bytes=4 if args.dtype == "float32" else 2,
        remat=not args.reduced, remat_policy=args.remat_policy,
        calibrate=args.calibrate, tuning_cache=args.tuning_cache,
        executor=args.executor,
        **optim.memory_model_kw(optimizer, fused=args.executor == "flat"))


def build_executor(cfg, plan, args, optimizer):
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    loss_fn = steps.make_loss_fn(cfg, dtype=dtype,
                                 remat_policy=plan.remat_policy)
    return engine.get_executor(args.executor)(loss_fn, optimizer, plan)


def make_build(cfg, args, ds, optimizer, device):
    """``plan -> (executor, step_fn, pipeline)``: every executor's
    ``step_split`` over a Pipeline that stages whole split mini-batches to
    ``device`` (the streaming executor slices micro-batches there)."""
    def build(plan):
        executor = build_executor(cfg, plan, args, optimizer)
        pipeline = engine.Pipeline(ds, plan, prefetch=args.prefetch,
                                   device=device)
        return executor, executor.step_split, pipeline
    return build


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
    executor, step_fn, pipeline = make_build(cfg, args, ds, opt, device)(plan)
    # the initial state lives only in ``state`` until run_trainer hands
    # it to the Trainer: an executor whose update makes new trees then
    # frees it after the first step
    state = {"params": transformer.init_params(cfg, seed=0, device=device)}
    state["opt_state"] = opt.init(state["params"])
    if isinstance(executor, engine.FlatFusedExecutor):
        state["params"], state["opt_state"] = executor.prepare(
            state["params"], state["opt_state"])
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
