"""Training launcher of the port — a single-device subset of the JAX
package's ``launch/train.py``.

Plans the batch geometry (``--microbatches`` pins N_Sμ; without it the
memory model sizes the micro-batch against the device's memory or
``--hbm-budget-gb``), builds the executor and runs a plain step loop over
``LMDataset`` batches (batch ``i`` drawn with seed ``i``), printing the
plan and the per-step losses. It runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --reduced --steps 2 --executor flat --device cpu
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

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
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def default_optimizer(args) -> optim.Optimizer:
    return optim.sgd(args.lr, momentum=0.9, weight_decay=5e-4)


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


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
        **optim.memory_model_kw(optimizer, fused=args.executor == "flat"))


def build_executor(cfg, plan, args, optimizer):
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    loss_fn = steps.make_loss_fn(cfg, dtype=dtype,
                                 remat_policy=plan.remat_policy)
    return engine.get_executor(args.executor)(loss_fn, optimizer, plan)


def _log(step: int, m: Dict[str, float], elapsed: float) -> None:
    print(f"step {step:4d}  loss {m['loss']:.4f}  |g| {m['grad_norm']:.3f}"
          f"  ({elapsed:.1f}s)", flush=True)


def train_loop(executor, params, opt_state, dataset, num_steps: int,
               device, log_every: int = 5):
    """``num_steps`` mini-batch updates; returns (params, opt_state,
    history) with each step's metrics as host floats and its wall time
    (host clock around the step, ended by the metrics' readback)."""
    plan = executor.plan
    history: List[Dict[str, float]] = []
    t_start = time.perf_counter()
    for step in range(num_steps):
        split = plan.device_split(
            dataset.batch(plan.mini_batch_size, step), device)
        t0 = time.perf_counter()
        params, opt_state, metrics = executor.step_split(params, opt_state,
                                                         split)
        m = {k: float(v) for k, v in metrics.items()}  # syncs the step
        m["step_seconds"] = time.perf_counter() - t0
        history.append(m)
        if log_every and (step % log_every == 0 or step == num_steps - 1):
            _log(step, m, time.perf_counter() - t_start)
    return params, opt_state, history


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available here; pass "
                 "--device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    opt = default_optimizer(args)
    plan = build_plan(cfg, args, opt, device)
    print(plan.describe(), flush=True)
    executor = build_executor(cfg, plan, args, opt)
    params = transformer.init_params(cfg, seed=0, device=device)
    opt_state = opt.init(params)
    if isinstance(executor, engine.FlatFusedExecutor):
        params, opt_state = executor.prepare(params, opt_state)
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=args.seq, seed=0)
    params, opt_state, history = train_loop(executor, params, opt_state, ds,
                                            args.steps, device, args.log_every)
    return {"plan": plan, "config": cfg, "history": history,
            "params": params, "opt_state": opt_state}


if __name__ == "__main__":
    main()
