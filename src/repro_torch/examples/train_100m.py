"""End-to-end training example: a ~100M-parameter decoder-only LM trained
with the full stack — MBS micro-batch streaming, the micro-batch sized by
the memory model, an LR schedule, and the engine's async input pipeline
and resumable Trainer (background batch synthesis, device staging,
metrics read back a step late, periodic checkpoints of params AND
optimizer state) — the twin of the JAX package's
``examples/train_100m.py``.

Default invocation is small; pass --full for the ~100M/200-step run:

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--full] \
        [--steps N] [--executor compiled|streaming|fused|flat] \
        [--hbm-budget-gb GB] [--ckpt-dir DIR] [--device cpu]

The planner's budget is ``--hbm-budget-gb`` GiB, by default the card's
memory; on the CPU it must be given (16 plans as the JAX twin does, for
its TPU v5e). Checkpoints go to ``--ckpt-dir`` (default
``build/train_100m_ckpt`` under the working directory), and a run
restores from the newest one there. ``--executor flat`` runs step ❹ by
K1 and step ❺ by K2 on the flat buffers, ``fused`` step ❹ by K1.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import engine, optim
from repro_torch.core import memory_model
from repro_torch.data import LMDataset
from repro_torch.examples import add_device, on_device, resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

GIB = 1024 ** 3
DEFAULT_CKPT_DIR = os.path.join("build", "train_100m_ckpt")


def model_100m() -> ModelConfig:
    # ~100M params: 12L, d=768, 12H, ff=2048, vocab 32k (tied)
    return ModelConfig(name="lm-100m", family="dense", num_layers=12,
                       d_model=768, num_heads=12, num_kv_heads=12,
                       head_dim=64, d_ff=2048, vocab_size=32_768,
                       layer_pattern=("global",))


def model_small() -> ModelConfig:
    return ModelConfig(name="lm-4m", family="dense", num_layers=4,
                       d_model=192, num_heads=4, num_kv_heads=4, head_dim=48,
                       d_ff=512, vocab_size=2048, layer_pattern=("global",))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_100m")
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--mini-batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--executor", choices=sorted(engine.EXECUTORS),
                    default="compiled")
    ap.add_argument("--hbm-budget-gb", type=float, default=None,
                    help="the planner's budget in GiB (default: the card's "
                         "memory; needed with --device cpu)")
    add_device(ap)
    return ap


def main(argv=None, params=None):
    """Returns the plan, the config, the step it started from, the
    Trainer's history (every step's metrics, unrounded), its checkpoint
    log and the pipeline's stats. ``params`` replaces the seed-0 initial
    weights."""
    ap = build_parser()
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)
    if args.hbm_budget_gb is not None:
        budget = int(args.hbm_budget_gb * GIB)
    elif device.type == "cuda":
        budget = memory_model.device_memory_bytes(device)
    else:
        ap.error("--device cpu: pass --hbm-budget-gb (the CPU has no device "
                 "memory to plan against)")

    cfg = model_100m() if args.full else model_small()
    seq = args.seq or (512 if args.full else 64)
    num_steps = args.steps or (200 if args.full else 40)
    print(f"model {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"seq {seq}, mini-batch {args.mini_batch}")

    # engine planner: auto micro-batch from the memory model (replaces the
    # paper's experimentally-determined size)
    plan = engine.plan_mbs(args.mini_batch, model_cfg=cfg, seq_len=seq,
                           budget_bytes=budget, remat=bool(args.full),
                           device=device)
    if not args.full and plan.micro_batch_size > 8:
        plan = engine.plan_mbs(args.mini_batch, micro_batch_size=8,
                               remat=bool(args.full), device=device)
    print(plan.describe())

    params = (transformer.init_params(cfg, seed=0, device=device)
              if params is None else on_device(params, device))
    # the loss checkpoints under the plan's remat policy (engine Layer 5)
    loss_fn = steps_lib.make_loss_fn(cfg, dtype=torch.float32,
                                     remat_policy=plan.remat_policy)
    opt = optim.sgd(optim.cosine_decay(0.3, num_steps, warmup=10),
                    momentum=0.9, weight_decay=1e-4)
    executor = engine.get_executor(args.executor)(loss_fn, opt, plan)
    opt_state = opt.init(params)
    if getattr(executor, "prepare", None) is not None:  # flat's buffers
        params, opt_state = executor.prepare(params, opt_state)

    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    pipeline = engine.Pipeline(ds, plan, prefetch=2, device=device)
    trainer = engine.Trainer(executor.step_split, pipeline,
                             ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every, log_every=10)

    start = 0
    restored = trainer.restore(params, opt_state)
    if restored is not None:
        params, opt_state, start = restored
        print(f"restored checkpoint at step {start}")
    del restored
    trainer.fit(params, opt_state, num_steps, start_step=start)
    stats = pipeline.stats
    print(f"done. input-wait fraction {stats.input_wait_fraction:.3f}")
    return {"plan": plan, "config": cfg, "start": start,
            "history": trainer.history, "checkpoints": trainer.ckpt_log,
            "pipeline": stats}


if __name__ == "__main__":
    main()
