"""Quickstart: train a small LM with Micro-Batch Streaming — the twin of
the JAX package's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Reduced qwen2 (seed 0), mini-batch 32 in micro-batches of 4 through the
``compiled`` executor, SGD with momentum, 20 steps of the synthetic LM
data; prints the loss and gradient norm every 5 steps and at the last.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs, optim
from repro_torch.core import mbs
from repro_torch.data import LMDataset
from repro_torch.examples import add_device, on_device, resolve_device, staged
from repro_torch.launch import steps
from repro_torch.models import transformer

MINI_BATCH = 32  # what you WANT to train with
MICRO_BATCH = 4  # what fits in memory (paper: the streaming unit)
STEPS = 20


def main(argv=None, params=None):
    """Returns ``{step: (loss, grad norm)}`` of the printed steps.
    ``params`` replaces the seed-0 initial weights (moved to the
    device)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(ap, args)

    cfg = configs.get_reduced("qwen2-1.5b")  # any assigned arch id works
    params = (transformer.init_params(cfg, seed=0, device=device)
              if params is None else on_device(params, device))
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32, remat=False)
    opt = optim.sgd(0.05, momentum=0.9)
    train_step = mbs.make_mbs_train_step(loss_fn, opt,
                                         mbs.MBSConfig(MICRO_BATCH))

    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=32, seed=0)
    opt_state = opt.init(params)
    printed = {}
    for step in range(STEPS):
        mini = ds.batch(MINI_BATCH, step)  # host mini-batch
        split = staged(mbs.split_minibatch(mini, MICRO_BATCH), device)
        params, opt_state, metrics = train_step(params, opt_state, split)
        if step % 5 == 0 or step == STEPS - 1:
            printed[step] = (float(metrics["loss"]),
                             float(metrics["grad_norm"]))
            print(f"step {step:3d}  loss {printed[step][0]:.4f}  "
                  f"|grad| {printed[step][1]:.3f}", flush=True)
    print("done — trained a mini-batch 8x larger than the compute unit.")
    return printed


if __name__ == "__main__":
    main()
