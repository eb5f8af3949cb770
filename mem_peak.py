#!/usr/bin/env python3
"""What holds the device memory at the peak of a training run of the
port, on one NVIDIA GPU. From the repository root:

    python3 mem_peak.py [--executor flat streaming ...] [-- launcher flags]
    python3 mem_peak.py --cnn unet [--micro 4]

For each executor it runs ``repro_torch.launch.train.main`` (full
qwen2-1.5b, bf16 compute, seq 1024, mini-batch 16 in 4 micro-batches, 3
steps, unless launcher flags follow ``--``) with PyTorch's allocator
history on (``torch.cuda.memory._record_memory_history``), replays the
history to the moment the most bytes were live, and prints those blocks
grouped by the line of ``repro_torch`` that allocated them (blocks
allocated outside Python, e.g. by autograd's engine or cuDNN, show as
``?``), then the largest single blocks. With ``--cnn`` it records one
``flat`` step of the paper's ResNet-50 (224 px) or U-Net (384 px) over
two micro-batches of ``--micro`` images instead (fp32, TF32 off, remat
"none", the setup of chip_smoke's phase 7b). Without a GPU it exits
non-zero.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
GIB = 2 ** 30
LAUNCH = ["--arch", "qwen2-1.5b", "--dtype", "bfloat16", "--seq", "1024",
          "--mini-batch", "16", "--microbatches", "4", "--steps", "3",
          "--log-every", "1"]


def site(frames) -> str:
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            return (f"{name.split('repro_torch/')[-1]}:{f.get('line')} "
                    f"{f.get('name')}")
    return "?"


def peak_blocks(events):
    """(bytes live at the peak, index of the event, live blocks then)."""
    def replay(upto):
        live, cur, best, at = {}, 0, 0, -1
        for i, e in enumerate(events[:upto]):
            if e["action"] == "alloc":
                live[e["addr"]] = e
                cur += e["size"]
            elif e["action"] == "free_completed":
                gone = live.pop(e["addr"], None)
                cur -= gone["size"] if gone else 0
            if cur > best:
                best, at = cur, i
        return best, at, live
    best, at, _ = replay(len(events))
    _, _, live = replay(at + 1)
    return best, at, live


def cnn_step(which: str, micro: int):
    """One ``flat`` step of the paper's model ``which`` over two
    micro-batches of ``micro`` images, from seed 0."""
    import torch
    from repro_torch import engine, optim
    from repro_torch.configs import resnet50, unet
    from repro_torch.data import ClassificationDataset, SegmentationDataset
    from repro_torch.models import cnn
    dev = torch.device("cuda")
    if which == "resnet50":
        cfg = resnet50.config()
        opt = optim.sgd(0.01, momentum=0.9, weight_decay=5e-4)
        ds = ClassificationDataset(cfg.num_classes, cfg.image_size, seed=0)
    else:
        cfg = unet.config()
        opt = optim.adam(0.01, weight_decay=5e-4)
        ds = SegmentationDataset(cfg.image_size, seed=0)
    plan = engine.plan_mbs(2 * micro, micro_batch_size=micro, device=dev,
                           remat_policy="none")
    batch = ds.batch(2 * micro, 0)

    def run():
        params, state = cnn.init(cfg, seed=0, device=dev)
        ex = engine.FlatFusedExecutor(cnn.make_loss_fn(cfg, state), opt,
                                      plan)
        p, s = ex.prepare(params, opt.init(params))
        del params
        return ex.step_split(p, s, plan.device_split(batch, dev))
    return run


def record(torch, label: str, fn, top: int) -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python",
        max_entries=2_000_000)
    res = fn()
    torch.cuda.synchronize()
    events = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    best, at, live = peak_blocks(events)
    groups = {}
    for b in live.values():
        n, size = groups.get(site(b.get("frames", [])), (0, 0))
        groups[site(b.get("frames", []))] = (n + 1, size + b["size"])
    print(f"{label}: {best} B ({best / GIB:.2f} GiB) live at event "
          f"{at} of {len(events)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; last event before "
          f"the peak: {events[at]['action']} {events[at]['size']} B at "
          f"{site(events[at].get('frames', []))}", flush=True)
    for name, (n, size) in sorted(groups.items(),
                                  key=lambda kv: -kv[1][1])[:top]:
        print(f"  {size / GIB:7.2f} GiB in {n:5d} blocks  {name}",
              flush=True)
    print("  largest blocks live at the peak (GiB): " + ", ".join(
        f"{b['size'] / GIB:.3f} {site(b.get('frames', []))}"
        for b in sorted(live.values(), key=lambda b: -b["size"])[:5]),
        flush=True)
    del res, events, live


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--executor", nargs="+", default=["flat", "streaming"])
    ap.add_argument("--cnn", choices=["resnet50", "unet"], default=None)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    args, extra = ap.parse_known_args()
    import torch
    if not torch.cuda.is_available():
        print("mem_peak: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import train

    if args.cnn:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        record(torch, f"{args.cnn} flat step, 2 x {args.micro} images",
               cnn_step(args.cnn, args.micro), args.top)
    launch = [a for a in extra if a != "--"] or LAUNCH
    for executor in ([] if args.cnn else args.executor):
        record(torch, executor,
               lambda: train.main(launch + ["--executor", executor]),
               args.top)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
