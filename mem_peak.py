#!/usr/bin/env python3
"""What holds the device memory at the peak of a training run of the
port, on one NVIDIA GPU. From the repository root:

    python3 mem_peak.py [--executor flat streaming ...] [-- launcher flags]

For each executor it runs ``repro_torch.launch.train.main`` (full
qwen2-1.5b, bf16 compute, seq 1024, mini-batch 16 in 4 micro-batches, 3
steps, unless launcher flags follow ``--``) with PyTorch's allocator
history on (``torch.cuda.memory._record_memory_history``), replays the
history to the moment the most bytes were live, and prints those blocks
grouped by the line of ``repro_torch`` that allocated them (blocks
allocated outside Python, e.g. by autograd's engine, show as ``?``).
Without a GPU it exits non-zero.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--executor", nargs="+", default=["flat", "streaming"])
    ap.add_argument("--top", type=int, default=12)
    args, extra = ap.parse_known_args()
    import torch
    if not torch.cuda.is_available():
        print("mem_peak: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import train

    launch = [a for a in extra if a != "--"] or LAUNCH
    for executor in args.executor:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(
            enabled="all", context="alloc", stacks="python",
            max_entries=2_000_000)
        res = train.main(launch + ["--executor", executor])
        torch.cuda.synchronize()
        events = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        best, at, live = peak_blocks(events)
        groups = {}
        for b in live.values():
            n, size = groups.get(site(b.get("frames", [])), (0, 0))
            groups[site(b.get("frames", []))] = (n + 1, size + b["size"])
        print(f"{executor}: {best} B ({best / GIB:.2f} GiB) live at event "
              f"{at} of {len(events)}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B; last event before "
              f"the peak: {events[at]['action']} {events[at]['size']} B at "
              f"{site(events[at].get('frames', []))}", flush=True)
        for name, (n, size) in sorted(groups.items(),
                                      key=lambda kv: -kv[1][1])[:args.top]:
            print(f"  {size / GIB:7.2f} GiB in {n:5d} blocks  {name}",
                  flush=True)
        del res, events, live
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
