#!/usr/bin/env python3
"""Where the data-parallel step's all-reduce goes, on one NVIDIA GPU
shared by two ranks over gloo (chip_smoke phase 16a's setting). Run from
the repository root:

    python3 allreduce_parts.py [--elems N] [--reps R]

Two ranks of a ``repro_torch.launch.world.LocalWorld`` on ``cuda:0``
each hold an fp32 buffer of N elements (default: full qwen2-1.5b's
flat bucket plus the loss, metric and valid-count slots, 1,543,714,307 —
what ``ShardedExecutor``'s ``flat`` inner reduces in place) and time, in
turns, with both ranks starting each part together (a barrier, then the
device synchronized):

  * ``d2h``: the buffer copied into page-locked host memory;
  * ``h2d``: and back;
  * ``host_all_reduce``: gloo's all-reduce of the host copy (the ring
    over the host's loopback and the host's adds);
  * ``cuda_all_reduce``: gloo's all-reduce of the card's buffer, as
    ``engine.psum_flat`` issues it.

Each part's seconds are the later of the two ranks' (the collective
ends for both when the later one arrives). Prints the card's name and
power limit, one line a part, and one JSON object as its last line.
Needs the card; without one it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BUCKET = 1_543_714_304 + 3  # qwen2-1.5b's fp32 bucket + loss, aux, valid
PARTS = ("d2h", "h2d", "host_all_reduce", "cuda_all_reduce")


def rank_parts(mesh, n: int, reps: int) -> dict:
    """On one rank: each part's seconds, ``reps`` turns, A B C D D C B A
    in each."""
    import torch
    import torch.distributed as dist

    dev = mesh.device
    x = torch.ones(n, device=dev)
    host = torch.empty(n, pin_memory=True)

    def timed(fn) -> float:
        dist.barrier()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    fns = {"d2h": lambda: host.copy_(x, non_blocking=True),
           "h2d": lambda: x.copy_(host, non_blocking=True),
           "host_all_reduce": lambda: dist.all_reduce(host),
           "cuda_all_reduce": lambda: dist.all_reduce(x)}
    out = {p: [] for p in PARTS}
    for _ in range(reps):
        for p in PARTS + PARTS[::-1]:
            out[p].append(timed(fns[p]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--elems", type=int, default=BUCKET)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("allreduce_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.world import LocalWorld

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    store = os.path.join(ROOT, "build", "allreduce_parts")
    os.makedirs(store, exist_ok=True)
    with LocalWorld(2, device="cuda", store_dir=store, timeout_s=900,
                    threads=0) as world:
        ranks = world.run(rank_parts, args.elems, args.reps)
    gb = args.elems * 4 / 1e9
    res = {}
    for p in PARTS:
        # each turn's time is the later rank's
        turns = [max(t) for t in zip(*(r[p] for r in ranks))]
        res[p] = {"turns_s": turns, "median_s": sorted(turns)[len(turns) // 2],
                  "gb_per_s": gb / (sorted(turns)[len(turns) // 2])}
        print(f"{p}: {res[p]['median_s']:.4f}s median of {turns} "
              f"({res[p]['gb_per_s']:.3f} GB/s over {gb:.3f} GB)",
              flush=True)
    print(json.dumps({"card": card, "elems": args.elems, "bytes":
                      args.elems * 4, "parts": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
