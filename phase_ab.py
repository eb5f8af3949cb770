#!/usr/bin/env python3
"""Times phases 6, 16a and 19c of ``chip_smoke.py`` from two checkouts of the
repository on one NVIDIA GPU, to tell a change's cost from the card's
run-to-run spread. From the repository root:

    python3 phase_ab.py --a DIR --b DIR

It runs A, B, B, A, every run in a process of its own that imports the
``chip_smoke.py`` of its checkout (and, through it, that checkout's
``src/repro_torch``), builds its CUDA libraries (phase 2) and runs, in
order:

  6    the main path (``main_path_phase``): its steady step's seconds;
  16a  data parallelism under torchrun (``dp_main_path_phase``): its
       wall seconds and each rank's steady step;
  19c  the pipeline check on ``LocalWorld``s (``pp_check_phase``): its
       wall seconds.

Each run prints one JSON line (``{"root": ..., "phases": {...}}``); the
last line gathers them with the card's name and power limit. A phase
that fails fails the run. Without a GPU it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = ("6", "16a", "19c")


def child(root: str) -> dict:
    """One run: the phases of ``root``'s chip_smoke, timed."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase_ab.py: no GPU")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(cs.ROOT, "build", "triton"))
    sys.path.insert(0, os.path.join(cs.ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.build_phase()
    out = {}
    for p in PHASES:
        t0 = time.perf_counter()
        if p == "6":
            res = cs.main_path_phase(dev)
            got = {"steady_step_s": res["steady_step_s"]}
        elif p == "16a":
            res = cs.dp_main_path_phase(dev)
            got = {"wall_s": res["wall_s"],
                   "steady_step_s": [r["steady_step_s"]
                                     for r in res["ranks"]]}
        else:
            cs.pp_check_phase(dev)
            got = {}
        got["phase_s"] = time.perf_counter() - t0
        out[p] = got
        cs.gc_collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a")
    ap.add_argument("--b")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = child(args.child)
        print(json.dumps({"root": args.child, "phases": res}), flush=True)
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    runs = []
    for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root],
            capture_output=True, text=True)
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        if proc.returncode:
            print(f"{label} ({root}) failed: rc {proc.returncode}",
                  flush=True)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["label"] = label
        print(json.dumps(line), flush=True)
        runs.append(line)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
