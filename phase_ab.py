#!/usr/bin/env python3
"""Times phases of ``chip_smoke.py`` from two checkouts of the repository
on one NVIDIA GPU, to tell a change's cost from the card's run-to-run
spread. From the repository root:

    python3 phase_ab.py --a DIR --b DIR [--phases 6 16a worlds]

It runs A, B, B, A, every run in a process of its own that imports the
``chip_smoke.py`` of its checkout (and, through it, that checkout's
``src/repro_torch``), builds its CUDA libraries (phase 2) and runs, in
order, the phases asked for (default ``worlds``):

  6       the main path (``main_path_phase``): its steady step's seconds;
  16a     data parallelism under torchrun (``dp_main_path_phase``): its
          wall seconds and each rank's steady step;
  worlds  the phases on worlds of ranks: a checkout with ``world_phases``
          runs 16b, 16c, 19a, 19b, 19c, 21a / 21b, 22a and 22b in its two
          ``LocalWorld``s; an older one runs 16b, 16c, 19c
          (``pp_check_phase``) and 21a / 21b (``gspmd_train_phase``) in
          worlds of their own and 19a and 19b under torchrun. 21c is not
          run (it needs 18a's numbers). Each phase's seconds and their
          sum.

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

PHASES = ("6", "16a", "worlds")


def child(root: str, phases) -> dict:
    """One run: the phases of ``root``'s chip_smoke, timed."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase_ab.py: no GPU")
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(cs.ROOT, "build", "triton"))
    sys.path.insert(0, os.path.join(cs.ROOT, "src"))
    import multiprocessing.forkserver
    from repro_torch.launch import world as world_lib
    world_lib.context()
    multiprocessing.forkserver.ensure_running()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.build_phase()
    out = {}
    for p in phases:
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
            phase_s = {}

            def timed(name, fn, *a):
                t = time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    phase_s[name] = time.perf_counter() - t
            if hasattr(cs, "world_phases"):
                cs.world_phases(timed, dev)
            else:
                timed("16b data-parallel check", cs.dp_check_phase, dev)
                timed("16c fault agreement", cs.fault_agreement_phase, dev)
                for label in cs.PP_RUNS:
                    timed(label, cs.pp_launcher_phase, dev, label)
                timed("19c pipeline check", cs.pp_check_phase, dev)
                timed("21a/21b GSPMD", cs.gspmd_train_phase, dev)
            got = {"phases": phase_s}
        got["phase_s"] = time.perf_counter() - t0
        out[p] = got
        cs.gc_collect()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a")
    ap.add_argument("--b")
    ap.add_argument("--phases", nargs="+", choices=PHASES,
                    default=["worlds"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        res = child(args.child, args.phases)
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
            [sys.executable, os.path.abspath(__file__), "--child", root,
             "--phases", *args.phases], capture_output=True, text=True)
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
