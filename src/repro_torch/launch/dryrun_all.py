"""Run the dry-run matrix: every (architecture × input shape) of
``configs.ARCHS`` × ``configs.SHAPES`` on one device, each combo in a
subprocess of its own (a fresh process per combo keeps one combo's
failure or memory out of the others), one JSON file per combo. The
reference's second column, the 2-pod production mesh, runs every shape
as one rank of the 2x16x16 GSPMD mesh (``dryrun --multi-pod``: a fake
world of 512 ranks); ``long_500k`` is skipped where the reference does
not assign it.

  python -m repro_torch.launch.dryrun_all --out build/dryrun \\
      [--only-arch qwen2-1.5b] [--device cuda|cpu] [--timeout 600] \\
      [--jobs 8]

A combo whose JSON exists is read, not run again. ``--jobs`` runs that
many combos at once (each is one host process; a fake step allocates
nothing on the card). The run ends with a table of every combo: the
predicted peak on one device (on one rank of the multi-pod mesh), the
FLOPs a step, the plan (a train step's) or the step's kind, and whether
the peak fits ``CARD_BYTES`` (one H100's 80 GB).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

from .. import configs
from .dryrun import CARD_BYTES

# per-arch micro-batch count for train_4k (the reference's): 16 → one
# sample per data shard of its mesh for the giant models
TRAIN_MICROBATCHES = {
    "grok-1-314b": 16, "mixtral-8x22b": 16, "qwen2-vl-72b": 16,
}
DEFAULT_MICROBATCHES = 8


def combos():
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            for mesh in ("single", "multi"):
                yield arch, shape, mesh


def _write(path: str, res: dict) -> dict:
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res


def run_one(arch: str, shape: str, mesh: str, out_dir: str, *,
            device: str = "cuda", timeout: int = 600) -> dict:
    tag = f"{arch}__{shape}__{mesh}"
    path = os.path.join(out_dir, f"{tag}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    if not configs.supports_shape(arch, shape):
        return _write(path, {"arch": arch, "shape": shape, "mesh_tag": mesh,
                             "skipped": True, "reason": "long_500k requires "
                             "sub-quadratic attention"})
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--microbatches",
           str(TRAIN_MICROBATCHES.get(arch, DEFAULT_MICROBATCHES)),
           "--device", device, "--out", out_dir]
    if mesh == "multi":
        cmd.append("--multi-pod")
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        return _write(path, {"arch": arch, "shape": shape, "mesh_tag": mesh,
                             "failed": True, "exit_code": proc.returncode,
                             "stderr_tail": proc.stderr[-3000:],
                             "wall_s": round(time.time() - t0, 1)})
    with open(path) as f:
        res = json.load(f)
    res["wall_s"] = round(time.time() - t0, 1)
    return _write(path, res)


def summary_line(res: dict) -> str:
    """One combo's row of the table (see the module doc)."""
    head = f"{res['arch']:20s} {res['shape']:11s}"
    if res.get("skipped") or res.get("failed"):
        why = ("skipped" if res.get("skipped") else "failed: " + res.get(
            "stderr_tail", "").strip().splitlines()[-1][:80])
        return f"{head} {why}"
    peak = res["memory"]["peak_bytes_est"]
    plan = (f"{res['num_microbatches']} x micro "
            f"{res['per_device']['local_micro']} {res['remat_policy']}"
            if res["kind"] == "train" else res["kind"])
    return (f"{head} peak {peak / 2 ** 30:10.2f} GiB  "
            f"{res['raw_cost_analysis']['flops']:.4e} FLOPs  {plan:22s} "
            f"{'fits' if peak <= CARD_BYTES else 'does not fit'} 80 GB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun_all")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    ap.add_argument("--only-mesh", choices=["single", "multi"], default=None)
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--only-shape", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds a combo may take")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combos run at once")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    todo = [c for c in combos()
            if (not args.only_mesh or c[2] == args.only_mesh)
            and (not args.only_arch or c[0] == args.only_arch)
            and (not args.only_shape or c[1] == args.only_shape)]

    def one(combo):
        t0 = time.time()
        try:
            res = run_one(*combo, args.out, device=args.device,
                          timeout=args.timeout)
            status = ("SKIP" if res.get("skipped") else
                      "FAIL" if res.get("failed") else "ok")
        except subprocess.TimeoutExpired:
            status = "TIMEOUT"
        print(f"{combo[0]:24s} {combo[1]:12s} {combo[2]:6s} {status:7s} "
              f"{time.time() - t0:7.1f}s", flush=True)
        return status

    with concurrent.futures.ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results = list(pool.map(one, todo))

    print()
    for arch, shape, mesh in todo:
        with open(os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
                  ) as f:
            print(summary_line(json.load(f)), flush=True)
    n = {s: results.count(s) for s in ("ok", "SKIP")}
    print(f"\n{n['ok']} ok / {n['SKIP']} skipped / "
          f"{len(results) - sum(n.values())} failed of {len(results)}")
    return 0 if all(s in n for s in results) else 1


if __name__ == "__main__":
    sys.exit(main())
