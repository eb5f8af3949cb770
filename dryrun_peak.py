#!/usr/bin/env python3
"""What sets one rank's peak in the port's production-mesh dry run. From
the repository root (on the card host, or on the CPU with --device cpu):

    python3 dryrun_peak.py --arch moonshot-v1-16b-a3b --shape train_4k \
        [--multi-pod] [--src DIR] [--top 16] [--reduced --device cpu]

It runs ``repro_torch.launch.dryrun.run_dryrun`` with ``--mesh
production`` (one rank of a fake world, fake tensors: nothing is
allocated) as the dry run's command line does, with the census's count
of live bytes replaced by one that also remembers, for each storage, the
line of ``repro_torch`` and the ATen op that made it, with its shape and
dtype. Each time the live bytes pass the last snapshot by more than
STEP (a fraction) it snapshots the live storages
grouped by (line, op, shape, dtype); it prints the rank's peak, the
bytes live at the last snapshot and the largest groups there, one JSON
line at the end. ``--src`` picks the ``src`` directory the port is
imported from (default: this checkout's), so one call can measure two
trees.
"""
from __future__ import annotations

import argparse
import heapq
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SKIP = ("engine/gspmd.py", "engine/steptrace.py", "launch/mesh.py")
STEP = 0.002  # a new snapshot once the live bytes grow by this fraction


def _site(frame) -> str:
    """The innermost line of ``repro_torch`` (outside the census and the
    collectives' plumbing) on the stack above ``frame``."""
    f = frame
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and not name.endswith(SKIP):
            return (f"{name.split('repro_torch/')[-1]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


_PROPAGATING = {"depth": 0}


def mark_propagation() -> None:
    """Flag the calls of DTensor's whole-shape output-shape derivation."""
    from torch.distributed.tensor import _sharding_prop as sp
    fn = sp.ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(*args, **kwargs):
        _PROPAGATING["depth"] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PROPAGATING["depth"] -= 1

    sp.ShardingPropagator._propagate_tensor_meta_non_cached = marked


def tracking_live_bytes(base, top: int):
    class Tracking(base):
        """``_LiveBytes`` that keeps each storage's maker and snapshots
        the live groups as the live bytes climb."""

        def __init__(self):
            super().__init__()
            self.info = {}
            self.snap_live = 0
            self.snapshot = []

        def see(self, t):
            from repro_torch.engine.steptrace import _storage_id
            key = _storage_id(t)
            if key is None or key in self._refs or _PROPAGATING["depth"]:
                return
            caller = sys._getframe(1)
            func = caller.f_locals.get("func")
            op = str(func) if func is not None else "state"
            self.info[key] = (_site(caller), op, tuple(t.shape),
                              str(t.dtype).replace("torch.", ""),
                              t.untyped_storage().nbytes())
            super().see(t)
            if self.live > self.snap_live * (1 + STEP):
                self._snap()

        def _snap(self):
            groups = {}
            for key in list(self._refs):
                rec = self.info.get(key)
                if rec is None:
                    continue
                g = groups.setdefault(rec[:4], [0, 0])
                g[0] += rec[4]
                g[1] += 1
            self.snap_live = self.live
            self.snapshot = heapq.nlargest(
                top, ((b, n, k) for k, (b, n) in groups.items()))

    return Tracking


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun_peak.py")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_peak.py: no CUDA device here (pass --device cpu)",
              file=sys.stderr)
        return 1
    from repro_torch.engine import steptrace
    from repro_torch.launch import dryrun
    made = []

    mark_propagation()
    base = steptrace._LiveBytes
    tracking = tracking_live_bytes(base, args.top)

    def factory():
        live = tracking()
        made.append(live)
        return live

    steptrace._LiveBytes = factory
    t0 = time.perf_counter()
    try:
        res = dryrun.run_dryrun(
            args.arch, args.shape, multi_pod=args.multi_pod,
            reduced=args.reduced, probe=False, verbose=False,
            mesh_spec="production", device=torch.device(args.device))
    finally:
        steptrace._LiveBytes = base
    wall = time.perf_counter() - t0
    # the census whose peak the report gives is the last one made (the
    # first two micro-batches; DTensor's warm-up run comes first)
    live = made[-1] if made else None
    out = {"arch": args.arch, "shape": args.shape,
           "multi_pod": args.multi_pod, "src": args.src,
           "peak_bytes": res.get("memory", {}).get("peak_bytes_est"),
           "plan": res.get("per_device", {}).get("plan"),
           "remat_policy": res.get("remat_policy"),
           "modeled_bytes": res.get("oracle", {}).get("modeled_bytes"),
           "flops": res.get("raw_cost_analysis", {}).get("flops"),
           "collectives": res.get("gspmd", {}).get("collectives"),
           "seconds": round(wall, 1)}
    if live is not None:
        out["census_peak_bytes"] = live.peak
        out["snapshot_live_bytes"] = live.snap_live
        out["top"] = [{"bytes": b, "count": n, "site": k[0], "op": k[1],
                       "shape": list(k[2]), "dtype": k[3]}
                      for b, n, k in live.snapshot]
        print(f"{args.arch} {args.shape}: peak {live.peak} B; at the last "
              f"snapshot {live.snap_live} B live:")
        for row in out["top"]:
            print(f"  {row['bytes']:>16,d} B  {row['count']:>4d} x "
                  f"{row['shape']} {row['dtype']}  {row['op']}  "
                  f"{row['site']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
