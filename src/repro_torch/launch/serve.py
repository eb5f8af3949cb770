"""Serving launcher of the port: continuous batching under a synthetic
heavy-traffic stream, with KV-cache admission planned against a memory
budget. It runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
      --reduced --device cpu --budget 0.5 --requests 32 --rate 50 \
      --prompt-lens 16,48,96 --new-tokens 8,32 --temperature 0.7

``--budget`` (GiB) drives ``engine.plan_serve``: the number of concurrent
decode slots and the prefill micro-batch come from
``core/memory_model.serve_estimate``, not from a hand-picked batch.
Prefill latency and steady decode throughput are reported apart, after a
warmup pass (one decode step and one prefill per prompt bucket), and the
token a prefill samples is not counted as decoded. ``--layers`` cuts the
depth; the weights are random, from seed 0.

On a world of ranks (torchrun, or a process group already started) it
serves data-parallel, as the JAX launcher's host mesh over all its
devices plans it: ``engine.plan_serve(mesh=...)`` reads ``--budget`` per
device and admits ``local_slots`` a worker, and every rank runs one
``ServingEngine`` of that many slots on its own device (``cuda:LOCAL_RANK``,
or a share of one card over gloo). Every rank draws the same Poisson
stream from ``--seed`` and serves the requests whose id is its rank
modulo the world. Rank 0 gathers the ranks' reports and prints and
returns the report over all of them (``engine.serving.merge_reports``),
each rank's allocator peak beside the plan's modeled per-device peak.
The KV pool is each rank's own, not split by ``cache_specs``.

  torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.serve \
      --arch qwen2-1.5b --reduced --device cpu --requests 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import configs
from ..core.streaming import prefetch_iterator
from ..engine import serving
from ..models import transformer
from . import mesh as mesh_lib


def _int_list(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--budget", type=float, default=0.5,
                    help="device memory budget in GiB the serve plan is "
                         "admitted against")
    ap.add_argument("--max-len", type=int, default=128,
                    help="context capacity per slot (prompt + generated)")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--prompt-lens", type=_int_list, default=(16, 48, 96),
                    help="comma-separated prompt-length mix")
    ap.add_argument("--new-tokens", type=_int_list, default=(8, 32),
                    help="comma-separated output-budget mix")
    ap.add_argument("--slots", type=int, default=None,
                    help="pin the decode-slot count (default: memory model)")
    ap.add_argument("--prefill-micro", type=int, default=None,
                    help="pin the prefill micro-batch (default: memory model)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy, >0 = temperature sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-donate", action="store_true",
                    help="write every cache update into a fresh pool instead "
                         "of in place (costs a second full cache copy)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="compute dtype; the cache is bf16 with bfloat16, "
                         "fp32 with float32; weights are fp32")
    ap.add_argument("--json", default=None,
                    help="also write the full report to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Returns the plan, config, report (on a world: the report over every
    rank, the same on each), the requests this rank served and its engine
    (whose pool and params stay alive while the caller holds it); on a
    world also ``ranks``, each rank's finished request ids and allocator
    peak."""
    ap = build_parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA device is available here; pass "
                 "--device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        ap.error(f"--device must be cuda or cpu, got {args.device!r}")
    try:
        cfg = (configs.get_reduced(args.arch) if args.reduced
               else configs.get(args.arch))
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=args.layers)
        serving.check_servable(cfg)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))
    if max(args.prompt_lens) >= args.max_len:
        raise SystemExit(f"largest prompt length {max(args.prompt_lens)} "
                         f"leaves no room to generate at --max-len "
                         f"{args.max_len}")
    joined = dist.is_available() and dist.is_initialized()
    mesh = (mesh_lib.init_world(device.type)
            if mesh_lib.world_size() > 1 else None)
    try:
        return _serve(args, cfg, device if mesh is None else mesh.device,
                      mesh)
    finally:
        if mesh is not None and not joined:
            mesh_lib.shutdown()


def _serve(args, cfg, device, mesh) -> Dict[str, object]:
    rank0 = mesh is None or mesh.rank == 0
    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    plan = mesh_lib.broadcast_object(serving.plan_serve(
        cfg, budget_bytes=int(args.budget * 2**30), max_len=args.max_len,
        max_slots=args.slots, prefill_micro=args.prefill_micro, mesh=mesh,
        cache_bytes=2 if args.dtype == "bfloat16" else 4) if rank0 else None,
        mesh)
    if rank0:
        print(plan.describe(), flush=True)
    if mesh is not None and device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = transformer.init_params(cfg, seed=0, device=device)
    engine = serving.ServingEngine(
        params, cfg, plan, dtype=dtype, temperature=args.temperature,
        seed=args.seed, donate=not args.no_donate)
    del params
    # the Poisson stream, prompts synthesized by a worker thread; on a
    # world every rank draws it and keeps its own share of the requests
    world = 1 if mesh is None else mesh_lib.world_size()
    rank = 0 if mesh is None else mesh.rank
    stream = prefetch_iterator(
        (r for r in serving.synthetic_traffic(
            args.requests, rate_rps=args.rate, prompt_lens=args.prompt_lens,
            new_tokens=args.new_tokens, vocab_size=cfg.vocab_size,
            seed=args.seed + 1) if r.rid % world == rank),
        size=8)
    seen = []

    def tee(it):
        for r in it:
            seen.append(r)
            yield r

    engine.run(tee(stream), warmup_prompt_lens=args.prompt_lens)
    rep = engine.finished_report(seen)
    out = {"plan": plan, "config": cfg, "report": rep, "requests": seen,
           "engine": engine}
    if mesh is not None:
        mine = {"report": rep, "samples": engine.samples(seen),
                "rank": rank, "seen": len(seen),
                "finished": sorted(r.rid for r in seen
                                   if r.state == serving.FINISHED),
                "peak_allocated_bytes": (
                    torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None)}
        parts = [None] * world
        dist.all_gather_object(parts, mine, group=mesh.group)
        out["report"] = rep = serving.merge_reports(
            [p["report"] for p in parts], [p["samples"] for p in parts],
            plan)
        out["ranks"] = [{k: p[k] for k in ("rank", "seen", "finished",
                                           "peak_allocated_bytes")}
                        for p in parts]
    if not rank0:
        return out

    pf, dec = rep["prefill"], rep["decode"]
    n = len(seen) if mesh is None else sum(r["seen"] for r in out["ranks"])
    where = "" if mesh is None else f" on {world} ranks"
    print(f"{cfg.name}: {rep['requests']['finished']}/{n} requests "
          f"finished{where} (warmup {rep['warmup_s']:.2f}s, excluded)")
    print(f"  prefill: {pf['batches']} micro-batches, "
          f"{pf['prompt_tokens']} prompt tokens, latency "
          f"p50 {pf['latency_s']['p50'] * 1e3:.1f}ms "
          f"max {pf['latency_s']['max'] * 1e3:.1f}ms")
    print(f"  decode (steady-state): {dec['tokens']} tokens in "
          f"{dec['time_s']:.2f}s = {dec['tokens_per_s']:.1f} tok/s over "
          f"{dec['steps']} steps (decode-issued only)")
    print(f"  ITL p50 {dec['itl_s']['p50'] * 1e3:.1f}ms "
          f"p99 {dec['itl_s']['p99'] * 1e3:.1f}ms | "
          f"TTFT p50 {rep['ttft_s']['p50'] * 1e3:.1f}ms "
          f"p99 {rep['ttft_s']['p99'] * 1e3:.1f}ms")
    print(f"  slots: {rep['slots']['max_concurrent']} peak of "
          f"{rep['slots']['planned']} planned "
          f"(mean active {rep['slots']['mean_active_per_step']:.1f})",
          flush=True)
    for r in out.get("ranks", []):
        peak = r["peak_allocated_bytes"]
        print(f"  rank {r['rank']}: {len(r['finished'])} of {r['seen']} "
              f"requests finished; allocator peak "
              f"{'n/a' if peak is None else f'{peak} B'} beside the plan's "
              f"modeled {plan.modeled_peak_bytes()} B a device", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": cfg.name, "plan": plan.describe(),
                       "report": rep}, f, indent=2)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
