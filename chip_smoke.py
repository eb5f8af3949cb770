#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

  1. the card's name and power limit (``nvidia-smi``); TF32 stated and
     switched off for fp32 matmuls and convolutions;
  2. kernels K1–K4 (Triton, built from ``src/repro_torch/kernels`` at first
     use, cached under ``build/triton``) against their plain PyTorch
     versions at ragged sizes in every dtype combination — rtol 1e-6 /
     atol 1e-6 in fp32 and 1 ulp in bf16 (the kernels launch with
     floating-point contraction off and round where the plain versions
     round, so this only allows for the last place);
  3. one ``flat`` step against one ``compiled`` step at qwen2-1.5b width,
     depth cut to 2 layers, bf16 compute, same seed: params and momentum
     within the same tolerance;
  4. the main path: ``repro_torch.launch.train`` for full qwen2-1.5b
     (28 layers, d 1536, vocab 151936) through the ``flat`` executor, with
     the launch counters zeroed just before and read just after: every
     loss finite, the first near ln(vocab), K1 launched steps × N_Sμ ×
     buckets times and K2 steps × buckets times;
  5. each kernel at the main path's full bucket size: held against its
     plain version once more, then timed with CUDA events beside its
     bound, its plain version and the PyTorch call that computes the same
     function, where there is one.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
RAGGED_SIZES = [1, 1000, 4097, (1 << 20) + 3]
CHUNK = 1 << 27  # elements per slice when the plain version runs in slices
MAIN_ARGV = ["--arch", "qwen2-1.5b", "--executor", "flat",
             "--dtype", "bfloat16", "--seq", "1024", "--mini-batch", "16",
             "--microbatches", "4", "--steps", "3", "--log-every", "1"]

# per kernel: source, the Pallas kernel it replaces, bytes and flops moved
# per fp32 element (each input read once, each output written once)
KERNELS = {
    "grad_accum": ("src/repro_torch/kernels/grad_accum.py",
                   "src/repro/kernels/grad_accum.py:110", 12, 2),
    "fused_sgd_mom": ("src/repro_torch/kernels/fused_update.py",
                      "src/repro/kernels/fused_update.py:53", 20, 7),
    "fused_sgd": ("src/repro_torch/kernels/fused_update.py",
                  "src/repro/kernels/fused_update.py:67", 12, 5),
    "fused_adam": ("src/repro_torch/kernels/fused_update.py",
                   "src/repro/kernels/fused_update.py:121", 28, 17),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparison and timing
# ---------------------------------------------------------------------------

def max_violation(got, want) -> tuple:
    """(max abs error, whether every element is within tolerance):
    |a-b| <= 1e-6 + 1e-6|b| in fp32, one ulp in bf16."""
    import torch
    a, b = got.float(), want.float()
    err = (a - b).abs()
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(a.abs(), b.abs())
        _, exp = torch.frexp(mag)
        ulp = torch.ldexp(torch.ones_like(mag), exp - 8)
        ulp = torch.clamp(ulp, min=2.0 ** -133)
        ok = bool(torch.all(err <= ulp))
    else:
        ok = bool(torch.all(err <= 1e-6 + 1e-6 * b.abs()))
    return float(err.max()) if err.numel() else 0.0, ok


def event_ms(fn, reps: int) -> float:
    import torch
    fn()  # warm-up (and first-use compile)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernel cases: each builds inputs, runs the wrapper in place and the plain
# version on copies, and returns the buffers to compare
# ---------------------------------------------------------------------------

def _kernel_cases(n, dev, gen):
    """(kernel name, label, run) triples at ``n`` elements; ``run()``
    returns [(kernel output, plain output), ...]."""
    import torch
    from repro_torch import kernels
    ref = kernels.ref

    def rnd(dtype=torch.float32, positive=False):
        x = torch.randn(n, generator=gen, device=dev)
        return (x.abs() if positive else x).to(dtype)

    def sc(*vals):
        return [torch.tensor(v, dtype=torch.float32, device=dev)
                for v in vals]

    cases = []
    for gdt in (torch.float32, torch.bfloat16):
        def k1(gdt=gdt):
            acc, g = rnd(), rnd(gdt)
            s = torch.full((1,), 1.0 / 3.0, device=dev)
            want = ref.grad_accum_ref(acc, g, s)
            kernels.grad_accum(acc, g, s)
            return [(acc, want)]
        cases.append(("grad_accum", f"acc fp32 grad {gdt}", k1))
    for dt in (torch.float32, torch.bfloat16):
        for nesterov, wd, clip in ((False, 5e-4, 1.0), (True, 1e-2, 0.5)):
            def k2(dt=dt, nesterov=nesterov, wd=wd, clip=clip):
                p, g, m = rnd(dt), rnd(), rnd(dt)
                lr, cl = sc(0.05, clip)
                wp, wm = ref.fused_sgd_ref(p, g, m, lr, cl, momentum=0.9,
                                           weight_decay=wd,
                                           nesterov=nesterov)
                kernels.fused_sgd(p, g, m, lr, cl, momentum=0.9,
                                  weight_decay=wd, nesterov=nesterov)
                return [(p, wp), (m, wm)]
            cases.append(("fused_sgd_mom",
                          f"{dt} nesterov={nesterov} wd={wd} clip={clip}",
                          k2))
        for wd in (0.0, 5e-4):
            def k3(dt=dt, wd=wd):
                p, g = rnd(dt), rnd()
                lr, cl = sc(0.1, 0.7)
                wp, _ = ref.fused_sgd_ref(p, g, None, lr, cl,
                                          weight_decay=wd)
                kernels.fused_sgd(p, g, None, lr, cl, weight_decay=wd)
                return [(p, wp)]
            cases.append(("fused_sgd", f"{dt} wd={wd}", k3))
        for wd, decoupled, clip in ((0.0, False, 1.0), (1e-2, False, 0.7),
                                    (1e-2, True, 0.7)):
            def k4(dt=dt, wd=wd, decoupled=decoupled, clip=clip):
                p, g, m, v = rnd(dt), rnd(), rnd(dt), rnd(dt, positive=True)
                lr, cl, bc1, bc2 = sc(1e-3, clip, 1 - 0.9 ** 3,
                                      1 - 0.999 ** 3)
                want = ref.fused_adam_ref(p, g, m, v, lr, bc1, bc2, cl,
                                          weight_decay=wd,
                                          decoupled=decoupled)
                kernels.fused_adam(p, g, m, v, lr, bc1, bc2, cl,
                                   weight_decay=wd, decoupled=decoupled)
                return list(zip((p, m, v), want))
            cases.append(("fused_adam",
                          f"{dt} wd={wd} decoupled={decoupled} clip={clip}",
                          k4))
    return cases


def kernel_phase(dev, errs) -> None:
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    for n in RAGGED_SIZES:
        for name, label, run in _kernel_cases(n, dev, gen):
            for got, want in run():
                err, ok = max_violation(got, want)
                errs[name] = max(errs[name], err)
                check(ok, f"{name} [{label}, n={n}] disagrees with its "
                          f"plain version: max abs err {err:.3e}")
    torch.cuda.synchronize()
    print(f"kernels: K1-K4 match their plain versions at n={RAGGED_SIZES} "
          f"in fp32 and bf16 ({time.perf_counter() - t0:.1f}s incl. build)",
          flush=True)


# ---------------------------------------------------------------------------
# cross-check: flat against compiled at full width, 2 layers
# ---------------------------------------------------------------------------

def cross_check_phase(dev) -> None:
    import torch
    from repro_torch import configs, engine, optim, tree
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    seq, mini = 256, 8
    plan = engine.plan_mbs(mini, num_microbatches=4, remat_policy="none",
                           device=dev)
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.bfloat16,
                                 remat_policy="none")
    batch = LMDataset(cfg.vocab_size, seq, seed=0).batch(mini, 0)
    outs = {}
    for name in ("compiled", "flat"):
        opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
        ex = engine.get_executor(name)(loss_fn, opt, plan)
        params = transformer.init_params(cfg, seed=0, device=dev)
        state = opt.init(params)
        if name == "flat":
            params, state = ex.prepare(params, state)
        params, state, m = ex.step_split(params, state,
                                         plan.device_split(batch, dev))
        outs[name] = (params, state["mom"], float(m["loss"]))
        del params, state
    (cp, cm, closs), (fp, fm, floss) = outs["compiled"], outs["flat"]
    worst = 0.0
    for what, a, b in (("params", fp, cp), ("momentum", fm, cm)):
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            err, ok = max_violation(x, y)
            worst = max(worst, err)
            check(ok, f"flat vs compiled {what} disagree: max abs err "
                      f"{err:.3e} (rtol 1e-6, atol 1e-6)")
    check(math.isfinite(closs) and abs(closs - floss) <= 1e-5 * abs(closs),
          f"flat loss {floss} vs compiled loss {closs}")
    print(f"cross-check: flat == compiled after one step at qwen2-1.5b width, "
          f"2 layers, bf16 (loss {floss:.6f}, max abs err {worst:.3e})",
          flush=True)
    del outs, cp, cm, fp, fm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def main_path_phase(dev) -> dict:
    import torch
    from repro_torch import kernels, optim
    from repro_torch.core import memory_model
    from repro_torch.engine import FlatSpec
    from repro_torch.launch import train

    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.main(MAIN_ARGV)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    plan, cfg, hist = res["plan"], res["config"], res["history"]
    spec = FlatSpec.for_tree(res["params"])
    n_steps, n_b = len(hist), spec.num_buckets
    losses = [h["loss"] for h in hist]
    check(n_steps == 3 and all(math.isfinite(x) for x in losses),
          f"main path losses not finite: {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]:.4f} is far from ln(vocab) "
          f"{math.log(cfg.vocab_size):.4f} for a random model")
    for buf in spec.buffers_of(res["params"]):
        check(bool(torch.isfinite(buf).all()), "params not finite")
    want_k1 = n_steps * plan.num_micro_batches * n_b
    check(counts["grad_accum"] == want_k1,
          f"K1 launched {counts['grad_accum']} times, expected {want_k1}")
    check(counts["fused_sgd_mom"] == n_steps * n_b,
          f"K2 launched {counts['fused_sgd_mom']} times, expected "
          f"{n_steps * n_b}")
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    est = memory_model.estimate(
        cfg, 1024, act_bytes=2, remat_policy=plan.remat_policy,
        **optim.memory_model_kw(opt, fused=True)).total(
        plan.micro_batch_size)
    steady = [h["step_seconds"] for h in hist[1:]]
    step_s = sum(steady) / len(steady)
    tokens = plan.mini_batch_size * 1024
    print(f"main path: {plan.describe()}", flush=True)
    print(f"main path: losses {losses}; step seconds "
          f"{[h['step_seconds'] for h in hist]}; steady step {step_s:.4f}s, "
          f"{tokens / step_s:.1f} tokens/s; wall {wall:.1f}s incl. init",
          flush=True)
    print(f"main path: peak allocated {peak} B "
          f"({peak / 2 ** 30:.2f} GiB) vs memory-model estimate {est} B "
          f"({est / 2 ** 30:.2f} GiB); buckets {spec.bucket_sizes} "
          f"{[str(d) for d in spec.bucket_dtypes]}; launches {counts}",
          flush=True)
    sizes = spec.bucket_sizes
    del res, spec
    torch.cuda.empty_cache()
    return {"counts": counts, "bucket_size": max(sizes)}


# ---------------------------------------------------------------------------
# full-size compare and timing
# ---------------------------------------------------------------------------

def _plain_in_slices(fn, n: int) -> None:
    for lo in range(0, n, CHUNK):
        fn(slice(lo, min(lo + CHUNK, n)))


def full_size_phase(dev, n: int, errs) -> dict:
    """Each kernel at ``n`` fp32 elements (the main path's bucket): compare
    with the plain version (run slice by slice on copies of the inputs, to
    bound memory), then time kernel, plain version (slice by slice, the
    same work) and the PyTorch call computing the same function."""
    import torch
    from repro_torch import kernels
    ref = kernels.ref
    gen = torch.Generator(device=dev).manual_seed(1)
    reps = 10
    res = {}

    def rnd(positive=False):
        x = torch.randn(n, generator=gen, device=dev)
        return x.abs_() if positive else x

    def compare(name, pairs_of):
        """Kernel outputs against the plain version, slice by slice."""
        for lo in range(0, n, CHUNK):
            for got, want in pairs_of(slice(lo, min(lo + CHUNK, n))):
                err, ok = max_violation(got, want)
                errs[name] = max(errs[name], err)
                check(ok, f"{name} at n={n} disagrees with its plain "
                          f"version: max abs err {err:.3e}")

    lr, clip = (torch.tensor(v, device=dev) for v in (0.05, 1.0))
    # K1
    acc, g = rnd(), rnd()
    s = torch.full((1,), 0.25, device=dev)
    acc0 = acc.clone()
    kernels.grad_accum(acc, g, s)
    compare("grad_accum", lambda c: [
        (acc[c], ref.grad_accum_ref(acc0[c], g[c], s))])
    del acc0
    res["grad_accum"] = (
        event_ms(lambda: kernels.grad_accum(acc, g, s), reps),
        event_ms(lambda: _plain_in_slices(
            lambda c: ref.grad_accum_ref(acc[c], g[c], s), n), reps),
        event_ms(lambda: acc.add_(g, alpha=0.25), reps))
    del acc, g
    # K2 and K3
    p, g, m = rnd(), rnd(), rnd()
    p0, m0 = p.clone(), m.clone()
    kernels.fused_sgd(p, g, m, lr, clip, momentum=0.9, weight_decay=5e-4)
    compare("fused_sgd_mom", lambda c: zip((p[c], m[c]), ref.fused_sgd_ref(
        p0[c], g[c], m0[c], lr, clip, momentum=0.9, weight_decay=5e-4)))
    p0.copy_(p)
    kernels.fused_sgd(p, g, None, lr, clip, weight_decay=5e-4)
    compare("fused_sgd", lambda c: [(p[c], ref.fused_sgd_ref(
        p0[c], g[c], None, lr, clip, weight_decay=5e-4)[0])])
    del p0, m0
    res["fused_sgd_mom"] = (
        event_ms(lambda: kernels.fused_sgd(p, g, m, lr, clip, momentum=0.9,
                                           weight_decay=5e-4), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_sgd_ref(
            p[c], g[c], m[c], lr, clip, momentum=0.9, weight_decay=5e-4),
            n), reps),
        event_ms(lambda: torch._fused_sgd_(
            [p], [g], [m], weight_decay=5e-4, momentum=0.9, lr=0.05,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), reps))
    res["fused_sgd"] = (
        event_ms(lambda: kernels.fused_sgd(p, g, None, lr, clip,
                                           weight_decay=5e-4), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_sgd_ref(
            p[c], g[c], None, lr, clip, weight_decay=5e-4), n), reps),
        event_ms(lambda: torch._fused_sgd_(
            [p], [g], [], weight_decay=5e-4, momentum=0.0, lr=0.05,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), reps))
    del m
    # K4
    v = rnd(positive=True)
    m = rnd()
    bc1, bc2 = (torch.tensor(x, device=dev) for x in (0.1, 0.001))
    lr4 = torch.tensor(1e-3, device=dev)
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    kernels.fused_adam(p, g, m, v, lr4, bc1, bc2, clip, weight_decay=1e-2,
                       decoupled=True)
    compare("fused_adam", lambda c: zip((p[c], m[c], v[c]), ref.fused_adam_ref(
        p0[c], g[c], m0[c], v0[c], lr4, bc1, bc2, clip, weight_decay=1e-2,
        decoupled=True)))
    del p0, m0, v0
    res["fused_adam"] = (
        event_ms(lambda: kernels.fused_adam(p, g, m, v, lr4, bc1, bc2, clip,
                                            weight_decay=1e-2,
                                            decoupled=True), reps),
        event_ms(lambda: _plain_in_slices(lambda c: ref.fused_adam_ref(
            p[c], g[c], m[c], v[c], lr4, bc1, bc2, clip, weight_decay=1e-2,
            decoupled=True), n), reps),
        None)
    del p, g, m, v
    torch.cuda.empty_cache()
    return res


def run() -> dict:
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this script "
                           "drives the port on a GPU and has no CPU mode")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch import kernels

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    dev = torch.device("cuda", 0)
    errs = {k: 0.0 for k in KERNELS}

    kernel_phase(dev, errs)
    cross_check_phase(dev)
    main = main_path_phase(dev)
    n = main["bucket_size"]
    times = full_size_phase(dev, n, errs)
    # launches of the comparisons above do not count: the counts are the
    # main path's, read right after it
    records = []
    for name, (src, replaces, bytes_per, flops_per) in KERNELS.items():
        ms, plain_ms, lib_ms = times[name]
        byte_ms = n * bytes_per / HBM_BYTES_PER_S * 1e3
        op_ms = n * flops_per / FP32_FLOPS_PER_S * 1e3
        records.append({
            "name": name, "route": "triton", "source": src,
            "replaces": replaces, "launches": main["counts"][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms, "n": n})
    print(json.dumps({"kernels": records}), flush=True)
    print(f"card: {card_line()}", flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        result = run()
    except (SmokeFailure, ImportError, subprocess.SubprocessError,
            OSError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
