#!/usr/bin/env python3
"""Where a skipped step's time goes in K4's ``GUARD`` variant, on one
NVIDIA GPU. Run from the repository root:

    python3 k4_guard.py

It compiles K4 (``kernels/fused_update.py``'s ``_adam_kernel``) as the
port launches it and in two forms of the earlier guard, which ANDed the
finite flag into the load and store mask and ran the update on every
lane:

  * ``exit``: the kernel as it is (a flag of 0 ends each program before
    its first load), with the flag at 1 and at 0, and unguarded;
  * ``masked``: the flag in the mask, the masked loads giving what they
    give (the earlier kernel);
  * ``masked_ones``: the same, the masked loads giving 1.0, so the lanes
    of a skipped step feed the divisions and the square root ordinary
    operands;

beside K2's ``GUARD`` variant at flag 0. For each compiled kernel it
prints ptxas's registers and counts in its SASS (``cuobjdump``) the
instructions that tell the paths apart: calls (the IEEE-rounded
division's and square root's slow paths are subroutines), ``FCHK`` (the
division's test for them), ``MUFU`` and the loads, predicated or not.
Then it checks ``exit`` at flag 1 bit-identical to the unguarded kernel
and at flag 0 writing nothing (at a ragged size, NaN in the accumulator),
and times every launch in turns (A B … B A) at the main path's bucket,
qwen2-1.5b's 1,543,714,304 fp32 elements, with ``chip_smoke.py``'s
timer (CUDA events over 10 launches behind a sleep kernel). Prints the
card's name and power limit and one JSON object as its last line. Needs
the card and no network; without a card it exits non-zero.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "k4_guard")
N = 1_543_714_304  # qwen2-1.5b's fp32 bucket: the main path's size
RAGGED = 1_000_003
REPS = 10


def _masked_kernel():
    """The earlier K4 ``GUARD`` body: the flag ANDed into every mask;
    ``ONES`` makes the masked loads give 1.0."""
    import triton
    import triton.language as tl

    @triton.jit
    def _adam_masked(p_ptr, g_ptr, m_ptr, v_ptr, s_ptr, n,
                     B1: tl.constexpr, OMB1: tl.constexpr,
                     B2: tl.constexpr, OMB2: tl.constexpr,
                     EPS: tl.constexpr, WD: tl.constexpr,
                     ONES: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = (offs < n) & (tl.load(s_ptr + 4) != 0.0)
        lr = tl.load(s_ptr)
        gscale = tl.load(s_ptr + 1)
        bc1 = tl.load(s_ptr + 2)
        bc2 = tl.load(s_ptr + 3)
        if ONES:
            p = tl.load(p_ptr + offs, mask=mask, other=1.0)
            g = tl.load(g_ptr + offs, mask=mask, other=1.0) * gscale
            m = tl.load(m_ptr + offs, mask=mask, other=1.0)
            v = tl.load(v_ptr + offs, mask=mask, other=1.0)
        else:
            p = tl.load(p_ptr + offs, mask=mask)
            g = tl.load(g_ptr + offs, mask=mask) * gscale
            m = tl.load(m_ptr + offs, mask=mask)
            v = tl.load(v_ptr + offs, mask=mask)
        m = B1 * m + OMB1 * g
        v = B2 * v + OMB2 * (g * g)
        den = tl.sqrt_rn(tl.div_rn(v, bc2)) + EPS
        u = tl.div_rn(tl.div_rn(m, bc1), den) + WD * p
        p = p + -lr * u
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)

    return _adam_masked


def _cuobjdump() -> str:
    from repro_torch.kernels import _cuda
    tools = [os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")]
    import triton
    tools.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                              "nvidia", "bin", "cuobjdump"))
    return next(t for t in tools if os.access(t, os.X_OK))


def sass_counts(name: str, compiled) -> dict:
    """Registers, spills and the telling instructions of one compiled
    Triton kernel's SASS; its listing is kept in ``build/k4_guard``."""
    cubin = os.path.join(OUT, f"{name}.cubin")
    with open(cubin, "wb") as f:
        f.write(compiled.asm["cubin"])
    sass = subprocess.run([_cuobjdump(), "-sass", cubin], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    with open(os.path.join(OUT, f"{name}.sass"), "w") as f:
        f.write(sass)
    ins = [ln.split("*/", 1)[1].strip() for ln in sass.splitlines()
           if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln) and "*/" in ln]
    ldg = [i for i in ins if re.search(r"\bLDG\b", i)]
    first_vec = next((k for k, i in enumerate(ins) if "LDG.E.128" in i),
                     len(ins))
    return {"registers": compiled.n_regs, "spills": compiled.n_spills,
            "instructions": len(ins),
            "calls": sum("CALL" in i for i in ins),
            "fchk": sum("FCHK" in i for i in ins),
            "mufu": sum("MUFU" in i for i in ins),
            "ldg": len(ldg),
            "ldg_predicated": sum(i.startswith("@") for i in ldg),
            # registers zeroed for a predicated-off load to leave
            "zeroed_pairs": sum(i.startswith("CS2R") and "SRZ" in i
                                for i in ins),
            "exit_before_vector_loads": any("EXIT" in i
                                            for i in ins[:first_vec])}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k4_guard: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import fused_update
    from repro_torch.kernels._launch import scalars, stream_geometry
    import triton

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    _, sgd_mom, _, adam = fused_update._kernels()
    masked = _masked_kernel()
    consts = dict(B1=0.9, OMB1=1 - 0.9, B2=0.999, OMB2=1 - 0.999, EPS=1e-8,
                  WD=1e-2)

    def s_of(flag, k2=False):
        """K4's scalar operand (lr, clip, bias corrections[, flag]), or
        K2's (lr, clip, flag)."""
        vals = (0.05, 0.7) if k2 else (1e-3, 0.7, 0.1, 0.001)
        return scalars(dev, *vals, *(() if flag is None else (flag,)))

    def launch(form, ops, s):
        """One launch of ``form`` over ``ops`` (p, g, m, v) with scalar
        operand ``s``; returns Triton's compiled kernel."""
        n = ops[0].numel()
        block, warps = stream_geometry("fused_update", torch.float32, n)
        grid = (triton.cdiv(n, block),)
        kw = dict(BLOCK=block, num_warps=warps, enable_fp_fusion=False)
        if form in ("exit", "unguarded"):
            return adam[grid](*ops, s, n, COUPLED_WD=False,
                              DECOUPLED_WD=True, GUARD=form == "exit",
                              **consts, **kw)
        if form == "k2":
            return sgd_mom[grid](*ops[:3], s, n, MU=0.9, WD=5e-4,
                                 HAS_WD=True, NESTEROV=True, GUARD=True,
                                 BLOCK=block, num_warps=warps,
                                 enable_fp_fusion=False)
        return masked[grid](*ops, s, n, ONES=form == "masked_ones",
                            **consts, **kw)

    def operands(n, gen):
        def rnd():
            return torch.randn(n, generator=gen, device=dev)
        return [rnd(), rnd(), rnd(), rnd().abs()]

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)

    # bit for bit at a ragged size: flag 1 as unguarded, flag 0 untouched
    ops = operands(RAGGED, gen)
    want = [x.clone() for x in ops]
    launch("unguarded", want, s_of(None))
    got = [x.clone() for x in ops]
    launch("exit", got, s_of(1.0))
    same1 = all(torch.equal(a, b) for a, b in zip(got, want))
    got = [x.clone() for x in ops]
    got[1][RAGGED // 2] = float("nan")
    launch("exit", got, s_of(0.0))
    untouched = all(torch.equal(a, b) for i, (a, b) in
                    enumerate(zip(got, ops)) if i != 1)
    print(f"check: exit flag 1 bit-identical to unguarded: {same1}; flag 0 "
          f"wrote nothing: {untouched}", flush=True)
    del ops, want, got

    ops = operands(N, gen)
    one, zero = s_of(1.0), s_of(0.0)
    runs = {"unguarded": ("unguarded", None), "exit_flag1": ("exit", one),
            "exit_flag0": ("exit", zero), "masked_flag1": ("masked", one),
            "masked_flag0": ("masked", zero),
            "masked_ones_flag0": ("masked_ones", zero),
            "k2_guard_flag0": ("k2", s_of(0.0, k2=True))}
    sass = {}
    for form in ("unguarded", "exit", "masked", "masked_ones", "k2"):
        s = {"unguarded": s_of(None), "k2": s_of(1.0, k2=True)}.get(form,
                                                                   one)
        ck = launch(form, ops, s)
        sass[form] = sass_counts(form, ck)
        print(f"sass: {form}: {sass[form]}", flush=True)
    plain_s = s_of(None)
    turns = chip_smoke.turns_ms(
        {name: (lambda f=form, s=s: launch(f, ops, plain_s if s is None
                                           else s))
         for name, (form, s) in runs.items()}, REPS)
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    for k in runs:
        print(f"time: {k}: {ms[k]:.4f} ms (turns {turns[k]}) at n={N} "
              f"[{card}]", flush=True)
    ok = same1 and untouched
    print(json.dumps({"card": card, "n": N, "ms": ms, "turns_ms": turns,
                      "sass": sass, "flag1_bit_identical": same1,
                      "flag0_untouched": untouched}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
