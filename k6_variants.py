#!/usr/bin/env python3
"""Where K6's bf16 time goes, on one NVIDIA GPU. Run from the repository
root (after ``chip_smoke.py`` has passed, which checks the kernel itself):

    python3 k6_variants.py [--baseline path/to/flash_attention.cu]

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
in variants made from it by editing one part of the bf16 kernel
(``flash_fwd_wgmma``), each with ``nvcc`` as ``kernels/_cuda.py`` builds it
(into ``build/k6_variants``), and times each at the full-width cases of
``chip_smoke.py``'s kernel-API phase, in turns (A B … B A), launched
straight through the library's C entry:

  * ``as_is``: the kernel as it is (checked here against the plain version
    at a few edge shapes, 1 ulp + 2e-5);
  * ``no_turns``: the two consumer warpgroups do not take turns to issue
    their GEMMs (no named barriers);
  * ``branchy``: scale, cap and mask in one loop with a branch per score
    (``if (has_softcap)``, ``if (masked)``), as the first design had them;
  * ``expf``: ``expf(s - m)`` for p instead of the folded ``exp2f``;
  * ``no_p_lo``: PV over ``P_hi`` alone (wrong values; what the split
    costs);
  * ``no_softmax``: the softmax left out (wrong values; what the tensor
    cores and the pipeline take alone);
  * ``--baseline``: another source of the library, e.g. an earlier
    commit's (``git show <commit>:src/repro_torch/kernels/csrc/
    flash_attention.cu > build/baseline.cu``).

Times are ``chip_smoke.py``'s: CUDA events over 20 launches queued behind
a sleep kernel (the device's time, not the host's launch overhead),
beside the library call's. The variants that compute wrong values are
timed, never checked.
Prints one JSON object as its last line. Needs the card, ``nvcc`` and no
network; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "flash_attention.cu")
OUT = os.path.join(ROOT, "build", "k6_variants")

CAP_MASK = '''      if (has_softcap) {
        if (masked) cap_and_mask(std::true_type(), std::true_type(), k0);
        else cap_and_mask(std::true_type(), std::false_type(), k0);
      } else {
        if (masked) cap_and_mask(std::false_type(), std::true_type(), k0);
        else cap_and_mask(std::false_type(), std::false_type(), k0);
      }
'''
BRANCHY = '''#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float x = sc[j] * scale;
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        if (masked) {
          const int row = r0 + 8 * ((j >> 1) & 1);
          const int col = k0 + 8 * (j >> 2) + cq + (j & 1);
          const bool keep = col < S && (!causal || col <= row) &&
                            (!has_window || col > row - window);
          if (!keep) x = -INFINITY;
        }
        sc[j] = x;
      }
'''
EXP2 = "        sc[j] = exp2f((sc[j] - m[r]) * kLog2e);\n"
TURN_WAIT = 'asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");'
TURN_PASS = 'asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");'
P_LO = "        Mma<HD>::rs(acc, p_lo[c], dv);\n"
# (name, [(old, new), ...], computes the right values)
VARIANTS = [
    ("no_turns", [(TURN_WAIT, ""), (TURN_PASS, "")], True),
    ("branchy", [(CAP_MASK, BRANCHY)], True),
    ("expf", [(EXP2, "        sc[j] = expf(sc[j] - m[r]);\n")], True),
    ("no_p_lo", [(P_LO, "")], False),
    ("no_softmax", [("    auto softmax = [&](int i) {\n",
                     "    auto softmax = [&](int i) {\n"
                     "      alpha[0] = alpha[1] = 1.f;\n      return;\n")],
     False),
]
EDGE = [(2, 4, 2, 256, 64, {}), (1, 2, 2, 200, 64, {}),
        (1, 12, 2, 256, 128, {}), (1, 2, 1, 128, 32, {"causal": False}),
        (1, 2, 1, 333, 256, {"window": 64, "softcap": 50.0})]


def build(name: str, source: str):
    """(launch function, error-string function) of a library built from
    ``source`` with the port's own nvcc flags."""
    from repro_torch.kernels import _cuda
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(source)
    proc = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc could not build {name}:\n"
                           f"{proc.stderr[-4000:]}")
    spills = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "spill stores" in ln and not ln.strip().startswith("0 ")]
    lib = ctypes.CDLL(so)
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return (fn, lib.repro_cuda_error_string), spills


def launcher(entry, q, k, v, tile, causal=True, window=None, softcap=None):
    """A launch of one library's bf16 K6, straight through its C entry (as
    ``flash_attention_kernels.flash_attention`` calls it, with ``tile``)."""
    import torch
    fn, err_str = entry
    out = torch.empty_like(q)
    B, H, S, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], S, hd, 1, int(causal), int(window is not None),
            int(window or 0), 1.0 / math.sqrt(hd), int(softcap is not None),
            float(softcap or 0.0), tile[0], tile[1])

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K6 launch failed: {err_str(err).decode()}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another flash_attention.cu to time")
    ap.add_argument("--baseline-tile", default="64x64",
                    help="the tile its bf16 instances take (block_q x "
                         "block_k; 64x64 before the wgmma kernel)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k6_variants: no GPU: this script times K6 on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention_kernels as fa, ref
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with open(SRC) as f:
        source = f.read()
    sources, correct = {"as_is": source}, {"as_is": True}
    for name, edits, right in VARIANTS:
        text = source
        for old, new in edits:
            if old not in text:
                print(f"variant {name}: its pattern is not in the source; "
                      f"skipped", flush=True)
                break
            text = text.replace(old, new)
        else:
            sources[name], correct[name] = text, right
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"], correct["baseline"] = f.read(), True
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, at once
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    libs = {n: b[0] for n, b in built.items()}
    tiles = {n: (lambda hd: fa.tile(torch.bfloat16, hd)) for n in libs}
    if args.baseline:
        bq, bk = (int(x) for x in args.baseline_tile.split("x"))
        tiles["baseline"] = lambda hd: (bq, bk)
    print(f"ptxas spill lines (non-zero) by variant: "
          f"{ {n: b[1] for n, b in built.items()} }", flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    for name in [n for n in libs if correct[n]]:
        for B, H, Hkv, S, hd, kw in EDGE:
            q, k, v = cs._attn_inputs(gen, dev, B, H, Hkv, S, hd,
                                      torch.bfloat16)
            run = launcher(libs[name], q, k, v, tiles[name](hd), **kw)
            err, ok = cs.max_violation(
                run(), ref.attention_ref(q, k, v, **kw), atol=cs.ATTN_ATOL,
                rtol=0.0, bf16_atol=cs.ATTN_ATOL)
            if not ok:
                print(f"variant {name} disagrees with the plain version at "
                      f"B{B} H{H}/{Hkv} S{S} hd{hd} {kw}: {err:.3e}",
                      file=sys.stderr)
                return 1
    print(f"checked at {len(EDGE)} edge shapes: "
          f"{[n for n in libs if correct[n]]}", flush=True)

    names = list(libs)
    order = names + names[::-1]
    results = []
    for case, _, B, H, Hkv, S, hd, opts, lib in cs.ATTN_CASES:
        q, k, v = cs._attn_inputs(gen, dev, B, H, Hkv, S, hd, torch.bfloat16)
        w, cap = opts.get("window"), opts.get("softcap")
        runs = {n: launcher(libs[n], q, k, v, tiles[n](hd), window=w,
                            softcap=cap) for n in names}
        times = {n: [] for n in names}
        for name in order:
            times[name].append(cs.event_ms(runs[name], cs.ATTN_REPS))
        lib_fn = cs._library_call(lib, q, k, v, w, cap)
        lib_fn()
        rec = {"case": case, "library": cs.LIBRARY_CALLS[lib],
               "library_ms": cs.event_ms(lib_fn, cs.ATTN_REPS),
               "variants": {n: {"ms": times[n], "correct": correct[n]}
                            for n in names}}
        results.append(rec)
        print(f"{case}: library {rec['library_ms']:.4f} ms; "
              + ", ".join(f"{n} {'/'.join(f'{t:.4f}' for t in times[n])}"
                          for n in names) + " (ms, A…A)", flush=True)
        del q, k, v, lib_fn, runs
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps({"card": card, "cases": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
