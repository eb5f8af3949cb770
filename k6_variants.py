#!/usr/bin/env python3
"""Where K6's time goes, on one NVIDIA GPU: its bf16 kernel
(``flash_fwd_wgmma``) or, with ``--dtype float32``, its fp32 kernel
(``flash_fwd_simt``). Run from the repository root (after
``chip_smoke.py`` has passed, which checks the kernels themselves):

    python3 k6_variants.py [--dtype float32] [--baseline old/flash_attention.cu]

It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
in variants made from it by editing one part of the chosen kernel, each
with ``nvcc`` as ``kernels/_cuda.py`` builds it (into
``build/k6_variants``), and times each at the full-width cases of
``chip_smoke.py``'s kernel-API phase, in turns (A B … B A), launched
straight through the library's C entry. Every build is checked against
the plain version at a few edge shapes first (bf16 1 ulp + 2e-5, fp32
2e-5), except the variants that compute wrong values on purpose.

bf16 variants:

  * ``as_is``: the kernel as it is;
  * ``no_turns``: the two consumer warpgroups do not take turns to issue
    their GEMMs (no named barriers);
  * ``branchy``: scale, cap and mask in one loop with a branch per score
    (``if (has_softcap)``, ``if (masked)``), as the first design had them;
  * ``expf``: ``expf(s - m)`` for p instead of the folded ``exp2f``;
  * ``no_p_lo``: PV over ``P_hi`` alone (wrong values; what the split
    costs);
  * ``no_softmax``: the softmax left out (wrong values; what the tensor
    cores and the pipeline take alone).

fp32 variants:

  * ``as_is``: the kernel as it is;
  * ``sync_loads``: every group of asynchronous copies waited for right
    after it is issued (no load in flight under the FMAs);
  * ``index_order``: the grid in index order (q-tile fastest, heads in
    order), as the first SIMT kernel's, instead of the heaviest q-tiles
    first with a KV head's q-heads side by side;
  * ``branchy``: scale, cap and mask with a branch per score;
  * ``expf``: ``expf(s - m)`` for p instead of the folded ``exp2f``;
  * ``rows4``: hd 128 as hd 256 (256 threads: PV's 4 rows a thread and
    QK^T's 8 x 4 scores over half of d each) instead of 128 threads (8
    rows, 8 x 4 scores over all of d);
  * ``no_softmax``: scale, cap, mask and softmax left out, the raw scores
    taken as P (wrong values; what the two products, the loads and the
    barriers take alone).

``--baseline``: another source of the library, e.g. an earlier commit's
(``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu >
build/baseline.cu``), launched at ``--baseline-tile`` (for bf16, 64x64
before the wgmma kernel; the fp32 tile has stayed 64x64). ``--source
NAME=PATH`` (repeatable): more sources, timed at the checkout's tiles.

Times are ``chip_smoke.py``'s: CUDA events over 20 launches queued behind
a sleep kernel (the device's time, not the host's launch overhead),
beside the library call's (fp32: TF32 off). For fp32 each case's line
also gives the bound (the kept pairs' FLOPs at 67 TFLOP/s) and each
variant's share of it, and the build lines give ptxas's registers and
spills and the blocks an SM holds (the occupancy calculator) for every
fp32 instance. The variants that compute wrong values are timed, never
checked. Prints one JSON object as its last line. Needs the card, ``nvcc``
and no network; without a card it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
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

# the fp32 kernel's parts, as the source has them
SIMT_GRID = '''  int idx = blockIdx.x;
  const int g = idx % G;
  idx /= G;
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  const int q0 = (nq - 1 - idx / B) * kTile;
  const int h = hk * G + g;
'''
SIMT_INDEX_ORDER = '''  int idx = blockIdx.x;
  const int q0 = (idx % nq) * kTile;
  idx /= nq;
  const int h = idx % H;
  const int b = idx / H;
  const int hk = h / G;
'''
SIMT_CAP_MASK = '''    if (has_softcap) {
      if (masked) cap_and_mask(std::true_type(), std::true_type());
      else cap_and_mask(std::true_type(), std::false_type());
    } else {
      if (masked) cap_and_mask(std::false_type(), std::true_type());
      else cap_and_mask(std::false_type(), std::false_type());
    }
'''
SIMT_BRANCHY = '''#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = f[i][j] * scale;
        if (has_softcap) x = tanhf(x / softcap) * softcap;
        if (masked) {
          const int row = q0 + 8 * sy + KR * dh + i;
          const int col = k0 + sx + 16 * j;
          const bool keep = col < S && (!causal || col <= row) &&
                            (!has_window || col > row - window);
          if (!keep) x = -INFINITY;
        }
        f[i][j] = x;
      }
'''
SIMT_EXP2 = "        f[i][j] = exp2f((f[i][j] - m_cur) * kLog2e);\n"
SIMT_SOFTMAX = "    for (int i = 0; i < KR; ++i) {\n      float mx = fmaxf("
SIMT_ALPHA = "    float alpha[KR];\n"
SIMT_ROWS = "return hd == 256 ? 4 : 8;"
SIMT_VARIANTS = [
    ("sync_loads", [("cp_commit();", "cp_commit();\n    cp_wait<0>();")],
     True),
    ("index_order", [(SIMT_GRID, SIMT_INDEX_ORDER)], True),
    ("branchy", [(SIMT_CAP_MASK, SIMT_BRANCHY)], True),
    ("expf", [(SIMT_EXP2, "        f[i][j] = expf(f[i][j] - m_cur);\n")],
     True),
    ("rows4", [(SIMT_ROWS, "return hd >= 128 ? 4 : 8;")], True),
    ("no_softmax", [(SIMT_CAP_MASK, ""),
                    (SIMT_SOFTMAX, SIMT_SOFTMAX.replace("i < KR", "i < 0")),
                    (SIMT_ALPHA, SIMT_ALPHA + "    for (int i = 0; i < KR; ++i) "
                                              "alpha[i] = 1.f;\n")],
     False),
]
# the fp32 edges: S one below, one above and below the 64-row tile, and hd
# 256 with the gemma layers' GQA group (2), window and cap
SIMT_EDGE = [(2, 4, 2, 256, 64, {}), (1, 2, 2, 63, 64, {}),
             (1, 4, 2, 65, 128, {}), (1, 12, 2, 256, 128, {}),
             (1, 2, 1, 128, 32, {"causal": False}), (1, 2, 1, 20, 256, {}),
             (1, 4, 2, 333, 256, {"window": 64, "softcap": 50.0})]


def ptxas_instances(log: str) -> dict:
    """ptxas's registers and spill bytes by fp32 instance ('simt hd 128')
    in a build's log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            hd = re.search(r"flash_fwd_simtI\D*?(\d+)E", m.group(1))
            cur = f"simt hd {hd.group(1)}" if hd else None
            if cur:
                out[cur] = {}
        elif cur and "spill stores" in line:
            st, ld = (int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
            out[cur].update(spill_stores=st, spill_loads=ld)
        elif cur and "Used " in line:
            out[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def build(name: str, source: str):
    """((launch function, error-string function), non-zero spill lines,
    the fp32 instances' ptxas lines, the library) of a library built from
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
    log = proc.stdout + proc.stderr
    spills = [ln.strip() for ln in log.splitlines()
              if "spill stores" in ln and not ln.strip().startswith("0 ")]
    lib = ctypes.CDLL(so)
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return ((fn, lib.repro_cuda_error_string), spills, ptxas_instances(log),
            lib)


def occupancy(lib):
    """The fp32 kernel's (blocks an SM holds, threads a block), by head
    dim, from the library's occupancy query; None for a library without
    one."""
    fn = getattr(lib, "repro_flash_attention_simt_occupancy", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for hd in (32, 64, 128, 256):
        threads = ctypes.c_int(0)
        out[hd] = (fn(hd, ctypes.byref(threads)), threads.value)
    return out


def launcher(entry, q, k, v, tile, causal=True, window=None, softcap=None):
    """A launch of one library's K6, straight through its C entry (as
    ``flash_attention_kernels.flash_attention`` calls it, with ``tile``):
    the bf16 kernel on bf16 inputs, the fp32 one on fp32."""
    import torch
    fn, err_str = entry
    out = torch.empty_like(q)
    B, H, S, hd = q.shape
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], S, hd, int(q.dtype == torch.bfloat16), int(causal),
            int(window is not None), int(window or 0), 1.0 / math.sqrt(hd),
            int(softcap is not None), float(softcap or 0.0), tile[0],
            tile[1])

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K6 launch failed: {err_str(err).decode()}")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16", help="the kernel to take apart")
    ap.add_argument("--baseline", help="another flash_attention.cu to time")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH",
                    help="more sources of the library to check and time "
                         "beside it, at the checkout's tiles")
    ap.add_argument("--baseline-tile", default="64x64",
                    help="the tile its instances of the dtype take (block_q "
                         "x block_k; bf16 64x64 before the wgmma kernel)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k6_variants: no GPU: this script times K6 on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention_kernels as fa, ref
    dtype = getattr(torch, args.dtype)
    fp32 = dtype == torch.float32
    if fp32:  # the library calls on fp32 inputs, as chip_smoke times them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with open(SRC) as f:
        source = f.read()
    sources, correct = {"as_is": source}, {"as_is": True}
    for name, edits, right in SIMT_VARIANTS if fp32 else VARIANTS:
        text = source
        for old, new in edits:
            if old not in text:
                print(f"variant {name}: its pattern is not in the source; "
                      f"skipped", flush=True)
                break
            text = text.replace(old, new)
        else:
            sources[name], correct[name] = text, right
    for name, path in [s.split("=", 1) for s in args.source] + (
            [("baseline", args.baseline)] if args.baseline else []):
        with open(path) as f:
            sources[name], correct[name] = f.read(), True
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, at once
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    libs = {n: b[0] for n, b in built.items()}
    tiles = {n: (lambda hd: fa.tile(dtype, hd)) for n in libs}
    if args.baseline:
        bq, bk = (int(x) for x in args.baseline_tile.split("x"))
        tiles["baseline"] = lambda hd: (bq, bk)
    print(f"ptxas spill lines (non-zero) by variant: "
          f"{ {n: b[1] for n, b in built.items()} }", flush=True)
    occupied = {}
    if fp32:
        for n, b in built.items():
            occupied[n] = occupancy(b[3])
            print(f"fp32 instances of {n}: ptxas {b[2]}; (blocks an SM "
                  f"holds, threads a block) by head dim {occupied[n]}",
                  flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    edge = SIMT_EDGE if fp32 else EDGE
    for name in [n for n in libs if correct[n]]:
        for B, H, Hkv, S, hd, kw in edge:
            q, k, v = cs._attn_inputs(gen, dev, B, H, Hkv, S, hd, dtype)
            run = launcher(libs[name], q, k, v, tiles[name](hd), **kw)
            err, ok = cs.max_violation(
                run(), ref.attention_ref(q, k, v, **kw), atol=cs.ATTN_ATOL,
                rtol=0.0, bf16_atol=cs.ATTN_ATOL)
            if not ok:
                print(f"variant {name} disagrees with the plain version at "
                      f"B{B} H{H}/{Hkv} S{S} hd{hd} {kw}: {err:.3e}",
                      file=sys.stderr)
                return 1
    print(f"checked at {len(edge)} edge shapes: "
          f"{[n for n in libs if correct[n]]}", flush=True)

    names = list(libs)
    order = names + names[::-1]
    results = []
    for case, _, B, H, Hkv, S, hd, opts, lib in cs.ATTN_CASES:
        q, k, v = cs._attn_inputs(gen, dev, B, H, Hkv, S, hd, dtype)
        w, cap = opts.get("window"), opts.get("softcap")
        runs = {n: launcher(libs[n], q, k, v, tiles[n](hd), window=w,
                            softcap=cap) for n in names}
        times = {n: [] for n in names}
        for name in order:
            times[name].append(cs.event_ms(runs[name], cs.ATTN_REPS))
        errs = {}
        if fp32:  # the variants that compute the right values, at full width
            want = ref.attention_ref(q, k, v, window=w, softcap=cap)
            for name in [n for n in names if correct[n]]:
                errs[name], ok = cs.max_violation(runs[name](), want,
                                                  atol=cs.ATTN_ATOL, rtol=0.0)
                if not ok:
                    print(f"variant {name} disagrees with the plain version "
                          f"at {case}: {errs[name]:.3e}", file=sys.stderr)
                    return 1
            del want
        lib_fn = cs._library_call(lib, q, k, v, w, cap)
        lib_fn()
        rec = {"case": case, "dtype": args.dtype,
               "library": cs.LIBRARY_CALLS[lib],
               "library_ms": cs.event_ms(lib_fn, cs.ATTN_REPS),
               "variants": {n: {"ms": times[n], "correct": correct[n]}
                            for n in names}}
        bound = ""
        if fp32:
            flops = 4 * hd * cs.kept_pairs(S, True, w) * B * H
            rec["bound_ms"] = flops / cs.FP32_FLOPS_PER_S * 1e3
            for n in names:
                rec["variants"][n]["pct_of_bound"] = [
                    100.0 * rec["bound_ms"] / t for t in times[n]]
                if n in errs:
                    rec["variants"][n]["max_abs_err"] = errs[n]
            bound = f"; bound {rec['bound_ms']:.4f} ms (67 TFLOP/s fp32)"
        results.append(rec)
        print(f"{case} {args.dtype}: library {rec['library_ms']:.4f} ms"
              f"{bound}; "
              + ", ".join(f"{n} {'/'.join(f'{t:.4f}' for t in times[n])}"
                          for n in names) + " (ms, A…A)", flush=True)
        del q, k, v, lib_fn, runs
        torch.cuda.empty_cache()
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps({"card": card, "dtype": args.dtype,
                      "ptxas_fp32": {n: b[2] for n, b in built.items()},
                      "occupancy_fp32": occupied, "cases": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
