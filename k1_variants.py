#!/usr/bin/env python3
"""Where K1's time goes, on one NVIDIA GPU. Run from the repository root
(after ``chip_smoke.py`` has passed, which checks the kernel itself):

    python3 k1_variants.py

It builds ``src/repro_torch/kernels/csrc/grad_accum.cu`` as it is and in
variants made from it by editing one part, each with ``nvcc`` as
``kernels/_cuda.py`` builds it (into ``build/k1_variants``, all at once),
checks every variant bit for bit against the plain version at a few
ragged and unaligned pairs, and times each in turns (A B … B A) at the
main path's gradient: qwen2-1.5b's 14 leaves (one tensor a leaf) into one
fp32 bucket, and the same bucket as one flat pair, launched straight
through the library's C entry, beside ``add_`` on the flat pair:

  * ``as_is``: the kernel as it is, at ``_launch.stream_geometry``'s
    block (4096 elements, 8 warps at this size);
  * ``plain_hints``: ordinary loads and stores instead of the streaming
    ``__ldcs``/``__stcs``;
  * ``unroll2`` / ``unroll8``: a thread loads 2 or 8 16-byte vectors of
    each operand before its first store, instead of 4;
  * ``block2048`` / ``block8192``: the source as it is at 2048 elements
    over 4 warps or 8192 over 8 warps a block.

Times are ``chip_smoke.py``'s: CUDA events over 10 launches queued behind
a sleep kernel (the device's time, not the host's launch overhead).
Prints one JSON object as its last line. Needs the card, ``nvcc`` and no
network; without a card it exits non-zero.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "grad_accum.cu")
OUT = os.path.join(ROOT, "build", "k1_variants")
REPS = 10

INCLUDES = "#include <type_traits>\n"
PLAIN_HINTS = ("#include <type_traits>\n#define __ldcs(p) (*(p))\n"
               "#define __stcs(p, v) (*(p) = (v))\n")
UNROLL = "constexpr int kUnroll = 4;"
# (name, [(old, new), ...])
SOURCES = [
    ("plain_hints", [(INCLUDES, PLAIN_HINTS)]),
    ("unroll2", [(UNROLL, "constexpr int kUnroll = 2;")]),
    ("unroll8", [(UNROLL, "constexpr int kUnroll = 8;")]),
]
# (name, library, (block, warps) or None for stream_geometry's)
RUNS = [("as_is", "as_is", None), ("plain_hints", "plain_hints", None),
        ("unroll2", "unroll2", None), ("unroll8", "unroll8", None),
        ("block2048", "as_is", (2048, 4)), ("block8192", "as_is", (8192, 8))]


def build(name: str, source: str):
    """The launch function of a library built from ``source`` with the
    port's own nvcc flags, and ptxas's register lines."""
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
    regs = [ln.split(":")[-1].strip()
            for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill stores" in ln]
    lib = ctypes.CDLL(so)
    fn = lib.repro_grad_accum
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, regs


def launcher(fn, accs, grads, s, geometry):
    """One launch of a library's K1 over the pairs (fp32 accumulators, one
    gradient dtype), straight through its C entry."""
    import torch
    from repro_torch.kernels import _launch
    k = len(accs)
    n_total = sum(a.numel() for a in accs)
    block, warps = geometry or _launch.stream_geometry(
        "grad_accum", accs[0].dtype, n_total)
    ptrs = ctypes.c_void_p * k
    args = (ptrs(*(a.data_ptr() for a in accs)),
            ptrs(*(g.data_ptr() for g in grads)),
            (ctypes.c_longlong * k)(*(a.numel() for a in accs)), k,
            s.data_ptr(), int(accs[0].dtype == torch.bfloat16),
            int(grads[0].dtype == torch.bfloat16), block, warps)

    def run():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")
    return run


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_variants: no GPU: this script times K1 on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.engine import FlatSpec
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    with open(SRC) as f:
        source = f.read()
    sources = {"as_is": source}
    for name, edits in SOURCES:
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: its pattern is not in "
                                   f"the source")
            text = text.replace(old, new)
        sources[name] = text
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, at once
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    print(f"ptxas by variant: { {n: b[1] for n, b in built.items()} }",
          flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    s = torch.full((1,), 0.25, device=dev)
    for name, lib, geometry in RUNS:  # bit for bit, unaligned and ragged
        for adt, gdt in ((torch.float32, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.bfloat16)):
            buf = torch.randn(30000, generator=gen, device=dev).to(adt)
            offs, sizes = [0, 4099, 12001, 20004], [4097, 7000, 1, 9000]
            accs = [buf[o:o + n] for o, n in zip(offs, sizes)]
            grads = [torch.randn(n, generator=gen, device=dev).to(gdt)
                     for n in sizes]
            want = buf.clone()
            for o, n, g in zip(offs, sizes, grads):
                want[o:o + n] = ref.grad_accum_ref(want[o:o + n], g, s)
            launcher(built[lib][0], accs, grads, s, geometry)()
            torch.cuda.synchronize()
            if not torch.equal(buf, want):
                print(f"variant {name} ({adt}, {gdt}) is not bit-identical "
                      f"to the plain version", file=sys.stderr)
                return 1
    print(f"checked bit for bit: {[r[0] for r in RUNS]}", flush=True)

    params = transformer.init_params(configs.get("qwen2-1.5b"), seed=0,
                                     device=dev)
    spec = FlatSpec.for_tree(params)
    del params
    torch.cuda.empty_cache()
    n = spec.bucket_sizes[0]
    acc = torch.randn(n, generator=gen, device=dev)
    leaves = ([acc[sl.offset:sl.offset + sl.size] for sl in spec.slots],
              [torch.randn(sl.size, generator=gen, device=dev)
               for sl in spec.slots])
    gflat = torch.randn(n, generator=gen, device=dev)
    layouts = {"leaves": leaves, "flat_pair": ([acc], [gflat])}
    names = [r[0] for r in RUNS] + ["add_"]
    order = names + names[::-1]
    results = {}
    for layout, (accs, grads) in layouts.items():
        runs = {name: launcher(built[lib][0], accs, grads, s, geometry)
                for name, lib, geometry in RUNS}
        runs["add_"] = lambda: acc.add_(gflat, alpha=0.25)
        times = {name: [] for name in names}
        for name in order:
            times[name].append(cs.event_ms(runs[name], REPS))
        results[layout] = times
        print(f"{layout} ({len(accs)} pairs, {n} fp32 elements; bound "
              f"{n * 12 / cs.HBM_BYTES_PER_S * 1e3:.4f} ms): "
              + ", ".join(f"{k} {'/'.join(f'{t:.4f}' for t in v)}"
                          for k, v in times.items()) + " (ms, A…A)",
              flush=True)
    print(f"card: {cs.card_line()}", flush=True)
    print(json.dumps({"card": card, "n": n, "leaves": len(spec.slots),
                      "bound_ms": n * 12 / cs.HBM_BYTES_PER_S * 1e3,
                      "times": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
