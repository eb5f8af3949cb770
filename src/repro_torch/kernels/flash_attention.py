"""Kernel K6: forward flash attention, in CUDA C++ for Hopper
(``csrc/flash_attention.cu``, built and loaded by ``_cuda``).

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``: blockwise
online-softmax attention whose (S, S) score matrix never exists, with
causal and sliding-window masks (fully masked k-tiles skipped), tanh
soft-capping and GQA. The wrapper checks the operands, picks the tiles and
launches on the current stream; a CPU tensor takes the plain version
(``ref.attention_ref``).

The library holds two kernels, and the wrapper dispatches by dtype (not a
fallback: each dtype has exactly one kernel, and a launch that fails
raises):

  * bf16 → ``wgmma_bf16``: QKᵀ and PV on the tensor cores (``wgmma``),
    K/V tiles fed by TMA into a 2-stage ring, warp-specialised. P enters
    PV as two bf16 terms, ``P_hi = bf16(P)`` and ``P_lo = bf16(P − P_hi)``,
    into one fp32 accumulator, so the reference's fp32 P is kept to ~16
    bits where one bf16 rounding would keep 8. Its operands must be
    16-byte aligned (TMA), which the wrapper checks.
  * fp32 → ``simt_fp32``: both products as fp32 FMAs on the CUDA cores
    (``wgmma`` on fp32 operands is TF32, which would drop the reference's
    fp32 products): 64 × 64 tiles, each thread an 8 × 4 block of scores
    and a block of the output in registers (8 rows of 128 threads at
    hd ≤ 128; 4 rows of 256 at hd 256, where QKᵀ's d is split between
    the two halves of a warp), fed by 16-byte shared loads (Q staged
    transposed, K row-major and padded), K/V tiles brought in by
    ``cp.async`` under the FMAs, the bf16 kernel's grid order and
    branch-free masks; its operands are 16-byte aligned (an unaligned
    one is copied, :func:`aligned16`). Blocks an SM:
    :func:`simt_occupancy`.

The design and what bounds it are noted in the source. Each kernel has one
tile per head dim, in :data:`TILES`: bf16 128 × 128 at hd ≤ 128 and
128 × 64 at hd 256, fp32 64 × 64 at every head dim. ``block_q`` and
``block_k`` are kept, as the reference's arguments and the tuner's keys
(``flash_q``/``flash_k``), and take only the instance's tile; another
tile gets an instance once a tuner has measured that it pays. The kernels
mask the ragged tail of S themselves, so no copy is padded; the
reference's contract is kept all the same: where S is not a multiple of
the tiles (each clamped to S), only causal attention is accepted, as the
reference's padded path asserts.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _cuda, ref
from ._launch import (FLOAT_DTYPES, LAUNCHES, VARIANT_LAUNCHES, check_block,
                      is_fake, kernel_scope, lookup_tuned_block)

HEAD_DIMS = (32, 64, 128, 256)
# (block_q, block_k) of the one kernel instance for each (dtype, head dim)
TILES = {**{(torch.float32, hd): (64, 64) for hd in HEAD_DIMS},
         **{(torch.bfloat16, hd): (128, 64 if hd == 256 else 128)
            for hd in HEAD_DIMS}}
# the kernel each dtype launches, as counted in VARIANT_LAUNCHES
VARIANTS = {torch.bfloat16: "wgmma_bf16", torch.float32: "simt_fp32"}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _cuda.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def smem_bytes(hd: int, dtype) -> int:
    """The dynamic shared memory K6 asks for at head dim ``hd`` for
    ``dtype`` inputs, in bytes, as the library computes it (builds the
    library at first use)."""
    fn = _cuda.load("flash_attention").repro_flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(hd, int(dtype == torch.bfloat16)))


def simt_occupancy(hd: int) -> Tuple[int, int]:
    """(blocks an SM holds, threads a block) of the fp32 kernel at head
    dim ``hd``, the blocks as the CUDA occupancy calculator gives them for
    its threads, registers and shared memory (builds the library at first
    use; needs the card)."""
    fn = _cuda.load("flash_attention").repro_flash_attention_simt_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    threads = ctypes.c_int(0)
    blocks = fn(hd, ctypes.byref(threads))
    return int(blocks), int(threads.value)


def tile(dtype, hd: Optional[int] = None) -> Tuple[int, int]:
    """The instance's (block_q, block_k) for ``dtype`` at head dim ``hd``.
    Without ``hd``, the dtype's tile where it is one for every head dim
    (fp32's); bf16's depends on the head dim and needs it."""
    if hd is not None:
        if (dtype, hd) not in TILES:
            raise ValueError(f"flash_attention: no kernel instance for "
                             f"{dtype} at head dim {hd}")
        return TILES[(dtype, hd)]
    tiles = {t for (dt, _), t in TILES.items() if dt == dtype}
    if len(tiles) != 1:
        raise ValueError(f"flash_attention: the {dtype} tile depends on the "
                         f"head dim; pass hd")
    return tiles.pop()


def launch_blocks(S: int, dtype, block_q: Optional[int] = None,
                  block_k: Optional[int] = None, interpret: bool = False,
                  hd: Optional[int] = None) -> Tuple[int, int]:
    """(block_q, block_k) for a sequence of ``S``: the arguments, else the
    tuning resolver's (kinds ``flash_q``/``flash_k``, the reference's),
    else the instance's tile (:func:`tile`). Only that tile is taken."""
    inst = tile(dtype, hd)
    if block_q is None:
        block_q = _tuned("flash_q", dtype, S, interpret, inst[0]) or inst[0]
    if block_k is None:
        block_k = _tuned("flash_k", dtype, S, interpret, inst[1]) or inst[1]
    for what, blk, want in (("block_q", block_q, inst[0]),
                            ("block_k", block_k, inst[1])):
        check_block(f"flash_attention {what}", blk)
        if blk != want:
            raise ValueError(f"flash_attention: no kernel instance for "
                             f"{what} {blk}; {dtype} at head dim {hd} has "
                             f"the tile {inst}")
    return block_q, block_k


def _tuned(kind: str, dtype, S: int, interpret: bool,
           inst: int) -> Optional[int]:
    """The resolver's tile, clamped to S. A tile that spans S is one tile
    for the whole sequence, which the instance's tile gives as well when
    it covers S (the kernel masks rows and columns past S)."""
    blk = lookup_tuned_block(kind, dtype, S, interpret)
    if blk is not None and blk >= S and inst >= S:
        blk = inst
    return blk


def check_aligned(*tensors: torch.Tensor) -> None:
    """The bf16 kernel reads its operands through TMA, which needs each
    base address 16-byte aligned: raise on one that is not."""
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: bf16 operands must be "
                             f"16-byte aligned for TMA; one starts at "
                             f"address {x.data_ptr():#x}")


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it at a 16-byte aligned address: the fp32
    kernel moves its operands in 16-byte chunks (``cp.async``, float4
    loads and stores) and refuses an unaligned one."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(q, k, v) -> torch.device:
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError("flash_attention: q, k, v must be 4-D tensors "
                             "(B, H, S, hd)")
    B, H, S, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, hd):
        raise ValueError(f"flash_attention: expected k, v (B, Hkv, S, hd) "
                         f"beside q {tuple(q.shape)}, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if k.shape[1] < 1 or H % k.shape[1]:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} has no kernel "
                         f"instance; the head dims are {HEAD_DIMS}")
    if q.dtype not in FLOAT_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{FLOAT_DTYPES}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel or plain version for "
                         f"device {q.device}")
    return q.device


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) → (B, H, S, hd) in q's
    dtype. A CUDA tensor launches K6 (bf16: the wgmma kernel, fp32: the
    SIMT kernel); a CPU one takes the plain version."""
    dev = _check(q, k, v)
    with kernel_scope("flash_attention", (), (q, k, v)):
        return _attention(dev, q, k, v, causal, window, softcap, block_q,
                          block_k)


def _attention(dev, q, k, v, causal, window, softcap, block_q, block_k):
    B, H, S, hd = q.shape
    bq, bk = launch_blocks(S, q.dtype, block_q, block_k,
                           interpret=dev.type == "cpu", hd=hd)
    if not causal and S and (S % min(bq, S) or S % min(bk, S)):
        raise ValueError(f"flash_attention: S={S} is not a multiple of the "
                         f"tiles ({bq}, {bk}); there, as in the reference, "
                         f"only causal attention is accepted")
    if dev.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    out = torch.empty_like(q)
    if out.numel() == 0 or is_fake(q):  # is_fake: shapes only
        return out
    fn, err_str = _entry()
    if q.dtype == torch.bfloat16:
        check_aligned(q, k, v, out)
    else:
        q, k, v = (aligned16(x) for x in (q, k, v))
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, k.shape[1], S, hd, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), int(window is not None),
                 int(window or 0), 1.0 / math.sqrt(hd),
                 int(softcap is not None), float(softcap or 0.0), bq, bk,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention: the launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[VARIANTS[q.dtype]] += 1
    return out
