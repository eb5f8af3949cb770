"""Kernel K6: forward flash attention, in CUDA C++ for Hopper
(``csrc/flash_attention.cu``, built and loaded by ``_cuda``).

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``: blockwise
online-softmax attention whose (S, S) score matrix never exists, with
causal and sliding-window masks (fully masked k-tiles skipped), tanh
soft-capping and GQA. The kernel's design and what bounds it are noted in
the source. The wrapper checks the operands, picks the tiles and launches
on the current stream; a CPU tensor takes the plain version
(``ref.attention_ref``).

The kernel has one tile, 64 × 64, instantiated for ``hd`` ∈ {32, 64,
128, 256} — the head dims of every config of the reference, full and
reduced. ``block_q``/``block_k`` are kept, as the reference's arguments
and the tuner's keys, and take only the tiles in :data:`TILES`; another
tile gets an instance once a tuner has measured that it pays. The kernel
masks the ragged tail of S itself, so no copy is padded; the reference's
contract is kept all the same: where S is not a multiple of the tiles
(each clamped to S), only causal attention is accepted, as the
reference's padded path asserts.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import _cuda, ref
from ._launch import FLOAT_DTYPES, LAUNCHES, check_block, lookup_tuned_block

HEAD_DIMS = (32, 64, 128, 256)
TILES = (64,)
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64


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


def smem_bytes(hd: int) -> int:
    """The dynamic shared memory K6 asks for at head dim ``hd``, in bytes,
    as the library computes it (builds the library at first use)."""
    fn = _cuda.load("flash_attention").repro_flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(hd))


def launch_blocks(S: int, dtype, block_q: Optional[int] = None,
                  block_k: Optional[int] = None,
                  interpret: bool = False) -> Tuple[int, int]:
    """(block_q, block_k) for a sequence of ``S``: the arguments, else the
    tuning resolver's (kinds ``flash_q``/``flash_k``, the reference's),
    else 64 × 64. Only the tiles the kernel has instances for are taken."""
    if block_q is None:
        block_q = _tuned("flash_q", dtype, S, interpret) or DEFAULT_BLOCK_Q
    if block_k is None:
        block_k = _tuned("flash_k", dtype, S, interpret) or DEFAULT_BLOCK_K
    for what, blk in (("block_q", block_q), ("block_k", block_k)):
        check_block(f"flash_attention {what}", blk)
        if blk not in TILES:
            raise ValueError(f"flash_attention: no kernel instance for "
                             f"{what} {blk}; the tiles are {TILES}")
    return block_q, block_k


def _tuned(kind: str, dtype, S: int, interpret: bool) -> Optional[int]:
    """The resolver's tile, clamped to S. A tile that spans S is one tile
    for the whole sequence, which the smallest instance that covers S
    gives as well (the kernel masks rows and columns past S)."""
    blk = lookup_tuned_block(kind, dtype, S, interpret)
    if blk is not None and blk >= S:
        blk = next((t for t in TILES if t >= S), blk)
    return blk


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
    dtype. A CUDA tensor launches K6; a CPU one takes the plain version."""
    dev = _check(q, k, v)
    B, H, S, hd = q.shape
    bq, bk = launch_blocks(S, q.dtype, block_q, block_k,
                           interpret=dev.type == "cpu")
    if not causal and S and (S % min(bq, S) or S % min(bk, S)):
        raise ValueError(f"flash_attention: S={S} is not a multiple of the "
                         f"tiles ({bq}, {bk}); there, as in the reference, "
                         f"only causal attention is accepted")
    if dev.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    fn, err_str = _entry()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
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
    return out
