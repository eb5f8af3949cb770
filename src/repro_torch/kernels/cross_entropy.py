"""Kernel K5: fused cross-entropy, the scaled per-token NLL, in Triton for
Hopper.

``out[t] = (logsumexp(logits[t]) - logits[t, labels[t]]) · scale`` in
fp32, with ``scale`` the 1/N_Sμ MBS normalization (paper eq. 14).

Replaces ``repro/kernels/cross_entropy.py::_ce_kernel``. Bound by bytes:
one read of the (T, V) logits against a few flops an element, so the
design is one streaming pass. Each program owns ``BLOCK_T`` rows and loops
over the vocabulary in ``BLOCK_V`` chunks — the loop takes the place of
the TPU grid's sequential vocab axis, since Hopper's blocks run in no
order and carry nothing between them. The online max/sum update and the
gold logit taken on the fly are the Pallas kernel's, cast for cast:
masked columns are -1e30 (not -inf, so ``m_prev - m_cur`` never becomes
``inf - inf``) and the final sum is clamped at 1e-30. Nothing is padded:
the ragged vocab tail (151,936 = 74 × 2048 + 384) and row tail are masked
in the kernel. A label outside [0, V) hits no column, so its row gives
``lse · scale``, as the Pallas kernel does. Launches turn floating-point
contraction off, as K2–K4 do (K1 rounds its product and sum apart by
intrinsics).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import ref
from ._launch import (FLOAT_DTYPES, LAUNCHES, check_block, is_fake,
                      kernel_scope, lookup_tuned_block)

# The port's own tiles (the TPU's 256 × 2048 was a VMEM size): a few rows
# a program, so the grid spreads a few thousand rows over every SM, and a
# vocab chunk of 16 fp32 elements a thread at 8 warps.
DEFAULT_BLOCK_T = 2
DEFAULT_BLOCK_V = 2048
NUM_WARPS = 8


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ce_kernel(x_ptr, lab_ptr, out_ptr, T, V, stride_t, scale,
                  BLOCK_T: tl.constexpr, BLOCK_V: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        row_ok = rows < T
        labels = tl.load(lab_ptr + rows, mask=row_ok, other=-1)
        base = x_ptr + rows.to(tl.int64)[:, None] * stride_t
        m = tl.full((BLOCK_T,), -1e30, tl.float32)
        l = tl.zeros((BLOCK_T,), tl.float32)
        g = tl.zeros((BLOCK_T,), tl.float32)
        for v0 in range(0, V, BLOCK_V):
            cols = v0 + tl.arange(0, BLOCK_V)
            valid = (cols < V)[None, :] & row_ok[:, None]
            x = tl.load(base + cols[None, :], mask=valid, other=0.0)
            x = tl.where(valid, x.to(tl.float32), -1e30)
            m_cur = tl.maximum(m, tl.max(x, axis=1))
            l = (l * tl.exp(m - m_cur)
                 + tl.sum(tl.where(valid, tl.exp(x - m_cur[:, None]), 0.0),
                          axis=1))
            m = m_cur
            hit = (cols[None, :] == labels[:, None]) & valid
            g = g + tl.sum(tl.where(hit, x, 0.0), axis=1)
        lse = m + tl.log(tl.maximum(l, 1e-30))
        tl.store(out_ptr + rows, (lse - g) * scale, mask=row_ok)

    return triton, ce_kernel


def launch_blocks(logits: torch.Tensor, block_t: Optional[int] = None,
                  block_v: Optional[int] = None,
                  interpret: bool = False) -> Tuple[int, int]:
    """(BLOCK_T, BLOCK_V) for these logits: the arguments, else the
    tuning resolver's (kinds ``cross_entropy_t``/``cross_entropy_v``, the
    reference's), else the defaults. Powers of two only."""
    T, V = logits.shape
    if block_t is None:
        block_t = (lookup_tuned_block("cross_entropy_t", logits.dtype, T,
                                      interpret) or DEFAULT_BLOCK_T)
    if block_v is None:
        block_v = (lookup_tuned_block("cross_entropy_v", logits.dtype, V,
                                      interpret) or DEFAULT_BLOCK_V)
    return (check_block("cross_entropy block_t", block_t),
            check_block("cross_entropy block_v", block_v))


def _check(logits, labels) -> torch.device:
    if logits.dim() != 2 or labels.dim() != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"cross_entropy: expected logits (T, V) and labels "
                         f"(T,), got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if logits.dtype not in FLOAT_DTYPES:
        raise TypeError(f"cross_entropy: unsupported dtype {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cross_entropy: labels must be int32 or int64, got "
                        f"{labels.dtype}")
    if logits.device != labels.device:
        raise ValueError("cross_entropy: logits and labels on different "
                         "devices")
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("cross_entropy: operands must be contiguous")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cross_entropy: no kernel or plain version for "
                         f"device {logits.device}")
    return logits.device


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  scale: float = 1.0, block_t: Optional[int] = None,
                  block_v: Optional[int] = None) -> torch.Tensor:
    """logits: (T, V) fp32 or bf16; labels: (T,) int → per-token NLL (T,)
    fp32, times ``scale``. A CUDA tensor launches K5; a CPU one takes the
    plain version (``ref.cross_entropy_ref · scale``)."""
    dev = _check(logits, labels)
    with kernel_scope("cross_entropy", (), (logits, labels)):
        return _cross_entropy(dev, logits, labels, scale, block_t, block_v)


def _cross_entropy(dev, logits, labels, scale, block_t, block_v):
    bt, bv = launch_blocks(logits, block_t, block_v,
                           interpret=dev.type == "cpu")
    if dev.type == "cpu":
        return ref.cross_entropy_ref(logits, labels) * float(scale)
    T, V = logits.shape
    out = torch.empty(T, dtype=torch.float32, device=dev)
    if T == 0 or is_fake(logits):  # is_fake: shapes only
        return out
    triton, kern = _kernel()
    with torch.cuda.device(dev):
        kern[(triton.cdiv(T, bt),)](logits, labels, out, T, V,
                                   logits.stride(0), float(scale),
                                   BLOCK_T=bt, BLOCK_V=bv,
                                   num_warps=NUM_WARPS,
                                   enable_fp_fusion=False)
    LAUNCHES["cross_entropy"] += 1
    return out
