"""Kernel K1: fused normalized gradient accumulation, in Triton for Hopper.

Paper Fig. 2 step ❹ + eq. (14): ``acc ← acc + grad · scale`` with
``scale = 1/N_Sμ`` (or ``1/N_B_valid`` in exact mode), written in place
on the fp32 accumulator; the gradient may arrive in bf16.

Replaces ``repro/kernels/grad_accum.py::_accum_kernel`` (the Pallas
kernel, ``input_output_aliases={1: 0}``). Bound by bytes: 12 bytes an
element for fp32 operands (read acc, read grad, write acc) against two
flops, so the design is one masked, vectorised pass over a 1-D grid
(``_launch.stream_geometry``) that keeps every load 16 bytes wide. The
scale arrives as a 1-element fp32 device tensor, the counterpart of the
Pallas ``scale_ref``: no host sync per micro-batch. The ragged tail is
masked in the kernel; nothing is padded. Floating-point contraction is
off, so the kernel rounds the product and the sum as the plain version
does.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .. import tree
from . import ref
from ._launch import LAUNCHES, check_buffers, scalars, stream_geometry


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def accum_kernel(acc_ptr, g_ptr, s_ptr, n, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        acc = tl.load(acc_ptr + offs, mask=mask)
        g = tl.load(g_ptr + offs, mask=mask)
        s = tl.load(s_ptr).to(acc.dtype)
        tl.store(acc_ptr + offs, acc + g.to(acc.dtype) * s, mask=mask)

    return triton, accum_kernel


def _launch(acc: torch.Tensor, grad: torch.Tensor, s: torch.Tensor) -> None:
    """Launch K1 on CUDA tensors; raises (never falls back) when there is
    no GPU or no Triton."""
    triton, kern = _kernel()
    n = acc.numel()
    block, warps = stream_geometry("grad_accum", acc.dtype, n)
    with torch.cuda.device(acc.device):
        kern[(triton.cdiv(n, block),)](acc, grad, s, n, BLOCK=block,
                                       num_warps=warps,
                                       enable_fp_fusion=False)
    LAUNCHES["grad_accum"] += 1


def grad_accum(acc: torch.Tensor, grad: torch.Tensor, scale) -> torch.Tensor:
    """acc += scale * grad, in place on ``acc`` (returned). acc: (N,) fp32;
    grad: (N,) fp32 or bf16; scale: a number or a 1-element tensor.
    A CUDA ``acc`` launches K1; a CPU one takes the plain version."""
    dev = check_buffers("grad_accum", (acc, grad))
    s = scalars(dev, scale)
    if dev.type == "cuda":
        _launch(acc, grad, s)
        return acc
    return acc.copy_(ref.grad_accum_ref(acc, grad, s))


def grad_accum_tree(acc_tree, grad_tree, scale):
    """K1 leaf by leaf over parameter trees (each leaf viewed as 1-D) —
    the ``fused`` executor's per-leaf path, O(num_leaves) launches."""
    return tree.map(lambda a, g: grad_accum(a.view(-1), g.reshape(-1),
                                            scale).view(a.shape),
                    acc_tree, grad_tree)


def grad_accum_buckets(acc_buffers: Sequence[torch.Tensor],
                       grad_buffers: Sequence[torch.Tensor], scale
                       ) -> Tuple[torch.Tensor, ...]:
    """One K1 launch per dtype bucket of ``engine.flat.FlatSpec``."""
    return tuple(grad_accum(a, g, scale)
                 for a, g in zip(acc_buffers, grad_buffers))
