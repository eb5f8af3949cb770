"""Kernel K1: fused normalized gradient accumulation, in CUDA C++ for
Hopper (``csrc/grad_accum.cu``, built and loaded by ``_cuda``).

Paper Fig. 2 step ❹ + eq. (14): ``acc ← acc + grad · scale`` with
``scale = 1/N_Sμ`` (or ``1/N_B_valid`` in exact mode), written in place
on the fp32 accumulator; the gradient may arrive in bf16.

Replaces ``repro/kernels/grad_accum.py::_accum_kernel`` (the Pallas
kernel, ``input_output_aliases={1: 0}``). Bound by bytes: 12 an element
for fp32 operands (read acc, read grad, write acc) against two flops. One
launch takes a list of (accumulator, gradient) pairs, so the flat
executor adds each gradient leaf, where autograd left it, into its slice
of the flat accumulator: the concatenated copy that a one-operand kernel
needs (8 more bytes an element, and a second gradient live) is never
made. The scale arrives as a
1-element fp32 device tensor, the counterpart of the Pallas ``scale_ref``:
no host sync per micro-batch. The design is noted in the source.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .. import tree
from . import _cuda, ref
from ._launch import (FLOAT_DTYPES, LAUNCHES, check_buffers, is_fake,
                      kernel_scope, scalars, stream_geometry)

# pairs a launch takes: the source's kMaxEntries (it refuses more)
MAX_ENTRIES = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# bytes of gradient the wrapper copied to make a leaf contiguous (the
# kernel reads each leaf in place; a strided one is copied alone)
COPIED_BYTES = {"grad_accum": 0}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _cuda.load("grad_accum")
    fn = lib.repro_grad_accum
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib.repro_cuda_error_string


def launch_groups(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                  ) -> List[List[int]]:
    """Indices of ``pairs`` by launch: pairs of one (accumulator dtype,
    gradient dtype), in order, at most ``MAX_ENTRIES`` to a launch; empty
    pairs are left out (they have nothing to add)."""
    by_dtype: Dict[tuple, List[int]] = {}
    for i, (a, g) in enumerate(pairs):
        if a.numel():
            by_dtype.setdefault((a.dtype, g.dtype), []).append(i)
    return [idx[lo:lo + MAX_ENTRIES] for idx in by_dtype.values()
            for lo in range(0, len(idx), MAX_ENTRIES)]


def _launch(accs: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
            s: torch.Tensor, block: Optional[int] = None) -> None:
    """One K1 launch over contiguous CUDA pairs of one dtype pair (at most
    ``MAX_ENTRIES``); raises (never falls back) when there is no GPU or no
    ``nvcc``, or when the launch fails."""
    fn, err_str = _entry()
    k = len(accs)
    n_total = sum(a.numel() for a in accs)
    block, warps = stream_geometry("grad_accum", accs[0].dtype, n_total,
                                   block)
    ptrs = ctypes.c_void_p * k
    dev = accs[0].device
    with torch.cuda.device(dev):
        err = fn(ptrs(*(a.data_ptr() for a in accs)),
                 ptrs(*(g.data_ptr() for g in grads)),
                 (ctypes.c_longlong * k)(*(a.numel() for a in accs)), k,
                 s.data_ptr(), _DTYPE_CODE[accs[0].dtype],
                 _DTYPE_CODE[grads[0].dtype], block, warps,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"grad_accum: the launch failed: "
                           f"{err_str(err).decode()} (cudaError {err})")
    LAUNCHES["grad_accum"] += 1


def _check_pairs(accs, grads) -> torch.device:
    if len(accs) != len(grads):
        raise ValueError(f"grad_accum: {len(accs)} accumulators for "
                         f"{len(grads)} gradients")
    dev = accs[0].device
    for a, g in zip(accs, grads):
        for x in (a, g):
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"grad_accum: expected tensors, got "
                                f"{type(x)!r}")
            if x.dtype not in FLOAT_DTYPES:
                raise TypeError(f"grad_accum: unsupported dtype {x.dtype}")
            if x.device != dev:
                raise ValueError(f"grad_accum: operands on different "
                                 f"devices {dev} and {x.device}")
        if a.numel() != g.numel():
            raise ValueError(f"grad_accum: unequal numel, accumulator "
                             f"{tuple(a.shape)} and gradient "
                             f"{tuple(g.shape)}")
        if not a.is_contiguous():
            raise ValueError("grad_accum: accumulators must be contiguous "
                             "(they are written in place)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grad_accum: no kernel or plain version for "
                         f"device {dev}")
    return dev


def grad_accum_many(accs: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], scale, *,
                    block: Optional[int] = None) -> List[torch.Tensor]:
    """acc += scale * grad for each pair, in place on the accumulators
    (returned). Each accumulator is contiguous (it may be a view into a
    flat bucket) and has its gradient's numel; fp32 or bf16 each; scale
    a number or a 1-element tensor. CUDA pairs take one K1 launch per
    :func:`launch_groups` group, of ``block`` elements a CUDA block (a
    power of two; default: the tuned or default block); CPU pairs take
    the plain version."""
    accs, grads = list(accs), list(grads)
    if not accs:
        return accs
    dev = _check_pairs(accs, grads)
    with kernel_scope("grad_accum", accs, grads):
        return _accumulate(dev, accs, grads, scale, block)


def _accumulate(dev, accs, grads, scale, block) -> List[torch.Tensor]:
    s = scalars(dev, scale)
    for i, g in enumerate(grads):
        if not g.is_contiguous():
            COPIED_BYTES["grad_accum"] += g.numel() * g.element_size()
            grads[i] = g.contiguous()
    if dev.type == "cpu":
        for a, g in zip(accs, grads):
            a.view(-1).copy_(ref.grad_accum_ref(a.view(-1), g.view(-1), s))
        return accs
    if is_fake(accs[0]):  # shapes only: nothing to launch
        return accs
    for idx in launch_groups(list(zip(accs, grads))):
        _launch([accs[i] for i in idx], [grads[i] for i in idx], s, block)
    return accs


def grad_accum(acc: torch.Tensor, grad: torch.Tensor, scale) -> torch.Tensor:
    """acc += scale * grad, in place on ``acc`` (returned). acc: (N,) fp32;
    grad: (N,) fp32 or bf16; scale: a number or a 1-element tensor.
    A CUDA ``acc`` launches K1; a CPU one takes the plain version."""
    check_buffers("grad_accum", (acc, grad))
    grad_accum_many([acc], [grad], scale)
    return acc


def grad_accum_tree(acc_tree, grad_tree, scale):
    """K1 over parameter trees of one structure (each leaf in place on
    the accumulator tree, returned) — the ``fused`` executor's path, one
    launch per gradient dtype."""
    accs, treedef = tree.flatten(acc_tree)
    grads, gdef = tree.flatten(grad_tree)
    if gdef != treedef:
        raise ValueError("grad_accum_tree: the trees differ in structure")
    grad_accum_many(accs, grads, scale)
    return acc_tree


def grad_accum_buckets(acc_buffers: Sequence[torch.Tensor],
                       grad_buffers: Sequence[torch.Tensor], scale
                       ) -> Tuple[torch.Tensor, ...]:
    """K1 over flat dtype buckets of ``engine.flat.FlatSpec``: one launch
    per bucket (its gradient dtype)."""
    for a, g in zip(acc_buffers, grad_buffers):
        check_buffers("grad_accum", (a, g))
    return tuple(grad_accum_many(acc_buffers, grad_buffers, scale))
