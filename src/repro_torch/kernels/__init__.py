"""Hopper kernels of the port — the public API.

  * ``grad_accum`` / ``grad_accum_tree`` / ``grad_accum_buckets`` — kernel
    K1, the fused scaled accumulate (paper step ❹), in place on the fp32
    accumulator;
  * ``fused_sgd`` (K2 with momentum, K3 without) and ``fused_adam`` (K4) —
    the in-place fused optimizer updates (paper step ❺);
  * ``ref`` — the plain PyTorch versions every kernel is held against;
  * ``launch_counts`` / ``reset_launch_counts`` — the per-kernel launch
    counters, which show that a run went through the kernels.

A wrapper launches its kernel for CUDA tensors and raises when it cannot
(no GPU, no Triton); for CPU tensors it runs the plain version. Triton is
imported, and a kernel compiled, at its first launch.
"""
from . import fused_update, ref  # noqa: F401
from ._launch import launch_counts, reset_launch_counts  # noqa: F401
from .fused_update import fused_adam, fused_sgd  # noqa: F401
from .grad_accum import (grad_accum, grad_accum_buckets,  # noqa: F401
                         grad_accum_tree)
