"""Hopper kernels of the port — the public API, as the reference's
(``repro/kernels/__init__.py``):

  * ``grad_accum`` / ``grad_accum_many`` / ``grad_accum_tree`` /
    ``grad_accum_buckets`` — kernel K1 (CUDA C++), the fused scaled
    accumulate (paper step ❹), in place on the fp32 accumulator, over a
    list of (accumulator, gradient) pairs in one launch;
  * ``fused_sgd`` (K2 with momentum, K3 without) and ``fused_adam`` (K4) —
    the in-place fused optimizer updates (paper step ❺);
  * ``flash_attention`` — differentiable attention, forward by K6 (CUDA
    C++); ``cross_entropy`` (= ``fused_cross_entropy``) — the
    differentiable scaled per-token NLL, forward by K5 (Triton);
  * ``ops`` (the autograd wrappers), ``ref`` (the plain PyTorch versions
    every kernel is held against), and the raw kernel modules under
    ``grad_accum_kernels``, ``cross_entropy_kernels`` and
    ``flash_attention_kernels`` (the functions above shadow the module
    names);
  * ``set_block_resolver`` / ``lookup_tuned_block`` / ``resolve_block`` —
    the launch-geometry hooks a tuner installs into;
  * ``launch_counts`` / ``reset_launch_counts`` — the per-kernel launch
    counters, which show that a run went through the kernels;
    ``variant_launch_counts`` splits K6's by the kernel its dtype took.

A wrapper launches its kernel for CUDA tensors and raises when it cannot
(no GPU, no Triton, no ``nvcc``); for CPU tensors it runs the plain
version; for fake tensors (``FakeTensorMode``, a dry run) on the card it
computes its output's shape and launches nothing. Each call runs in
``_launch.kernel_scope``, through which a recorded step
(``engine.steptrace``) sees it. Triton is imported, and a Triton kernel
(K2–K5) compiled, at its first launch; a CUDA C++ kernel (K1, K6) is
built by ``nvcc`` at its first launch (``_cuda``).
"""
from . import cross_entropy as cross_entropy_kernels  # noqa: F401
from . import flash_attention as flash_attention_kernels  # noqa: F401
from . import grad_accum as grad_accum_kernels  # noqa: F401
from . import fused_update, ops, ref  # noqa: F401
from ._launch import (launch_counts, lookup_tuned_block,  # noqa: F401
                      reset_launch_counts, resolve_block,
                      set_block_resolver, variant_launch_counts)
from .fused_update import fused_adam, fused_sgd  # noqa: F401
from .grad_accum import (grad_accum, grad_accum_buckets,  # noqa: F401
                         grad_accum_many, grad_accum_tree)
from .ops import flash_attention, fused_cross_entropy  # noqa: F401

cross_entropy = fused_cross_entropy
