"""PyTorch + CUDA port of the Micro-Batch Processing (MBS) system.

Mirrors the JAX package's module layout (``configs``, ``models``, ``core``,
``optim``, ``engine``, ``data``, ``launch``, ``kernels``) with plain
functions over nested dicts of tensors. The step-❹/❺ kernels are Triton
kernels for Hopper (``kernels/``); every kernel has a plain PyTorch
version beside it that runs whenever the tensors lie on the CPU.

Entry points run on CUDA unless the caller asks for the CPU.
"""
