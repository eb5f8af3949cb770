"""What the kernels share: argument checks, the launch heuristic of the
1-D streaming kernels, the launch-geometry hooks, the launch counters and
the fp32 scalar operand.

The 1-D kernels (K1–K4) are bound by HBM bytes (a few flops per element
against 12–28 bytes moved), so a launch only has to keep enough 16-byte
loads in flight to saturate the memory system. The TPU package sized its
blocks to VMEM; on Hopper a block is a tile of registers, so the
heuristic keeps blocks small and lets the grid supply the parallelism.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

# Launch counters, one per kernel: a wrapper adds one where it launches
# its kernel and nowhere else (the CPU plain path does not count).
LAUNCHES: Dict[str, int] = {"grad_accum": 0, "fused_sgd_mom": 0,
                            "fused_sgd": 0, "fused_adam": 0,
                            "cross_entropy": 0, "flash_attention": 0}
# K6's launches by kernel (it dispatches by dtype), beside its total above
VARIANT_LAUNCHES: Dict[str, int] = {"wgmma_bf16": 0, "simt_fp32": 0}

SMALL_N = 1 << 20  # below this, smaller blocks spread a buffer over more SMs
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


# A step trace in progress (``engine.steptrace.record``) observes every
# wrapper's call here: the Triton and ctypes launches are invisible to a
# dispatch mode, and a fake tensor's call launches nothing
_KERNEL_OBSERVER: list = [None]


def set_kernel_observer(obs: Optional[Callable]) -> None:
    """Install (or clear, with None) the context-manager factory
    ``obs(name, writes, reads)`` that :func:`kernel_scope` enters."""
    _KERNEL_OBSERVER[0] = obs


def kernel_scope(name: str, writes, reads=()):
    """The context a wrapper runs its kernel (or its plain version) in:
    a null context unless a trace observes the calls. ``writes`` are the
    operands written in place (K5 and K6 write a new output: none),
    ``reads`` the others."""
    obs = _KERNEL_OBSERVER[0]
    if obs is None:
        return contextlib.nullcontext()
    return obs(name, writes, reads)


def is_fake(t: torch.Tensor) -> bool:
    """A fake tensor (``FakeTensorMode``): shapes and dtypes, no data, so
    a wrapper computes its output's shape and launches nothing."""
    from torch._subclasses.fake_tensor import is_fake as fake
    return fake(t)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def variant_launch_counts() -> Dict[str, int]:
    return dict(VARIANT_LAUNCHES)


def launch_config(n: int) -> Tuple[int, int]:
    """(BLOCK elements, num_warps) for an ``n``-element 1-D stream: 1024
    elements over 4 warps for buffers under ``SMALL_N`` (so a 1 MB buffer
    still spans every SM), 4096 over 8 warps above it — 16 elements a
    thread, four 16-byte fp32 vectors, with ceil(n / 4096) blocks in the
    grid. Any block gives identical values; this choice changes speed only."""
    block = 1024 if n < SMALL_N else 4096
    return block, num_warps(block)


def num_warps(block: int) -> int:
    """Warps for a 1-D block: 4 up to 2048 elements, 8 from 4096 on."""
    return 8 if block >= 4096 else 4


# Tuning-cache hook, the counterpart of the reference's (installed by a
# tuner; the kernels stay dependency-free). The resolver maps
# (kind, dtype_str, n, interpret) to a measured-best block, or None to
# keep the default. The key is the reference's: ``dtype_str`` is
# "float32" or "bfloat16", and ``interpret`` is True for the plain CPU
# path, which the reference's interpret mode stands for. The port needs a
# tuning cache of its own all the same: the keys are the reference's, the
# values must be measured on the card. The reference's TPU values are
# VMEM sizes: K6 refuses a flash tile it has no instance for (128-row
# tiles at fp32, whose instance is 64 × 64), and 256-row cross-entropy
# blocks oversize K5.
_BLOCK_RESOLVER: Optional[Callable[[str, str, int, bool], Optional[int]]] = None


def set_block_resolver(fn: Optional[Callable]) -> None:
    """Install (or clear, with None) the tuned-block lookup that a kernel
    wrapper consults when it is called without a block."""
    global _BLOCK_RESOLVER
    _BLOCK_RESOLVER = fn


def check_block(what: str, block) -> int:
    """Triton takes a block only as a power of two: anything else is
    refused, never rounded."""
    if not isinstance(block, int) or block < 1 or block & (block - 1):
        raise ValueError(f"{what}: block {block!r} is not a power of two")
    return block


def lookup_tuned_block(kind: str, dtype, n: int,
                       interpret: Optional[bool] = None) -> Optional[int]:
    """The resolver's block for this (kind, dtype, size), clamped to
    [1, n] with n rounded up to a power of two (a Triton block masks its
    ragged edge, and must be a power of two; for n a power of two this is
    the reference's clamp) — or None when no resolver is installed or it
    has no entry. A block that is not a power of two is refused."""
    if _BLOCK_RESOLVER is None:
        return None
    if interpret is None:
        interpret = not torch.cuda.is_available()
    tuned = _BLOCK_RESOLVER(kind, str(dtype).removeprefix("torch."), int(n),
                            bool(interpret))
    if not tuned:
        return None
    return min(check_block(f"resolver block for {kind!r}", tuned),
               1 << max(int(n) - 1, 0).bit_length())


def resolve_block(kind: str, dtype, n: int,
                  interpret: Optional[bool] = None) -> int:
    """Block for an ``n``-element 1-D stream: the resolver's when it has
    one, else :func:`launch_config`'s."""
    return (lookup_tuned_block(kind, dtype, n, interpret)
            or launch_config(n)[0])


def stream_geometry(kind: str, dtype, n: int, block: Optional[int] = None
                    ) -> Tuple[int, int]:
    """(BLOCK, num_warps) that a 1-D kernel launches with on the card: the
    caller's ``block`` (a power of two; the block tuner's candidates),
    else :func:`resolve_block`'s. With neither a block nor a resolver this
    is :func:`launch_config`."""
    if block is None:
        block = resolve_block(kind, dtype, n, interpret=False)
    else:
        check_block(kind, block)
    return block, num_warps(block)


def check_buffers(name: str, bufs: Iterable[torch.Tensor]) -> torch.device:
    """All operands 1-D, contiguous, floating, the same length and on one
    device. Returns that device."""
    bufs = list(bufs)
    n = bufs[0].shape
    dev = bufs[0].device
    for b in bufs:
        if not isinstance(b, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(b)!r}")
        if b.dim() != 1 or b.shape != n:
            raise ValueError(f"{name}: operands must be 1-D of one length, "
                             f"got {[tuple(x.shape) for x in bufs]}")
        if b.device != dev:
            raise ValueError(f"{name}: operands on different devices "
                             f"{[str(x.device) for x in bufs]}")
        if not b.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if b.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name}: unsupported dtype {b.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device "
                         f"{dev}")
    return dev


def scalars(device: torch.device, *vals) -> torch.Tensor:
    """The kernels' fp32 scalar operand. Tensors stay on the device (no
    host sync); Python numbers are filled in on the device."""
    parts = []
    for v in vals:
        if isinstance(v, torch.Tensor):
            parts.append(v.detach().reshape(1).to(device=device,
                                                  dtype=torch.float32))
        else:
            parts.append(torch.full((1,), float(v), dtype=torch.float32,
                                    device=device))
    return torch.cat(parts) if len(parts) > 1 else parts[0]
