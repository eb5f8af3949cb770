"""What the 1-D streaming kernels share: argument checks, the launch
heuristic, the launch counters and the fp32 scalar operand.

The kernels here are bound by HBM bytes (a few flops per element against
12–28 bytes moved), so a launch only has to keep enough 16-byte loads in
flight to saturate the memory system. The TPU package sized its blocks to
VMEM; on Hopper a block is a tile of registers, so the heuristic keeps
blocks small and lets the grid supply the parallelism.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

# Launch counters, one per kernel: a wrapper adds one where it launches
# its kernel and nowhere else (the CPU plain path does not count).
LAUNCHES: Dict[str, int] = {"grad_accum": 0, "fused_sgd_mom": 0,
                            "fused_sgd": 0, "fused_adam": 0}

SMALL_N = 1 << 20  # below this, smaller blocks spread a buffer over more SMs
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def launch_config(n: int) -> Tuple[int, int]:
    """(BLOCK elements, num_warps) for an ``n``-element 1-D stream: 1024
    elements over 4 warps for buffers under ``SMALL_N`` (so a 1 MB buffer
    still spans every SM), 4096 over 8 warps above it — 16 elements a
    thread, four 16-byte fp32 vectors, with ceil(n / 4096) blocks in the
    grid. Any block gives identical values; this choice changes speed only."""
    return (1024, 4) if n < SMALL_N else (4096, 8)


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
