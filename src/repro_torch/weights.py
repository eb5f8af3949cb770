"""Parameter conversion between the JAX package's trees and the port's.

The JAX package hands its parameters over as nested dicts and tuples of
numpy arrays (``jax.tree.map(np.asarray, params)``); the port's params
are the same structure of tensors, so conversion is leaf by leaf and
needs no JAX here.

Conv kernels are the one layout that differs: the reference keeps them
HWIO (its NHWC convolutions), the port OIHW (PyTorch's). Every 4-D leaf
is a conv kernel — no other model of either package has one — and is
transposed on the way in and out.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only for bf16 leaves; numpy has no bf16
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy().copy()


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def from_reference(params, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) → the port's."""
    return tree.map(lambda x: _to_tensor(_hwio_to_oihw(np.asarray(x)),
                                         device), params)


def to_reference(params):
    """The port's params → nested dicts/tuples of numpy arrays."""
    return tree.map(lambda t: np.ascontiguousarray(
        _oihw_to_hwio(_to_numpy(t))), params)
