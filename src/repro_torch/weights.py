"""Parameter conversion between the JAX package's trees and the port's.

The JAX package hands its parameters over as nested dicts and tuples of
numpy arrays (``jax.tree.map(np.asarray, params)``); the port's params
are the same structure of tensors, so conversion is leaf by leaf and
needs no JAX here.

Conv kernels are the one layout that differs: the reference keeps them
HWIO (its NHWC convolutions), the port OIHW (PyTorch's). A conv kernel is
a 4-D leaf named ``w`` (``cnn.conv_init``'s ``{"w": ...}``) and is
transposed on the way in and out; the MoE experts' stacked weights
(``w_up``, ``w_gate``, ``w_down``: periods × experts × in × out) are 4-D
too, and keep their layout.
"""
from __future__ import annotations

import numpy as np
import torch



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


def _map_named(fn, t, name=None):
    """``fn(leaf, key)`` over a tree's leaves, the key being the dict key
    the leaf sits under (None in a tuple); structure kept."""
    if isinstance(t, dict):
        return {k: _map_named(fn, v, k) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_map_named(fn, v) for v in t)
    return None if t is None else fn(t, name)


def _is_conv(a, name) -> bool:
    return name == "w" and a.ndim == 4


def from_reference(params, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) → the port's."""
    def conv(x, name):
        a = np.asarray(x)
        return _to_tensor(a.transpose(3, 2, 0, 1) if _is_conv(a, name)
                          else a, device)
    return _map_named(conv, params)


def to_reference(params):
    """The port's params → nested dicts/tuples of numpy arrays."""
    def conv(t, name):
        a = _to_numpy(t)
        # np.array, not np.ascontiguousarray: that makes a 0-d leaf 1-d
        return np.array(a.transpose(2, 3, 1, 0) if _is_conv(a, name) else a,
                        order="C")
    return _map_named(conv, params)
