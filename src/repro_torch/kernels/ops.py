"""Differentiable wrappers around kernels K5 and K6, the counterparts of the
reference's ``jax.custom_vjp`` wrappers (``repro/kernels/ops.py``).

The forward runs the kernel; the backward is the reference's, in plain
PyTorch: for attention, a recompute through ``ref.attention_ref`` under
autograd (as ``ops._fa_bwd`` does under ``jax.vjp``); for cross-entropy,
``(softmax − onehot) · g · scale``. Neither backward is a kernel in the
reference, so neither is one here.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cross_entropy as ce_kernel
from . import flash_attention as fa_kernel
from . import ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return fa_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.attention_ref(*ins, causal=causal, window=window,
                                    softcap=softcap)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None)


def flash_attention(q, k, v, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) → (B, H, S, hd)."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, scale):
        ctx.save_for_backward(logits, labels)
        ctx.scale = scale
        return ce_kernel.cross_entropy(logits, labels, scale=scale)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        # d/dlogits [scale · (lse − gold)] = scale · (softmax − onehot); the
        # one-hot is a subtraction of 1 at the gold index (p − 0 is exact),
        # and a label outside [0, V) has none, as jax.nn.one_hot gives
        V = logits.shape[-1]
        d = torch.softmax(logits.float(), dim=-1)
        hit = (labels >= 0) & (labels < V)
        d.scatter_add_(1, labels.long().clamp(0, V - 1)[:, None],
                       -hit.float()[:, None])
        d = d * (g[:, None] * ctx.scale)
        return d.to(logits.dtype), None, None


def fused_cross_entropy(logits, labels, scale: float = 1.0) -> torch.Tensor:
    """Per-token scaled NLL: (T, V), (T,) → (T,) fp32."""
    return _FusedCrossEntropy.apply(logits, labels, scale)
