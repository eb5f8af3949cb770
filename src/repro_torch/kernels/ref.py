"""Plain PyTorch versions of every kernel's function — the oracles the
kernels are held against on the card, and the path the kernel wrappers
take for tensors on the CPU.

Casts follow the JAX package's oracles (``repro/kernels/ref.py``) one for
one. Two promotion rules differ between the frameworks and are written
out here: a Python constant multiplying a low-precision array is rounded
to that array's dtype first (JAX's weak typing, :func:`weak`), and a
0-d fp32 tensor does promote a bf16 array to fp32 (explicit ``.float()``),
which torch's 0-d promotion rule would not do by itself.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX applies it to an array of ``dtype``:
    rounded to that dtype (exact for fp32 arrays' purposes when the
    product is computed in fp32, as torch and Triton do)."""
    if dtype == torch.float32:
        return float(c)
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, Hkv, S, hd) with H % Hkv == 0.
    Returns (B, H, S, hd) in q.dtype; math in fp32."""
    B, H, S, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, S, hd)
    logits = torch.einsum("bkgsd,bktd->bkgst", qf, k.float())
    logits = logits / math.sqrt(hd)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= cols <= rows
    if window is not None:
        ok &= cols > rows - window
    logits = torch.where(ok, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def cross_entropy_ref(logits, labels) -> torch.Tensor:
    """logits: (T, V); labels: (T,) int. Returns per-token NLL (T,) fp32.
    A label outside [0, V) has no gold logit, so its row gives the
    logsumexp, as the reference's kernel gives (its oracle leaves such a
    label undefined)."""
    logits = logits.float()
    V = logits.shape[-1]
    lse = torch.logsumexp(logits, dim=-1)
    hit = (labels >= 0) & (labels < V)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(0, max(V - 1, 0))[:, None])[:, 0]
    return lse - torch.where(hit, gold, torch.zeros_like(gold))


def grad_accum_ref(acc, grad, scale) -> torch.Tensor:
    """Paper step ❹ with eq. (14) normalization: acc + scale * grad,
    accumulating in acc's dtype (fp32). ``scale`` is a 1-element tensor."""
    return acc + grad.to(acc.dtype) * scale.to(acc.dtype)


def _guarded(ok, new, old):
    """``new`` where the device flag ``ok`` is set (or absent), else
    ``old`` bit for bit: a skipped step writes nothing."""
    if ok is None or old is None:
        return new
    return torch.where(ok.reshape(()) != 0, new, old)


def finite_all_ref(bufs) -> torch.Tensor:
    """True iff every element of every buffer is finite: a 0-d bool on
    the buffers' device (the reference's ``exec_core.finite_all``)."""
    oks = [torch.isfinite(b).all() for b in bufs]
    return torch.stack(oks).all() if oks else torch.ones((), dtype=torch.bool)


def fused_sgd_ref(p, g, m, lr, clip_scale, *, momentum: float = 0.0,
                  weight_decay: float = 0.0, nesterov: bool = False,
                  ok=None):
    """Oracle for ``fused_update.fused_sgd`` (kernels K2 and K3): the
    arithmetic of ``optim.sgd``'s update plus ``exec_core.apply_update`` as
    one pass over flat buffers. ``lr`` and ``clip_scale`` are fp32 tensors.
    Returns (new_p, new_m) — new_m is None when ``m`` is None. With the
    guard flag ``ok`` (a 1-element tensor, the guarded kernels' operand)
    at 0 both come back unchanged; at 1 they are the update's."""
    p0, m0 = p, m
    g = g * clip_scale.to(g.dtype)
    if weight_decay:
        g = g + weak(weight_decay, g.dtype) * p.to(g.dtype)
    if m is not None:
        m = weak(momentum, m.dtype) * m + g.to(m.dtype)
        eff = g + weak(momentum, m.dtype) * m if nesterov else m
    else:
        eff = g
    u = -lr * eff.float()
    return _guarded(ok, p + u.to(p.dtype), p0), _guarded(ok, m, m0)


def fused_adam_ref(p, g, m, v, lr, bias_corr1, bias_corr2, clip_scale, *,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0, decoupled: bool = False,
                   ok=None):
    """Oracle for ``fused_update.fused_adam`` (kernel K4): ``optim.adam``'s
    arithmetic as one flat pass. ``lr``, ``bias_corr{1,2}`` and
    ``clip_scale`` are fp32 tensors. Returns (new_p, new_m, new_v); with
    the guard flag ``ok`` at 0, the old ones (see :func:`fused_sgd_ref`)."""
    old = (p, m, v)
    g = g * clip_scale.to(g.dtype)
    if weight_decay and not decoupled:
        g = g + weak(weight_decay, g.dtype) * p.to(g.dtype)
    m = weak(b1, m.dtype) * m + weak(1 - b1, m.dtype) * g.to(m.dtype)
    v = weak(b2, v.dtype) * v + weak(1 - b2, v.dtype) * torch.square(
        g.to(v.dtype))
    # the fp32 bias corrections promote bf16 state to fp32, as in JAX
    u = (m.float() / bias_corr1) / (torch.sqrt(v.float() / bias_corr2) + eps)
    if weight_decay and decoupled:
        u = u + weight_decay * p.float()
    u = -lr * u
    return tuple(_guarded(ok, new, o)
                 for new, o in zip((p + u.to(p.dtype), m, v), old))

