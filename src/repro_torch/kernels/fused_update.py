"""Kernels K2, K3 and K4: fused in-place optimizer updates (paper step ❺),
in Triton for Hopper.

  K2 ``_sgd_mom_kernel``  replaces ``repro/kernels/fused_update.py::_sgd_mom_kernel``
  K3 ``_sgd_kernel``      replaces ``repro/kernels/fused_update.py::_sgd_kernel``
  K4 ``_adam_kernel``     replaces ``repro/kernels/fused_update.py::_adam_kernel``

Each reads the fp32 flat gradient accumulator of one dtype bucket
(``engine/flat.py``) and writes params and optimizer state in place, in
one pass, so step ❺ allocates nothing beyond the scalar operand — the
counterpart of the Pallas kernels' ``input_output_aliases`` plus donation.

All three are bound by bytes: per fp32 element K2 moves 20 bytes (read
p, g, m; write p, m), K3 12 and K4 28, against 5–15 flops. The design is
one masked, vectorised pass over a 1-D grid (``_launch.stream_geometry``).
The traced scalars (learning rate, global-norm clip scale, Adam bias
corrections) arrive through one small fp32 device tensor, the Pallas
``s_ref``; the static hyperparameters (momentum, weight decay, nesterov,
betas, eps, decoupled) are ``tl.constexpr``.

With ``GUARD`` (the supervisor's finite check in front of step ❺, the
reference's ``lax.cond``) the scalar operand carries one more slot, the
finite flag, after the others. K2 and K3 AND it into their load and
store mask, so a flag of 0 makes the launch read and write nothing. K4
reads it first and ends the program where it is 0: its masked lanes
would still run the update on the zeros that a predicated-off load
leaves, and on a zero operand the IEEE-rounded divisions and square root
(``div_rn``, ``sqrt_rn``) take their slow-path subroutines, so a skipped
step would cost more than a full pass. Without ``GUARD`` the branch is
compiled away and the kernel is the unguarded one.

The arithmetic copies the Pallas kernels cast for cast, in the promotion
rules that ``ref.py`` spells out: each product with a constant is rounded
to the state's dtype before it is added, so a bf16 bucket rounds where
the plain version rounds. Launches turn floating-point contraction off
(``enable_fp_fusion=False``): an FMA would round ``a*b + c`` once where
the plain version rounds twice, and in a bf16 bucket that can flip the
rounding of an operand and move the result by more than one ulp.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from ._launch import (LAUNCHES, check_buffers, is_fake, kernel_scope,
                      scalars, stream_geometry)


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def _sgd_mom_kernel(p_ptr, g_ptr, m_ptr, s_ptr, n,
                        MU: tl.constexpr, WD: tl.constexpr,
                        HAS_WD: tl.constexpr, NESTEROV: tl.constexpr,
                        GUARD: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        if GUARD:  # the finite flag: 0 masks every load and store
            mask = mask & (tl.load(s_ptr + 2) != 0.0)
        lr = tl.load(s_ptr)
        gscale = tl.load(s_ptr + 1)
        p = tl.load(p_ptr + offs, mask=mask)
        g = tl.load(g_ptr + offs, mask=mask) * gscale
        m = tl.load(m_ptr + offs, mask=mask)
        if HAS_WD:
            g = g + WD * p.to(tl.float32)
        mdt = m.dtype
        m = ((MU * m.to(tl.float32)).to(mdt).to(tl.float32)
             + g.to(mdt).to(tl.float32)).to(mdt)
        if NESTEROV:
            eff = g + (MU * m.to(tl.float32)).to(mdt).to(tl.float32)
        else:
            eff = m.to(tl.float32)
        u = -lr * eff
        p = (p.to(tl.float32) + u.to(p.dtype).to(tl.float32)).to(p.dtype)
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)

    @triton.jit
    def _sgd_kernel(p_ptr, g_ptr, s_ptr, n, WD: tl.constexpr,
                    HAS_WD: tl.constexpr, GUARD: tl.constexpr,
                    BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        if GUARD:
            mask = mask & (tl.load(s_ptr + 2) != 0.0)
        lr = tl.load(s_ptr)
        gscale = tl.load(s_ptr + 1)
        p = tl.load(p_ptr + offs, mask=mask)
        g = tl.load(g_ptr + offs, mask=mask) * gscale
        if HAS_WD:
            g = g + WD * p.to(tl.float32)
        u = -lr * g
        p = (p.to(tl.float32) + u.to(p.dtype).to(tl.float32)).to(p.dtype)
        tl.store(p_ptr + offs, p, mask=mask)

    @triton.jit
    def _adam_kernel(p_ptr, g_ptr, m_ptr, v_ptr, s_ptr, n,
                     B1: tl.constexpr, OMB1: tl.constexpr,
                     B2: tl.constexpr, OMB2: tl.constexpr,
                     EPS: tl.constexpr, WD: tl.constexpr,
                     COUPLED_WD: tl.constexpr, DECOUPLED_WD: tl.constexpr,
                     GUARD: tl.constexpr, BLOCK: tl.constexpr):
        if GUARD:  # the finite flag: 0 ends the program before any load
            if tl.load(s_ptr + 4) == 0.0:
                return
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        lr = tl.load(s_ptr)
        gscale = tl.load(s_ptr + 1)
        bc1 = tl.load(s_ptr + 2)
        bc2 = tl.load(s_ptr + 3)
        p = tl.load(p_ptr + offs, mask=mask)
        g = tl.load(g_ptr + offs, mask=mask) * gscale
        m = tl.load(m_ptr + offs, mask=mask)
        v = tl.load(v_ptr + offs, mask=mask)
        if COUPLED_WD:
            g = g + WD * p.to(tl.float32)
        mdt = m.dtype
        vdt = v.dtype
        gm = g.to(mdt).to(tl.float32)
        m = ((B1 * m.to(tl.float32)).to(mdt).to(tl.float32)
             + (OMB1 * gm).to(mdt).to(tl.float32)).to(mdt)
        gv = g.to(vdt).to(tl.float32)
        sq = (gv * gv).to(vdt).to(tl.float32)
        v = ((B2 * v.to(tl.float32)).to(vdt).to(tl.float32)
             + (OMB2 * sq).to(vdt).to(tl.float32)).to(vdt)
        den = tl.sqrt_rn(tl.div_rn(v.to(tl.float32), bc2)) + EPS
        u = tl.div_rn(tl.div_rn(m.to(tl.float32), bc1), den)
        if DECOUPLED_WD:
            u = u + WD * p.to(tl.float32)
        u = -lr * u
        p = (p.to(tl.float32) + u.to(p.dtype).to(tl.float32)).to(p.dtype)
        tl.store(p_ptr + offs, p, mask=mask)
        tl.store(m_ptr + offs, m, mask=mask)
        tl.store(v_ptr + offs, v, mask=mask)

    return triton, _sgd_mom_kernel, _sgd_kernel, _adam_kernel


def _check(name, params, grads, *state) -> torch.device:
    dev = check_buffers(name, (params, grads) + tuple(state))
    if grads.dtype != torch.float32:
        raise TypeError(f"{name}: the gradient accumulator must be fp32, "
                        f"got {grads.dtype}")
    return dev


def fused_sgd(params, grads, mom, lr, clip_scale=1.0, *,
              momentum: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False, block=None, ok=None):
    """One in-place SGD(-momentum) step over a flat bucket.

    params/mom: (N,) in the bucket dtype; grads: (N,) fp32 accumulator;
    lr, clip_scale: numbers or 1-element tensors. Writes params (and mom)
    in place and returns (params, mom) — or params alone when ``mom`` is
    None. CUDA tensors launch K2 (with ``mom``) or K3 (without), at
    ``block`` elements a program (a power of two; default: the tuned or
    default block); CPU tensors take the plain version.

    ``ok`` (a device scalar, the guard's finite flag) launches the
    guarded variant: each program reads the flag and, where it is 0,
    loads and stores nothing, so a skipped step leaves every buffer as
    it was without a host sync. Without ``ok`` the kernel is the
    unguarded one."""
    if mom is None:
        dev = _check("fused_sgd", params, grads)
    else:
        dev = _check("fused_sgd", params, grads, mom)
    name = "fused_sgd" if mom is None else "fused_sgd_mom"
    with kernel_scope(name, [t for t in (params, mom) if t is not None],
                      (grads,)):
        guard = ok is not None
        s = scalars(dev, lr, clip_scale, *((ok,) if guard else ()))
        if dev.type == "cpu":
            new_p, new_m = ref.fused_sgd_ref(
                params, grads, mom, s[0], s[1], momentum=momentum,
                weight_decay=weight_decay, nesterov=nesterov,
                ok=s[2] if guard else None)
            params.copy_(new_p)
            if mom is None:
                return params
            mom.copy_(new_m)
            return params, mom
        if is_fake(params):  # shapes only: nothing to launch
            return params if mom is None else (params, mom)
        triton, sgd_mom, sgd, _ = _kernels()
        n = params.numel()
        block, warps = stream_geometry("fused_update", params.dtype, n,
                                       block)
        grid = (triton.cdiv(n, block),)
        wd = ref.weak(weight_decay, torch.float32)
        with torch.cuda.device(dev):
            if mom is None:
                sgd[grid](params, grads, s, n, WD=wd,
                          HAS_WD=bool(weight_decay), GUARD=guard,
                          BLOCK=block, num_warps=warps,
                          enable_fp_fusion=False)
                LAUNCHES["fused_sgd"] += 1
                return params
            sgd_mom[grid](params, grads, mom, s, n,
                          MU=ref.weak(momentum, mom.dtype), WD=wd,
                          HAS_WD=bool(weight_decay), NESTEROV=bool(nesterov),
                          GUARD=guard, BLOCK=block, num_warps=warps,
                          enable_fp_fusion=False)
        LAUNCHES["fused_sgd_mom"] += 1
        return params, mom


def fused_adam(params, grads, m, v, lr, bias_corr1, bias_corr2,
               clip_scale=1.0, *, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 0.0,
               decoupled: bool = False, block=None, ok=None):
    """One in-place Adam/AdamW step over a flat bucket.

    params/m/v: (N,) bucket buffers; grads: (N,) fp32 accumulator;
    ``bias_corr{1,2}`` are the ``1 - beta**step`` scalars, numbers or
    1-element device tensors. Writes params, m and v in place and returns
    them. CUDA tensors launch K4 (``block`` and ``ok`` as for
    :func:`fused_sgd`); CPU tensors take the plain version."""
    dev = _check("fused_adam", params, grads, m, v)
    with kernel_scope("fused_adam", (params, m, v), (grads,)):
        guard = ok is not None
        s = scalars(dev, lr, clip_scale, bias_corr1, bias_corr2,
                    *((ok,) if guard else ()))
        if dev.type == "cpu":
            outs = ref.fused_adam_ref(
                params, grads, m, v, s[0], s[2], s[3], s[1], b1=b1, b2=b2,
                eps=eps, weight_decay=weight_decay, decoupled=decoupled,
                ok=s[4] if guard else None)
            for buf, new in zip((params, m, v), outs):
                buf.copy_(new)
            return params, m, v
        if is_fake(params):  # shapes only: nothing to launch
            return params, m, v
        triton, _, _, adam = _kernels()
        n = params.numel()
        block, warps = stream_geometry("fused_update", params.dtype, n,
                                       block)
        with torch.cuda.device(dev):
            adam[(triton.cdiv(n, block),)](
                params, grads, m, v, s, n,
                B1=ref.weak(b1, m.dtype), OMB1=ref.weak(1 - b1, m.dtype),
                B2=ref.weak(b2, v.dtype), OMB2=ref.weak(1 - b2, v.dtype),
                EPS=float(eps), WD=float(weight_decay),
                COUPLED_WD=bool(weight_decay) and not decoupled,
                DECOUPLED_WD=bool(weight_decay) and decoupled, GUARD=guard,
                BLOCK=block, num_warps=warps, enable_fp_fusion=False)
        LAUNCHES["fused_adam"] += 1
        return params, m, v
