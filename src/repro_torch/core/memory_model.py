"""Analytic device-memory model → automatic micro-batch sizing.

The paper determines the micro-batch size "experimentally ... the maximum
size that can compute on GPU" (§4.3.2). This model computes it instead:
per-device bytes as an affine function of the micro-batch size, and the
largest power of two that fits the budget. The arithmetic is the JAX
package's, term for term, so both packages admit the same plans.

  params           P * 4 B (fp32 master)
  grads (accum)    same as params
  optimizer state  k_opt * params bytes (SGD-m: 1, Adam: 2)
  update transient step-❺ peak beyond the steady state: the unfused update
                   holds a full ``updates`` tree plus fresh state trees,
                   (1 + k_opt) * params bytes; the fused flat path writes
                   in place and is counted as zero.
  activations      per-period boundaries plus the live working set the
                   remat policy leaves, proportional to micro_batch * seq.

The default budget is the card's own memory (``device_memory_bytes``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models import remat as remat_lib
from ..models.config import ModelConfig

# lattice order == the planner's escalation order (cheapest recompute first)
POLICY_ORDER = remat_lib.POLICIES

# fraction of a period's working set that "dots" keeps saved (the matmul
# outputs; elementwise intermediates are recomputed)
DOTS_SAVED_FRACTION = 0.5

# optimizer-state slots per optimizer (momentum / m+v trees)
OPT_SLOTS = {"sgd": 1, "sgd_plain": 0, "adam": 2, "adamw": 2}

FIXED_BYTES = 64 * 1024 ** 2


def device_memory_bytes(device="cuda") -> int:
    """Total memory of a CUDA device — the default planning budget. A CPU
    device has no such budget: its callers pass one."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(
            f"no default memory budget for device {device}; pass "
            "budget_bytes (the CPU has no device memory to plan against)")
    return torch.cuda.get_device_properties(device).total_memory


def _resolve_slots(optimizer: str, opt_slots: Optional[int]) -> int:
    if opt_slots is not None:
        return opt_slots
    try:
        return OPT_SLOTS[optimizer]
    except KeyError:
        raise ValueError(
            f"unknown optimizer {optimizer!r}; known: {sorted(OPT_SLOTS)} "
            "(or pass opt_slots explicitly)") from None


def update_transient_bytes(params_bytes: int, optimizer: str = "sgd",
                           fused: bool = False, *,
                           opt_slots: Optional[int] = None) -> int:
    """Peak transient bytes of step ❺ beyond the steady state: zero for
    the fused in-place path, ``(1 + k_opt) * params`` for the unfused one."""
    if fused:
        return 0
    return (1 + _resolve_slots(optimizer, opt_slots)) * params_bytes


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    params_bytes: int
    grads_bytes: int
    opt_bytes: int
    activation_bytes_per_sample: int  # per micro-batch sample, at given seq
    fixed_bytes: int
    update_transient_bytes: int = 0  # step-❺ peak (0 for the fused path)

    def total(self, micro_batch: int) -> int:
        """Conservative peak-bytes bound: the activation peak and the
        step-❺ transient are summed although they never coexist."""
        return (self.params_bytes + self.grads_bytes + self.opt_bytes
                + self.fixed_bytes + self.update_transient_bytes
                + self.activation_bytes_per_sample * micro_batch)

    def affine_coeffs(self) -> tuple:
        """(fixed, per_sample) with total(m) == fixed + per_sample·m. The
        estimate is exactly affine in the micro-batch size, and so is the
        measured peak to a good approximation, which is what lets
        ``engine.autotune`` map one onto the other with one affine
        correction per key, fit from two or three probe steps."""
        return self.total(0), self.activation_bytes_per_sample


def activation_bytes_per_sample(cfg: ModelConfig, seq: int,
                                act_bytes: int = 2, remat: bool = True,
                                remat_policy: Optional[str] = None) -> int:
    """Live activation bytes for ONE sample of length ``seq``: residual
    checkpoints at every period boundary, a blocked-CE logits slice, and
    the remat policy's share of the per-period working set."""
    policy = remat_lib.resolve(remat, remat_policy)
    d = cfg.d_model
    boundary = cfg.num_periods * seq * d * act_bytes
    widths = [d * 6]  # qkv + attn out + residuals
    if cfg.is_moe:
        widths.append(cfg.experts_per_token * cfg.moe_d_ff * 3
                      * cfg.capacity_factor)
    elif cfg.d_ff:
        widths.append(cfg.d_ff * 3)
    if cfg.ssm_state:
        widths.append(cfg.ssm_d_inner * 4)
    if cfg.lru_width:
        widths.append(cfg.lru_width * 6)
    period_live = seq * int(max(widths)) * act_bytes * cfg.pattern_len
    logits_live = seq * cfg.vocab_size * 4 // 8  # blocked CE: 1/8 vocab
    if policy == "none":
        live = cfg.num_periods * period_live
    elif policy == "dots":
        live = period_live + int(
            DOTS_SAVED_FRACTION * (cfg.num_periods - 1) * period_live)
    elif policy == "period":
        live = period_live
    else:  # "full"
        live = -(-period_live // cfg.pattern_len)
    return boundary + live + logits_live


def estimate(cfg: ModelConfig, seq: int, *,
             opt_slots: Optional[int] = None, act_bytes: int = 2,
             remat: bool = True, remat_policy: Optional[str] = None,
             optimizer: str = "sgd", fused_update: bool = False
             ) -> MemoryEstimate:
    """Single-device estimate. ``fused_update=True`` models the flat
    in-place update (``--executor flat``), whose step-❺ transient is zero."""
    p_bytes = cfg.param_count() * 4
    slots = _resolve_slots(optimizer, opt_slots)
    return MemoryEstimate(
        params_bytes=p_bytes,
        grads_bytes=p_bytes,
        opt_bytes=slots * p_bytes,
        activation_bytes_per_sample=activation_bytes_per_sample(
            cfg, seq, act_bytes, remat, remat_policy),
        fixed_bytes=FIXED_BYTES,
        update_transient_bytes=update_transient_bytes(
            p_bytes, optimizer, fused_update, opt_slots=slots),
    )


def suggest_micro_batch_size(cfg: ModelConfig, seq: int, mini_batch: int, *,
                             budget_bytes: int, **kw) -> Optional[int]:
    """Largest power-of-two micro-batch (≤ mini_batch) that fits the budget,
    or None when even micro-batch 1 does not (MBS cannot shrink the model
    itself). ``kw`` are :func:`estimate`'s options."""
    est = estimate(cfg, seq, **kw)
    best = None
    m = 1
    while m <= mini_batch:
        if est.total(m) <= budget_bytes:
            best = m
        m *= 2
    return best


def suggest_remat_policy_and_micro(
        cfg: ModelConfig, seq: int, mini_batch: int, *, budget_bytes: int,
        target_micro: Optional[int] = None, **kw
        ) -> Tuple[str, Optional[int]]:
    """Joint (remat policy, micro-batch) choice: the first policy on the
    lattice whose admitted micro-batch reaches ``target_micro`` (default:
    the whole mini-batch); else the policy admitting the largest
    micro-batch, ties toward cheaper recompute; ``(heaviest, None)`` when
    nothing fits."""
    target = min(target_micro or mini_batch, mini_batch)
    best_policy, best_micro = POLICY_ORDER[-1], None
    for policy in POLICY_ORDER:
        micro = suggest_micro_batch_size(cfg, seq, mini_batch,
                                         budget_bytes=budget_bytes,
                                         remat_policy=policy, **kw)
        if micro is not None and micro >= target:
            return policy, micro
        if micro is not None and (best_micro is None or micro > best_micro):
            best_policy, best_micro = policy, micro
    return best_policy, best_micro

