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

Serving has its own terms (``serve_estimate``): fp32 weights, the KV-cache
bytes of one request slot and one prefill sample's working set, which
``engine.serving.plan_serve`` admits against a budget the same way.
"""
from __future__ import annotations

import dataclasses
import functools
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


def pipeline_activation_bytes_per_sample(cfg: ModelConfig, seq: int,
                                         stages: int, act_bytes: int = 2,
                                         remat: bool = True,
                                         remat_policy: Optional[str] = None
                                         ) -> int:
    """Per-device live activation bytes for ONE local sample under the
    1F1B pipelined executor with ``stages`` stages — the reference's
    arithmetic term for term:

      rings        2 depth-``stages`` rings (arriving activations and the
                   backward's saved inputs), each slot one residual-stream
                   carry (seq * d_model);
      stage live   ONE stage's working set: its share of the period
                   boundaries (num_periods / stages) plus the remat
                   policy's live term, the lattice of
                   :func:`activation_bytes_per_sample` with the period
                   count cut to the stage's share;
      logits       the blocked-CE logits slice, charged on every stage.

    The reference's SPMD schedule traces the masked loss head on every
    stage, so it charges the logits everywhere; the port runs the head on
    the last stage only, and keeps the charge so that both packages admit
    the same plans."""
    if stages < 1:
        raise ValueError(f"stages must be >= 1, got {stages}")
    policy = remat_lib.resolve(remat, remat_policy)
    d = cfg.d_model
    carry = seq * d * act_bytes
    rings = 2 * stages * carry
    per_stage = -(-cfg.num_periods // stages)
    widths = [d * 6]
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
    logits_live = seq * cfg.vocab_size * 4 // 8
    if policy == "none":
        live = per_stage * period_live
    elif policy == "dots":
        live = period_live + int(
            DOTS_SAVED_FRACTION * (per_stage - 1) * period_live)
    elif policy == "period":
        live = period_live
    else:  # "full"
        live = -(-period_live // cfg.pattern_len)
    return rings + per_stage * carry + live + logits_live


def param_shard_ratio(cfg: ModelConfig, mesh, *, fsdp: bool = True) -> float:
    """Per-device fraction of the parameter bytes under the reference's
    sharding policy (``launch/sharding.param_specs``), divisibility
    included: a leaf whose dims do not divide the mesh stays replicated
    and costs its full bytes. Gradients and optimizer state shard with the
    same specs, so one ratio covers all three terms. ``fsdp=False`` models
    the data-parallel executor that replicates params (the port's
    ``ShardedExecutor``): only the model axis discounts. Memoized on
    (config, axis sizes, fsdp)."""
    return _param_shard_ratio(cfg, tuple(mesh.items()), fsdp)


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as shapes only: ``init_params`` under
    a fake-tensor mode, which allocates nothing (the reference's
    ``jax.eval_shape``), the family's (``launch.steps.init_params``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..launch import steps  # deferred: the models import this module
    with FakeTensorMode():
        return steps.init_params(cfg, seed=0, device="cpu")


@functools.lru_cache(maxsize=256)
def _param_shard_ratio(cfg: ModelConfig, mesh_dims: tuple,
                       fsdp: bool) -> float:
    from .. import tree
    from ..launch import sharding as sharding_lib  # deferred: no cycle
    dims = dict(mesh_dims)
    shapes = param_shapes(cfg)
    specs = sharding_lib.param_specs(shapes, dims, fsdp=fsdp)
    total = sharded = 0
    for leaf, spec in zip(tree.leaves(shapes),
                          sharding_lib.spec_leaves(specs)):
        n = leaf.numel()
        total += n
        sharded += -(-n // sharding_lib.shard_factor(spec, dims))
    return sharded / total if total else 1.0


def estimate(cfg: ModelConfig, seq: int, *, tp: int = 1, fsdp: int = 1,
             opt_slots: Optional[int] = None, act_bytes: int = 2,
             remat: bool = True, remat_policy: Optional[str] = None,
             optimizer: str = "sgd", fused_update: bool = False,
             mesh=None, fsdp_params: bool = True,
             pipeline: bool = False) -> MemoryEstimate:
    """``fused_update=True`` models the flat in-place update (``--executor
    flat``), whose step-❺ transient is zero. ``tp`` / ``fsdp`` are the
    reference's manual divisors: the parameter-sized terms are divided by
    ``tp * fsdp`` and the activation term by ``tp``.

    ``mesh`` switches to the PER-DEVICE estimate: the params, gradients,
    optimizer-state and update-transient terms are discounted by
    :func:`param_shard_ratio` (``fsdp_params=False``: the replicating
    data-parallel executor; the manual divisors are ignored) and the
    activation term is divided by the model axis only — the data axis
    enters through the *local* micro-batch the caller budgets with.

    ``pipeline=True`` reads the mesh's model axis as 1F1B stages: the
    activation term becomes :func:`pipeline_activation_bytes_per_sample`
    instead of the ``// tp`` discount (the parameter terms keep the
    reference's sharding-policy ratio)."""
    if mesh is not None:
        from ..launch import mesh as mesh_lib  # deferred: no cycle
        tp = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
        p_bytes = int(cfg.param_count() * 4
                      * param_shard_ratio(cfg, mesh, fsdp=fsdp_params))
    else:
        p_bytes = cfg.param_count() * 4 // (tp * fsdp)
    if pipeline and tp > 1:
        act_per_sample = pipeline_activation_bytes_per_sample(
            cfg, seq, tp, act_bytes, remat, remat_policy)
    else:
        act_per_sample = activation_bytes_per_sample(
            cfg, seq, act_bytes, remat, remat_policy) // tp
    slots = _resolve_slots(optimizer, opt_slots)
    return MemoryEstimate(
        params_bytes=p_bytes,
        grads_bytes=p_bytes,
        opt_bytes=slots * p_bytes,
        activation_bytes_per_sample=act_per_sample,
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


def max_minibatch_without_mbs(cfg: ModelConfig, seq: int, *,
                              budget_bytes: int, **kw) -> int:
    """The paper's "w/o MBS" failure point: the largest mini-batch whose
    whole-batch activations fit the budget (beyond it, the run 'Fails').
    ``kw`` are :func:`estimate`'s options."""
    est = estimate(cfg, seq, **kw)
    m = 0
    while est.total(m + 1) <= budget_bytes:
        m += 1
        if m > 1 << 24:
            break
    return m


# ---------------------------------------------------------------------------
# Serving: KV-cache admission terms (``engine.serving.plan_serve``)
# ---------------------------------------------------------------------------

# bytes of the per-slot ring-position bookkeeping (``pos`` int32 per entry)
CACHE_POS_BYTES = 4


def kv_bytes_per_token(cfg: ModelConfig, cache_bytes: int = 2) -> int:
    """Decode-cache bytes one cached context token costs, summed over every
    attention layer: a K and a V row (``num_kv_heads * head_dim``) plus the
    ring slot's int32 position. State-carrying layers (ssm / recurrent)
    add nothing here: their decode state does not grow with the context
    (:func:`slot_state_bytes`)."""
    per_layer = 2 * cfg.num_kv_heads * cfg.head_dim * cache_bytes \
        + CACHE_POS_BYTES
    n_attn = sum(1 for k in cfg.layer_pattern if k in ("global", "local"))
    return cfg.num_periods * n_attn * per_layer


def slot_state_bytes(cfg: ModelConfig, cache_bytes: int = 2) -> int:
    """Context-independent decode state per request slot: the SSD state
    and conv tail of ``ssm`` slots, the RG-LRU hidden state and conv tail
    of ``recurrent`` slots."""
    total = 0
    for kind in cfg.layer_pattern:
        if kind == "ssm" and cfg.ssm_state:
            conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_state
            total += (cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                      + (cfg.conv_width - 1) * conv_dim * cache_bytes)
        elif kind == "recurrent" and cfg.lru_width:
            total += (cfg.lru_width * 4
                      + (cfg.conv_width - 1) * cfg.lru_width * cache_bytes)
    return cfg.num_periods * total


def kv_slot_bytes(cfg: ModelConfig, max_len: int, cache_bytes: int = 2,
                  global_window: Optional[int] = None) -> int:
    """Decode-cache bytes one request slot holds at context capacity
    ``max_len``: a ``local`` ring holds ``min(sliding_window, max_len)``
    entries, a ``global`` ring ``min(global_window, max_len)`` (``max_len``
    without a global window)."""
    per_entry = 2 * cfg.num_kv_heads * cfg.head_dim * cache_bytes \
        + CACHE_POS_BYTES
    total = 0
    for kind in cfg.layer_pattern:
        if kind in ("global", "local"):
            w = cfg.sliding_window if kind == "local" else global_window
            entries = max_len if w is None else min(w, max_len)
            total += entries * per_entry
    return cfg.num_periods * total + slot_state_bytes(cfg, cache_bytes)


def prefill_activation_bytes_per_sample(cfg: ModelConfig, seq: int,
                                        act_bytes: int = 2) -> int:
    """Forward-only live bytes for one prefill sample of length ``seq``:
    the residual stream (x and one block output in flight), one period's
    working set (the prefill frees a period's intermediates before the
    next runs) and the last-token logits row. The cache the prefill builds
    is charged by the caller through :func:`kv_slot_bytes`."""
    d = cfg.d_model
    stream = 2 * seq * d * act_bytes
    widths = [d * 6]
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
    logits_live = cfg.vocab_size * 4
    return stream + period_live + logits_live


@dataclasses.dataclass(frozen=True)
class ServeMemoryEstimate:
    """Serving twin of :class:`MemoryEstimate`: affine in the number of
    admitted decode slots at a fixed prefill micro-batch size."""
    params_bytes: int
    kv_slot_bytes: int  # decode-cache bytes per admitted request slot
    prefill_bytes_per_sample: int  # activations + the cache being built
    fixed_bytes: int

    def total(self, slots: int, prefill_micro: int = 0) -> int:
        """Peak bytes with ``slots`` decode slots and a prefill micro-batch
        of ``prefill_micro`` in flight; the prefill term is charged in full
        although prefill and decode alternate (over-counting never
        over-admits)."""
        return (self.params_bytes + self.fixed_bytes
                + self.kv_slot_bytes * slots
                + self.prefill_bytes_per_sample * prefill_micro)

    def affine_coeffs(self, prefill_micro: int = 0) -> tuple:
        """(fixed, per_slot) with total(s) == fixed + per_slot * s."""
        return self.total(0, prefill_micro), self.kv_slot_bytes


def serve_estimate(cfg: ModelConfig, max_len: int, *,
                   prefill_len: Optional[int] = None,
                   cache_bytes: int = 2, act_bytes: int = 2,
                   global_window: Optional[int] = None, mesh=None,
                   fsdp_params: bool = False) -> ServeMemoryEstimate:
    """Analytic serving memory: fp32 inference weights (no gradients,
    optimizer state or update transient), the per-slot KV bytes at
    ``max_len`` and the per-sample prefill cost at ``prefill_len``
    (default ``max_len``). ``mesh`` makes it the PER-DEVICE estimate as
    :func:`estimate` does — params discounted by the sharding ratio
    (``fsdp_params=False``: the replicating data-parallel replica), the
    cache and activation terms for the *local* slot and prefill counts."""
    if mesh is not None:
        p_bytes = int(cfg.param_count() * 4
                      * param_shard_ratio(cfg, mesh, fsdp=fsdp_params))
    else:
        p_bytes = cfg.param_count() * 4
    pf = max_len if prefill_len is None else prefill_len
    slot = kv_slot_bytes(cfg, max_len, cache_bytes, global_window)
    return ServeMemoryEstimate(
        params_bytes=p_bytes,
        kv_slot_bytes=slot,
        prefill_bytes_per_sample=(
            prefill_activation_bytes_per_sample(cfg, pf, act_bytes) + slot),
        fixed_bytes=FIXED_BYTES,
    )
