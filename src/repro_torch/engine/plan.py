"""MBS planner — batch geometry + normalization/accumulation policy.

  * when the caller does not pin a micro-batch size, ``plan_mbs`` asks the
    analytic memory model (``core/memory_model.py``) for the largest
    micro-batch that fits the budget — by default the card's own memory;
  * ragged mini-batches (N_B % N_μ != 0) zero-pad the tail micro-batch
    and carry a ``sample_weight`` mask; a ragged ``"paper"`` plan is
    upgraded to ``"exact"`` (eq. 15–17 hold for any split there).

Plans equal the JAX package's field for field for the same inputs, on
one device, on a data-parallel mesh and on a pipeline mesh
(``pipeline=True``: the model axis runs 1F1B stages,
``engine.PipelinedExecutor``), calibrated ones included: with
``calibrate="auto"`` both read the same tuning-cache entry
(``engine/autotune.py``).

Staging (paper Fig. 1): :func:`host_tensors` turns a split numpy batch
into page-locked host tensors, :func:`stage` copies them to the card with
``non_blocking=True`` on a given CUDA stream and records an event after
the copies, and :func:`wait_staged` orders the consumer's stream after
that event before the batch is first used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MBSConfig:
    """Legacy per-step policy (the JAX package's; new code builds an
    :class:`MBSPlan` through :func:`plan_mbs`). The reference's
    ``remat_micro_step`` and ``unroll`` shape its ``lax.scan``; the port
    runs the micro-batch loop eagerly and has neither."""
    micro_batch_size: int
    normalization: str = "paper"  # "paper" | "exact"
    accum_dtype: Any = torch.float32


def num_micro_batches(mini_batch_size: int, micro_batch_size: int) -> int:
    """Algorithm 1 lines 1–5: N_μ ← min(N_μ, N_B); N_Sμ = ceil(N_B / N_μ)."""
    micro = min(micro_batch_size, mini_batch_size)
    return int(math.ceil(mini_batch_size / micro))


def split_minibatch(batch: Dict[str, np.ndarray], micro_batch_size: int
                    ) -> Dict[str, np.ndarray]:
    """Host-side split (paper Fig. 2 step ❶): every leaf ``(N_B, ...)`` →
    ``(N_Sμ, N_μ, ...)``, zero-padding the ragged tail, plus a
    ``sample_weight`` mask (1 = real sample, 0 = padding) composed with any
    dataset-provided weights."""
    existing_w = batch.get("sample_weight")
    rest = {k: v for k, v in batch.items() if k != "sample_weight"}
    n_b = next(iter(rest.values())).shape[0]
    n_mu = min(micro_batch_size, n_b)
    n_s = num_micro_batches(n_b, n_mu)
    pad = n_s * n_mu - n_b

    def split(x):
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return x.reshape(n_s, n_mu, *x.shape[1:])

    out = {k: split(np.asarray(v)) for k, v in rest.items()}
    w = np.ones((n_b,), np.float32)
    if existing_w is not None:
        w = w * np.asarray(existing_w, np.float32).reshape(n_b)
    if pad:
        w = np.concatenate([w, np.zeros((pad,), np.float32)])
    out["sample_weight"] = w.reshape(n_s, n_mu)
    return out


@dataclasses.dataclass(frozen=True)
class MBSPlan:
    """Batch geometry + accumulation policy for one training setup.

    ``mini_batch_size`` samples are split into ``num_micro_batches``
    micro-batches of ``micro_batch_size``, with ``pad`` zero samples at the
    tail (masked by ``sample_weight``). ``normalization`` is Algorithm 1
    verbatim ("paper": micro mean / N_Sμ) or ragged-exact ("exact": Σ valid
    per-sample losses / N_B_valid); ``accum_dtype`` is the accumulator's
    precision; ``remat_policy`` the checkpointing grade the loss must be
    built with (``auto_policy``: chosen by the planner)."""
    mini_batch_size: int
    micro_batch_size: int
    num_micro_batches: int  # N_Sμ
    pad: int  # zero samples appended to the last micro-batch
    normalization: str = "paper"  # "paper" | "exact"
    accum_dtype: Any = torch.float32
    auto_micro: bool = False  # micro size chosen by the memory model
    auto_normalization: bool = False  # "paper" upgraded to "exact" (ragged)
    remat_policy: str = "period"  # none | dots | period | full
    auto_policy: bool = False  # policy chosen by the planner ("auto")
    # measured-feedback admission: True when the micro size was admitted
    # against the memory oracle's corrected bytes (engine/autotune.py);
    # ``correction`` is the (a, b) of ``measured ≈ a·modeled + b`` applied
    calibrated: bool = False
    correction: Optional[tuple] = None
    # data-parallel geometry: each of ``data_parallel`` workers takes
    # ``local_micro`` samples of every micro-batch (micro_batch_size =
    # local_micro * data_parallel); the gradients are summed across them
    # once per mini-batch (``engine.ShardedExecutor``)
    data_parallel: int = 1
    local_micro: Optional[int] = None  # = micro_batch_size when dp == 1
    # > 1 when the plan was admitted pipeline-aware (plan_mbs(pipeline=
    # True) on a mesh with a model axis): the model axis runs this many
    # 1F1B stages, and the activation budget charged stage-local
    # activations × the in-flight depth instead of the // tp discount
    pipeline_stages: int = 1

    def __post_init__(self):
        if self.local_micro is None:
            object.__setattr__(self, "local_micro",
                               self.micro_batch_size // self.data_parallel)

    def split(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Pad-and-mask split of a host mini-batch. Non-uniform dataset
        weights are only normalized correctly by "exact" mode, so they are
        refused under "paper"."""
        w = batch.get("sample_weight")
        if w is not None and self.normalization == "paper":
            w = np.asarray(w)
            if w.size and not np.all(w == w.flat[0]):
                raise ValueError(
                    'batch carries a non-uniform sample_weight, which '
                    '"paper" normalization cannot weight correctly — '
                    'build the plan with normalization="exact"')
        return split_minibatch(batch, self.micro_batch_size)

    def as_config(self) -> MBSConfig:
        return MBSConfig(self.micro_batch_size, self.normalization,
                         self.accum_dtype)

    @classmethod
    def from_config(cls, cfg: MBSConfig,
                    mini_batch_size: Optional[int] = None) -> "MBSPlan":
        """Adapt a legacy MBSConfig. Without a mini-batch size the geometry
        fields are degenerate (the executors take N_Sμ from the data; only
        the policy fields matter)."""
        mini = (mini_batch_size if mini_batch_size is not None
                else cfg.micro_batch_size)
        micro = min(cfg.micro_batch_size, mini)
        n_s = num_micro_batches(mini, micro)
        return cls(mini, micro, n_s, n_s * micro - mini, cfg.normalization,
                   cfg.accum_dtype)

    def device_split(self, batch: Dict[str, np.ndarray], device
                     ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.split(batch).items()}

    def describe(self) -> str:
        src = ("calibrated memory model" if self.calibrated
               else "memory model" if self.auto_micro else "pinned")
        norm = self.normalization + (" (auto)" if self.auto_normalization
                                     else "")
        pol = self.remat_policy + (" (auto)" if self.auto_policy else "")
        accum = str(self.accum_dtype).replace("torch.", "")
        mesh = (f", data-parallel {self.data_parallel} x local "
                f"{self.local_micro}" if self.data_parallel > 1 else "")
        if self.pipeline_stages > 1:
            mesh += f", pipeline {self.pipeline_stages} stages"
        return (f"MBSPlan: mini-batch {self.mini_batch_size} -> "
                f"{self.num_micro_batches} x micro-batch "
                f"{self.micro_batch_size} (pad {self.pad}, micro {src}, "
                f"normalization {norm}, remat {pol}, accum {accum}{mesh})")


def host_tensors(split: Dict[str, np.ndarray], *, pin: bool
                 ) -> Dict[str, torch.Tensor]:
    """A split batch as host tensors: page-locked copies when ``pin`` (the
    source an asynchronous copy to the card needs — from pageable memory
    ``non_blocking=True`` is a synchronous copy), else the numpy memory
    itself."""
    out = {}
    for k, v in split.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def stage(host: Dict[str, torch.Tensor], device, stream
          ) -> Tuple[Dict[str, torch.Tensor], Optional[Any]]:
    """Copy host tensors to ``device``: (device tensors, event). On CUDA
    the copies are issued with ``non_blocking=True`` on the CUDA
    ``stream`` and the event is recorded there after them; pass both to
    :func:`wait_staged` before the first use. On the CPU (``stream``
    None) the tensors are returned as they are and the event is None."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}, None
    with torch.cuda.stream(stream):
        out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def wait_staged(tensors: Dict[str, torch.Tensor], event
                ) -> Dict[str, torch.Tensor]:
    """Order the current stream after a staged batch's copies and mark its
    tensors as used on that stream: they were allocated on the copy
    stream, so without ``record_stream`` the caching allocator would hand
    their blocks to the next copy while this stream still reads them. A
    no-op on the CPU (``event`` None)."""
    if event is None:
        return tensors
    cur = torch.cuda.current_stream(next(iter(tensors.values())).device)
    cur.wait_event(event)
    for t in tensors.values():
        t.record_stream(cur)
    return tensors


def plan_mbs(mini_batch_size: int, *,
             micro_batch_size: Optional[int] = None,
             num_microbatches: Optional[int] = None,
             model_cfg=None, seq_len: Optional[int] = None,
             budget_bytes: Optional[int] = None, device="cuda",
             normalization: str = "paper",
             accum_dtype: Any = torch.float32,
             tp: int = 1, fsdp: int = 1, opt_slots: Optional[int] = None,
             act_bytes: int = 2, remat: bool = True,
             remat_policy: Optional[str] = None,
             optimizer: str = "sgd", fused_update: bool = False,
             mesh=None, fsdp_params: bool = True,
             calibrate: str = "off", tuning_cache: Optional[str] = None,
             executor: str = "compiled", pipeline: bool = False) -> MBSPlan:
    """Produce an :class:`MBSPlan` for one training setup.

    Micro-batch size, in priority order:
      1. ``micro_batch_size`` pinned by the caller;
      2. ``num_microbatches`` pinned → ceil(N_B / N_Sμ);
      3. the memory model (needs ``model_cfg`` and ``seq_len``): the
         largest power of two that fits ``budget_bytes`` (default: the
         total memory of CUDA ``device``; a CPU caller passes a budget);
      4. no model config → one micro-batch.

    ``remat_policy``: an explicit policy is used as given; ``"auto"``
    chooses it jointly with the micro size (cheapest recompute that meets
    the whole mini-batch, or with a pinned size the cheapest that admits
    it); ``None`` maps the ``remat`` bool (True → "period").

    ``tp`` / ``fsdp`` are the memory model's manual divisors (the
    reference's; a mesh overrides them, ``memory_model.estimate``).

    ``mesh`` (a mapping of axis name to size, e.g. a
    ``launch.mesh.Mesh``) makes the plan data-parallel: the budget is
    PER-DEVICE bytes (params and optimizer state discounted by
    ``memory_model.param_shard_ratio``; ``fsdp_params=False`` models the
    replicating ``ShardedExecutor``), the memory model sizes the local
    micro-batch, and the global micro-batch stays divisible by the data
    extent: a pinned size is rounded UP to the next multiple, but never
    past the largest multiple that fits in the mini-batch. The plan is
    arithmetic plus, under ``calibrate="auto"``, one cache read — a
    launcher with several ranks plans on rank 0 and broadcasts the plan
    (``launch.mesh.broadcast_object``), so every rank holds the same one.

    ``calibrate`` closes the loop against the card (only when the planner
    itself sizes the micro-batch, path 3):
      * ``"off"``: analytic admission, no cache I/O;
      * ``"auto"``: when the tuning cache (``tuning_cache`` or the active
        or default one) holds a correction for this (arch, seq, policy,
        mesh, optimizer, ``executor``, backend) key, admission searches
        *corrected* bytes ``a·modeled + b`` over every integer micro
        size; without one, or when the corrected search admits nothing,
        the analytic choice stands;
      * ``"force"``: run the probe steps now (``autotune.calibrate_memory``
        on CUDA ``device``), persist the fit, then admit against it,
        probing an admitted size that was never probed and stepping down
        while its measured peak is over the budget
        (``autotune.calibrated_micro``).
    A policy one of whose probes the card cannot hold (now, or as the
    cache records) is ruled out: under ``"auto"`` the planner climbs the
    remat lattice to the next policy, as it does past a policy whose
    corrected bytes exceed the budget even at micro 1 (the heaviest
    policy's analytic plan stands when none admits one). On the last
    rung, and for a pinned policy, only an out-of-memory smallest probe
    rules it out — ``ValueError`` — and a larger one caps admission.
    A calibrated plan records ``calibrated=True`` and the correction.
    ``executor`` only keys the cache entry (and names the executor the
    probes run); it does not change the geometry.

    ``pipeline=True`` reads the mesh's model axis as 1F1B pipeline
    stages: admission charges stage-local activations × the in-flight
    micro-batch count (``memory_model.pipeline_activation_bytes_per_sample``)
    instead of the tensor-parallel ``// tp`` discount, and the plan
    records ``pipeline_stages``. A stage count that does not divide the
    model's block stack is refused here, before any executor is built.
    ``calibrate="force"`` is refused with it: the probes run one worker's
    whole-model step, not a stage's."""
    if calibrate not in ("off", "auto", "force"):
        raise ValueError(
            f'calibrate must be "off", "auto" or "force", got {calibrate!r}')
    if mini_batch_size < 1:
        raise ValueError(f"mini_batch_size must be >= 1, got {mini_batch_size}")
    from ..core import memory_model  # deferred: core imports this package
    from ..models import remat as remat_lib
    dp = 1
    stages = 1
    if mesh is not None:
        from ..launch import mesh as mesh_lib  # deferred: no cycle
        dp = mesh_lib.data_parallel_size(mesh)
        if pipeline:
            stages = mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS)
    if pipeline and stages > 1 and model_cfg is not None \
            and model_cfg.num_periods % stages:
        raise ValueError(
            f"pipeline stage count {stages} (the mesh's model axis) does "
            f"not divide the block stack ({model_cfg.num_periods} periods) "
            "— pick a model axis that divides num_periods evenly")
    if pipeline and calibrate == "force":
        raise ValueError(
            'calibrate="force" probes one worker\'s whole-model step; a '
            "pipeline stage's peak is not measured — plan the pipeline "
            'with calibrate="auto" or "off"')
    if mini_batch_size < dp:
        raise ValueError(
            f"mini-batch {mini_batch_size} is smaller than the mesh's "
            f"data-parallel size {dp}; every worker needs at least one "
            "sample per micro-batch — shrink the data axis or grow the batch")
    auto_policy_requested = remat_policy == "auto"
    policy = (None if auto_policy_requested
              else remat_lib.resolve(remat, remat_policy))
    can_search = model_cfg is not None and seq_len is not None
    mm_kw = dict(tp=tp, fsdp=fsdp, opt_slots=opt_slots, act_bytes=act_bytes,
                 optimizer=optimizer, fused_update=fused_update,
                 mesh=mesh, fsdp_params=fsdp_params)
    if pipeline:  # the probes of calibrate="force" (refused above) lack it
        mm_kw["pipeline"] = True
    # the memory model budgets what ONE device holds: local samples
    local_mini = mini_batch_size // dp

    def budget() -> int:
        return budget_bytes or memory_model.device_memory_bytes(device)

    auto = False
    policy_searched = False
    calibrated = False
    correction = None
    if micro_batch_size is not None:
        micro = micro_batch_size
    elif num_microbatches is not None:
        if num_microbatches < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        micro = int(math.ceil(mini_batch_size / num_microbatches))
    elif model_cfg is not None:
        if seq_len is None:
            raise ValueError("auto micro-batch sizing needs seq_len")
        if auto_policy_requested:
            policy, local = memory_model.suggest_remat_policy_and_micro(
                model_cfg, seq_len, local_mini, budget_bytes=budget(),
                **mm_kw)
            policy_searched = True
        else:
            local = memory_model.suggest_micro_batch_size(
                model_cfg, seq_len, local_mini, budget_bytes=budget(),
                remat_policy=policy, **mm_kw)
        if calibrate != "off":
            # the analytic search picked the policy; calibration refines
            # the micro size for that policy only — or, when its probe
            # does not fit the card, walks the rungs above it by the
            # joint search's rule (``suggest_remat_policy_and_micro``):
            # the first whose micro reaches the local mini-batch, else
            # the one admitting the largest, ties to the cheaper
            from . import autotune
            order = memory_model.POLICY_ORDER
            ladder = (order[order.index(policy):] if auto_policy_requested
                      else (policy,))
            chosen = best = None
            for i, pol in enumerate(ladder):
                last = i + 1 == len(ladder)
                try:
                    cal_local, corr = autotune.calibrated_micro(
                        model_cfg, seq_len, local_mini, budget(),
                        remat_policy=pol, executor=executor,
                        mode=calibrate, cache_path=tuning_cache,
                        device=device, strict=not last, **mm_kw)
                except autotune.ProbeOutOfMemory as e:
                    if not last or best is not None:
                        continue
                    raise ValueError(f"{e} — " + (
                        f"no policy from {ladder[0]!r} up fits the card"
                        if auto_policy_requested else
                        'pin a heavier remat policy or pass remat_policy='
                        '"auto"')) from None
                if cal_local is None and corr is not None and not last:
                    continue  # measured over the budget even at micro 1
                admits = (0 if cal_local is None and corr is not None
                          else cal_local if cal_local is not None else
                          memory_model.suggest_micro_batch_size(
                              model_cfg, seq_len, local_mini,
                              budget_bytes=budget(), remat_policy=pol,
                              **mm_kw) or 0)
                if pol == policy or admits >= local_mini:
                    chosen = (pol, cal_local, corr)
                    break
                if best is None or admits > best[0]:
                    best = (admits, (pol, cal_local, corr))
            if chosen is None and best is not None:
                chosen = best[1]
            if chosen is not None:
                pol, cal_local, corr = chosen
                if pol != policy:
                    policy = pol
                    local = memory_model.suggest_micro_batch_size(
                        model_cfg, seq_len, local_mini,
                        budget_bytes=budget(), remat_policy=policy,
                        **mm_kw)
                if cal_local is not None:
                    local = cal_local
                    calibrated = True
                    correction = (float(corr[0]), float(corr[1]))
        micro = (local or 1) * dp
        auto = True
    else:
        micro = mini_batch_size

    micro = max(1, min(micro, mini_batch_size))  # Algorithm 1 lines 2–4
    if dp > 1:
        # divisible by the data extent: round UP to the next multiple (a
        # worker's load ceil(micro/dp) never exceeds the pinned intent),
        # capped at the largest multiple within the mini-batch
        micro = min(dp * -(-micro // dp), dp * local_mini)
    if policy is None:  # "auto" with a pinned micro size (or no model cfg)
        if can_search:
            policy = memory_model.POLICY_ORDER[-1]
            for p in memory_model.POLICY_ORDER:
                est = memory_model.estimate(model_cfg, seq_len,
                                            remat_policy=p, **mm_kw)
                if est.total(micro // dp) <= budget():
                    policy = p
                    break
            policy_searched = True
        else:
            # nothing to search against: the legacy bool decides, and the
            # plan must not claim the planner validated the choice
            policy = remat_lib.resolve(remat, None)
    n_s = num_micro_batches(mini_batch_size, micro)
    pad = n_s * micro - mini_batch_size
    auto_norm = False
    if pad and normalization == "paper":
        # Algorithm 1 divides each micro mean by N_Sμ, which over-weights a
        # short tail; "exact" reproduces the mini-batch gradient for any split
        normalization, auto_norm = "exact", True
    return MBSPlan(mini_batch_size, micro, n_s, pad, normalization,
                   accum_dtype, auto_micro=auto,
                   auto_normalization=auto_norm, remat_policy=policy,
                   auto_policy=auto_policy_requested and policy_searched,
                   calibrated=calibrated, correction=correction,
                   data_parallel=dp, local_micro=micro // dp,
                   pipeline_stages=stages)
