"""Fault-tolerant training runtime: the :class:`Supervisor` (the JAX
package's ``engine/supervisor.py``).

MBS admission plans to the edge of device memory, so a run must expect
the plan to be wrong now and then (allocator fragmentation, a co-tenant,
a calibration miss), and long large-batch runs to meet non-finite
gradients and flaky I/O. The supervisor wraps the step loop with a
recovery state machine over the ``faults`` taxonomy:

  ``oom``        (the caching allocator's ``torch.OutOfMemoryError`` out
                 of a step) → **degrade, re-plan, resume**: escalate the
                 remat policy one rung up ``models/remat.py``'s lattice
                 first, then shrink the micro-batch through ``plan_mbs``,
                 after feeding the failure into the tuning cache as a
                 negative bound (``autotune.record_oom_bound``), so the
                 re-plan, and every later plan under the key, admits less
                 than what failed. The failed runtime is dropped before
                 the new one is built (see below), the last completed
                 state is restored (the newest committed checkpoint, else
                 the host anchor) into the new executor's layout, and the
                 steps since are replayed: the Pipeline's step-indexed
                 seeding makes the recovered trajectory equal an
                 uninterrupted run at the degraded plan.
  ``nonfinite``  (the executors' ``guard=True`` finite check) → bounded
                 retry, then skip: the guarded update left the state as
                 it was, so the same seeded batch is drawn again
                 (``pipeline.rebatch``) up to ``nan_retries`` times, then
                 the step is skipped; ``max_consecutive_nan`` skips in a
                 row trip the circuit breaker, and ``on_nan="halt"``
                 raises on the first.
  ``transient``  (``faults.TransientError`` or ``OSError`` escaping the
                 Pipeline's own retries, or a failed checkpoint write) →
                 bounded retry with jittered backoff; a checkpoint that
                 still fails after ``io_retries`` is skipped with a
                 warning and training goes on.
  ``crash``      (``faults.InjectedCrash``) → propagates: it stands for
                 the process dying.
  ``fatal``      anything else, a CUDA error among them (``faults.is_oom``
                 takes only what can be recovered from) → propagates.

What eager PyTorch adds to the reference's recovery: a failed step's
tensors (activations, the accumulator, the staged batch) are held by the
exception's traceback, by the open batch stream and by the loop's own
names. The recovery runs after the ``except`` block has been left, with
only the exception's class and message kept; it closes the stream (its
producer thread stops and its staged batches go), drops the state and
the old executor and pipeline, collects and empties the allocator's
cache, and only then builds the next runtime. The anchor is a host copy
(``flat`` trains its buffers in place and the tree executors free the old
trees), timed and counted in ``anchor_log``.

Supervision cost: with the guard on, the supervisor reads the
``nonfinite`` flag back every step (the retry must know before the next
step is dispatched). The guarded step itself reads nothing back.

On a mesh every rank runs its own supervisor over an
``engine.ShardedExecutor`` or ``engine.PipelinedExecutor``, and a fault
is one decision for all of them, as the reference's single controller
takes it. The guard's flag comes from the globally reduced gradient, so
every rank retries or skips alike. An out-of-memory error on one rank
alone (a real one, or one ``faults.oom_at(..., rank=r)`` injects) is
agreed by the step's own all-reduce: every rank raises the same error
before the update (``ShardedExecutor``'s module doc). The recovery then
takes its decisions on rank 0 alone and broadcasts them
(``launch.mesh.broadcast_object`` over the executor's mesh): the negative
bound is written to the tuning cache by rank 0 only, the degraded plan
(or the give-up) is rank 0's, and so is the resume step, which every
rank restores (the same checkpoint, or its anchor of that step). The
allocator's peaks in the record stay each rank's own. Only a ``writer``
(rank 0) saves checkpoints. A pipelined run anchors and checkpoints the
reference-format state, which ``PipelinedExecutor.gather_state`` puts
together on every rank (a collective, at the same steps on every rank),
and each rank restores its own slice through the executor's
``prepare``. A GSPMD run (``engine.GspmdExecutor``) that writes no
checkpoint anchors each rank's own blocks instead (``local_state``: no
collective, and a rank's host holds its share only) and restores them
through ``place_local``; with a checkpoint directory it anchors and
checkpoints the gathered reference-format state, as the pipelined run
does.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import random as _random
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..checkpoint import checkpoint
from ..launch import mesh as mesh_lib
from ..models import remat as remat_lib
from . import autotune, faults
from .plan import MBSPlan, plan_mbs
from .trainer import _default_log


class SupervisorError(RuntimeError):
    """Base class for supervisor give-ups (recovery budget exhausted)."""
    exit_code = 40


class RestartBudgetExceeded(SupervisorError):
    """More OOM restarts than ``max_restarts``."""
    exit_code = 41


class PlanExhausted(SupervisorError):
    """OOM with nothing left to degrade (remat full, micro-batch 1)."""
    exit_code = 42


class NaNCircuitBreaker(SupervisorError):
    """``max_consecutive_nan`` skipped steps in a row."""
    exit_code = 43


class NaNHalt(SupervisorError):
    """Non-finite step under ``on_nan="halt"``."""
    exit_code = 44


@dataclasses.dataclass
class SupervisorConfig:
    """Recovery budgets and policies (all deterministic; ``seed`` keys only
    the backoff jitter)."""
    max_restarts: int = 3  # OOM re-plan budget for the whole fit
    on_nan: str = "skip"  # "skip" (bounded retry then skip) | "halt"
    nan_retries: int = 1  # same-step clean re-draw attempts before skipping
    max_consecutive_nan: int = 3  # skipped-in-a-row circuit breaker
    io_retries: int = 3  # checkpoint-I/O attempts per save
    stream_retries: int = 2  # transient failures escaping the Pipeline
    backoff_s: float = 0.02  # base backoff (jittered, doubling)
    seed: int = 0

    def __post_init__(self):
        if self.on_nan not in ("skip", "halt"):
            raise ValueError(f"on_nan must be 'skip'|'halt', "
                             f"got {self.on_nan!r}")


@dataclasses.dataclass
class FaultRecord:
    """One recovery event. The reference's fields, then what an OOM
    recovery saw on the card: the failure's class and the head of its
    message, the allocator's peaks up to the failure, and what was
    allocated and reserved once the new runtime held the restored state
    (0 on the CPU)."""
    kind: str  # faults taxonomy label
    step: int  # global step at which the fault surfaced
    action: str  # what the supervisor did
    recovery_s: float = 0.0  # fault caught -> ready to dispatch again
    steps_lost: int = 0  # completed steps replayed (OOM) or skipped (NaN)
    detail: str = ""
    peak_allocated_bytes: int = 0
    peak_reserved_bytes: int = 0
    allocated_bytes: int = 0
    reserved_bytes: int = 0


def degrade_plan(plan: MBSPlan, ctx: Optional[Dict[str, Any]] = None
                 ) -> Tuple[MBSPlan, str]:
    """One deterministic rung down the degradation ladder; returns
    ``(new_plan, action)``.

    Rungs: escalate ``remat_policy`` up the lattice (micro size pinned,
    geometry kept) until "full", then shrink the micro-batch: with a plan
    ``ctx`` (the launcher's model and budget) re-derive it through
    ``plan_mbs(calibrate="auto")``, so the negative bound recorded for the
    OOM drives the new admission; without one, halve it (keeping
    data-parallel divisibility). Raises :class:`PlanExhausted` at the
    bottom of the ladder."""
    lattice = remat_lib.POLICIES
    i = lattice.index(plan.remat_policy)
    if i + 1 < len(lattice):
        nxt = lattice[i + 1]
        action = f"remat {plan.remat_policy}->{nxt}"
        if ctx and ctx.get("model_cfg") is not None:
            new = plan_mbs(plan.mini_batch_size,
                           micro_batch_size=plan.micro_batch_size,
                           remat_policy=nxt, **_ctx_kw(plan, ctx))
        else:
            new = dataclasses.replace(plan, remat_policy=nxt,
                                      auto_policy=False)
        return new, action

    dp = max(plan.data_parallel, 1)
    if plan.micro_batch_size <= max(1, dp):
        raise PlanExhausted(
            f"OOM at remat=full, micro={plan.micro_batch_size}, dp={dp}: "
            "nothing left to degrade (the model itself does not fit — MBS "
            "cannot shrink it; add model parallelism)")
    if ctx and ctx.get("model_cfg") is not None \
            and ctx.get("budget_bytes") is not None:
        new = plan_mbs(plan.mini_batch_size,
                       budget_bytes=ctx["budget_bytes"],
                       remat_policy=plan.remat_policy, calibrate="auto",
                       **_ctx_kw(plan, ctx))
        if new.micro_batch_size < plan.micro_batch_size:
            return new, (f"replan micro {plan.micro_batch_size}->"
                         f"{new.micro_batch_size} (calibrated)")
        # the bound did not move admission (a corrupted cache degraded the
        # lookup to analytic): fall through to the deterministic halving
    new_micro = (plan.micro_batch_size // 2 // dp) * dp if dp > 1 \
        else plan.micro_batch_size // 2
    if new_micro < max(1, dp):
        raise PlanExhausted(
            f"cannot halve micro={plan.micro_batch_size} below the "
            f"data-parallel extent {dp}")
    action = f"halve micro {plan.micro_batch_size}->{new_micro}"
    if ctx and ctx.get("model_cfg") is not None:
        return plan_mbs(plan.mini_batch_size, micro_batch_size=new_micro,
                        remat_policy=plan.remat_policy,
                        **_ctx_kw(plan, ctx)), action
    n_s = math.ceil(plan.mini_batch_size / new_micro)
    pad = n_s * new_micro - plan.mini_batch_size
    norm = ("exact" if (pad and plan.normalization == "paper")
            else plan.normalization)
    return dataclasses.replace(
        plan, micro_batch_size=new_micro, num_micro_batches=n_s, pad=pad,
        normalization=norm,
        auto_normalization=plan.auto_normalization or norm != plan.normalization,
        local_micro=new_micro // dp if dp > 1 else new_micro,
        auto_micro=False, calibrated=False, correction=None), action


def _ctx_kw(plan: MBSPlan, ctx: Dict[str, Any]) -> Dict[str, Any]:
    """The ``plan_mbs`` kwargs a launcher-style plan context carries (the
    reference's, with the device the plan is for)."""
    kw = dict(model_cfg=ctx.get("model_cfg"), seq_len=ctx.get("seq_len"),
              normalization=plan.normalization,
              accum_dtype=plan.accum_dtype, mesh=ctx.get("mesh"),
              optimizer=ctx.get("optimizer", "sgd"),
              executor=ctx.get("executor", "compiled"),
              tuning_cache=ctx.get("tuning_cache"),
              device=ctx.get("device", "cuda"))
    kw.update(ctx.get("mm_kw") or {})
    return kw


def _memory(device) -> Dict[str, int]:
    """The caching allocator's counters on a CUDA ``device`` (zeros on the
    CPU)."""
    if torch.device(device).type != "cuda":
        return dict.fromkeys(("allocated", "reserved", "peak_allocated",
                              "peak_reserved"), 0)
    return {"allocated": torch.cuda.memory_allocated(device),
            "reserved": torch.cuda.memory_reserved(device),
            "peak_allocated": torch.cuda.max_memory_allocated(device),
            "peak_reserved": torch.cuda.max_memory_reserved(device)}


def _nbytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


class Supervisor:
    """Wraps the runtime that ``build`` makes with the recovery state
    machine (see the module doc).

    ``build(plan) -> (executor, step_fn, pipeline)`` is the launcher's
    rebuild factory (``launch.train.make_build``), closed over the model
    and the optimizer; its executors should carry ``guard=True`` so the
    NaN path has its flag. A state restored from the anchor or a
    checkpoint is placed in the current executor's layout (``flat``'s
    buffers through its ``prepare``) on the pipeline's device.

    ``plan_ctx`` (optional) is the launcher's planning context
    (``model_cfg``, ``seq_len``, ``budget_bytes``, ``device``, ``mesh``,
    ``optimizer``, ``executor``, ``tuning_cache``, ``mm_kw``): with it an
    OOM re-plans through ``plan_mbs`` and records the negative bound;
    without it the ladder is geometric (remat escalation, then halving).
    ``writer=False`` (the ranks of a data-parallel world but rank 0)
    restores from ``ckpt_dir`` but never writes a checkpoint.
    """

    def __init__(self, build: Callable[[MBSPlan], Tuple[Any, Callable, Any]],
                 plan: MBSPlan, *,
                 config: Optional[SupervisorConfig] = None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: Optional[int] = None, log_every: int = 5,
                 log_fn: Optional[Callable] = _default_log,
                 plan_ctx: Optional[Dict[str, Any]] = None,
                 writer: bool = True):
        self.build = build
        self.writer = writer
        self.plan = plan
        self.config = config or SupervisorConfig()
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self.log_every = log_every
        self.log_fn = log_fn
        self.plan_ctx = plan_ctx
        self.executor, self.step_fn, self.pipeline = build(plan)
        self.device = self.pipeline.device
        self.restarts = 0
        self.records: List[FaultRecord] = []
        self.history: Dict[int, float] = {}  # step -> loss (completed steps)
        # step -> host metrics and the host clock at their readback
        self.metrics: Dict[int, Dict[str, float]] = {}
        self.anchor_log: List[Dict[str, float]] = []
        self._rng = _random.Random(self.config.seed ^ 0x0F0F)
        self._snapshot: Optional[Tuple[Any, Any, int]] = None
        self._local_template = None  # set while the anchor is local blocks

    # -- state anchoring / restore ------------------------------------------

    def _anchor(self, params, opt_state, step: int) -> None:
        """Host copy of the completed state at ``step``: the restore
        source of last resort (``flat`` overwrites its buffers at the next
        step, the tree executors free the old trees; a pipelined
        executor's is the reference-format state it gathers). Refreshed
        at the checkpoint cadence, so its cost amortizes like a save. A
        GSPMD executor's, when no checkpoint is written, is its own blocks
        (``local_state``)."""
        t0 = time.perf_counter()
        self._snapshot = self._local_template = None  # the old copy goes
        local = (None if self.ckpt_dir
                 else getattr(self.executor, "local_state", None))
        gather = getattr(self.executor, "gather_state", None)
        if local is not None:
            (params, opt_state), self._local_template = local(params,
                                                              opt_state)
        elif gather is not None:
            params, opt_state = gather(params, opt_state)
        else:
            params, opt_state = tree.map(
                lambda t: t.detach().to("cpu", copy=True),
                (params, opt_state))
        self._snapshot = (params, opt_state, step)
        self.anchor_log.append({"step": step,
                                "bytes": _nbytes((params, opt_state)),
                                "seconds": time.perf_counter() - t0})

    def _save(self, params, opt_state, step: int) -> None:
        """Checkpoint with bounded transient-I/O retry; a save that still
        fails is skipped (training goes on, durability catches up at the
        next cadence). ``InjectedCrash`` propagates: it models process
        death."""
        self._anchor(params, opt_state, step)
        if not self.ckpt_dir or not self.writer:
            return
        params, opt_state, _ = self._snapshot  # the host copy just made
        for attempt in range(self.config.io_retries + 1):
            try:
                checkpoint.save(self.ckpt_dir, step,
                                {"params": params, "opt_state": opt_state},
                                keep=self.ckpt_keep)
                return
            except faults.InjectedCrash:
                raise
            except OSError as e:
                if attempt >= self.config.io_retries:
                    warnings.warn(f"checkpoint at step {step} failed after "
                                  f"{attempt + 1} attempts ({e}); continuing")
                    return
                self.records.append(FaultRecord(
                    "transient", step, f"ckpt-io retry {attempt + 1}"))
                self._backoff(attempt)

    def _place(self, params, opt_state) -> Tuple[Any, Any]:
        """A host state on the pipeline's device, in the layout the current
        executor trains (always a copy: the anchor stays untouched)."""
        prepare = getattr(self.executor, "prepare", None)
        if prepare is not None:
            return prepare(params, opt_state, device=self.device)
        return tree.map(lambda t: t.to(self.device, copy=True),
                        (params, opt_state))

    def _load(self, step: int, template):
        """A committed checkpoint on the host, or None if it is corrupt."""
        try:
            t = checkpoint.restore(self.ckpt_dir, template, step,
                                   device="cpu")
        except checkpoint.CheckpointCorruptError:
            return None
        return t["params"], t["opt_state"]

    def _restore(self, only: Optional[int] = None):
        """(params, opt_state, step) of the newest recoverable completed
        state, placed for the current executor: the newest loadable
        committed checkpoint when it is not older than the anchor, else
        the anchor. ``only``: the step another rank chose (its checkpoint,
        or the anchor when it is the anchor's)."""
        params, opt_state, step = self._snapshot
        if self.ckpt_dir:
            template = {"params": params, "opt_state": opt_state}
            for s in reversed(checkpoint.committed_steps(self.ckpt_dir)):
                if s < step:
                    break  # the anchor is newer
                if only is not None and s != only:
                    continue
                loaded = self._load(s, template)
                if loaded is not None:
                    return (*self._place(*loaded), s)
        if only is not None and only != step:
            raise RuntimeError(f"rank 0 resumes from step {only}, which "
                               f"this rank cannot load (anchor at {step})")
        if self._local_template is not None:
            return (*self.executor.place_local(
                params, opt_state, self._local_template,
                device=self.device), step)
        return (*self._place(params, opt_state), step)

    def restore(self, params, opt_state):
        """Trainer-compatible initial resume: ``(params, opt_state, step)``
        from the newest loadable committed checkpoint in ``ckpt_dir``
        (torn or checksum-failing ones are skipped), placed for the
        executor — or ``None``."""
        if not self.ckpt_dir:
            return None
        full = getattr(self.executor, "full_template", None)
        if full is not None:  # a pipeline stage's slice: the whole's shape
            params, opt_state = full(params, opt_state)
        template = {"params": params, "opt_state": opt_state}
        for step in reversed(checkpoint.committed_steps(self.ckpt_dir)):
            loaded = self._load(step, template)
            if loaded is not None:
                return (*self._place(*loaded), step)
        return None

    def _backoff(self, attempt: int) -> None:
        time.sleep(self.config.backoff_s * (1 + self._rng.random())
                   * (2 ** attempt))

    # -- the recovery state machine -----------------------------------------

    def _recover_oom(self, failure: str, failed_step: int
                     ) -> Tuple[Any, Any, int]:
        """Degrade → re-plan (negative bound) → drop the failed runtime →
        rebuild → restore. Called after the ``except`` block has been
        left, with the state and the batch stream already dropped. On
        the card it resets the allocator's peak statistics once the
        record has them, so the next peak read is the recovered plan's."""
        t0 = time.perf_counter()
        self.restarts += 1
        if self.restarts > self.config.max_restarts:
            raise RestartBudgetExceeded(
                f"{self.restarts - 1} restarts exhausted (last OOM at step "
                f"{failed_step}: {failure})")
        at_failure = _memory(self.device)
        mesh = getattr(self.executor, "mesh", None)
        decider = mesh is None or mesh.rank == 0
        decision = self._degrade(failed_step) if decider else None
        self.plan, action, give_up = mesh_lib.broadcast_object(decision,
                                                               mesh)
        if give_up is not None:
            raise give_up
        # the failed runtime goes before the next is built
        self.executor = self.step_fn = self.pipeline = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.executor, self.step_fn, self.pipeline = self.build(self.plan)
        if decider:
            params, opt_state, resume_step = self._restore()
            mesh_lib.broadcast_object(resume_step, mesh)
        else:
            params, opt_state, resume_step = self._restore(
                mesh_lib.broadcast_object(None, mesh))
        after = _memory(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        rec = FaultRecord(
            "oom", failed_step, action,
            recovery_s=time.perf_counter() - t0,
            steps_lost=failed_step - resume_step, detail=failure,
            peak_allocated_bytes=at_failure["peak_allocated"],
            peak_reserved_bytes=at_failure["peak_reserved"],
            allocated_bytes=after["allocated"],
            reserved_bytes=after["reserved"])
        self.records.append(rec)
        if self.log_fn:
            print(f"[supervisor] OOM at step {failed_step} ({failure}): "
                  f"{action}; resuming from step {resume_step} "
                  f"({rec.recovery_s:.2f}s, {rec.steps_lost} steps "
                  f"replayed); peak allocated {rec.peak_allocated_bytes} B, "
                  f"reserved {rec.peak_reserved_bytes} B at the failure; "
                  f"allocated {rec.allocated_bytes} B, reserved "
                  f"{rec.reserved_bytes} B after the rebuild", flush=True)
        return params, opt_state, resume_step

    def _degrade(self, failed_step: int):
        """The recovery's decision (rank 0's on a mesh): the negative
        bound recorded, then ``(degraded plan, action, None)``, or
        ``(None, None, give-up)`` at the bottom of the ladder."""
        ctx = self.plan_ctx
        cache_path = (ctx or {}).get("tuning_cache")
        faults.on_replan(cache_path or
                         (autotune.get_cache().path if ctx else None))
        if ctx and ctx.get("model_cfg") is not None \
                and ctx.get("budget_bytes") is not None:
            # the observed failure becomes a negative calibration bound
            # BEFORE re-planning, so plan_mbs(calibrate="auto") sees it
            autotune.record_oom_bound(
                ctx["model_cfg"], ctx["seq_len"], self.plan.micro_batch_size,
                ctx["budget_bytes"], remat_policy=self.plan.remat_policy,
                mesh=ctx.get("mesh"), optimizer=ctx.get("optimizer", "sgd"),
                executor=ctx.get("executor", "compiled"),
                cache_path=cache_path, device=ctx.get("device", "cuda"),
                **(ctx.get("mm_kw") or {}))
        try:
            return (*degrade_plan(self.plan, ctx), None)
        except PlanExhausted as e:
            return None, None, e

    def _handle_nonfinite(self, params, opt_state, metrics, step: int):
        """Bounded same-batch (clean re-draw) retry, then skip. The guarded
        update passed the state through untouched, so the returned
        buffers ARE the pre-step state."""
        if self.config.on_nan == "halt":
            raise NaNHalt(f"non-finite gradient at step {step} "
                          "(on_nan='halt')")
        t0 = time.perf_counter()
        for attempt in range(self.config.nan_retries):
            batch = self.pipeline.rebatch(step)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            del batch
            if not float(metrics.get("nonfinite", 0.0)):
                self.records.append(FaultRecord(
                    "nonfinite", step, f"retried ok (attempt {attempt + 1})",
                    recovery_s=time.perf_counter() - t0))
                return params, opt_state, metrics, False
        self.records.append(FaultRecord(
            "nonfinite", step, "skipped", steps_lost=1,
            recovery_s=time.perf_counter() - t0))
        return params, opt_state, metrics, True

    # -- the loop -----------------------------------------------------------

    def fit(self, params, opt_state, num_steps: int, *, start_step: int = 0
            ) -> Tuple[Any, Any, Dict[str, float]]:
        """Supervised ``Trainer.fit``: the same contract (final state and
        the last step's metrics as host floats), plus ``records``,
        ``history``, ``metrics`` and :meth:`report` describing every
        recovery."""
        cfg = self.config
        t_fit = time.perf_counter()
        self._anchor(params, opt_state, start_step)
        step = start_step
        consecutive_nan = 0
        stream_failures = 0
        last: Dict[str, float] = {}
        while step < num_steps:
            stream = self.pipeline.batches(num_steps - step, start=step)
            batch = metrics = failure = None
            try:
                for batch in stream:
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    batch = None
                    if float(metrics.get("nonfinite", 0.0)):
                        params, opt_state, metrics, skipped = \
                            self._handle_nonfinite(params, opt_state,
                                                   metrics, step)
                        if skipped:
                            consecutive_nan += 1
                            if consecutive_nan >= cfg.max_consecutive_nan:
                                raise NaNCircuitBreaker(
                                    f"{consecutive_nan} consecutive "
                                    f"non-finite steps ending at {step}")
                        else:
                            consecutive_nan = 0
                    else:
                        consecutive_nan = 0
                    last = {k: float(v) for k, v in metrics.items()}
                    metrics = None
                    self.history[step] = last.get("loss", float("nan"))
                    self.metrics[step] = {**last,
                                          "readback_s": time.perf_counter()}
                    if self.log_fn and self.log_every \
                            and step % self.log_every == 0:
                        self.log_fn(step, last, time.perf_counter() - t_fit)
                    step += 1
                    if self.ckpt_every and step % self.ckpt_every == 0 \
                            and step < num_steps:
                        self._save(params, opt_state, step)
            except Exception as exc:
                if faults.is_oom(exc):
                    # keep the words only: the traceback holds the
                    # failed step's tensors
                    failure = f"{type(exc).__name__}: {_head(exc)}"
                elif faults.is_transient(exc):
                    stream_failures += 1
                    if stream_failures > cfg.stream_retries:
                        raise
                    self.records.append(FaultRecord(
                        "transient", step, "stream restart"))
                    self._backoff(stream_failures - 1)
                else:
                    raise  # fatal (and InjectedCrash): propagate unchanged
            finally:
                stream.close()
            if failure is not None:
                params = opt_state = batch = metrics = stream = None
                params, opt_state, step = self._recover_oom(failure, step)
        if num_steps > start_step:
            self._save(params, opt_state, num_steps)
        return params, opt_state, last

    def report(self) -> Dict[str, Any]:
        return {
            "restarts": self.restarts,
            "plan": {"micro_batch_size": self.plan.micro_batch_size,
                     "num_micro_batches": self.plan.num_micro_batches,
                     "remat_policy": self.plan.remat_policy},
            "faults": [dataclasses.asdict(r) for r in self.records],
            "steps_lost": sum(r.steps_lost for r in self.records),
            "completed_steps": len(self.history),
            "anchors": list(self.anchor_log),
        }


def _head(exc: BaseException, limit: int = 200) -> str:
    """The first line of an exception's message, cut to ``limit``."""
    lines = str(exc).strip().splitlines()
    return (lines[0] if lines else "")[:limit]
