"""Deterministic fault-injection harness and fault taxonomy (the JAX
package's ``engine/faults.py``).

Every recovery path must be provable on the CPU: a real device OOM cannot
be staged deterministically, a real torn checkpoint needs a kill -9
mid-write. This module makes each fault class a seeded, replayable event:

  * a :class:`FaultPlan` is a list of :class:`FaultSpec`s — fault kind,
    the hook index at which to fire, and how many times;
  * production code carries cheap **hook points** (``on_dispatch`` in the
    executors' ``step_split``, ``on_host_batch``/``corrupt_batch`` in the
    ``Pipeline`` worker, ``on_checkpoint_io``/``on_checkpoint_commit`` in
    ``checkpoint.save``, ``on_replan`` in the supervisor) that are a
    single ``is None`` check when no plan is active;
  * the same plan replays the same faults at the same indices every run
    (the only state is per-spec fire counters).

Fault classes (``FaultSpec.kind``):

  ``oom``           ``torch.OutOfMemoryError`` raised at executor
                    dispatch — fires on every dispatch with index >=
                    ``step`` while charges remain, and only while the
                    active plan's micro-batch is >= ``min_micro``.
  ``nan``           a NaN written into micro-batch ``micro``'s
                    ``sample_weight`` of global step ``step``'s split batch.
  ``worker``        :class:`TransientWorkerError` raised inside the
                    ``Pipeline``'s background producer for global step
                    ``step``.
  ``torn_write``    :class:`InjectedCrash` raised between the npz rename
                    and the manifest write in ``checkpoint.save``.
  ``ckpt_io``       :class:`InjectedIOError` (an ``OSError``) raised
                    before the checkpoint write.
  ``corrupt_cache`` the reference's garbage written over the tuning-cache
                    file at the supervisor's re-plan hook: the tolerant
                    load must degrade to analytic instead of sinking the
                    recovery.

``step`` is the hook's own index space: the global *training step* for
``nan``/``worker``, the *save step* for the checkpoint kinds, and the
*dispatch counter* (``step_split`` calls since activation) for ``oom``.
``step=None`` is a wildcard.

``FaultSpec.rank`` makes an ``oom`` fire on one rank of a world alone
(the executor passes its rank to ``on_dispatch``); ``None`` fires on
every rank. The reference has one controller, so the field is the test
harness's only: it stages the fault that the executors must agree across
the ranks (``agreed_oom``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# fault taxonomy
# ---------------------------------------------------------------------------

class FaultError(Exception):
    """Base class for injected faults (never raised by real failures)."""


class TransientError(Exception):
    """Marker mixin: a retryable failure (bounded retry + backoff)."""


class TransientWorkerError(FaultError, TransientError):
    """Injected transient failure in the input-pipeline producer."""


class InjectedIOError(FaultError, TransientError, OSError):
    """Injected transient checkpoint-I/O failure."""


class InjectedCrash(FaultError):
    """Simulated process death (e.g. mid-checkpoint-write). Not
    retryable: the harness raises it so tests can assert on the on-disk
    state it leaves behind."""


# the JAX package's pattern; PyTorch's allocator says "CUDA out of memory"
_OOM_RE = re.compile(
    r"RESOURCE_EXHAUSTED|OUT_OF_MEMORY|[Oo]ut of memory|[Rr]esource exhausted")
# an error the CUDA runtime or a library returned: an out-of-memory among
# them ("CUDA error: out of memory" from a launch, CUBLAS_STATUS_ALLOC_
# FAILED) may leave the context unusable, so it is not recovered from
_CUDA_ERROR_RE = re.compile(r"CUDA error|CUBLAS_STATUS_|CUDNN_STATUS_")

KINDS = ("oom", "nan", "worker", "torn_write", "ckpt_io", "corrupt_cache")

#: classification labels (the supervisor's recovery state machine keys)
OOM, TRANSIENT, CRASH, FATAL = "oom", "transient", "crash", "fatal"


def is_oom(exc: BaseException) -> bool:
    """True for a device out-of-memory failure the supervisor can recover
    from: the caching allocator's ``torch.OutOfMemoryError`` (real or
    injected), or a ``RuntimeError`` that says so in the reference's
    words. An out-of-memory that the CUDA runtime or a library reports as
    an error (``CUDA error: out of memory``, ``CUBLAS_STATUS_ALLOC_FAILED``)
    is not: it may leave the context unusable, so it is fatal."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    return (isinstance(exc, RuntimeError) and not _CUDA_ERROR_RE.search(msg)
            and _OOM_RE.search(msg) is not None)


def is_transient(exc: BaseException) -> bool:
    """True for failures worth a bounded retry: the explicit transient
    taxonomy plus plain I/O errors (never an OOM)."""
    if is_oom(exc):
        return False
    return isinstance(exc, (TransientError, OSError))


def classify(exc: BaseException) -> str:
    """Map any exception onto the fault taxonomy."""
    if is_oom(exc):
        return OOM
    if isinstance(exc, InjectedCrash):
        return CRASH
    if is_transient(exc):
        return TRANSIENT
    return FATAL


def injected_oom(detail: str = "") -> torch.OutOfMemoryError:
    """The exception class PyTorch's allocator raises, with a message
    :func:`is_oom` recognises."""
    return torch.OutOfMemoryError(
        "RESOURCE_EXHAUSTED: injected OOM (repro_torch.engine.faults)"
        + (f": {detail}" if detail else ""))


def agreed_oom(ranks, world: int, by: str = "the step's all-reduce"
               ) -> torch.OutOfMemoryError:
    """The error every rank of a world raises once a reduction (``by``,
    the step's all-reduce by default) has shown that ``ranks`` ran out of
    memory: one message on every rank, so every rank's supervisor records
    the same fault."""
    return torch.OutOfMemoryError(
        f"RESOURCE_EXHAUSTED: out of memory on rank(s) "
        f"{sorted(int(r) for r in ranks)} of {world}, agreed across the "
        f"world by {by}")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault. ``times`` is the number of firings, ``micro``
    the poisoned micro-batch for ``nan``, ``min_micro`` the admission
    threshold below which an ``oom`` stops firing (0 = always), ``rank``
    the one rank an ``oom`` fires on (None = every rank)."""
    kind: str
    step: Optional[int] = 0
    micro: int = 0
    times: int = 1
    min_micro: int = 0
    rank: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {list(KINDS)}")


def oom_at(step: int, *, times: int = 1, min_micro: int = 0,
           rank: Optional[int] = None) -> FaultSpec:
    return FaultSpec("oom", step, times=times, min_micro=min_micro,
                     rank=rank)


def nan_at(step: Optional[int], *, micro: int = 0, times: int = 1
           ) -> FaultSpec:
    return FaultSpec("nan", step, micro=micro, times=times)


def worker_at(step: int, *, times: int = 1) -> FaultSpec:
    return FaultSpec("worker", step, times=times)


def torn_write_at(step: int) -> FaultSpec:
    return FaultSpec("torn_write", step)


def ckpt_io_at(step: int, *, times: int = 1) -> FaultSpec:
    return FaultSpec("ckpt_io", step, times=times)


def corrupt_cache() -> FaultSpec:
    return FaultSpec("corrupt_cache", None)


class FaultPlan:
    """A seeded, replayable schedule of injected faults: per-spec
    remaining-charge counters, a dispatch counter for the ``oom`` index
    space, and a ``fired`` log ``(kind, index)``."""

    def __init__(self, *specs: FaultSpec, seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = seed
        self._remaining = [s.times for s in self.specs]
        self.dispatches = 0
        self.fired: List[Tuple[str, int]] = []

    def _take(self, kind: str, index: int, *,
              at_least: bool = False) -> Optional[FaultSpec]:
        for i, s in enumerate(self.specs):
            if s.kind != kind or self._remaining[i] <= 0:
                continue
            if s.step is not None and (index < s.step if at_least
                                       else index != s.step):
                continue
            self._remaining[i] -= 1
            self.fired.append((kind, index))
            return s
        return None

    def fired_kinds(self) -> List[str]:
        return [k for k, _ in self.fired]


# ---------------------------------------------------------------------------
# activation + the hook points production code calls
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def activate(plan: FaultPlan) -> FaultPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """``with faults.inject(FaultPlan(oom_at(2))): ...`` — activation is
    process-global (the hooks live in module scope), scoped by this
    context manager."""
    activate(plan)
    try:
        yield plan
    finally:
        deactivate()


def on_dispatch(plan_geometry: Any = None, rank: Optional[int] = None
                ) -> None:
    """Executor hook, called at every ``step_split`` dispatch: raises an
    injected OOM when an armed ``oom`` spec matches the dispatch index,
    the plan's micro-batch is not below ``min_micro`` and the spec's
    ``rank`` (if any) is the caller's ``rank``."""
    if _ACTIVE is None:
        return
    idx = _ACTIVE.dispatches
    _ACTIVE.dispatches += 1
    micro = getattr(plan_geometry, "micro_batch_size", None)
    for i, s in enumerate(_ACTIVE.specs):
        if (s.kind == "oom" and _ACTIVE._remaining[i] > 0
                and (s.step is None or idx >= s.step)
                and (micro is None or micro >= s.min_micro)
                and (s.rank is None or s.rank == rank)):
            _ACTIVE._remaining[i] -= 1
            _ACTIVE.fired.append(("oom", idx))
            raise injected_oom(f"dispatch {idx}, micro={micro}")


def on_host_batch(step: int) -> None:
    """Pipeline producer hook (background thread): transient worker
    failure for global step ``step``."""
    if _ACTIVE is None:
        return
    if _ACTIVE._take("worker", step) is not None:
        raise TransientWorkerError(f"injected worker fault at step {step}")


def corrupt_batch(split: Dict[str, np.ndarray], step: int
                  ) -> Dict[str, np.ndarray]:
    """Pipeline producer hook: poison micro-batch ``micro`` of global step
    ``step``'s split batch with a NaN in its ``sample_weight``."""
    if _ACTIVE is None:
        return split
    spec = _ACTIVE._take("nan", step)
    if spec is None or "sample_weight" not in split:
        return split
    w = np.array(split["sample_weight"], np.float32, copy=True)
    j = min(spec.micro, w.shape[0] - 1)
    w[j, 0] = np.nan
    out = dict(split)
    out["sample_weight"] = w
    return out


def on_checkpoint_io(step: int) -> None:
    """checkpoint.save hook, before any file is touched: transient I/O
    failure (the retryable class)."""
    if _ACTIVE is None:
        return
    if _ACTIVE._take("ckpt_io", step) is not None:
        raise InjectedIOError(f"injected checkpoint I/O fault at step {step}")


def on_checkpoint_commit(step: int) -> None:
    """checkpoint.save hook, between the npz rename and the manifest
    write: simulated crash leaving a torn (uncommitted) checkpoint."""
    if _ACTIVE is None:
        return
    if _ACTIVE._take("torn_write", step) is not None:
        raise InjectedCrash(
            f"injected crash before manifest commit at step {step}")


def on_replan(cache_path: Optional[str]) -> None:
    """Supervisor hook, fired when an OOM recovery is about to consult and
    update the tuning cache: a ``corrupt_cache`` spec overwrites the cache
    file with the reference's garbage — the tolerant load must degrade to
    analytic."""
    if _ACTIVE is None or cache_path is None:
        return
    if _ACTIVE._take("corrupt_cache", 0, at_least=True) is not None:
        try:
            with open(cache_path, "w") as f:
                f.write('{"version": "garbage", "memory": [corrupt')
        except OSError:
            pass  # nothing to corrupt: the lookup already degrades
