"""Closed-loop autotuner: measured feedback for the planner and the 1-D
kernels behind one persistent on-disk cache — the JAX package's
``engine/autotune.py``.

Both halves key into one JSON cache (``~/.cache/repro-torch-tuning/
tuning.json``, overridable by ``REPRO_TORCH_TUNING_CACHE``,
:func:`set_cache_path` or the launcher's ``--tuning-cache``). Its keys and
schema are the reference's, so a file one package writes is read by the
other; the backend component is ``"cpu"`` on the CPU and ``"gpu"`` on the
card, as JAX names them, so an entry measured on a TPU never serves the
card.

**Half 1 — memory oracle.** ``core/memory_model`` is open-loop analytic,
and on the card's eager step it is *under* the real peak (2.2× at full
qwen2-1.5b), so an uncalibrated plan can admit a micro-batch the card
cannot hold. :func:`calibrate_memory` closes the loop: one real step of
the executor at 2–3 probe micro-batch sizes, the allocator's peak read
after each (:func:`measured_step_bytes`), a per-key affine fit
``measured ≈ a·modeled + b`` persisted. A calibrated
``plan_mbs(calibrate="auto"|"force")`` then binary-searches admission
(any integer micro-batch) against *corrected* bytes and records
``MBSPlan.calibrated``/``correction``; with no cache entry it falls back
to the analytic model. Two repairs over the reference's loop
(:func:`calibrated_micro`), both kept in the cache entry so ``"auto"``
plans what ``"force"`` planned:

  * a probe the card cannot hold (the allocator's ``OutOfMemoryError``)
    frees what it allocated, is recorded under the policy's key
    (``"oom"``) and raises :class:`ProbeOutOfMemory`: the policy does not
    fit, and ``plan_mbs`` climbs the remat lattice. On the lattice's last
    rung (or a pinned policy) only the smallest probe's OOM rules the
    policy out (the planner's ``ValueError``); a larger one caps
    admission below its size;
  * the measured peak is the larger of two lines (the set-up's and the
    step's), so a fit over micro 1, 2, 4 can under-predict a larger
    admitted size. Under ``"force"`` an admitted size that was never
    probed is probed once; a measured peak over the budget caps admission
    below that size, the fit is redone with the point, and the search
    steps down until a measured probe fits (the probe list's own
    over-budget points cap every later search, at any budget).

**Half 2 — block tuner.** :func:`tune_block_sizes` / :func:`tune_for_params`
time K1 (``grad_accum``) and K2 (``fused_update``) over candidate launch
blocks with CUDA events and persist the winner per (kernel, dtype,
buffer-size bucket, backend); the wrappers look it up through the resolver
this module installs at import (``kernels._launch.set_block_resolver``),
and keep ``launch_config``'s block where the cache has none.

Invariant: tuning changes speed and admission, never values — a tuned
block gives the default block's bits, and a calibrated plan runs the same
step arithmetic as an analytic plan of the same geometry.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..kernels import fused_sgd, grad_accum_many, set_block_resolver
from .flat import FlatSpec

CACHE_VERSION = 1

# Candidate 1-D launch blocks of the timed sweep: powers of two that K1
# (any block, one chunk a CUDA block) and the Triton K2-K4 (a power-of-two
# BLOCK, at most 2^20 elements) accept, around launch_config's 1024/4096.
# The reference's extra candidate 0, the whole buffer in one program,
# stood for its interpret-mode winner: one program over a 1.5e9-element
# bucket is no launch geometry on the card, so the port sweeps these.
CANDIDATE_BLOCKS = (1024, 2048, 4096, 8192, 16384)


def default_backend() -> str:
    """JAX's name for the platform the kernels run on here."""
    return "gpu" if torch.cuda.is_available() else "cpu"


def backend_of(device) -> str:
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# cache keys (the reference's layout)
# ---------------------------------------------------------------------------

def mesh_tag(mesh) -> str:
    """Stable axis-name/size fingerprint of a mesh, given as a mapping of
    axis name to size (JAX's ``Mesh.shape``); "none" on one device. Part
    of every memory key, so a mesh-calibrated correction never serves a
    single-device plan (and vice versa)."""
    if mesh is None:
        return "none"
    return "x".join(f"{ax}{n}" for ax, n in mesh.items())


def arch_tag(cfg) -> str:
    """Config fingerprint: the name alone collides between full and
    reduced variants, so the dimensions that move the memory model are in
    it."""
    dims = [f"L{getattr(cfg, 'num_layers', 0)}"]
    for short, attr in (("d", "d_model"), ("ff", "d_ff"), ("v", "vocab_size")):
        val = getattr(cfg, attr, None)
        if val:
            dims.append(f"{short}{val}")
    return "-".join([cfg.name] + dims)


def memory_key(cfg, seq: int, remat_policy: str, mesh, optimizer: str,
               executor: str, backend: Optional[str] = None) -> str:
    backend = backend or default_backend()
    return "|".join([arch_tag(cfg), f"s{seq}", str(remat_policy),
                     f"mesh:{mesh_tag(mesh)}", str(optimizer),
                     str(executor), backend])


def size_bucket(n: int) -> str:
    """Power-of-two ceiling bucket: one tuned entry covers every buffer
    within a factor of two of the measured size."""
    n = max(int(n), 1)
    return f"p{(n - 1).bit_length()}"


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def block_key(kind: str, dtype, n: int, *, interpret: Optional[bool] = None,
              backend: Optional[str] = None) -> str:
    """``interpret`` is True for the plain CPU path (the reference's
    interpret mode stands for it): ``"cpu+interp"``; the card's kernels
    key as ``"gpu"``."""
    if interpret is None:
        interpret = not torch.cuda.is_available()
    backend = backend or default_backend()
    mode = f"{backend}+interp" if interpret else backend
    return "|".join([kind, _dtype_name(dtype), size_bucket(n), mode])


# ---------------------------------------------------------------------------
# the persistent cache
# ---------------------------------------------------------------------------

def default_cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-tuning", "tuning.json")


class ProbeOutOfMemory(RuntimeError):
    """A calibration probe's real step did not fit the card: the policy of
    ``key`` does not fit (recorded in the cache under ``key``)."""

    def __init__(self, key: str, remat_policy: str, micro: int,
                 error: str):
        super().__init__(
            f"remat policy {remat_policy!r}: the calibration probe at "
            f"micro-batch {micro} does not fit the card ({error})")
        self.key, self.remat_policy = key, remat_policy
        self.micro, self.error = micro, error


def _empty() -> Dict[str, Any]:
    return {"version": CACHE_VERSION, "memory": {}, "blocks": {}}


class TuningCache:
    """Tolerant JSON store for both halves.

    A corrupt file, another version and a malformed entry all read as
    *absent*: the planner falls back to the analytic model and the kernels
    to their default block; a lookup never raises. Writes are atomic
    (temporary file + rename) and best-effort: an unwritable cache stays
    in memory, with a warning."""

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.expanduser(path) if path else default_cache_path()
        self._data: Optional[Dict[str, Any]] = None

    @property
    def data(self) -> Dict[str, Any]:
        if self._data is None:
            self._data = self._load()
        return self._data

    def _load(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return _empty()
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
            return _empty()  # stale schema: recalibrate rather than misread
        out = _empty()
        if isinstance(raw.get("memory"), dict):
            out["memory"] = raw["memory"]
        if isinstance(raw.get("blocks"), dict):
            out["blocks"] = raw["blocks"]
        return out

    def save(self) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as e:
            warnings.warn(f"tuning cache not persisted to {self.path}: {e}")

    # -- memory-oracle entries ----------------------------------------------

    def memory_correction(self, key: str) -> Optional[Tuple[float, float]]:
        entry = self.data["memory"].get(key)
        if not isinstance(entry, dict):
            return None
        try:
            a, b = float(entry["a"]), float(entry["b"])
        except (KeyError, TypeError, ValueError):
            return None  # a malformed or stale entry is no entry
        if not (a > 0.0 and math.isfinite(a) and math.isfinite(b)):
            return None
        return a, b

    def memory_entry(self, key: str) -> Dict[str, Any]:
        entry = self.data["memory"].get(key)
        return entry if isinstance(entry, dict) else {}

    def memory_oom(self, key: str) -> Optional[Dict[str, Any]]:
        """The record of a probe the card could not hold under ``key``
        (``{"micro", "error"}``), or None."""
        oom = self.memory_entry(key).get("oom")
        return oom if isinstance(oom, dict) else None

    def put_memory(self, key: str, a: float, b: float,
                   probes: Sequence[Sequence[float]] = (),
                   oom_micros: Sequence[int] = ()) -> None:
        """A fit and its probes (micro, modeled, measured); ``oom_micros``
        are probed sizes the card could not hold."""
        entry = {"a": float(a), "b": float(b),
                 "probes": [[int(m), int(mod), int(meas)]
                            for m, mod, meas in probes]}
        if oom_micros:
            entry["oom_micros"] = sorted(int(m) for m in oom_micros)
        self.data["memory"][key] = entry
        self.save()

    def put_memory_oom(self, key: str, micro: int, error: str) -> None:
        """The policy of ``key`` does not fit: its smallest probe,
        ``micro``, ran out of memory (no fit)."""
        self.data["memory"][key] = {
            "oom": {"micro": int(micro), "error": str(error)}}
        self.save()

    # -- tuned-block entries ------------------------------------------------

    def tuned_block(self, key: str) -> Optional[int]:
        entry = self.data["blocks"].get(key)
        if not isinstance(entry, dict):
            return None
        try:
            block = int(entry["block"])
        except (KeyError, TypeError, ValueError):
            return None
        return block if block >= 0 else None  # 0: the reference's whole buffer

    def put_block(self, key: str, block: int,
                  timings_us: Optional[Dict[str, float]] = None) -> None:
        self.data["blocks"][key] = {"block": int(block),
                                    "timings_us": timings_us or {}}
        self.save()


_active_path: Optional[str] = None
_caches: Dict[str, TuningCache] = {}


def set_cache_path(path: Optional[str]) -> None:
    """Point the process-wide active cache (planner lookups without an
    explicit path, and the kernels' block resolver) at ``path``; None goes
    back to ``REPRO_TORCH_TUNING_CACHE`` or the default."""
    global _active_path
    _active_path = os.path.expanduser(path) if path else None


def get_cache(path: Optional[str] = None) -> TuningCache:
    p = os.path.expanduser(path) if path else (_active_path
                                               or default_cache_path())
    if p not in _caches:
        _caches[p] = TuningCache(p)
    return _caches[p]


# ---------------------------------------------------------------------------
# Half 1 — memory oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryCorrection:
    """``measured ≈ a · modeled + b`` for one cache key."""
    a: float
    b: float
    probes: Tuple[Tuple[int, int, int], ...] = ()  # (micro, modeled, measured)

    @property
    def correction(self) -> Tuple[float, float]:
        return (self.a, self.b)

    def corrected(self, modeled_bytes: float) -> float:
        return self.a * modeled_bytes + self.b


def _probe_optimizer(name: str):
    """An optimizer whose state tree matches the named rule (the
    hyperparameters do not move the memory profile; the slots do)."""
    from .. import optim
    if name == "sgd_plain":
        return optim.sgd(0.01)
    if name == "adam":
        return optim.adam(0.01)
    if name == "adamw":
        return optim.adam(0.01, weight_decay=0.01, decoupled=True)
    return optim.sgd(0.01, momentum=0.9)


def measured_step_bytes(cfg, seq: int, micro: int, *,
                        remat_policy: str = "period",
                        optimizer: str = "sgd", executor: str = "compiled",
                        act_bytes: int = 4, num_probe_microbatches: int = 2,
                        device="cuda") -> int:
    """Peak device bytes of one REAL training step at a pinned micro-batch
    size: the allocator's peak statistics reset, one ``step_split`` of the
    executor the key names over ``num_probe_microbatches`` micro-batches
    of ``micro`` samples (params and optimizer state made fresh for it),
    the peak read, everything freed. Counted from what was allocated
    before the probe, so the bytes are the step's own: params, optimizer
    state, batch, accumulator, activations and update transients.

    The reference reads XLA's ``memory_analysis()`` of an abstract
    compile and probes ``compiled`` in place of ``streaming``, which has
    no jittable step; every executor of the port has a real eager step,
    so the one the key names is the one measured. The batch is the
    family's, as the reference's ``abstract_train_batch`` shapes it:
    frames and target tokens for an enc-dec config, patch embeddings
    and M-RoPE streams beside the tokens for a VLM
    (``steps.family_batch``), frames and embeddings in the activation
    dtype. A step the card cannot hold frees what the probe allocated and
    raises a fresh ``torch.OutOfMemoryError`` (no traceback holding the
    probe's tensors). The CPU has no allocator peak to read: there this
    raises, and never returns a modeled number."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(
            f"measured_step_bytes needs a CUDA device, got {device}: the "
            "memory oracle reads the caching allocator's peak, which the "
            "CPU does not have")
    from ..launch import steps
    from .executors import FlatFusedExecutor, get_executor
    from .plan import plan_mbs

    dtype = torch.float32 if act_bytes >= 4 else torch.bfloat16
    mini = micro * num_probe_microbatches
    plan = plan_mbs(mini, micro_batch_size=micro, device=device,
                    remat_policy=remat_policy)
    opt = _probe_optimizer(optimizer)
    ex = get_executor(executor)(
        steps.make_loss_fn(cfg, dtype=dtype, remat_policy=remat_policy),
        opt, plan)
    batch = steps.family_batch(cfg, seq, mini, seed=0)
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    state, error = {}, None
    try:
        state["split"] = steps.device_split(plan, batch, device, dtype)
        state["params"] = steps.init_params(cfg, seed=0, device=device)
        state["opt_state"] = opt.init(state["params"])
        if isinstance(ex, FlatFusedExecutor):
            state["params"], state["opt_state"] = ex.prepare(
                state["params"], state["opt_state"])
        state["out"] = ex.step_split(state.pop("params"),
                                     state.pop("opt_state"), state["split"])
        torch.cuda.synchronize(device)
    except torch.OutOfMemoryError as e:
        error = (str(e).splitlines() or ["out of memory"])[0]
    peak = torch.cuda.max_memory_allocated(device) - base
    state.clear()
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    if error is not None:
        raise torch.OutOfMemoryError(
            f"calibration probe at micro-batch {micro} (remat "
            f"{remat_policy}): {error}")
    return int(peak)


def _fit_affine(points: Sequence[Tuple[float, float]]) -> Tuple[float, float]:
    """Least-squares ``y ≈ a·x + b`` with safe degeneracies: one probe (or
    identical x values) pins only the offset; a non-positive or
    non-finite slope falls back to offset-only (a = 1)."""
    xs = [float(x) for x, _ in points]
    ys = [float(y) for _, y in points]
    n = len(xs)
    if n == 0:
        return 1.0, 0.0
    mx, my = sum(xs) / n, sum(ys) / n
    var = sum((x - mx) ** 2 for x in xs)
    if n < 2 or var == 0.0:
        return 1.0, my - mx
    a = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / var
    if not (a > 0.0 and math.isfinite(a)):
        return 1.0, my - mx
    return a, my - a * mx


def calibrate_memory(cfg, seq: int, *, remat_policy: str = "period",
                     optimizer: str = "sgd", executor: str = "compiled",
                     mesh=None, probe_micros: Sequence[int] = (1, 2, 4),
                     act_bytes: int = 4, tp: int = 1, fsdp: int = 1,
                     opt_slots: Optional[int] = None,
                     fused_update: bool = False, fsdp_params: bool = True,
                     cache: Optional[TuningCache] = None,
                     cache_path: Optional[str] = None,
                     device="cuda", strict: bool = True) -> MemoryCorrection:
    """Run the probes for one key, fit, and persist the correction.

    A probe is the single-worker step at micro ``m``; for a mesh plan
    that is the per-device view the planner budgets (exact for the
    replicating data-parallel executor), and the entry is keyed by the
    mesh so it never serves another topology. When the card cannot hold
    a probe, the policy does not fit: that is recorded under the key and
    raises :class:`ProbeOutOfMemory` — unless ``strict`` is False and an
    earlier probe ran, when the probing ends there, the fit is made over
    the probes that ran, and admission stays below the size that did not
    fit (``oom_micros``, :func:`measured_cap`)."""
    from ..core import memory_model
    cache = cache or get_cache(cache_path)
    est = memory_model.estimate(
        cfg, seq, tp=tp, fsdp=fsdp, opt_slots=opt_slots,
        act_bytes=act_bytes, remat_policy=remat_policy, optimizer=optimizer,
        fused_update=fused_update, mesh=mesh, fsdp_params=fsdp_params)
    key = memory_key(cfg, seq, remat_policy, mesh, optimizer, executor,
                     backend_of(device))
    probes, ooms = [], []
    for m in sorted({int(m) for m in probe_micros if m >= 1}):
        try:
            measured = measured_step_bytes(
                cfg, seq, m, remat_policy=remat_policy, optimizer=optimizer,
                executor=executor, act_bytes=act_bytes, device=device)
        except torch.OutOfMemoryError as e:
            if probes and not strict:
                ooms.append(m)
                break
            error = (str(e).splitlines() or ["out of memory"])[0]
            cache.put_memory_oom(key, m, error)
            raise ProbeOutOfMemory(key, remat_policy, m, error) from None
        probes.append((m, est.total(m), measured))
    a, b = _fit_affine([(mod, meas) for _, mod, meas in probes])
    cache.put_memory(key, a, b, probes, ooms)
    return MemoryCorrection(a, b, tuple(probes))


def measured_cap(entry: Dict[str, Any], budget: int) -> Optional[int]:
    """The smallest probed micro-batch of a cache entry that did not fit
    ``budget`` (its measured peak above it, or out of memory), or None:
    admission stays below it whatever the fit says."""
    over = [int(p[0]) for p in entry.get("probes", ()) if p[2] > budget]
    over += [int(m) for m in entry.get("oom_micros", ())]
    return min(over) if over else None


def calibrated_micro(cfg, seq: int, local_mini: int, budget: int, *,
                     remat_policy: str, mesh, optimizer: str, executor: str,
                     mode: str, cache_path: Optional[str] = None,
                     probe_micros: Sequence[int] = (1, 2, 4),
                     device="cuda", strict: bool = True, **mm_kw
                     ) -> Tuple[Optional[int], Optional[Tuple[float, float]]]:
    """The planner's entry: (admitted local micro-batch, correction), both
    None without a correction; the micro None when the corrected search
    admits nothing. ``mode="auto"`` reads the cache (no entry → the
    analytic fallback); ``"force"`` runs the probes now, then backs off:
    an admitted size never probed is probed once, and the search is
    redone with its point until it lands on a probed size (module doc).
    A policy whose probe ran out of memory — now, or as the cache records
    — raises :class:`ProbeOutOfMemory` (``strict``: as
    :func:`calibrate_memory`)."""
    cache = get_cache(cache_path)
    key = memory_key(cfg, seq, remat_policy, mesh, optimizer, executor,
                     backend_of(device))
    if mode == "force":
        calibrate_memory(
            cfg, seq, remat_policy=remat_policy, optimizer=optimizer,
            executor=executor, mesh=mesh, probe_micros=probe_micros,
            cache=cache, device=device, strict=strict, **mm_kw)
    oom = cache.memory_oom(key)
    if oom is not None:
        raise ProbeOutOfMemory(key, remat_policy, oom.get("micro", 0),
                               oom.get("error", "out of memory"))
    corr = cache.memory_correction(key)
    if corr is None:
        return None, None
    from ..core import memory_model
    est = memory_model.estimate(cfg, seq, remat_policy=remat_policy,
                                mesh=mesh, optimizer=optimizer, **mm_kw)
    while True:
        entry = cache.memory_entry(key)
        micro = corrected_micro_search(
            cfg, seq, local_mini, budget, corr, remat_policy=remat_policy,
            cap=measured_cap(entry, budget), mesh=mesh, optimizer=optimizer,
            **mm_kw)
        probes = [tuple(p) for p in entry.get("probes", ())]
        ooms = list(entry.get("oom_micros", ()))
        if (mode != "force" or micro is None
                or micro in {p[0] for p in probes} | set(ooms)):
            return micro, corr
        try:
            probes.append((micro, est.total(micro), measured_step_bytes(
                cfg, seq, micro, remat_policy=remat_policy,
                optimizer=optimizer, executor=executor,
                act_bytes=mm_kw.get("act_bytes", 4), device=device)))
        except torch.OutOfMemoryError:
            ooms.append(micro)
        corr = _fit_affine([(mod, meas) for _, mod, meas in probes])
        cache.put_memory(key, *corr, probes, ooms)


def corrected_micro_search(cfg, seq: int, local_mini: int, budget: int,
                           correction: Tuple[float, float], *,
                           remat_policy: str, cap: Optional[int] = None,
                           **mm_kw) -> Optional[int]:
    """Largest micro-batch (any integer ≤ ``local_mini``, not only powers
    of two: corrected bytes are trusted, so the power-of-two margin goes)
    whose corrected bytes fit the budget, below ``cap`` when given (a
    probed size measured over the budget, :func:`measured_cap`); None
    when even 1 does not."""
    from ..core import memory_model
    est = memory_model.estimate(cfg, seq, remat_policy=remat_policy, **mm_kw)
    a, b = correction
    fixed, per_sample = est.affine_coeffs()  # total(m) == fixed + per_sample*m

    def fits(m: int) -> bool:
        return a * (fixed + per_sample * m) + b <= budget

    if not fits(1) or (cap is not None and cap <= 1):
        return None
    lo, hi = 1, max(int(local_mini), 1)
    if cap is not None:
        hi = min(hi, cap - 1)
    while lo < hi:  # binary search of the admission frontier (monotone)
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def record_oom_bound(cfg, seq: int, micro: int, budget: int, *,
                     remat_policy: str, mesh=None, optimizer: str = "sgd",
                     executor: str = "compiled",
                     cache: Optional[TuningCache] = None,
                     cache_path: Optional[str] = None, device="cuda",
                     **mm_kw) -> Tuple[float, float]:
    """Feed an observed out-of-memory back into the cache as a negative
    bound: micro-batch ``micro`` does NOT fit ``budget`` under this key,
    yet the current correction (the cached fit, or the identity for an
    analytic plan) admits it — so raise the offset ``b`` until
    ``corrected(modeled(micro)) = budget + 1``; the next
    :func:`corrected_micro_search` under the key admits less than
    ``micro``. A correction that already rejects ``micro`` is left as it
    is (the failure came from elsewhere: fragmentation, a co-tenant)."""
    from ..core import memory_model
    cache = cache or get_cache(cache_path)
    key = memory_key(cfg, seq, remat_policy, mesh, optimizer, executor,
                     backend_of(device))
    a, b = cache.memory_correction(key) or (1.0, 0.0)
    est = memory_model.estimate(cfg, seq, remat_policy=remat_policy, **mm_kw)
    fixed, per_sample = est.affine_coeffs()
    modeled = fixed + per_sample * max(int(micro), 1)
    if a * modeled + b <= budget:  # the correction wrongly admits micro
        b = float(budget) - a * modeled + 1.0
        entry = cache.memory_entry(key)
        cache.put_memory(key, a, b, entry.get("probes", ()),
                         entry.get("oom_micros", ()))
    return a, b


# ---------------------------------------------------------------------------
# Half 2 — kernel block tuner
# ---------------------------------------------------------------------------

def sweep_operands(kind: str, n: int, dtype=torch.float32, device="cuda",
                   seed: int = 0) -> Tuple[torch.Tensor, ...]:
    """Random operands for one kernel over an ``n``-element bucket:
    (accumulator, gradient) for ``grad_accum``, (params, gradient,
    momentum) for ``fused_update``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn((n,), generator=gen, device=device)
    if kind == "grad_accum":
        return torch.randn((n,), generator=gen, device=device), g
    if kind == "fused_update":
        p = torch.randn((n,), generator=gen, device=device).to(dtype)
        return p, g, torch.randn((n,), generator=gen, device=device
                                 ).to(dtype)
    raise ValueError(f"unknown tunable kernel kind {kind!r}")


def run_with_block(kind: str, operands, block: Optional[int]) -> None:
    """One launch of the kind's kernel, in place on ``operands``, at
    ``block`` (None: the default geometry): K1 adds 1/8 of the gradient,
    K2 takes an SGD step with momentum 0.9 and weight decay 1e-4."""
    if kind == "grad_accum":
        acc, g = operands
        grad_accum_many([acc], [g], 0.125, block=block)
    elif kind == "fused_update":
        p, g, m = operands
        fused_sgd(p, g, m, 0.01, momentum=0.9, weight_decay=1e-4,
                  block=block)
    else:
        raise ValueError(f"unknown tunable kernel kind {kind!r}")


def _time_us(fn, iters: int, warmup: int = 1) -> float:
    """Median device time of ``fn`` (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    times.sort()
    return times[len(times) // 2]


def tune_block_sizes(n: int, dtype=torch.float32, *,
                     kind: str = "grad_accum",
                     candidates: Sequence[int] = CANDIDATE_BLOCKS,
                     iters: int = 3, device="cuda",
                     cache: Optional[TuningCache] = None,
                     cache_path: Optional[str] = None) -> Dict[str, Any]:
    """Timed sweep over candidate launch blocks for one (kernel, dtype,
    buffer size) on the card; persists the winner under the size bucket,
    so every buffer within 2× reuses it. Returns the sweep's record."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"tune_block_sizes times kernels on a CUDA "
                           f"device, got {device}")
    cache = cache or get_cache(cache_path)
    n = int(n)
    ops = sweep_operands(kind, n, dtype, device)
    timings: Dict[str, float] = {}
    best_block, best_t = None, None
    with torch.cuda.device(device):
        for cand in dict.fromkeys(candidates):
            t = _time_us(lambda: run_with_block(kind, ops, cand), iters)
            timings[str(cand)] = t
            if best_t is None or t < best_t:
                best_block, best_t = cand, t
    del ops
    key = block_key(kind, dtype, n, interpret=False,
                    backend=backend_of(device))
    cache.put_block(key, best_block, timings)
    return {"key": key, "n": n, "block": best_block, "time_us": best_t,
            "timings_us": timings}


def tune_for_params(params, *, kinds: Sequence[str] = ("grad_accum",
                                                       "fused_update"),
                    iters: int = 3, device="cuda",
                    cache: Optional[TuningCache] = None,
                    cache_path: Optional[str] = None) -> Dict[str, Any]:
    """Tune every dtype bucket of a model's :class:`FlatSpec` — the
    buffers the flat executor launches over. K1 keys on its accumulator
    (fp32), K2 on the bucket's dtype."""
    spec = FlatSpec.for_tree(params)
    out = {}
    for n, dt in zip(spec.bucket_sizes, spec.bucket_dtypes):
        for kind in kinds:
            rec = tune_block_sizes(
                n, torch.float32 if kind == "grad_accum" else dt, kind=kind,
                iters=iters, device=device, cache=cache,
                cache_path=cache_path)
            out[rec["key"]] = rec
    return out


# ---------------------------------------------------------------------------
# the kernel-side resolver, installed at import: a wrapper called without
# a block sees the active cache's winners
# ---------------------------------------------------------------------------

def _tuned_block_resolver(kind: str, dtype_str: str, n: int,
                          interpret: bool) -> Optional[int]:
    try:
        tuned = get_cache().tuned_block(
            block_key(kind, dtype_str, n, interpret=interpret))
    # a broken cache must never sink a kernel launch
    except Exception:  # repro: noqa(LINT006) the fallback is the default block
        return None
    # 0 (the reference's whole buffer) and a block that is not a power of
    # two are no launch geometry here: keep the default
    if not tuned or tuned & (tuned - 1):
        return None
    return tuned


set_block_resolver(_tuned_block_resolver)
