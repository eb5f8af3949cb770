"""Decode-step contracts of the serving engine (SRV001–SRV002) — the
reference's ``analysis/serve_checks.py`` over one real decode step.

The serving engine's steady state is ONE decode step over the whole KV
slot pool, so its memory behaviour rests on two facts this module pins:

  * SRV001 — with donation (``ServingEngine(donate=True)``, the default)
    the step writes the pool in place: every pool leaf keeps its
    storage. A non-donated step (``--no-donate``) writes a fresh copy,
    so the old and the new pool are live at once — two full KV copies,
    which halves the slots ``plan_serve`` could admit — and fires it.
  * SRV002 — the step's peak (the allocator's on the card, the live
    tensor bytes on the CPU) agrees with ``memory_model.serve_estimate``'s
    decode-time picture within a declared band AND stays under the
    budget the :class:`ServePlan` was admitted against — the serving twin
    of HLO003.

The engine is built as ``launch.serve`` builds it (seed-0 weights, fp32
compute, a bf16 pool) at the reference's analysis geometry.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .. import configs, tree
from ..engine import serving, steptrace
from ..launch import mesh as mesh_lib, steps
from .findings import Finding, Report, SEVERITY_ERROR

#: the serve matrix: one pure-attention stack (ragged prefill, ring KV)
#: and one state-carrying family (exact-length grouping, ssm state
#: slots) — resnet50 has no decode path and enc-dec is not servable
SERVE_TARGETS = ("qwen2-1.5b", "mamba2-780m")

ANALYSIS_MAX_LEN = 64
ANALYSIS_BUDGET = 1 << 30
ANALYSIS_SLOTS = 8
ANALYSIS_PREFILL = 4

#: SRV002 band: HLO003's order-of-magnitude tripwire with decode-sized
#: slack (the serve model's fixed term is 64 MiB)
SERVE_MEMORY_TOLERANCE = 16.0
SERVE_SLACK_BYTES = 256 << 20


def build_decode(arch: str, *, mesh=None, donate: bool = True,
                 budget_bytes: int = ANALYSIS_BUDGET,
                 max_len: int = ANALYSIS_MAX_LEN,
                 max_slots: Optional[int] = ANALYSIS_SLOTS,
                 prefill_micro: Optional[int] = ANALYSIS_PREFILL,
                 device="cpu") -> Dict[str, Any]:
    """Plan and build one serving engine of ``arch`` (reduced) as the
    serve launcher does, with the pool donated or not. On a ``mesh`` (the
    ``(data, model)`` sizes of a data-parallel serve world) the plan is
    ``plan_serve(mesh=)``'s and the engine one rank's: ``local_slots``
    (the launcher's world path serves each rank's requests with such an
    engine, and no decode step talks to another rank)."""
    cfg = configs.get_reduced(arch)
    if mesh is not None:
        mesh = mesh_lib.make_host_mesh(data=mesh[0], model=mesh[1])
    plan = serving.plan_serve(cfg, budget_bytes=budget_bytes,
                              max_len=max_len, max_slots=max_slots,
                              prefill_micro=prefill_micro, mesh=mesh)
    params = steps.init_params(cfg, seed=0, device=device)
    eng = serving.ServingEngine(params, cfg, plan, donate=donate)
    return dict(cfg=cfg, plan=plan, engine=eng,
                cache_bytes=eng.pool.bytes())


def measure_decode(eng: "serving.ServingEngine") -> steptrace.StepRun:
    """One decode step over the whole pool (the logits and the greedy
    next tokens, all on the device), recorded, with the pool's storages
    before and after it and its peak."""
    dev = eng.device
    before = steptrace.state_storages(eng.pool.cache)
    nbytes = [t.numel() * t.element_size()
              for t in tree.leaves(eng.pool.cache)]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        alive = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    @torch.inference_mode()
    def step():
        return torch.argmax(eng._decode_logits(), -1)

    trace = steptrace.record(step, inputs=(eng.params, eng.pool.cache,
                                           eng._tok, eng._pos), device=dev)
    after = steptrace.state_storages(eng.pool.cache)
    peak, source = ((torch.cuda.max_memory_allocated(dev) - alive
                     + trace.base_live_bytes, "max_memory_allocated") if cuda
                    else (trace.peak_live_bytes, "live tensor bytes"))
    return steptrace.StepRun(trace, before, after, nbytes, int(peak), source)


# ---------------------------------------------------------------------------
# SRV001 — the pool written in place
# ---------------------------------------------------------------------------

def check_decode_aliasing(run: steptrace.StepRun, cache_bytes: int, *,
                          context: str = "") -> List[Finding]:
    """Every pool leaf keeps its storage across the decode step; anything
    less means the step wrote a copy and held two KV generations live."""
    _, kept = run.kept_bytes(min_bytes=1)
    if kept < cache_bytes:
        return [Finding(
            "SRV001", SEVERITY_ERROR,
            f"decode step kept {kept} bytes of the KV pool's {cache_bytes} "
            "in place — the pool is not updated in place (two full KV "
            "copies live per step)", location=context,
            details={"kept_bytes": kept, "cache_bytes": cache_bytes})]
    return []


def check_cache_kept(kept: bool, *, context: str = "") -> List[Finding]:
    """SRV001 over a decode step whose cache is placed on a GSPMD mesh:
    ``kept`` says every block of the rank's cache kept its storage."""
    if kept:
        return []
    return [Finding(
        "SRV001", SEVERITY_ERROR,
        "decode step replaced blocks of the rank's cache — the pool is "
        "not updated in place (two full KV copies live per step)",
        location=context)]


# ---------------------------------------------------------------------------
# SRV002 — decode peak vs serve memory model vs budget
# ---------------------------------------------------------------------------

def check_decode_memory(run, plan: "serving.ServePlan", *,
                        tolerance: float = SERVE_MEMORY_TOLERANCE,
                        slack_bytes: int = SERVE_SLACK_BYTES,
                        context: str = "") -> List[Finding]:
    """The decode peak inside the model band around
    ``plan.modeled_peak_bytes(prefill_micro=0)`` (no prefill in flight in
    a pure decode step) and never over ``plan.budget_bytes``. ``run`` is
    a ``StepRun`` or a peak in bytes."""
    measured = run if isinstance(run, int) else int(run.peak_bytes)
    modeled = plan.modeled_peak_bytes(prefill_micro=0)
    details = {"measured_bytes": measured, "modeled_bytes": modeled,
               "budget_bytes": plan.budget_bytes, "tolerance": tolerance,
               "slack_bytes": slack_bytes, "slots": plan.local_slots}
    out = []
    hi = modeled * tolerance + slack_bytes
    lo = max(0.0, modeled / tolerance - slack_bytes)
    if not (lo <= measured <= hi):
        out.append(Finding(
            "SRV002", SEVERITY_ERROR,
            f"decode peak {measured} bytes vs modeled {modeled} bytes — "
            f"outside {tolerance}x band (allowed [{int(lo)}, {int(hi)}])",
            location=context, details=details))
    if measured > plan.budget_bytes:
        out.append(Finding(
            "SRV002", SEVERITY_ERROR,
            f"decode peak {measured} bytes exceeds the "
            f"{plan.budget_bytes}-byte budget the plan admitted "
            f"{plan.local_slots} slots against", location=context,
            details=details))
    return out


def run_serve_suite(arch: str = "qwen2-1.5b", *, mesh: Any = None,
                    donate: bool = True,
                    budget_bytes: int = ANALYSIS_BUDGET,
                    max_len: int = ANALYSIS_MAX_LEN,
                    tolerance: float = SERVE_MEMORY_TOLERANCE,
                    device="cpu", ranks: int = 2) -> Report:
    """Build one serving engine, run one decode step and check both
    contracts. ``mesh`` as the contract suite's (``suite.resolve_mesh``:
    "single", "host" — ``ranks`` ranks on the data axis — or
    "DATA:MODEL"): the data-parallel serve plan, one rank's engine of
    ``local_slots`` and its decode step (:func:`build_decode`)."""
    from .suite import resolve_mesh
    dims = resolve_mesh(mesh, ranks)
    built = build_decode(arch, mesh=dims, donate=donate,
                         budget_bytes=budget_bytes, max_len=max_len,
                         device=device)
    plan: serving.ServePlan = built["plan"]
    report = Report(context={
        "target": arch, "mode": "serve-decode",
        "mesh": (f"dp={plan.data_parallel}" if plan.data_parallel > 1
                 else "single"),
        "slots": plan.local_slots, "max_len": plan.max_len,
        "donate": donate})
    run = measure_decode(built["engine"])
    ctx = f"{arch}/serve-decode"
    report.extend(check_decode_aliasing(run, built["cache_bytes"],
                                        context=ctx), "SRV001")
    report.extend(check_decode_memory(run, plan, tolerance=tolerance,
                                      context=ctx), "SRV002")
    report.context["peak_bytes"] = run.peak_bytes
    report.context["peak_source"] = run.peak_source
    return report
