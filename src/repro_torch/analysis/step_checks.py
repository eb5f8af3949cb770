"""Contract checks over one measured step (rules HLO001–HLO005) — the
reference's ``analysis/hlo_checks.py``, read for an eager step.

The reference inspects the compiled executable: its input/output
aliasing, its memory analysis and its collective schedule. The port's
counterpart is one real step (:func:`engine.steptrace.measure`): the
storages the state lived in before and after it, its peak (the
allocator's on the card, the live tensor bytes on the CPU and in a dry
run) and the
collectives it issued. This module is the one place the census helpers
live: ``launch/dryrun.py`` and the tests read them from here.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import tree
from ..engine import steptrace
from .findings import Finding, SEVERITY_ERROR
from .trace_checks import (SCALAR_ALLREDUCE_BYTES, axis_of,
                           pipeline_census)


def _trace(obj) -> steptrace.StepTrace:
    return obj.trace if isinstance(obj, steptrace.StepRun) else obj


def collective_bytes(obj) -> Dict[str, Dict[str, int]]:
    """Bytes and calls of every collective of a step (a ``StepRun`` or a
    ``StepTrace``), by kind (``all_reduce``, ``all_gather``, ...)."""
    return _trace(obj).collective_census()


def allreduce_count(obj) -> int:
    """All-reduces the step issued."""
    return sum(1 for c in _trace(obj).collectives if c.kind == "all_reduce")


def tree_bytes(t) -> int:
    return sum(x.numel() * x.element_size() for x in tree.leaves(t)
               if isinstance(x, torch.Tensor))


def measured_peak_bytes(run: steptrace.StepRun) -> int:
    """The step's peak: on the card ``max_memory_allocated`` above the
    bytes alive before it, plus its inputs; on the CPU the live tensor
    bytes."""
    return int(run.peak_bytes)


# ---------------------------------------------------------------------------
# HLO001 — in-place update
# ---------------------------------------------------------------------------

def accumulator_storages(trace) -> List[set]:
    """For each K1 call of the step, the storages it accumulated into."""
    return [set(c.write_storages) for c in trace.kernels
            if c.name == "grad_accum" and c.launched
            and None not in c.write_storages]


def check_aliasing(run: steptrace.StepRun, *, in_place: bool = True,
                   n_micro: Optional[int] = None,
                   context: str = "") -> List[Finding]:
    """The zero-copy update: an executor that updates in place
    (``updates_in_place``) must return its params, optimizer state and
    flat buffers in the storages it was given — every leaf of 64 bytes
    or more (a 0-d step counter is made anew); a tree-update executor
    (``in_place=False``) makes new state by design. Given ``n_micro``,
    every executor's K1 calls must add each micro-batch's gradient into
    the storages the first micro-batch's calls wrote."""
    total, kept = run.kept_bytes()
    out = []
    if in_place and kept < total:
        out.append(Finding(
            "HLO001", SEVERITY_ERROR,
            f"the step kept {kept} of {total} state bytes in their "
            "storage — a param/optimizer-state/flat buffer was not "
            "updated in place (two copies of it were live)",
            location=context,
            details={"kept_bytes": kept, "state_bytes": total}))
    accs = accumulator_storages(run.trace)
    if n_micro and accs and len(accs) % n_micro == 0:
        first = set().union(*accs[:len(accs) // n_micro])
        every = set().union(*accs)
        if every != first:
            out.append(Finding(
                "HLO001", SEVERITY_ERROR,
                f"{len(accs)} K1 calls over {n_micro} micro-batches wrote "
                f"{len(every)} accumulator storages, the first "
                f"micro-batch {len(first)} — the accumulator was copied "
                "between micro-batches", location=context,
                details={"k1_calls": len(accs), "storages": len(every),
                         "first_micro_storages": len(first)}))
    return out


# ---------------------------------------------------------------------------
# HLO002 — unexpected all-gathers
# ---------------------------------------------------------------------------

def check_unexpected_ops(obj, *, expect_gather: bool = False,
                         context: str = "") -> List[Finding]:
    """A replicated-state (non-FSDP) step has no business all-gathering:
    params are whole on every rank. (FSDP steps do gather — pass
    ``expect_gather=True``.)"""
    if expect_gather:
        return []
    census = collective_bytes(obj)
    if "all_gather" in census:
        g = census["all_gather"]
        return [Finding(
            "HLO002", SEVERITY_ERROR,
            f"{g['count']} unexpected all-gather(s) ({g['bytes']} bytes) "
            "in a replicated-state step", location=context,
            details={"op": "all_gather", **g})]
    return []


# ---------------------------------------------------------------------------
# HLO003 — memory model cross-check
# ---------------------------------------------------------------------------

def check_memory_model(run, modeled_bytes: Optional[int], *,
                       tolerance: float = 16.0,
                       slack_bytes: int = 1 << 30,
                       context: str = "") -> List[Finding]:
    """Tripwire for an order-of-magnitude break between the analytic
    ``core/memory_model`` estimate and the step's peak: they must agree
    within ``tolerance``× (plus ``slack_bytes`` of headroom for tiny
    configs). ``run`` is a ``StepRun`` or a peak in bytes."""
    if modeled_bytes is None:
        return []
    measured = (run if isinstance(run, int) else measured_peak_bytes(run))
    hi = modeled_bytes * tolerance + slack_bytes
    lo = max(0.0, modeled_bytes / tolerance - slack_bytes)
    if not (lo <= measured <= hi):
        return [Finding(
            "HLO003", SEVERITY_ERROR,
            f"step peak {measured} bytes vs modeled {modeled_bytes} "
            f"bytes — outside {tolerance}x tolerance "
            f"(allowed [{int(lo)}, {int(hi)}])",
            location=context,
            details={"measured_bytes": measured,
                     "modeled_bytes": modeled_bytes,
                     "tolerance": tolerance, "slack_bytes": slack_bytes})]
    return []


# ---------------------------------------------------------------------------
# HLO004 — the step's gradient-sync schedule
# ---------------------------------------------------------------------------

def check_gradient_sync(obj, *, expect: str, n_micro: int,
                        context: str = "") -> List[Finding]:
    """One all-reduce per mini-batch for a deferred-sync step, >= N_Smu
    for the per-micro baseline, none without a mesh — counted over every
    all-reduce the step issued, whatever its payload."""
    if expect not in ("none", "deferred", "per-micro"):
        raise ValueError(f"bad expect {expect!r}")
    count = allreduce_count(obj)
    details = {"all_reduce_count": count, "n_micro": n_micro,
               "expect": expect}
    if expect == "none" and count != 0:
        return [Finding("HLO004", SEVERITY_ERROR,
                        f"{count} all-reduce(s) in a mesh-free step",
                        location=context, details=details)]
    if expect == "deferred" and count != 1:
        return [Finding(
            "HLO004", SEVERITY_ERROR,
            f"deferred-sync step issued {count} all-reduces, contract is "
            "exactly 1 per mini-batch", location=context, details=details)]
    if expect == "per-micro" and count < n_micro:
        return [Finding(
            "HLO004", SEVERITY_ERROR,
            f"per-micro baseline issued {count} all-reduces, expected >= "
            f"{n_micro}", location=context, details=details)]
    return []


# ---------------------------------------------------------------------------
# HLO005 — the pipelined step's schedule
# ---------------------------------------------------------------------------

def check_pipeline_step(obj, *, expect: str, n_micro: int, stages: int,
                        rank: int, world: int, max_p2p: int,
                        context: str = "") -> List[Finding]:
    """The measured pipelined step: its non-scalar all-reduces are the
    data-axis one (when the data axis has more than one rank) and the
    (data+model) one when deferred, >= N_Smu when per-micro; scalar ones
    are metric traffic. Its point-to-point calls are at least one and at
    most the schedule's census ``max_p2p``."""
    if expect not in ("deferred", "per-micro"):
        raise ValueError(f"bad expect {expect!r}")
    trace = _trace(obj)
    big = [c for c in trace.collectives if c.kind == "all_reduce"
           and c.nbytes > SCALAR_ALLREDUCE_BYTES]
    census = pipeline_census(trace, rank=rank, stages=stages, world=world)
    p2p = sum(census[k] for k in ("fwd_send", "fwd_recv", "bwd_send",
                                  "bwd_recv"))
    dp = world // stages
    want = 2 if dp > 1 else 1
    details = {"nonscalar_allreduces": len(big),
               "by_axis": [axis_of(c.ranks, rank, stages, world)
                           for c in big],
               "p2p": p2p, "max_p2p": max_p2p, "n_micro": n_micro,
               "expect": expect}
    out: List[Finding] = []
    if expect == "deferred" and len(big) != want:
        out.append(Finding(
            "HLO005", SEVERITY_ERROR,
            f"deferred pipelined step issued {len(big)} non-scalar "
            f"all-reduce(s), contract is exactly {want} (the data-axis "
            "one on a data axis of more than one rank, and the "
            "(data+model) one)", location=context, details=details))
    if expect == "per-micro" and len(big) < n_micro:
        out.append(Finding(
            "HLO005", SEVERITY_ERROR,
            f"per-micro pipelined baseline issued {len(big)} non-scalar "
            f"all-reduce(s), expected >= {n_micro}", location=context,
            details=details))
    if not (1 <= p2p <= max_p2p):
        out.append(Finding(
            "HLO005", SEVERITY_ERROR,
            f"{p2p} point-to-point call(s) in the pipelined step, "
            f"expected between 1 and the schedule's census {max_p2p}",
            location=context, details=details))
    return out

