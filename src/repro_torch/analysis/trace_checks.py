"""Contract checks over the recorded step trace (rules JX001–JX005) —
the reference's ``analysis/jaxpr_checks.py`` read for an eager step.

They take the :class:`engine.steptrace.StepTrace` of one whole
mini-batch step (``executor.trace_step(...)``): its ATen ops, kernel
calls, collectives, host reads and checkpoint regions. An eager trace
is unrolled, so a collective issued inside the micro-batch loop appears
once per micro-batch and needs no trip count.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import tree
from ..engine import steptrace
from .findings import Finding, Report, SEVERITY_ERROR, SEVERITY_WARNING

#: in-place ops that add into their first operand
ACCUMULATE_OPS = frozenset({"aten.add_.Tensor", "aten.add_.Scalar"})
#: kernel wrappers that accumulate micro-gradients (K1)
ACCUMULATE_KERNELS = frozenset({"grad_accum"})
#: all-reduce payloads at or under this many bytes are scalar or metric
#: traffic, not gradient syncs (as the reference's HLO rules)
SCALAR_ALLREDUCE_BYTES = 64


def _dtype_name(d) -> str:
    return str(d).removeprefix("torch.")


def _param_shape_index(params):
    """(param shapes, plausible flat-bucket sizes, total elements) — what
    a gradient accumulator can look like: a param-shaped leaf (the tree
    executors), or a 1-D dtype bucket or the whole concatenation (the
    flat buffers and ``psum_flat``'s payload)."""
    leaves = [x for x in tree.leaves(params) if isinstance(x, torch.Tensor)]
    shapes = {tuple(x.shape) for x in leaves}
    by_dtype: Dict[str, int] = {}
    for x in leaves:
        by_dtype[str(x.dtype)] = by_dtype.get(str(x.dtype), 0) + x.numel()
    total = sum(x.numel() for x in leaves)
    return shapes, set(by_dtype.values()) | {total}, total


def _looks_like_accumulator(dtype: str, shape, shapes, bucket_sizes) -> bool:
    if not torch.empty((), dtype=getattr(torch, dtype)).is_floating_point():
        return False
    shape = tuple(shape)
    if not shape:
        return False
    if shape in shapes:
        return True
    n = 1
    for d in shape:
        n *= d
    return len(shape) == 1 and n in bucket_sizes


# ---------------------------------------------------------------------------
# JX001 — accumulator dtype
# ---------------------------------------------------------------------------

def accumulator_writes(trace: steptrace.StepTrace, params
                       ) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(dtype, shape, where) of every accumulation in the step: an
    in-place add of the forward or the update (not the backward, not a
    kernel's plain version) into an accumulator-shaped float tensor, and
    every operand K1 accumulates into."""
    shapes, buckets, _ = _param_shape_index(params)
    out = []
    for i, op in enumerate(trace.ops):
        if (op.name in ACCUMULATE_OPS and not op.backward
                and op.kernel is None and op.written):
            k = op.written[0]
            if _looks_like_accumulator(op.dtypes[k], op.shapes[k], shapes,
                                       buckets):
                out.append((op.dtypes[k], op.shapes[k], f"op {i} {op.name}"))
    for i, call in enumerate(trace.kernels):
        if call.name in ACCUMULATE_KERNELS:
            for dt, shape in zip(call.write_dtypes, call.write_shapes):
                out.append((dt, shape, f"kernel call {i} {call.name}"))
    return out


def check_accum_dtype(trace, plan, params) -> List[Finding]:
    """Every add into a micro-gradient accumulator — a plain in-place add
    or a K1 call — runs in ``plan.accum_dtype``."""
    expected = _dtype_name(plan.accum_dtype)
    n_s = int(plan.num_micro_batches)
    writes = accumulator_writes(trace, params)
    findings = [Finding(
        "JX001", SEVERITY_ERROR,
        f"gradient accumulator is {dt}, plan.accum_dtype is {expected} "
        f"(shape {tuple(shape)})", location=where,
        details={"found_dtype": dt, "expected_dtype": expected,
                 "shape": tuple(shape)})
        for dt, shape, where in writes if dt != expected]
    if not writes and n_s > 1:
        findings.append(Finding(
            "JX001", SEVERITY_WARNING,
            f"no gradient accumulation located in the step (N_Smu={n_s})"
            " — dtype contract unverifiable",
            details={"num_micro_batches": n_s}))
    return findings[:8] + ([Finding(
        "JX001", SEVERITY_ERROR,
        f"... and {len(findings) - 8} more accumulations in the wrong "
        "dtype")] if len(findings) > 8 else [])


# ---------------------------------------------------------------------------
# JX002 — remat policy applied
# ---------------------------------------------------------------------------

def remat_census(trace) -> Dict[str, int]:
    regions = trace.remat
    return {"regions": len(regions),
            "selective": sum(r.selective for r in regions),
            "nested": sum(r.depth > 1 for r in regions),
            "max_depth": max((r.depth for r in regions), default=0),
            "recomputed": sum(r.recomputed for r in regions)}


def check_remat_policy(trace, policy: Optional[str]) -> List[Finding]:
    """The planner's remat lattice row is what the step ran
    (``models/remat.py``): ``none`` — no checkpoint region; ``dots`` —
    selective regions (matmuls saved), one level; ``period`` — plain
    regions, one level; ``full`` — plain regions with a nested one per
    block. Every graded policy must also have recomputed in the backward
    (a region whose function never ran again saved nothing)."""
    c = remat_census(trace)
    details = {"policy": policy, **c}
    if policy in (None, "none"):
        if c["regions"]:
            return [Finding(
                "JX002", SEVERITY_ERROR,
                f"plan chose remat_policy='none' but the step ran "
                f"{c['regions']} checkpoint region(s) — paying recompute "
                "the planner did not budget", details=details)]
        return []
    if not c["regions"] or not c["recomputed"]:
        return [Finding(
            "JX002", SEVERITY_ERROR,
            f"plan chose remat_policy={policy!r} but the step "
            + ("ran no checkpoint region" if not c["regions"]
               else "recomputed no checkpoint region in its backward"),
            details=details)]
    want = {"dots": (c["selective"] == c["regions"] and c["max_depth"] == 1),
            "period": (c["selective"] == 0 and c["max_depth"] == 1),
            "full": (c["selective"] == 0 and c["max_depth"] >= 2)}
    if policy in want and not want[policy]:
        return [Finding(
            "JX002", SEVERITY_ERROR,
            f"plan chose remat_policy={policy!r} but the step's checkpoint "
            f"regions are {c['selective']} selective of {c['regions']}, "
            f"nested {c['max_depth']} deep", details=details)]
    return []


# ---------------------------------------------------------------------------
# JX003 — no host reads in the step
# ---------------------------------------------------------------------------

def check_host_reads(trace) -> List[Finding]:
    """No read of a device value by the host inside the step — and on the
    card no synchronizing call at all — unless its line is waived with
    ``# repro: noqa(JX003)`` and a reason."""
    out = []
    for r in list(trace.host_reads) + list(trace.sync_calls):
        if steptrace.waived(r.location, "JX003"):
            continue
        out.append(Finding(
            "JX003", SEVERITY_ERROR,
            f"host read {r.op!r} inside the step (the host waits for the "
            f"device): {r.source}", location=r.location,
            details={"op": r.op}))
    return out



# ---------------------------------------------------------------------------
# JX004 — collective census
# ---------------------------------------------------------------------------

def check_collectives(trace, params, *, n_micro: int,
                      expect: str) -> List[Finding]:
    """Gradient-sync census over the step, from every ``torch.distributed``
    call it made (not the executor's own count).

    ``expect``: ``"none"`` — a single-device step makes no collective;
    ``"deferred"`` — exactly ONE all-reduce whose payload covers the
    gradients (``psum_flat`` packs gradients, loss, metrics and the valid
    count into one buffer, so its payload is at least the total param
    elements) per mini-batch; ``"per-micro"`` — the baseline's >= N_Smu.
    Smaller all-reduces are censused and allowed; any other collective
    in a data-parallel step is a finding."""
    if expect not in ("none", "deferred", "per-micro"):
        raise ValueError(f"bad expect {expect!r}")
    _, _, total = _param_shape_index(params)
    out: List[Finding] = []
    grad_syncs, small, other = [], [], []
    for c in trace.collectives:
        if expect == "none":
            out.append(Finding(
                "JX004", SEVERITY_ERROR,
                f"collective {c.kind!r} ({c.numel} elements) in a "
                "single-device step", location=c.location,
                details={"op": c.op, "numel": c.numel}))
        elif c.kind == "all_reduce" and c.numel >= total:
            grad_syncs.append(c)
        elif c.kind == "all_reduce":
            small.append(c.location)
        else:
            other.append(f"{c.kind} @ {c.location}")
    if expect == "none":
        return out
    details = {"gradient_syncs": [
        {"location": c.location, "payload_elems": c.numel}
        for c in grad_syncs], "effective_count": len(grad_syncs),
        "n_micro": n_micro, "other_all_reduces": small,
        "other_collectives": other}
    if other:
        out.append(Finding(
            "JX004", SEVERITY_ERROR,
            f"{len(other)} collective(s) other than all-reduce in a "
            "data-parallel step", details=details))
    if expect == "deferred" and len(grad_syncs) != 1:
        out.append(Finding(
            "JX004", SEVERITY_ERROR,
            f"deferred-sync step must issue exactly ONE gradient "
            f"all-reduce per mini-batch, found {len(grad_syncs)} "
            f"(N_Smu={n_micro}) — the amortization the sharded engine "
            "promises is broken", details=details))
    elif expect == "per-micro" and len(grad_syncs) < n_micro:
        out.append(Finding(
            "JX004", SEVERITY_ERROR,
            f"per-micro baseline expected >= {n_micro} gradient "
            f"all-reduces per mini-batch, found {len(grad_syncs)}",
            details=details))
    return out


def check_gspmd_collectives(census: Dict[str, Any], mesh,
                            train: bool = True,
                            fsdp: bool = True) -> List[Finding]:
    """JX004 on one rank of a GSPMD mesh, from its census
    (``engine.CollectiveCensus.summary``): every collective runs over the
    mesh's own axes (a group of none of them is a finding), and in a
    ``train`` step with a batch axis above one rank the gradients are
    synchronized over it in the params' placement. With ``fsdp`` they
    are reduce-scattered (a step without a reduce-scatter is a finding);
    without it (params replicated over the batch axes) they are
    all-reduced over a batch axis, and no weight is gathered over one
    (``params_by_kind_and_axis``: a missing all-reduce or a weight's
    all-gather over ``data`` or ``pod`` is a finding)."""
    out: List[Finding] = []
    by = census.get("by_kind_and_axis", {})
    axes = set(mesh) | {"+".join(mesh)}
    stray = {k: ax for k, v in by.items() for ax in v if ax not in axes}
    if stray:
        out.append(Finding(
            "JX004", SEVERITY_ERROR,
            f"collectives over groups outside the mesh's axes {sorted(axes)}"
            f": {stray}", details={"by_kind_and_axis": by}))
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh.get(ax, 1)
    if not train or dp < 2:
        return out

    def over_batch(kind, counts=by):
        return sorted(ax for ax, n in counts.get(kind, {}).items()
                      if n and {"pod", "data"} & set(ax.split("+")))

    if fsdp and not by.get("reduce_scatter"):
        out.append(Finding(
            "JX004", SEVERITY_ERROR,
            f"no reduce-scatter in a GSPMD step over {dp} batch ranks: the "
            "gradients are not FSDP-reduced",
            details={"by_kind_and_axis": by}))
    if not fsdp:
        if not over_batch("all_reduce"):
            out.append(Finding(
                "JX004", SEVERITY_ERROR,
                f"no all-reduce over a batch axis in a GSPMD step over {dp}"
                " batch ranks with the params replicated there: the "
                "gradients are not synchronized",
                details={"by_kind_and_axis": by}))
        params = census.get("params_by_kind_and_axis", {})
        gathered = over_batch("all_gather", params)
        if gathered:
            out.append(Finding(
                "JX004", SEVERITY_ERROR,
                f"weights all-gathered over {gathered} in a GSPMD step "
                "whose params are replicated over the batch axes (no "
                "FSDP): a block is split where none should be",
                details={"params_by_kind_and_axis": params}))
    return out


# ---------------------------------------------------------------------------
# JX005 — pipelined (1F1B) census
# ---------------------------------------------------------------------------

def axis_of(ranks, rank: int, stages: int, world: int) -> str:
    """The mesh axis a group spans for a rank of a ``(data, model)``
    pipeline mesh (stage = rank % stages): the whole world is
    ``data+model``; ranks of one stage the ``data`` axis; else
    ``model``."""
    if len(ranks) >= world:
        return "data+model"
    if all(r % stages == rank % stages for r in ranks):
        return "data"
    return "model"


def pipeline_census(trace, *, rank: int, stages: int, world: int
                    ) -> Dict[str, int]:
    """Point-to-point calls by direction (a send to ``rank + 1`` is a
    forward activation, to ``rank - 1`` a backward cotangent; receives
    alike) and non-scalar all-reduces by axis."""
    out = {"fwd_send": 0, "fwd_recv": 0, "bwd_send": 0, "bwd_recv": 0,
           "data": 0, "model": 0, "data+model": 0, "other": 0}
    for c in trace.collectives:
        if c.kind in ("send", "recv") and c.peer is not None:
            fwd = (c.peer > rank) == (c.kind == "send")
            out[("fwd_" if fwd else "bwd_") + c.kind] += 1
        elif c.kind == "all_reduce":
            if c.nbytes > SCALAR_ALLREDUCE_BYTES:
                out[axis_of(c.ranks, rank, stages, world)] += 1
        else:
            out["other"] += 1
    return out


def check_pipeline_collectives(trace, plan, *, stages: int, rank: int,
                               world: int, leaves_per_transfer: int = 1,
                               expect: str = "deferred",
                               fsdp: bool = False) -> List[Finding]:
    """The 1F1B census of a :class:`engine.PipelinedExecutor` step on one
    rank: its point-to-point calls equal the schedule's closed form
    (``engine.p2p_counts``, each transfer one call per carry leaf); the
    deferred contract makes ONE data-axis gradient all-reduce (none on a
    data axis of one rank) and ONE (data+model) all-reduce; the per-micro
    baseline makes >= N_Smu data-axis all-reduces. FSDP steps replace
    the data-axis all-reduce with reduce-scatters (not censused, as in
    the reference)."""
    if expect not in ("deferred", "per-micro"):
        raise ValueError(f"bad expect {expect!r}")
    from ..engine.pipelined import p2p_counts
    n_micro = int(plan.num_micro_batches)
    dp = world // stages
    want = {k: v * leaves_per_transfer for k, v in
            p2p_counts(stages, n_micro, rank % stages).items()}
    got = pipeline_census(trace, rank=rank, stages=stages, world=world)
    details = {"expected_p2p": want, "census": got, "stages": stages,
               "data_parallel": dp, "n_micro": n_micro, "expect": expect}
    out: List[Finding] = []
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        out.append(Finding(
            "JX005", SEVERITY_ERROR,
            f"point-to-point calls {bad} (found, schedule) differ from the "
            f"1F1B closed form for stages={stages}, N_Smu={n_micro} — the "
            "executor moves activations outside the schedule",
            details=details))
    if fsdp:
        return out
    if expect == "deferred":
        if got["data"] != (1 if dp > 1 else 0):
            out.append(Finding(
                "JX005", SEVERITY_ERROR,
                f"deferred pipelined step must issue exactly "
                f"{1 if dp > 1 else 0} data-axis gradient all-reduce per "
                f"mini-batch (data axis of {dp}), found {got['data']}",
                details=details))
        if got["data+model"] != 1:
            out.append(Finding(
                "JX005", SEVERITY_ERROR,
                f"deferred pipelined step must issue exactly ONE "
                f"(data+model) all-reduce (shared grads, loss, metrics, "
                f"valid count), found {got['data+model']}",
                details=details))
    elif dp > 1 and got["data"] < n_micro:
        out.append(Finding(
            "JX005", SEVERITY_ERROR,
            f"per-micro pipelined baseline expected >= {n_micro} "
            f"data-axis all-reduces, found {got['data']}", details=details))
    return out


# ---------------------------------------------------------------------------
# the bundled trace passes
# ---------------------------------------------------------------------------

def check_pipelined_step(trace, plan, params, *, stages: int, rank: int,
                         world: int, leaves_per_transfer: int = 1,
                         expect_sync: str = "deferred", fsdp: bool = False,
                         policy: Optional[str] = "__from_plan__") -> Report:
    """The trace contracts of one rank's pipelined step: JX001 (over the
    rank's own leaves: its stage's and the shared ones), JX002, JX003 and
    JX005; JX005's schedule census replaces JX004's."""
    if policy == "__from_plan__":
        policy = plan.remat_policy
    rep = Report(context={"layer": "trace", "expect_sync": expect_sync,
                          "policy": policy, "pipelined": True})
    rep.extend(check_accum_dtype(trace, plan, params), "JX001")
    rep.extend(check_remat_policy(trace, policy), "JX002")
    rep.extend(check_host_reads(trace), "JX003")
    rep.extend(check_pipeline_collectives(
        trace, plan, stages=stages, rank=rank, world=world,
        leaves_per_transfer=leaves_per_transfer, expect=expect_sync,
        fsdp=fsdp), "JX005")
    return rep


def check_train_step(trace, plan, params, *, expect_sync: str = "none",
                     policy: Optional[str] = "__from_plan__") -> Report:
    """JX001–JX004 over one recorded train step."""
    if policy == "__from_plan__":
        policy = plan.remat_policy
    rep = Report(context={"layer": "trace", "expect_sync": expect_sync,
                          "policy": policy})
    rep.extend(check_accum_dtype(trace, plan, params), "JX001")
    rep.extend(check_remat_policy(trace, policy), "JX002")
    rep.extend(check_host_reads(trace), "JX003")
    rep.extend(check_collectives(trace, params,
                                 n_micro=int(plan.num_micro_batches),
                                 expect=expect_sync), "JX004")
    return rep
