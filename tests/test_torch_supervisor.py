"""The port's fault-tolerant Supervisor against the JAX package's:
``tests/test_supervisor.py`` case by case on the tiny tanh MLP, each run
in both packages under the same fault plan, with the same numpy inputs
and parameters.

Every case holds the port's run to the reference's: the same fault
records ``(kind, step, action, steps_lost)``, the same faults fired, the
same final plan, the supervised losses and the final params and momentum
within ``DTYPE_ATOL`` (fp32 2e-6) and the same step counter. Within the
port the reference's own assertions hold as they are (bit for bit where
the reference asks for it). The degradation ladder gives the same
``(plan, action)`` sequence in both packages, data-parallel divisibility
included, and the give-ups the same exit codes (40–44) class by class.

The reference's three ``@pytest.mark.mesh`` cases run the port in a gloo
world of 2 CPU ranks (``repro_torch.launch.world.LocalWorld``, the
ranks' side in ``tests/torch_mesh_cases.py``), each rank supervising an
``engine.ShardedExecutor``, against the reference on ``host_mesh(2)``;
the ranks agree bit for bit. Not here: the reference's supervisor-free
checkpoint and fault cases, which ``tests/test_torch_pipeline.py`` ports.
Beyond the reference: what eager PyTorch needs of an OOM recovery (the
failed runtime freed, the prefetch worker stopped, the anchor a host
copy, a restore into ``flat``'s layout) and which out-of-memory errors
count as recoverable.
"""
import dataclasses
import gc
import json
import threading
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_supervisor as jsup  # noqa: E402
import torch_mesh_cases as mesh_cases  # noqa: E402
from conftest import (DTYPE_ATOL, GOLDEN_LOSSES, ToyDataset,  # noqa: E402
                      host_mesh)
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.engine import faults as jfaults  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.engine import faults  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402
from test_torch_streaming import t_loss_fn  # noqa: E402

ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
EXECUTOR_GRID = sorted(engine.EXECUTORS)
MINI, STEPS = jsup.MINI, jsup.STEPS
PLAN_FIELDS = ("mini_batch_size", "micro_batch_size", "num_micro_batches",
               "pad", "normalization", "remat_policy", "data_parallel",
               "local_micro", "auto_micro", "calibrated")


def make_plan(**kw):
    base = dict(micro_batch_size=4, normalization="exact")
    base.update(kw)
    return engine.plan_mbs(MINI, device="cpu", **base)


def _opt():
    return optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)


def fresh_state():
    params = weights.from_reference(
        jax.tree.map(np.asarray, jsup.tiny_params()), "cpu")
    return params, _opt().init(params)


def make_build(executor: str, *, guard: bool = True, pipeline_kw=None,
               prefetch: int = 0):
    """The launcher-shaped rebuild factory over the tiny model:
    ``plan -> (executor, step_fn, pipeline)``."""
    ds = ToyDataset()

    def build(plan):
        ex = engine.get_executor(executor)(t_loss_fn, _opt(), plan,
                                           guard=guard)
        return ex, ex.step_split, engine.Pipeline(
            ds, plan, prefetch=prefetch, device="cpu", **(pipeline_kw or {}))

    return build


def run_supervised(build, specs=(), *, plan=None, sup_kw=None, steps=STEPS,
                   **ctor):
    plan = plan or make_plan()
    sup = engine.Supervisor(build, plan,
                            config=engine.SupervisorConfig(**(sup_kw or {})),
                            log_fn=None, **ctor)
    params, opt_state = fresh_state()
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        params, opt_state, last = sup.fit(params, opt_state, steps)
    return sup, fp, params, opt_state, last


def run_unsupervised(build, plan, steps=STEPS):
    _, step_fn, pipeline = build(plan)
    return engine.Trainer(step_fn, pipeline, log_fn=None).fit(
        *fresh_state(), steps)


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close(got, want, what=""):
    lg, lw = tree.leaves(got), jax.tree.leaves(want)
    assert len(lg) == len(lw), what
    for g, w in zip(lg, lw):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=ATOL, rtol=0, err_msg=what)


def _records(sup):
    return [(r.kind, r.step, r.action, r.steps_lost) for r in sup.records]


def _plan_fields(plan):
    return {f: getattr(plan, f) for f in PLAN_FIELDS}


def assert_same_run(port, ref, what=""):
    """A port run ``(sup, fp, params, opt_state, last)`` against the
    reference's under the same fault plan."""
    sup, fp, p, s, _ = port
    jsup_, jfp, jp, js, _ = ref
    assert _records(sup) == _records(jsup_), what
    assert fp.fired == jfp.fired, what
    assert sup.restarts == jsup_.restarts, what
    assert _plan_fields(sup.plan) == _plan_fields(jsup_.plan), what
    assert sorted(sup.history) == sorted(jsup_.history), what
    np.testing.assert_allclose(
        [sup.history[k] for k in sorted(sup.history)],
        [jsup_.history[k] for k in sorted(jsup_.history)],
        atol=ATOL, rtol=0, err_msg=what)
    _close((p, s["mom"]), (jp, js["mom"]), what)
    assert int(s["step"]) == int(js["step"]), what


def ref_run(executor, jspecs=(), *, guard=True, plan_kw=None, **kw):
    plan = jsup.make_plan(**(plan_kw or {}))
    return jsup.run_supervised(jsup.make_build(executor, guard=guard),
                               jspecs, plan=plan, **kw)


# ---------------------------------------------------------------------------
# negative control: supervision is invisible when nothing goes wrong
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_negative_control_bitwise(executor):
    build = make_build(executor, guard=False)
    port = run_supervised(build)
    sup, fp, p_sup, s_sup, _ = port
    p_ref, s_ref, _ = run_unsupervised(build, make_plan())
    assert fp.fired == []
    assert sup.restarts == 0 and sup.records == []
    assert _equal((p_sup, s_sup), (p_ref, s_ref))
    assert_same_run(port, ref_run(executor, guard=False), executor)


def test_supervised_golden_trajectory():
    sup, _, _, _, _ = run_supervised(make_build("compiled"))
    np.testing.assert_allclose(
        [sup.history[i] for i in range(STEPS)], GOLDEN_LOSSES, atol=2e-6)


# ---------------------------------------------------------------------------
# OOM: degrade + re-plan + resume == uninterrupted run at the degraded plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_oom_recovery_matches_degraded_golden(executor):
    plan = make_plan(remat_policy="full")
    build = make_build(executor)
    port = run_supervised(build, [faults.oom_at(2)], plan=plan)
    sup, fp, p_got, s_got, _ = port
    assert fp.fired_kinds() == ["oom"]
    assert sup.restarts == 1
    assert sup.plan.micro_batch_size == 2
    [rec] = [r for r in sup.records if r.kind == "oom"]
    assert rec.action == "halve micro 4->2"
    assert rec.detail.startswith("OutOfMemoryError: RESOURCE_EXHAUSTED")
    degraded, _ = engine.degrade_plan(plan)
    p_ref, s_ref, _ = run_unsupervised(build, degraded)
    for a, b in zip(tree.leaves((p_got, s_got)), tree.leaves((p_ref, s_ref))):
        assert float((a.float() - b.float()).abs().max()) <= ATOL
    assert_same_run(port, ref_run(executor, [jfaults.oom_at(2)],
                                  plan_kw={"remat_policy": "full"}),
                    executor)


def test_oom_remat_escalation_first():
    plan = make_plan()
    port = run_supervised(make_build("compiled"), [faults.oom_at(2)],
                          plan=plan)
    sup, _, p_got, _, _ = port
    [rec] = sup.records
    assert rec.kind == "oom" and "remat" in rec.action
    assert sup.plan.micro_batch_size == plan.micro_batch_size
    assert sup.plan.remat_policy != plan.remat_policy
    degraded, _ = engine.degrade_plan(plan)
    p_ref, _, _ = run_unsupervised(make_build("compiled"), degraded)
    assert _equal(p_got, p_ref)
    assert_same_run(port, ref_run("compiled", [jfaults.oom_at(2)]))


@pytest.mark.parametrize("case", ["restart_budget", "plan_exhausted"])
def test_oom_restart_budget_and_plan_exhaustion(case):
    if case == "restart_budget":
        kw = dict(plan_kw={"remat_policy": "full"},
                  sup_kw={"max_restarts": 1})
        err, jerr = engine.RestartBudgetExceeded, jengine.RestartBudgetExceeded
    else:  # micro=1 at remat=full: nothing left on the ladder
        kw = dict(plan_kw={"micro_batch_size": 1, "remat_policy": "full"},
                  sup_kw={"max_restarts": 99})
        err, jerr = engine.PlanExhausted, jengine.PlanExhausted
    with pytest.raises(err) as got:
        run_supervised(make_build("compiled"), [faults.oom_at(0, times=99)],
                       plan=make_plan(**kw["plan_kw"]), sup_kw=kw["sup_kw"])
    with pytest.raises(jerr) as want:
        ref_run("compiled", [jfaults.oom_at(0, times=99)], **kw)
    assert got.value.exit_code == want.value.exit_code


# ---------------------------------------------------------------------------
# non-finite gradients: guard + retry/skip + circuit breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_nan_retry_recovers_clean_trajectory(executor):
    build = make_build(executor)
    port = run_supervised(build, [faults.nan_at(1)])
    sup, fp, p_got, s_got, _ = port
    assert fp.fired_kinds() == ["nan"]
    [rec] = sup.records
    assert rec.kind == "nonfinite" and rec.action.startswith("retried ok")
    p_ref, s_ref, _ = run_unsupervised(build, make_plan())
    assert _equal((p_got, s_got), (p_ref, s_ref)), \
        f"{executor}: clean re-draw retry must be invisible"
    assert_same_run(port, ref_run(executor, [jfaults.nan_at(1)]), executor)


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_nan_skip_leaves_state_untouched(executor):
    build = make_build(executor)
    port = run_supervised(build, [faults.nan_at(1)],
                          sup_kw={"nan_retries": 0})
    sup, _, p_got, s_got, _ = port
    [rec] = sup.records
    assert rec.action == "skipped" and rec.steps_lost == 1
    # the same stream with step 1's update elided entirely
    ds, plan = ToyDataset(), make_plan()
    ex, step_fn, _ = build(plan)
    p_ref, s_ref = fresh_state()
    for i in (0, 2, 3, 4):
        batch = plan.device_split(ds.batch(MINI, i), "cpu")
        p_ref, s_ref, _ = step_fn(p_ref, s_ref, batch)
    assert _equal((p_got, s_got), (p_ref, s_ref)), \
        f"{executor}: skipped step must leave state bitwise untouched"
    assert int(s_got["step"]) == 4
    assert_same_run(port, ref_run(executor, [jfaults.nan_at(1)],
                                  sup_kw={"nan_retries": 0}), executor)


@pytest.mark.parametrize("case", ["circuit_breaker", "halt"])
def test_nan_give_ups(case):
    """The reference's ``test_nan_circuit_breaker`` and
    ``test_on_nan_halt``, in both packages."""
    if case == "circuit_breaker":
        specs = [faults.nan_at(None, times=99)]
        jspecs = [jfaults.nan_at(None, times=99)]
        sup_kw = {"nan_retries": 0, "max_consecutive_nan": 2}
        err, jerr = engine.NaNCircuitBreaker, jengine.NaNCircuitBreaker
    else:
        specs, jspecs = [faults.nan_at(1)], [jfaults.nan_at(1)]
        sup_kw = {"on_nan": "halt"}
        err, jerr = engine.NaNHalt, jengine.NaNHalt
    with pytest.raises(err):
        run_supervised(make_build("compiled"), specs, sup_kw=sup_kw)
    with pytest.raises(jerr):
        ref_run("compiled", jspecs, sup_kw=sup_kw)


def test_exit_code_contract():
    names = ("SupervisorError", "RestartBudgetExceeded", "PlanExhausted",
             "NaNCircuitBreaker", "NaNHalt")
    assert [getattr(engine, n).exit_code for n in names] == \
        [getattr(jengine, n).exit_code for n in names] == [40, 41, 42, 43, 44]
    for n in names[1:]:
        assert issubclass(getattr(engine, n), engine.SupervisorError)


# ---------------------------------------------------------------------------
# transient stream failures and checkpoint I/O
# ---------------------------------------------------------------------------

def test_stream_restart_resumes_midstream():
    build = make_build("compiled", pipeline_kw={"retries": 0})
    port = run_supervised(build, [faults.worker_at(2, times=2)])
    sup, fp, p_got, _, _ = port
    assert fp.fired_kinds() == ["worker", "worker"]
    assert [r.action for r in sup.records] == ["stream restart"] * 2
    p_ref, _, _ = run_unsupervised(build, make_plan())
    assert _equal(p_got, p_ref)
    ref = jsup.run_supervised(
        jsup.make_build("compiled", pipeline_kw={"retries": 0}),
        [jfaults.worker_at(2, times=2)])
    assert_same_run(port, ref)


def test_stream_restart_budget_exhausts():
    build = make_build("compiled", pipeline_kw={"retries": 0})
    with pytest.raises(faults.TransientWorkerError):
        run_supervised(build, [faults.worker_at(2, times=99)],
                       sup_kw={"stream_retries": 2})


def test_ckpt_io_fault_retried_then_skipped(tmp_path):
    build = make_build("compiled")
    d = str(tmp_path / "ckpt")
    port = run_supervised(build, [faults.ckpt_io_at(2)], ckpt_dir=d,
                          ckpt_every=2)
    assert [r.action for r in port[0].records] == ["ckpt-io retry 1"]
    assert ckpt_lib.committed_steps(d) == [2, 4, STEPS]
    ref = jsup.run_supervised(jsup.make_build("compiled"),
                              [jfaults.ckpt_io_at(2)],
                              ckpt_dir=str(tmp_path / "jckpt"), ckpt_every=2)
    assert_same_run(port, ref)

    d2 = str(tmp_path / "ckpt2")
    with pytest.warns(UserWarning, match="checkpoint at step 2 failed"):
        run_supervised(build, [faults.ckpt_io_at(2, times=99)], ckpt_dir=d2,
                       ckpt_every=2, sup_kw={"io_retries": 1})
    assert ckpt_lib.committed_steps(d2) == [4, STEPS]


def test_oom_resumes_from_a_committed_checkpoint(tmp_path):
    """With checkpoints at every step the OOM loses no completed step: the
    restore takes the newest committed checkpoint (as new as the anchor)
    and places it for the rebuilt executor, ``flat``'s buffers."""
    build = make_build("flat")
    plan = make_plan(remat_policy="full")
    port = run_supervised(build, [faults.oom_at(2)], plan=plan,
                          ckpt_dir=str(tmp_path / "c"), ckpt_every=1)
    assert _records(port[0]) == [("oom", 2, "halve micro 4->2", 0)]
    ref = jsup.run_supervised(jsup.make_build("flat"), [jfaults.oom_at(2)],
                              plan=jsup.make_plan(remat_policy="full"),
                              ckpt_dir=str(tmp_path / "j"), ckpt_every=1)
    assert_same_run(port, ref)
    spec = engine.FlatSpec.for_tree(port[2])
    assert spec.buffers_of(port[2]) is not None  # trained as flat views


# ---------------------------------------------------------------------------
# calibrated re-plan: the OOM feeds the tuning cache as a negative bound
# ---------------------------------------------------------------------------

def _calibrated_setup(tmp_path):
    cfg = configs.get_reduced("qwen2-1.5b")
    seq = 32
    cache_path = str(tmp_path / "tuning.json")
    est = memory_model.estimate(cfg, seq, remat_policy="full")
    budget = est.total(4)
    plan = engine.plan_mbs(16, model_cfg=cfg, seq_len=seq,
                           budget_bytes=budget, remat_policy="full",
                           calibrate="auto", tuning_cache=cache_path,
                           device="cpu")
    ctx = dict(model_cfg=cfg, seq_len=seq, budget_bytes=budget,
               executor="compiled", tuning_cache=cache_path, device="cpu")
    return plan, ctx, make_build("compiled"), cache_path


def _ref_calibrated(tmp_path, specs):
    plan, ctx, build, cache_path = jsup._calibrated_setup(tmp_path / "ref")
    assert jmemory_model.estimate(ctx["model_cfg"], ctx["seq_len"],
                                  remat_policy="full").total(4) \
        == ctx["budget_bytes"]
    sup = jengine.Supervisor(build, plan, log_fn=None, plan_ctx=ctx)
    with jfaults.inject(jfaults.FaultPlan(*specs(plan))) as fp:
        p, s, last = sup.fit(*jsup.fresh_state(), 4)
    return (sup, fp, p, s, last), cache_path


def _cache_memory(path):
    with open(path) as f:
        return json.load(f)["memory"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_calibrated_oom_exactly_one_replan_strictly_smaller(tmp_path,
                                                            corrupt):
    """The reference's ``test_calibrated_oom_exactly_one_replan_strictly_
    smaller`` and, with ``corrupt``, ``test_corrupt_cache_never_sinks_
    recovery``: the same single re-plan in both packages, and the same
    negative bound written into each cache file."""
    (tmp_path / "ref").mkdir()
    plan, ctx, build, cache_path = _calibrated_setup(tmp_path)
    assert plan.micro_batch_size >= 2
    sup = engine.Supervisor(build, plan, log_fn=None, plan_ctx=ctx)
    specs = [faults.oom_at(1, times=99, min_micro=plan.micro_batch_size)]
    if corrupt:
        specs.append(faults.corrupt_cache())
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        p, s, last = sup.fit(*fresh_state(), 4)
    assert sup.restarts == 1, "must re-plan EXACTLY once"
    assert ("corrupt_cache" in fp.fired_kinds()) == corrupt
    assert fp.fired_kinds().count("oom") == 1
    assert sup.plan.micro_batch_size < plan.micro_batch_size
    [rec] = [r for r in sup.records if r.kind == "oom"]
    assert "replan" in rec.action or "halve" in rec.action

    def jspecs(jplan):
        out = [jfaults.oom_at(1, times=99, min_micro=jplan.micro_batch_size)]
        return out + ([jfaults.corrupt_cache()] if corrupt else [])

    ref, jcache = _ref_calibrated(tmp_path, jspecs)
    assert_same_run((sup, fp, p, s, last), ref)
    assert _cache_memory(cache_path) == _cache_memory(jcache)


def test_corrupt_cache_file_degrades_to_analytic(tmp_path):
    """``TuningCache`` and ``record_oom_bound`` under the reference's
    garbage: both packages read no correction (analytic admission) and
    record the same bound, never raising."""
    from repro.engine import autotune as jautotune
    from repro_torch.engine import autotune
    cfg, jcfg = configs.get_reduced("qwen2-1.5b"), \
        jconfigs.get_reduced("qwen2-1.5b")
    out = {}
    for name, mod, c in (("port", autotune, cfg), ("ref", jautotune, jcfg)):
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            f.write('{"version": "garbage", "memory": [corrupt')
        key = mod.memory_key(c, 32, "full", None, "sgd", "compiled", "cpu")
        assert mod.TuningCache(path).memory_correction(key) is None
        est = (memory_model if name == "port" else jmemory_model).estimate(
            c, 32, remat_policy="full")
        kw = {"device": "cpu"} if name == "port" else {}
        bound = mod.record_oom_bound(c, 32, 3, est.total(4),
                                     remat_policy="full",
                                     cache=mod.TuningCache(path), **kw)
        out[name] = (bound, _cache_memory(path))
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the degradation ladder itself
# ---------------------------------------------------------------------------

def _ladder(mod, plan, ctx=None):
    seen = []
    while True:
        try:
            plan, action = mod.degrade_plan(plan, ctx)
        except mod.PlanExhausted:
            return seen
        seen.append((_plan_fields(plan), action))


@pytest.mark.parametrize("start", ["none", "period"])
def test_degradation_ladder_is_deterministic(start):
    seen = _ladder(engine, make_plan(remat_policy=start))
    assert seen == _ladder(jengine, jsup.make_plan(remat_policy=start))
    if start == "none":
        assert [a for _, a in seen] == [
            "remat none->dots", "remat dots->period", "remat period->full",
            "halve micro 4->2", "halve micro 2->1"]


def test_degradation_with_a_plan_context_matches_reference(tmp_path):
    """The launcher's context: remat rungs through ``plan_mbs``, then the
    calibrated re-plan (a bound recorded first) or halving — the same
    plans and actions in both packages over the whole ladder."""
    seq, mini = 32, 16
    cfg, jcfg = configs.get_reduced("qwen2-1.5b"), \
        jconfigs.get_reduced("qwen2-1.5b")
    budget = memory_model.estimate(cfg, seq, remat_policy="none").total(8)
    ctx = dict(model_cfg=cfg, seq_len=seq, budget_bytes=budget,
               device="cpu", tuning_cache=str(tmp_path / "t.json"))
    jctx = dict(model_cfg=jcfg, seq_len=seq, budget_bytes=budget,
                tuning_cache=str(tmp_path / "j.json"))
    plan = engine.plan_mbs(mini, model_cfg=cfg, seq_len=seq,
                           budget_bytes=budget, remat_policy="none",
                           device="cpu")
    jplan = jengine.plan_mbs(mini, model_cfg=jcfg, seq_len=seq,
                             budget_bytes=budget, remat_policy="none")
    assert _plan_fields(plan) == _plan_fields(jplan)
    assert _ladder(engine, plan, ctx) == _ladder(jengine, jplan, jctx)
    assert len(_ladder(engine, plan, ctx)) >= 4


def test_degradation_respects_data_parallel_divisibility():
    """The reference's case on a data-parallel mesh of 2: the halving
    keeps the micro-batch a multiple of 2 and stops at the data extent,
    plan for plan as the reference's does."""
    plan = make_plan(remat_policy="full", mesh={"data": 2, "model": 1})
    jplan = jsup.make_plan(remat_policy="full", mesh=host_mesh(2))
    assert _plan_fields(plan) == _plan_fields(jplan)
    degraded, action = engine.degrade_plan(plan)
    jdegraded, jaction = jengine.degrade_plan(jplan)
    assert (_plan_fields(degraded), action) == (_plan_fields(jdegraded),
                                                jaction)
    assert degraded.micro_batch_size == 2 and degraded.local_micro == 1
    with pytest.raises(engine.PlanExhausted) as got:
        engine.degrade_plan(degraded)
    with pytest.raises(jengine.PlanExhausted) as want:
        jengine.degrade_plan(jdegraded)
    assert str(got.value) == str(want.value)


def test_degradation_on_a_mesh_with_a_plan_context_matches_reference(
        tmp_path):
    """The launcher's context on a data-parallel mesh of 4: every rung
    re-plans through ``plan_mbs(mesh=...)`` (per-device budget, replicated
    params, divisible micro sizes), the same plans and actions over the
    whole ladder in both packages."""
    seq, mini = 32, 32
    cfg, jcfg = configs.get_reduced("qwen2-1.5b"), \
        jconfigs.get_reduced("qwen2-1.5b")
    tm, jm = {"data": 4, "model": 1}, host_mesh(4)
    budget = memory_model.estimate(cfg, seq, remat_policy="none").total(4)
    mm_kw = {"fsdp_params": False}
    ctx = dict(model_cfg=cfg, seq_len=seq, budget_bytes=budget, mesh=tm,
               device="cpu", tuning_cache=str(tmp_path / "t.json"),
               mm_kw=mm_kw)
    jctx = dict(model_cfg=jcfg, seq_len=seq, budget_bytes=budget, mesh=jm,
                tuning_cache=str(tmp_path / "j.json"), mm_kw=mm_kw)
    plan = engine.plan_mbs(mini, model_cfg=cfg, seq_len=seq,
                           budget_bytes=budget, remat_policy="none",
                           mesh=tm, fsdp_params=False, device="cpu")
    jplan = jengine.plan_mbs(mini, model_cfg=jcfg, seq_len=seq,
                             budget_bytes=budget, remat_policy="none",
                             mesh=jm, fsdp_params=False)
    assert _plan_fields(plan) == _plan_fields(jplan)
    assert plan.data_parallel == 4
    seen = _ladder(engine, plan, ctx)
    assert seen == _ladder(jengine, jplan, jctx)
    assert all(p["micro_batch_size"] % 4 == 0 for p, _ in seen)


# ---------------------------------------------------------------------------
# the supervisor over a data-parallel mesh (the reference's three
# ``@pytest.mark.mesh`` cases): a gloo world of 2 CPU ranks, each running
# its own supervisor over a ShardedExecutor, against the reference on
# host_mesh(2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with LocalWorld(2, store_dir=str(tmp_path_factory.mktemp("world")),
                    timeout_s=120) as w:
        yield w


def _mesh_plans(**kw):
    plan = make_plan(mesh={"data": 2, "model": 1}, **kw)
    jplan = jsup.make_plan(mesh=host_mesh(2), **kw)
    assert _plan_fields(plan) == _plan_fields(jplan)
    return plan, jplan


def _ref_mesh_run(jplan, jspecs=(), guard=True):
    build = jsup.make_build("compiled", guard=guard, mesh=host_mesh(2))
    return jsup.run_supervised(build, jspecs, plan=jplan)


def _tiny_np():
    return jax.tree.map(np.asarray, jsup.tiny_params())


def _port_mesh_run(world, plan, specs=(), guard=True):
    """Both ranks' supervised runs, which must agree bit for bit."""
    runs = world.run(mesh_cases.supervised, plan, list(specs), guard,
                     _tiny_np(), STEPS)
    for r in runs[1:]:
        assert r["records"] == runs[0]["records"]
        for a, b in zip(jax.tree.leaves((r["params"], r["opt_state"])),
                        jax.tree.leaves((runs[0]["params"],
                                         runs[0]["opt_state"]))):
            assert np.array_equal(a, b)
    return runs[0]


def _assert_same_as_reference(run, ref, what):
    jsup_, jfp, jp, js, _ = ref
    assert run["records"] == _records(jsup_), what
    assert run["fired"] == jfp.fired, what
    assert run["plan"] == _plan_fields(jsup_.plan), what
    np.testing.assert_allclose(
        [run["history"][k] for k in sorted(run["history"])],
        [jsup_.history[k] for k in sorted(jsup_.history)],
        atol=ATOL, rtol=0, err_msg=what)
    _close_np(run["params"], jp, what)
    _close_np(run["opt_state"]["mom"], js["mom"], what)
    assert int(run["opt_state"]["step"]) == int(js["step"]), what


def _close_np(got, want, what):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=ATOL,
                                   rtol=0, err_msg=what)


def test_sharded_negative_control_bitwise(world2):
    plan, jplan = _mesh_plans()
    run = _port_mesh_run(world2, plan, guard=False)
    ref_p, ref_s = world2.run(mesh_cases.unsupervised, plan, False,
                              _tiny_np(), STEPS)[0]
    assert run["fired"] == [] and run["records"] == []
    for a, b in zip(jax.tree.leaves((run["params"], run["opt_state"])),
                    jax.tree.leaves((ref_p, ref_s))):
        assert np.array_equal(a, b)
    _assert_same_as_reference(run, _ref_mesh_run(jplan, guard=False),
                              "negative control")


def test_sharded_oom_recovery_matches_degraded_golden(world2):
    plan, jplan = _mesh_plans(remat_policy="full")
    run = _port_mesh_run(world2, plan, [faults.oom_at(2)])
    assert [k for k, *_ in run["fired"]] == ["oom"]
    assert run["plan"]["micro_batch_size"] == 2
    assert run["plan"]["local_micro"] == 1
    degraded, _ = engine.degrade_plan(plan)
    ref_p, ref_s = world2.run(mesh_cases.unsupervised, degraded, True,
                              _tiny_np(), STEPS)[0]
    _close_np(run["params"], ref_p, "sharded params after OOM")
    _close_np(run["opt_state"]["mom"], ref_s["mom"], "sharded momentum")
    _assert_same_as_reference(
        run, _ref_mesh_run(jplan, [jfaults.oom_at(2)]), "OOM")


def test_sharded_nan_retry_recovers_clean_trajectory(world2):
    plan, jplan = _mesh_plans()
    run = _port_mesh_run(world2, plan, [faults.nan_at(1)])
    [rec] = run["records"]
    assert rec[0] == "nonfinite" and rec[2].startswith("retried ok")
    ref_p, _ = world2.run(mesh_cases.unsupervised, plan, True, _tiny_np(),
                          STEPS)[0]
    for a, b in zip(jax.tree.leaves(run["params"]), jax.tree.leaves(ref_p)):
        assert np.array_equal(a, b)
    _assert_same_as_reference(
        run, _ref_mesh_run(jplan, [jfaults.nan_at(1)]), "NaN retry")


# ---------------------------------------------------------------------------
# what an eager recovery must free, and what it may recover from
# ---------------------------------------------------------------------------

def test_oom_recovery_frees_the_failed_runtime():
    """After a recovery the failed executor, its pipeline and the batch
    stream's producer thread are gone, and the anchor is a host copy that
    shares no storage with the state it was taken from."""
    built = []
    inner = make_build("streaming", prefetch=2)

    def build(plan):
        ex, step_fn, pipe = inner(plan)
        built.append((weakref.ref(ex), weakref.ref(pipe)))
        return ex, step_fn, pipe

    sup = engine.Supervisor(build, make_plan(remat_policy="full"),
                            log_fn=None)
    params, opt_state = fresh_state()
    ptrs = {t.untyped_storage().data_ptr()
            for t in tree.leaves((params, opt_state))}
    with faults.inject(faults.FaultPlan(faults.oom_at(2))):
        sup.fit(params, opt_state, STEPS)
    del params, opt_state
    gc.collect()
    assert len(built) == 2 and sup.restarts == 1
    assert built[0][0]() is None and built[0][1]() is None
    for t in threading.enumerate():
        if t.name == "repro-torch-prefetch":
            t.join(timeout=10)  # the last stream's worker is returning
            assert not t.is_alive()
    anchor = sup._snapshot
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for t in tree.leaves(anchor[:2])}
    assert [a["step"] for a in sup.anchor_log] == [0, STEPS]
    assert sup.anchor_log[0]["bytes"] == sum(
        t.numel() * t.element_size() for t in tree.leaves(fresh_state()))


def test_restore_places_a_checkpoint_in_the_executors_layout(tmp_path):
    d = str(tmp_path / "c")
    run_supervised(make_build("flat"), ckpt_dir=d, ckpt_every=2)
    sup = engine.Supervisor(make_build("flat"), make_plan(), log_fn=None,
                            ckpt_dir=d)
    params, opt_state, step = sup.restore(*fresh_state())
    assert step == STEPS
    spec = engine.FlatSpec.for_tree(params)
    assert spec.buffers_of(params) is not None
    assert spec.buffers_of(opt_state["mom"]) is not None


def test_only_recoverable_out_of_memory_is_oom():
    assert faults.classify(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert faults.classify(RuntimeError("RESOURCE_EXHAUSTED: oom")) == "oom"
    for msg in ("CUDA error: out of memory\nCUDA kernel errors might be "
                "asynchronously reported", "CUDA error: "
                "CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate`",
                "cuDNN error: CUDNN_STATUS_ALLOC_FAILED"):
        assert faults.classify(RuntimeError(msg)) == "fatal"
    assert faults.KINDS == jfaults.KINDS
    assert faults.corrupt_cache() == faults.FaultSpec("corrupt_cache", None)


def test_on_replan_writes_the_references_garbage(tmp_path):
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    for mod, path in ((faults, got), (jfaults, want)):
        path.write_text("{}")
        with mod.inject(mod.FaultPlan(mod.corrupt_cache())) as fp:
            mod.on_replan(str(path))
            mod.on_replan(str(path))  # one charge
        assert fp.fired_kinds() == ["corrupt_cache"]
    assert got.read_text() == want.read_text()
    faults.on_replan(str(got))  # no active plan: a no-op


# ---------------------------------------------------------------------------
# a fault on one rank alone, agreed across the ranks (beyond the reference,
# whose one controller sees every device's OOM once)
# ---------------------------------------------------------------------------

def _staged_np():
    from conftest import staged_batch, staged_params
    return (jax.tree.map(np.asarray, staged_params()),
            [jax.tree.map(np.asarray, staged_batch(8, seed=t))
             for t in range(4)])


@pytest.mark.parametrize("executor", ["sharded", "pipelined"])
def test_one_rank_oom_is_agreed_across_ranks(world2, executor):
    """``oom_at(1, rank=1)`` fires on rank 1 alone: both ranks record it
    at the same step, degrade to the same plan, resume from the same step
    and end bit-identical — and equal to the run where the fault fires on
    every rank — within seconds (the process group's timeout is 120 s
    here), with one all-reduce in each step either way."""
    import torch_pipeline_cases as pipe_cases
    sharded = executor == "sharded"
    mesh = {"data": 2, "model": 1} if sharded else {"data": 1, "model": 2}
    plan = engine.plan_mbs(8, micro_batch_size=4, normalization="exact",
                           mesh=mesh, pipeline=not sharded, device="cpu")
    params, batches = _staged_np()

    def run(specs):
        runs = world2.run(pipe_cases.supervised, mesh["data"],
                          mesh["model"], plan, specs, params, batches,
                          sharded, timeout_s=60)
        for r in runs:
            assert r["seconds"] < 60
            assert r["records"] == runs[0]["records"]
            assert r["plan"] == runs[0]["plan"]
            assert r["calls"] == [1] * len(r["calls"])
            for a, b in zip(jax.tree.leaves((r["params"], r["opt_state"])),
                            jax.tree.leaves((runs[0]["params"],
                                             runs[0]["opt_state"]))):
                assert np.array_equal(a, b)
        return runs

    one = run([faults.oom_at(1, rank=1)])
    assert [r["fired"] for r in one] == [[], [("oom", 1)]]
    assert one[0]["records"] == [("oom", 1, "remat period->full", 1)]
    every = run([faults.oom_at(1)])
    assert one[0]["records"] == every[0]["records"]
    assert one[0]["plan"] == every[0]["plan"]
    assert one[0]["history"] == every[0]["history"]
    for a, b in zip(jax.tree.leaves((one[0]["params"], one[0]["opt_state"])),
                    jax.tree.leaves((every[0]["params"],
                                     every[0]["opt_state"]))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("inner", ["flat", "compiled"])
def test_first_step_oom_on_one_rank_is_agreed(world2, inner):
    """An OOM on rank 1 at its first dispatch, before its loss has ever
    returned: it learns the metrics' layout from a fake-tensor trace of
    the (reduced qwen2) loss, joins the step's one all-reduce with zeros,
    and both ranks raise the same error naming rank 1."""
    plan = engine.plan_mbs(8, micro_batch_size=4, normalization="exact",
                           mesh={"data": 2, "model": 1}, device="cpu")
    runs = world2.run(mesh_cases.agreed_first_step, inner,
                      configs.get_reduced("qwen2-1.5b"), plan, timeout_s=60)
    assert runs[0] == runs[1]
    err, calls = runs[0]
    assert "rank(s) [1] of 2" in err and calls == 1
