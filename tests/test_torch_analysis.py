"""The port's contract checker against the reference's:
``tests/test_analysis.py`` case for case, plus conformance — the same
seeded fault yields the same rule id in both packages wherever the
reference still runs.

Two directions, as in the reference:

  * POSITIVE — the shipped engine gives ZERO findings: the four
    executors × {one device, a 2-rank gloo world} on reduced qwen2-1.5b,
    one device for reduced mamba2-780m and ResNet-50, the 1F1B pipeline
    on a 1 × 2 world, the serve suite for both serve targets, and the
    port's own tree lint-clean.
  * NEGATIVE — every rule FIRES on a seeded violation: a bf16
    accumulator (JX001), missing and unexpected remat (JX002), a host
    read (JX003), a per-micro sync and a stray all-reduce (JX004 /
    HLO004), a dropped in-place update (HLO001), a wild memory model
    (HLO003), an undonated KV pool (SRV001), an over-budget decode
    (SRV002), and each LINT rule, waivable inline.

Three reference cases fail under jax 0.9.0 (ROADMAP.md queue 3):
``test_zero_findings_matrix[*-streaming]`` (JX001 finds no accumulator
in the streaming trace), ``test_hlo004_fires_on_per_micro_schedule`` and
``test_mesh_engine::test_exactly_one_gradient_allreduce_per_minibatch``
(the per-micro baseline compiles to one all-reduce). Their twins here
are ``test_zero_findings_matrix[*-streaming]`` (the port's JX001 finds
streaming's accumulator: ``test_jx001_sees_every_executors_accumulator``),
``test_hlo004_fires_on_per_micro_schedule`` (the port's census counts
the baseline's N_Smu all-reduces and fires) and
``test_one_all_reduce_per_minibatch_census``; they hold the port to the
result the reference intends.

Worlds are ``repro_torch.launch.world.LocalWorld``s of spawned CPU ranks,
started once for the module; their ranks run ``torch_analysis_cases`` and
the suite's own rank function, which import no JAX.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_analysis_cases as cases  # noqa: E402
from conftest import (make_executor as j_make_executor,  # noqa: E402
                      tiny_batch, tiny_loss_fn, tiny_optimizer, tiny_params)
from repro import analysis as janalysis  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.analysis import findings as JF  # noqa: E402
from repro_torch import analysis, engine, optim  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.analysis import serve_checks  # noqa: E402
from repro_torch.engine import exec_core  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402
from torch_mesh_cases import t_loss_fn  # noqa: E402

EXECUTORS = sorted(engine.EXECUTORS)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's gloo world of 2 CPU ranks."""
    w = LocalWorld(2, store_dir=str(tmp_path_factory.mktemp("world2")),
                   timeout_s=180)
    yield w
    w.close()


def _rules(findings):
    return {f.rule for f in findings}


def _t_params():
    """``conftest.tiny_params()`` as torch tensors (the same numbers)."""
    return {k: torch.tensor(np.asarray(v)) for k, v in tiny_params().items()}


def _t_setup(executor="compiled", n_micro=4, loss_fn=t_loss_fn,
             optimizer=None, **plan_kw):
    """The tiny model's plan, executor and state in the port, on the
    reference's inputs (``conftest.tiny_batch``)."""
    plan = engine.plan_mbs(4 * n_micro, num_microbatches=n_micro, **plan_kw)
    opt = optimizer or optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    ex = engine.get_executor(executor)(loss_fn, opt, plan)
    params = _t_params()
    state = opt.init(params)
    if hasattr(ex, "prepare"):
        params, state = ex.prepare(params, state)
    split = plan.device_split(tiny_batch(4 * n_micro), "cpu")
    return plan, ex, params, state, split


def _j_setup(n_micro=4, **plan_kw):
    plan = jengine.plan_mbs(4 * n_micro, num_microbatches=n_micro, **plan_kw)
    opt = tiny_optimizer()
    params = tiny_params()
    return plan, opt, params, opt.init(params), \
        plan.device_split(tiny_batch(4 * n_micro))


# ---------------------------------------------------------------------------
# positive: the shipped engine is contract-clean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("mesh_mode", ["single", "host"])
def test_zero_findings_matrix(executor, mesh_mode, world):
    """Every executor × mesh runs its step with zero findings — reduced
    qwen2-1.5b (period remat), one device or a 2-rank gloo world."""
    report = analysis.run_suite(
        "qwen2_reduced", executor=executor, mesh=mesh_mode, lint=False,
        device="cpu", world=world if mesh_mode == "host" else None)
    assert report.ok, report.format()
    want = {"JX001", "JX002", "JX003", "JX004", "HLO001", "HLO002",
            "HLO003", "HLO004"}
    assert want <= set(report.checks_run)


@pytest.mark.parametrize("target", ["mamba2_reduced", "resnet50"])
@pytest.mark.parametrize("executor", ["compiled", "flat"])
def test_zero_findings_other_targets(target, executor):
    report = analysis.run_suite(target, executor=executor, lint=False,
                                device="cpu")
    assert report.ok, report.format()


def test_zero_findings_pipelined(world):
    """The 1F1B pipeline over a 1 × 2 mesh: JX005's point-to-point
    census equals the closed form and the deferred sync makes one
    (data+model) all-reduce; HLO005 over the measured step."""
    report = analysis.run_suite("qwen2_reduced", mesh="1:2", lint=False,
                                device="cpu", world=world)
    assert report.ok, report.format()
    assert {"JX005", "HLO005"} <= set(report.checks_run)


@pytest.mark.parametrize("policy", ["none", "dots", "period", "full"])
def test_remat_policy_applied_on_real_model(policy):
    """JX002 on a REAL reduced config, each lattice row: the step's
    checkpoint regions are where ``models/remat.py`` puts them."""
    report = analysis.run_suite("qwen2_reduced", executor="compiled",
                                remat_policy=policy, lint=False,
                                device="cpu")
    assert report.ok, report.format()
    assert "JX002" in report.checks_run


def test_repo_is_lint_clean():
    assert analysis.lint_repo() == []


@pytest.mark.parametrize("arch", list(serve_checks.SERVE_TARGETS))
def test_serve_suite_clean_and_plans_agree(arch):
    """Both serve targets' decode steps are clean (SRV001, SRV002); the
    serve plan is the reference's, and so is its verdict."""
    report = analysis.run_serve_suite(arch, device="cpu")
    assert report.ok, report.format()
    jrep = janalysis.run_serve_suite(arch)
    assert jrep.ok
    assert (report.context["slots"], report.context["max_len"]) == \
        (jrep.context["slots"], jrep.context["max_len"])


# ---------------------------------------------------------------------------
# negative: each trace rule fires on a seeded violation, as in the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTORS)
def test_jx001_fires_on_bf16_accumulator(executor):
    """The executor honestly accumulates in bf16 (its plan says so); the
    contract under check demands fp32. Same rule id in the reference
    (its ``compiled`` executor; its trace of ``streaming`` shows no
    accumulator under jax 0.9.0). ``flat``'s K2 takes only an fp32
    accumulator, so its seeded step updates through the tree."""
    opt = (_no_fused_hook(optim.sgd(0.1, momentum=0.9))
           if executor == "flat" else None)
    plan, ex, params, state, split = _t_setup(
        executor, optimizer=opt, accum_dtype=torch.bfloat16)
    trace = ex.trace_step(params, state, split)
    plan_fp32 = engine.plan_mbs(16, num_microbatches=4)
    found = _rules(analysis.check_accum_dtype(trace, plan_fp32, params))
    assert found == {"JX001"}
    # the fp32 plan's own step is clean
    plan, ex, params, state, split = _t_setup(executor)
    assert analysis.check_accum_dtype(
        ex.trace_step(params, state, split), plan, params) == []

    jplan, opt, jparams, jstate, jsplit = _j_setup(accum_dtype=jnp.bfloat16)
    jex = j_make_executor("compiled", tiny_loss_fn, opt, jplan)
    jaxpr = jex.trace_step(jparams, jstate, jsplit)
    assert _rules(janalysis.check_accum_dtype(
        jaxpr, jengine.plan_mbs(16, num_microbatches=4), jparams)) == found


@pytest.mark.parametrize("executor", EXECUTORS)
def test_jx001_sees_every_executors_accumulator(executor):
    """The twin of the reference's streaming case that fails under jax
    0.9.0: the port locates the accumulation of every executor (a plain
    add or a K1 call, N_Smu times a leaf or bucket), so no executor's
    dtype contract goes unverified."""
    plan, ex, params, state, split = _t_setup(executor)
    writes = analysis.accumulator_writes(ex.trace_step(params, state, split),
                                         params)
    assert len(writes) >= plan.num_micro_batches
    assert {dt for dt, _, _ in writes} == {"float32"}


def test_jx002_fires_on_missing_and_unexpected_remat():
    plan, ex, params, state, split = _t_setup()
    trace = ex.trace_step(params, state, split)
    # policy says "period" but the step ran no checkpoint region
    assert _rules(analysis.check_remat_policy(trace, "period")) == {"JX002"}

    def remat_loss(p, b, exact_denom=None):
        return torch.utils.checkpoint.checkpoint(
            lambda q: t_loss_fn(q, b, exact_denom), p, use_reentrant=False)

    plan, ex2, params, state, split = _t_setup(loss_fn=remat_loss)
    trace2 = ex2.trace_step(params, state, split)
    # a checkpoint under policy "none": recompute the planner did not budget
    assert _rules(analysis.check_remat_policy(trace2, "none")) == {"JX002"}
    # the matched case is clean; "full" wants nested regions, "dots"
    # selective ones
    assert analysis.check_remat_policy(trace2, "period") == []
    assert _rules(analysis.check_remat_policy(trace2, "full")) == {"JX002"}
    assert _rules(analysis.check_remat_policy(trace2, "dots")) == {"JX002"}

    # the reference fires the same rule on the same two faults
    jplan, opt, jparams, jstate, jsplit = _j_setup()
    jaxpr = j_make_executor("compiled", tiny_loss_fn, opt, jplan).trace_step(
        jparams, jstate, jsplit)
    assert _rules(janalysis.check_remat_policy(jaxpr, "period")) == {"JX002"}

    def jremat_loss(p, b, exact_denom=None):
        return jax.checkpoint(lambda q: tiny_loss_fn(q, b, exact_denom))(p)

    jaxpr2 = j_make_executor("compiled", jremat_loss, opt, jplan).trace_step(
        jparams, jstate, jsplit)
    assert _rules(janalysis.check_remat_policy(jaxpr2, "none")) == {"JX002"}


def _chatty_loss(p, b, exact_denom=None):
    loss, metrics = t_loss_fn(p, b, exact_denom)
    loss.item()  # a host read inside the step
    return loss, metrics


def _waived_loss(p, b, exact_denom=None):
    loss, metrics = t_loss_fn(p, b, exact_denom)
    loss.item()  # repro: noqa(JX003) waived for the test
    return loss, metrics


def test_jx003_fires_on_host_read():
    """A host read inside the step fires JX003, at its line; the
    reference's host callback fires the same id. A waived line does
    not."""
    _, ex, params, state, split = _t_setup(loss_fn=_chatty_loss)
    found = analysis.check_host_reads(ex.trace_step(params, state, split))
    assert _rules(found) == {"JX003"}
    assert all(f.location.endswith(":" + str(
        _chatty_loss.__code__.co_firstlineno + 2)) for f in found)
    _, ex, params, state, split = _t_setup(loss_fn=_waived_loss)
    assert analysis.check_host_reads(ex.trace_step(params, state, split)) \
        == []

    jplan, opt, jparams, jstate, jsplit = _j_setup()

    def jchatty(p, b, exact_denom=None):
        loss, metrics = tiny_loss_fn(p, b, exact_denom)
        jax.debug.callback(lambda x: None, loss)
        return loss, metrics

    jaxpr = j_make_executor("compiled", jchatty, opt, jplan).trace_step(
        jparams, jstate, jsplit)
    assert _rules(janalysis.check_host_callbacks(jaxpr)) == {"JX003"}


def test_jx004_fires_on_per_micro_sync(world):
    """The ``defer_sync=False`` baseline fires JX004 under the deferred
    contract and is clean under its own, on every rank — as the
    reference's (which still runs under jax 0.9.0)."""
    for census in world.run(cases.per_micro_census):
        assert census["JX004 deferred"] == ["JX004"]
        assert census["JX004 per-micro"] == []
        assert census["all_reduces"] == 4
    from conftest import host_mesh, make_sharded_executor
    mesh = host_mesh(4)
    jplan, opt, jparams, jstate, jsplit = _j_setup(mesh=mesh, unroll=4)
    eager = make_sharded_executor("compiled", tiny_loss_fn, opt, jplan, mesh,
                                  defer_sync=False)
    jaxpr = eager.trace_step(jparams, jstate, jsplit)
    assert _rules(janalysis.check_collectives(
        jaxpr, jparams, n_micro=jplan.num_micro_batches,
        expect="deferred")) == {"JX004"}


def test_hlo004_fires_on_per_micro_schedule(world):
    """The twin of the reference's case that fails under jax 0.9.0 (its
    per-micro baseline compiles to one all-reduce): the port's step
    issues N_Smu all-reduces, so HLO004 fires on it under the deferred
    contract, and not under its own."""
    for census in world.run(cases.per_micro_census):
        assert census["HLO004 deferred"] == ["HLO004"]
        assert census["HLO004 per-micro"] == []


def test_one_all_reduce_per_minibatch_census(world):
    """The deferred step: exactly one all-reduce on every rank, clean
    under the deferred contract, firing under the per-micro one (the
    twin of ``test_exactly_one_gradient_allreduce_per_minibatch``)."""
    for census in world.run(cases.deferred_census):
        assert census["all_reduces"] == 1
        assert census["JX004 deferred"] == [] == census["HLO004 deferred"]
        assert census["JX004 per-micro"] == ["JX004"]
        assert census["HLO004 per-micro"] == ["HLO004"]


def test_census_sees_a_stray_all_reduce(world):
    """A gradient-sized all-reduce the loss issues itself: the
    executor's own count stays at one a step, the census sees five."""
    for census in world.run(cases.stray_all_reduce_census):
        assert census["executor_count"] == 1
        assert census["all_reduces"] == 5
        assert census["JX004 deferred"] == ["JX004"]
        assert census["HLO004 deferred"] == ["HLO004"]


# ---------------------------------------------------------------------------
# negative: the step rules
# ---------------------------------------------------------------------------

def _no_fused_hook(opt):
    """The same optimizer without its fused hook: ``flat`` then takes the
    tree update, which makes new state (the reference's undonated
    step)."""
    return optim.Optimizer(opt.init, opt.update)


def test_hlo001_fires_on_dropped_in_place_update():
    plan, ex, params, state, split = _t_setup("flat")
    assert ex.updates_in_place
    assert analysis.check_aliasing(ex.measure_step(params, state, split),
                                   n_micro=plan.num_micro_batches) == []
    opt = _no_fused_hook(optim.sgd(0.1, momentum=0.9, weight_decay=1e-4))
    plan, ex, params, state, split = _t_setup("flat", optimizer=opt)
    run = ex.measure_step(params, state, split)
    assert _rules(analysis.check_aliasing(run)) == {"HLO001"}

    jplan, opt, jparams, jstate, jsplit = _j_setup()
    jex = j_make_executor("compiled", tiny_loss_fn, opt, jplan)
    compiled = jex.lower_step(jparams, jstate, jsplit, donate=False).compile()
    assert _rules(janalysis.check_aliasing(
        compiled, janalysis.tree_bytes((jparams, jstate)))) == {"HLO001"}


def test_hlo001_fires_on_a_copied_accumulator(monkeypatch):
    """K1 must add every micro-batch into one accumulator: an
    accumulator allocated anew for each micro-batch fires HLO001."""
    plan, ex, params, state, split = _t_setup("fused")
    real = exec_core.accumulate

    def copying(acc, grads, **kw):
        fresh = [a.clone() for a in acc.values()]
        return real(dict(zip(acc, fresh)), grads, **kw)

    assert analysis.check_aliasing(
        ex.measure_step(params, state, split), in_place=False,
        n_micro=plan.num_micro_batches) == []
    monkeypatch.setattr(exec_core, "accumulate", copying)
    run = ex.measure_step(params, state, split)
    assert _rules(analysis.check_aliasing(
        run, in_place=False, n_micro=plan.num_micro_batches)) == {"HLO001"}


def test_hlo003_fires_on_wild_memory_model():
    _, ex, params, state, split = _t_setup()
    run = ex.measure_step(params, state, split)
    # the model claims 256 GiB for a KB-scale step: outside any sane band
    assert _rules(analysis.check_memory_model(run, 1 << 38)) == {"HLO003"}
    assert analysis.check_memory_model(
        run, analysis.measured_peak_bytes(run)) == []
    assert run.peak_source == "live tensor bytes"
    assert run.peak_bytes > run.trace.base_live_bytes

    jplan, opt, jparams, jstate, jsplit = _j_setup()
    compiled = j_make_executor("compiled", tiny_loss_fn, opt, jplan
                               ).lower_step(jparams, jstate, jsplit,
                                            donate=True).compile()
    assert _rules(janalysis.check_memory_model(compiled, 1 << 38)) == \
        {"HLO003"}


def test_hlo002_fires_on_an_all_gather():
    trace = engine.steptrace.StepTrace(collectives=[
        engine.steptrace.Collective("all_gather", "c10d._allgather_base_",
                                    8, 32, (0, 1), None, "x.py:1")])
    assert _rules(analysis.check_unexpected_ops(trace)) == {"HLO002"}
    assert analysis.check_unexpected_ops(trace, expect_gather=True) == []


@pytest.mark.parametrize("arch", list(serve_checks.SERVE_TARGETS))
def test_srv001_fires_on_undonated_pool(arch):
    """``--no-donate``: the decode step writes a fresh pool — SRV001 in
    both packages."""
    report = analysis.run_serve_suite(arch, donate=False, device="cpu")
    assert _rules(report.findings) == {"SRV001"}
    jb = janalysis.build_decode(arch, donate=False)
    assert _rules(janalysis.check_decode_aliasing(
        jb["compiled"], jb["cache_bytes"])) == {"SRV001"}


def test_srv002_fires_over_budget():
    built = analysis.build_decode("qwen2-1.5b", device="cpu")
    run = analysis.measure_decode(built["engine"])
    plan = built["plan"]
    assert analysis.check_decode_memory(run, plan) == []
    import dataclasses
    tight = dataclasses.replace(plan, budget_bytes=run.peak_bytes // 2)
    assert _rules(analysis.check_decode_memory(run, tight)) == {"SRV002"}


# ---------------------------------------------------------------------------
# negative: lint rules + the escape hatch
# ---------------------------------------------------------------------------

LINT_FIXTURES = {
    "LINT001": ("loss_val = metrics['loss'].item()\n", "engine-hot"),
    "LINT002": ("import torch.nn.functional as F\nq = F.pad(x, (0, 4))\n",
                "kernels"),
    "LINT003": ("def put(self, x):\n    self.pool.cache.copy_(x)\n",
                "engine"),
    "LINT004": ("LAUNCHES['k'] += 1\n", "kernels"),
    "LINT005": ("from repro_torch.kernels.grad_accum import grad_accum\n",
                "general"),
    "LINT006": ("try: x = 1\nexcept Exception: pass\n", "engine"),
}


@pytest.mark.parametrize("rule", sorted(LINT_FIXTURES))
def test_lint_rule_fires(rule):
    src, category = LINT_FIXTURES[rule]
    findings = analysis.lint_source(src, f"fixture_{rule}.py",
                                    category=category)
    assert rule in _rules(findings), [f.format() for f in findings]


@pytest.mark.parametrize("rule", sorted(LINT_FIXTURES))
def test_lint_noqa_waives(rule):
    src, category = LINT_FIXTURES[rule]
    lines = src.rstrip("\n").split("\n")
    lines[-1] += f"  # repro: noqa({rule})"
    waived = analysis.lint_source("\n".join(lines) + "\n",
                                  f"fixture_{rule}.py", category=category)
    assert rule not in _rules(waived)


@pytest.mark.parametrize("src", [
    "float(metrics['loss'])\n", "x = t.cpu()\n", "v = t.tolist()\n",
    "torch.cuda.synchronize()\n"])
def test_lint001_covers_every_host_sync(src):
    assert _rules(analysis.lint_source(src, "f.py", category="engine-hot")) \
        == {"LINT001"}
    assert analysis.lint_source(src, "f.py", category="general") == []


def test_lint003_reads_the_donate_flag():
    src = ("def put(self, x):\n    if self.donate:\n"
           "        self.pool.cache.copy_(x)\n")
    assert analysis.lint_source(src, "f.py", category="engine") == []


def test_lint004_fires_on_a_silent_fallback():
    src = ("def k(x):\n    try:\n        _launch(x)\n"
           "        LAUNCHES['k'] += 1\n    except Exception:\n"
           "        return ref.k_ref(x)\n")
    assert _rules(analysis.lint_source(src, "f.py", category="kernels")) \
        == {"LINT004"}
    clean = ("def k(x):\n    if x.is_cpu:\n        return ref.k_ref(x)\n"
             "    _launch(x)\n    LAUNCHES['k'] += 1\n")
    assert analysis.lint_source(clean, "f.py", category="kernels") == []


def test_lint006_taxonomy_routing_passes():
    src = ("try:\n    x = 1\nexcept Exception as e:\n"
           "    if faults.is_oom(e):\n        raise\n")
    assert analysis.lint_source(src, "fixture.py", category="engine") == []


def test_lint006_ignores_engine_external_code():
    src, _ = LINT_FIXTURES["LINT006"]
    assert analysis.lint_source(src, "fixture.py", category="general") == []


def test_seeded_violation_in_the_tree_fires(tmp_path):
    """A copy of the port's tree with one violation of each rule seeded
    into the module the rule reads: the lint names each."""
    import shutil
    root = tmp_path / "repro_torch"
    shutil.copytree(analysis.lint.repo_root(), root,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    seeds = {"engine/executors.py": "\n_x = _y.item()\n",
             "kernels/ops.py": "\n_q = F.pad(_x, (0, 1))\n",
             "engine/kv.py": "\ndef _put(pool, x):\n    pool.copy_(x)\n",
             "kernels/_launch.py": "\nLAUNCHES['seeded'] += 1\n",
             "engine/trainer.py":
                 "\nfrom ..kernels.grad_accum import grad_accum\n",
             "engine/plan.py": "\ntry:\n    pass\nexcept Exception:\n"
                               "    pass\n"}
    for rel, text in seeds.items():
        with open(root / rel, "a", encoding="utf-8") as fh:
            fh.write(text)
    found = _rules(analysis.lint_repo(str(root)))
    assert found == {f"LINT00{i}" for i in range(1, 7)}


# ---------------------------------------------------------------------------
# findings vocabulary + CLI gate
# ---------------------------------------------------------------------------

def test_rule_ids_and_exit_codes_are_the_references():
    assert set(F.RULES) == set(JF.RULES)
    assert (F.EXIT_OK, F.EXIT_ERROR, F.EXIT_BUDGET, F.EXIT_CONTRACT) == \
        (JF.EXIT_OK, JF.EXIT_ERROR, JF.EXIT_BUDGET, JF.EXIT_CONTRACT)
    assert {v["layer"] for v in F.RULES.values()} == {"trace", "step", "ast"}


def test_finding_rejects_unknown_rule():
    with pytest.raises(ValueError):
        F.Finding(rule="XX999", severity=F.SEVERITY_ERROR, message="?")


def test_report_exit_codes():
    rep = F.Report()
    assert rep.ok and rep.exit_code() == F.EXIT_OK
    rep.extend([F.Finding(rule="LINT001", severity=F.SEVERITY_ERROR,
                          message="seeded")], "LINT")
    assert not rep.ok and rep.exit_code() == F.EXIT_CONTRACT
    assert (F.EXIT_OK, F.EXIT_ERROR, F.EXIT_BUDGET, F.EXIT_CONTRACT) == \
        (0, 1, 2, 3)


def test_cli_lint_only_clean_and_violating(monkeypatch, capsys):
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis import lint as lint_mod

    assert cli.main(["--lint-only"]) == F.EXIT_OK

    seeded = [F.Finding(rule="LINT002", severity=F.SEVERITY_ERROR,
                        message="seeded violation", location="x.py:1")]
    monkeypatch.setattr(lint_mod, "lint_repo", lambda root=None: seeded)
    assert cli.main(["--lint-only", "--json"]) == F.EXIT_CONTRACT
    out = capsys.readouterr().out
    assert "seeded violation" in out and '"exit_code": 3' in out


def test_cli_matrix_on_the_cpu(capsys):
    from repro_torch.analysis import __main__ as cli
    assert cli.main(["--device", "cpu", "--config", "qwen2_reduced",
                     "--executor", "fused", "--json"]) == F.EXIT_OK
    assert '"total_findings": 0' in capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--serve", "--no-donate",
                     "--config", "qwen2-1.5b"]) == F.EXIT_CONTRACT
    assert "SRV001" in capsys.readouterr().out


def test_cli_no_hlo_runs_the_trace_rules_and_the_lint(capsys):
    """``--no-hlo`` (the reference's flag): the recorded step's trace
    rules and the lint, no rule of the measured layer, and the report
    names the rules it skipped. The trace rules run are those the
    reference's ``run_suite(hlo=False)`` runs on the same target."""
    import json
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis.suite import HLO_RULES
    assert cli.main(["--device", "cpu", "--no-hlo", "--json"]) == F.EXIT_OK
    rep = json.loads(capsys.readouterr().out)["reports"][0]
    want = janalysis.run_suite("qwen2_reduced", executor="flat", hlo=False,
                               lint=False).checks_run
    assert rep["checks_run"] == want + ["LINT"]
    assert rep["findings"] == []
    assert rep["context"]["skipped_rules"] == list(HLO_RULES)

