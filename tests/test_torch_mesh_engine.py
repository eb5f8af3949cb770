"""The port's data parallelism against the JAX package's:
``tests/test_mesh_engine.py`` case for case, each run in both packages on
the same numpy inputs and parameters.

The reference runs on ``conftest.host_mesh(data)`` (forced host devices);
the port on a gloo world of ``data`` CPU ranks
(``repro_torch.launch.world.LocalWorld``: one spawned world per data
size, started once for the module, every call bounded by a timeout). The
ranks run ``tests/torch_mesh_cases.py``, which imports no JAX.

Gradients, losses, params and optimizer state agree within
``conftest.DTYPE_ATOL`` (fp32: 2e-6); every rank returns the same
result; plans, memory estimates and sharding specs are arithmetic and
equal exactly. The reference's HLO census (one all-reduce in the
compiled step; it fails under jax 0.9.0, ROADMAP.md queue 3) becomes the
port's call census: ``engine.collective_stats`` counts the all-reduces
each step issues — one a mini-batch for every inner at N_Sμ ∈ {2, 8},
N_Sμ for the ``defer_sync=False`` baseline.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from conftest import (DTYPE_ATOL, GOLDEN_LOSSES, ToyDataset,  # noqa: E402
                      host_mesh, make_sharded_executor, tiny_batch,
                      tiny_loss_fn, tiny_optimizer, tiny_params)
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro_torch import configs, engine, optim, weights  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402

ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
INNERS = sorted(engine.EXECUTORS)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (mini_batch, micro_batch, expected normalization after planning), the
# reference's: the uniform split keeps "paper", the ragged one upgrades to
# "exact" and puts zero-weight padding on a worker's block
SPLIT_CASES = {
    "uniform-paper": (16, 8, "paper"),
    "ragged-exact": (10, 4, "exact"),
}
PLAN_FIELDS = ("mini_batch_size", "micro_batch_size", "num_micro_batches",
               "pad", "normalization", "remat_policy", "data_parallel",
               "local_micro", "auto_micro", "auto_policy")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(n)``: the module's gloo world of ``n`` CPU ranks."""
    started = {}

    def get(n: int) -> LocalWorld:
        if n not in started:
            started[n] = LocalWorld(
                n, store_dir=str(tmp_path_factory.mktemp(f"world{n}")),
                timeout_s=120)
        return started[n]

    yield get
    for w in started.values():
        w.close()


def tmesh(data: int):
    return {"data": data, "model": 1}


def params_np():
    return jax.tree.map(np.asarray, tiny_params())


def _fields(plan):
    return {f: getattr(plan, f) for f in PLAN_FIELDS}


def plans(mini, mesh_data, **kw):
    """(reference plan on host_mesh(data), port plan on {"data": data}),
    asserted equal."""
    jp = jengine.plan_mbs(mini, mesh=host_mesh(mesh_data), **kw)
    tp = engine.plan_mbs(mini, mesh=tmesh(mesh_data), device="cpu", **kw)
    assert _fields(tp) == _fields(jp)
    return jp, tp


def _np_tree(t):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), t)


def assert_close(got, want, what, atol=ATOL):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(_np_tree(want))
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        err = float(np.max(np.abs(np.asarray(g, np.float32) - w)))
        assert err <= atol, f"{what}: leaf {i} differs by {err:.3e}"


def same_on_every_rank(results, what):
    for r in results[1:]:
        for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(results[0])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), what
    return results[0]


def same_estimate(a, b) -> bool:
    """Two memory estimates (one of each package) term for term."""
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def port_single(inner, plan, split, opt=None):
    """The port's single-device executor on the global split."""
    opt = opt or cases.make_opt(cases.TINY_OPT)
    return engine.get_executor(inner)(cases.t_loss_fn, opt, plan)


# ---------------------------------------------------------------------------
# gradient/loss equivalence: inners × data × split regimes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_sharded_gradients_match_reference_and_single_device(
        world, inner, data, case):
    mini, micro, norm = SPLIT_CASES[case]
    jp, tp = plans(mini, data, micro_batch_size=micro)
    assert tp.normalization == norm
    split = tp.split(tiny_batch(mini))
    g_ref, l_ref = make_sharded_executor(
        inner, tiny_loss_fn, tiny_optimizer(), jp, host_mesh(data)
    ).gradients(tiny_params(), jp.device_split(tiny_batch(mini)))
    res = world(data).run(cases.gradients, inner, tp, params_np(), split)
    g, loss, calls = same_on_every_rank(res, f"{inner}/{data}/{case}")
    what = f"{inner}/data={data}/{case}"
    assert_close(g, g_ref, what + " grads vs reference")
    assert abs(loss - float(l_ref)) <= ATOL, what
    assert calls == 1, what
    g1, l1 = port_single(inner, tp, split).gradients(
        weights.from_reference(params_np(), "cpu"), cases._tensors(split))
    assert_close(g, cases.to_np(g1), what + " grads vs one device")
    assert abs(loss - float(l1)) <= ATOL, what


@pytest.mark.parametrize("inner", INNERS)
def test_sharded_update_matches_reference_with_clip(world, inner):
    """A full optimizer step under global-norm clipping on the ragged
    split: params, optimizer state, loss and grad-norm against the
    reference's sharded step and the port's one-device step — the clip
    scale comes from the globally summed gradient."""
    opt_spec = ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4},
                0.05)
    jopt = joptim.clip_by_global_norm(
        joptim.sgd(0.1, momentum=0.9, weight_decay=1e-4), 0.05)
    jp, tp = plans(10, 4, micro_batch_size=4)
    params = tiny_params()
    ex = make_sharded_executor(inner, tiny_loss_fn, jopt, jp, host_mesh(4),
                               donate=False)
    p_ref, s_ref, m_ref = ex.step_split(params, jopt.init(params),
                                        jp.device_split(tiny_batch(10)))
    split = tp.split(tiny_batch(10))
    res = world(4).run(cases.step, inner, tp, params_np(), split, opt_spec)
    p, s, m, calls = same_on_every_rank(res, inner)
    assert_close(p, p_ref, f"{inner} clipped params")
    assert_close(s["mom"], s_ref["mom"], f"{inner} clipped momentum")
    assert int(s["step"]) == int(s_ref["step"])
    assert abs(m["loss"] - float(m_ref["loss"])) <= ATOL
    assert abs(m["grad_norm"] - float(m_ref["grad_norm"])) <= 1e-4
    assert calls == 1
    opt = cases.make_opt(opt_spec)
    p1, _, m1 = port_single(inner, tp, split, opt).step_split(
        *cases._state(params_np(), opt), cases._tensors(split))
    assert_close(p, cases.to_np(p1), f"{inner} clipped params, one device")
    assert abs(m["loss"] - float(m1["loss"])) <= ATOL


@pytest.mark.parametrize("inner", ["compiled", "streaming"])
def test_sharded_step_via_host_minibatch(world, inner):
    """.step() splits the global host mini-batch and keeps this rank's
    block (``streaming`` copies it micro-batch by micro-batch) and
    matches .step_split() on the staged block."""
    _, tp = plans(16, 4, micro_batch_size=8)
    batch = tiny_batch(16)
    split = tp.split(batch)
    w = world(4)
    via_step = same_on_every_rank(w.run(
        cases.step, inner, tp, params_np(), None, cases.TINY_OPT, "step",
        batch), inner)
    via_split = same_on_every_rank(w.run(
        cases.step, inner, tp, params_np(), split), inner)
    assert_close(via_step[0], via_split[0], f"{inner} step vs step_split")
    assert abs(via_step[2]["loss"] - via_split[2]["loss"]) <= ATOL
    assert via_step[3] == via_split[3] == 1


# ---------------------------------------------------------------------------
# deferred sync: the port's call census
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", INNERS)
@pytest.mark.parametrize("n_micro", [2, 8])
def test_exactly_one_allreduce_per_minibatch(world, inner, n_micro):
    """Every inner issues ONE all-reduce a mini-batch, whatever N_Sμ."""
    _, tp = plans(8 * n_micro, 4, num_microbatches=n_micro)
    assert tp.num_micro_batches == n_micro
    split = tp.split(tiny_batch(8 * n_micro))
    assert world(4).run(cases.census, inner, tp, params_np(),
                        split) == [1] * 4


@pytest.mark.parametrize("n_micro", [2, 8])
def test_per_micro_baseline_syncs_every_micro_batch(world, n_micro):
    """``defer_sync=False`` (the baseline deferral removes) issues one
    all-reduce a micro-batch and reaches the same step."""
    _, tp = plans(8 * n_micro, 4, num_microbatches=n_micro)
    split = tp.split(tiny_batch(8 * n_micro))
    w = world(4)
    base = same_on_every_rank(w.run(cases.step, "compiled", tp, params_np(),
                                    split, cases.TINY_OPT, "step_split",
                                    None, False), "baseline")
    deferred = same_on_every_rank(w.run(cases.step, "compiled", tp,
                                        params_np(), split), "deferred")
    assert base[3] == n_micro and deferred[3] == 1
    assert_close(base[0], deferred[0], "baseline vs deferred params")
    assert abs(base[2]["loss"] - deferred[2]["loss"]) <= ATOL


# ---------------------------------------------------------------------------
# golden trajectory on a (data=4) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", INNERS)
def test_five_step_loss_trajectory_matches_golden_and_reference(world,
                                                                inner):
    jp, tp = plans(10, 4, micro_batch_size=4)
    losses = same_on_every_rank(world(4).run(
        cases.trajectory, inner, tp, params_np(), 5), inner)
    np.testing.assert_allclose(losses, GOLDEN_LOSSES, atol=5e-4, rtol=0)
    ex = make_sharded_executor(inner, tiny_loss_fn, tiny_optimizer(), jp,
                               host_mesh(4), donate=False)
    params, state = tiny_params(), tiny_optimizer().init(tiny_params())
    ref, ds = [], ToyDataset()
    for i in range(5):
        params, state, m = ex.step(params, state, ds.batch(10, i))
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# mesh-aware planning
# ---------------------------------------------------------------------------

def test_plan_records_mesh_geometry_and_divisibility():
    _, plan = plans(16, 4, micro_batch_size=8)
    assert plan.data_parallel == 4 and plan.local_micro == 2
    assert plan.micro_batch_size == plan.local_micro * plan.data_parallel
    # pinned sizes that do not divide round UP to the next multiple ...
    _, plan = plans(16, 4, micro_batch_size=6)
    assert plan.micro_batch_size == 8 and plan.local_micro == 2
    # ... but never past the largest multiple within the mini-batch
    _, plan = plans(10, 4, micro_batch_size=7)
    assert plan.micro_batch_size == 8 and plan.local_micro == 2
    with pytest.raises(ValueError, match="data-parallel") as got:
        engine.plan_mbs(3, micro_batch_size=1, mesh=tmesh(4), device="cpu")
    with pytest.raises(ValueError) as want:
        jengine.plan_mbs(3, micro_batch_size=1, mesh=host_mesh(4))
    assert str(got.value) == str(want.value)
    assert "data-parallel 4 x local 2" in engine.plan_mbs(
        16, micro_batch_size=8, mesh=tmesh(4), device="cpu").describe()


def test_sharded_executor_rejects_bad_plans():
    """The reference's refusals, word for word (no collective runs)."""
    tm, jm = mesh_lib.make_host_mesh(4), host_mesh(4)
    opt, jopt = cases.make_opt(cases.TINY_OPT), tiny_optimizer()
    bad = [
        (engine.plan_mbs(10, micro_batch_size=5, device="cpu"),
         jengine.plan_mbs(10, micro_batch_size=5), {}, "divide"),
        (engine.MBSPlan(10, 4, 3, 2, "paper"),
         jengine.MBSPlan(10, 4, 3, 2, "paper"), {}, "exact"),
        (engine.plan_mbs(16, micro_batch_size=8, mesh=tm, device="cpu"),
         jengine.plan_mbs(16, micro_batch_size=8, mesh=jm),
         {"inner": "flat", "defer_sync": False}, "defer_sync"),
    ]
    for tp, jp, kw, match in bad:
        with pytest.raises(ValueError, match=match) as got:
            engine.ShardedExecutor(cases.t_loss_fn, opt, tp, mesh=tm, **kw)
        with pytest.raises(ValueError) as want:
            jengine.ShardedExecutor(tiny_loss_fn, jopt, jp, mesh=jm, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=">= 2"):
        engine.ShardedExecutor(cases.t_loss_fn, opt, bad[2][0],
                               mesh=mesh_lib.make_host_mesh(1))


def test_admission_grows_with_data_axis():
    """At a fixed per-device budget the planner admits a larger global
    batch as the data axis grows 2 → 4 → 8, in both packages alike."""
    cfg, jcfg = (configs.get_reduced("qwen2-1.5b"),
                 jconfigs.get_reduced("qwen2-1.5b"))
    seq = 16
    est = memory_model.estimate(cfg, seq, remat_policy="none")
    assert same_estimate(est, jmemory_model.estimate(jcfg, seq,
                                                      remat_policy="none"))
    budget = est.total(0) + 3 * est.activation_bytes_per_sample
    admitted = []
    for data in (2, 4, 8):
        plan = engine.plan_mbs(256, model_cfg=cfg, seq_len=seq,
                               budget_bytes=budget, remat_policy="none",
                               mesh=tmesh(data), fsdp_params=False,
                               device="cpu")
        jplan = jengine.plan_mbs(256, model_cfg=jcfg, seq_len=seq,
                                 budget_bytes=budget, remat_policy="none",
                                 mesh=host_mesh(data), fsdp_params=False)
        assert _fields(plan) == _fields(jplan)
        assert plan.data_parallel == data
        per_dev = memory_model.estimate(cfg, seq, remat_policy="none",
                                        mesh=tmesh(data), fsdp_params=False)
        assert same_estimate(per_dev, jmemory_model.estimate(
            jcfg, seq, remat_policy="none", mesh=host_mesh(data),
            fsdp_params=False))
        assert per_dev.total(plan.local_micro) <= budget
        admitted.append(plan.micro_batch_size)
    assert admitted == sorted(admitted)
    assert admitted[-1] > admitted[0], admitted


@pytest.mark.parametrize("fused_update", [False, True])
def test_mesh_plans_equal_reference_across_budgets(fused_update):
    """Auto, pinned and policy-searched plans on data 2 / 4 / 8 meshes,
    FSDP-discounted or replicated, over a budget sweep: field for field."""
    for red, data, budget, policy, fsdp in [
            (True, 2, 2 ** 26, None, True), (True, 4, 2 ** 30, "auto", False),
            (True, 8, 2 ** 28, "auto", True), (False, 2, 40 * 2 ** 30,
                                               "auto", False),
            (False, 4, 30 * 2 ** 30, None, True),
            (False, 8, 80 * 10 ** 9, "auto", True)]:
        get = configs.get_reduced if red else configs.get
        jget = jconfigs.get_reduced if red else jconfigs.get
        for pins in [{}, {"micro_batch_size": 3}, {"num_microbatches": 4}]:
            kw = dict(model_cfg=None, seq_len=64, budget_bytes=budget,
                      remat_policy=policy, fsdp_params=fsdp,
                      fused_update=fused_update, **pins)
            tp = engine.plan_mbs(64, mesh=tmesh(data), device="cpu",
                                 **dict(kw, model_cfg=get("qwen2-1.5b")))
            jp = jengine.plan_mbs(64, mesh=host_mesh(data),
                                  **dict(kw, model_cfg=jget("qwen2-1.5b")))
            assert _fields(tp) == _fields(jp), (red, data, budget, pins)


def test_pipeline_stages_with_mesh_batch_blocks():
    """``Pipeline(mesh=...)`` stages rank r's block of dim 1 — the sample
    dim, sharded over the data axis — and the blocks of all ranks are the
    reference's staged global array, shard by shard."""
    jp, tp = plans(16, 4, micro_batch_size=8)
    jpipe = jengine.Pipeline(ToyDataset(), jp, prefetch=0, mesh=host_mesh(4))
    jbatch = next(iter(jpipe.batches(1)))
    blocks = [cases.pipeline_block(mesh_lib.make_host_mesh(4, rank=r), tp, 1)
              [0] for r in range(4)]
    for k in ("x", "y", "sample_weight"):
        assert blocks[0][k].shape[1] == tp.local_micro
        assert np.array_equal(np.concatenate([b[k] for b in blocks], axis=1),
                              np.asarray(jbatch[k]))
    shards = sorted(jbatch["x"].addressable_shards,
                    key=lambda s: s.index[1].start)
    for r, s in enumerate(shards):
        assert np.array_equal(blocks[r]["x"], np.asarray(s.data))
    with pytest.raises(ValueError, match="not both"):
        engine.Pipeline(ToyDataset(), tp, device="cpu",
                        mesh=mesh_lib.make_host_mesh(4),
                        sharding=lambda split: split)


def test_param_shard_ratio_discounts_fsdp():
    """FSDP discounts the per-device param bytes (divisible dims shard,
    the rest replicate); a replicating executor keeps them whole; both
    equal the reference's exactly."""
    cfg, jcfg = (configs.get_reduced("qwen2-1.5b"),
                 jconfigs.get_reduced("qwen2-1.5b"))
    r_fsdp = memory_model.param_shard_ratio(cfg, tmesh(4), fsdp=True)
    r_repl = memory_model.param_shard_ratio(cfg, tmesh(4), fsdp=False)
    assert r_fsdp < r_repl <= 1.0
    assert r_fsdp == jmemory_model.param_shard_ratio(jcfg, host_mesh(4),
                                                     fsdp=True)
    assert r_repl == jmemory_model.param_shard_ratio(jcfg, host_mesh(4),
                                                     fsdp=False)
    for fsdp in (True, False):
        est = memory_model.estimate(cfg, 16, mesh=tmesh(4), fsdp_params=fsdp)
        assert same_estimate(est, jmemory_model.estimate(
            jcfg, 16, mesh=host_mesh(4), fsdp_params=fsdp))
    assert memory_model.estimate(cfg, 16, mesh=tmesh(4)).params_bytes < \
        memory_model.estimate(cfg, 16, mesh=tmesh(4),
                              fsdp_params=False).params_bytes


# ---------------------------------------------------------------------------
# the sharding policy and the mesh helpers, as arithmetic
# ---------------------------------------------------------------------------

def _jspecs(tree_of_specs):
    return [tuple(s) for s in jax.tree.leaves(
        tree_of_specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                    .PartitionSpec))]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "mamba2-780m",
                                  "moonshot-v1-16b-a3b"])
def test_sharding_specs_equal_reference(arch):
    """param_specs (TP, FSDP, FSDP over pod), batch_specs and cache_specs
    on (data, model) and (pod, data, model) meshes: spec for spec."""
    from repro.models import transformer as jtransformer
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    shapes = memory_model.param_shapes(cfg)
    jshapes = jax.eval_shape(lambda k: jtransformer.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    batch = {"x": np.zeros((3, 8, 16)), "y": np.zeros((3, 6)),
             "w": np.zeros((3, 8))}
    cache = {"k": np.zeros((2, 8, 16, 2, 4)), "pos": np.zeros((2, 8, 16))}
    for dims in [(2, 1, 0), (4, 2, 0), (2, 2, 2), (1, 8, 0)]:
        data, model, pod = dims
        jm = jmesh.make_host_mesh(data=data, model=model, pod=pod)
        tm = mesh_lib.make_host_mesh(data, model, pod)
        for fsdp, over_pod in [(True, False), (False, False), (True, True)]:
            got = sharding.spec_leaves(sharding.param_specs(
                shapes, tm, fsdp=fsdp, fsdp_over_pod=over_pod))
            want = _jspecs(jsharding.param_specs(
                jshapes, jm, fsdp=fsdp, fsdp_over_pod=over_pod))
            assert [tuple(s) for s in got] == want, (dims, fsdp, over_pod)
        assert sharding.spec_leaves(sharding.batch_specs(batch, tm)) == \
            _jspecs(jsharding.batch_specs(batch, jm))
        assert sharding.spec_leaves(sharding.cache_specs(cache, tm)) == \
            _jspecs(jsharding.cache_specs(cache, jm))
        assert mesh_lib.batch_axes(tm) == jmesh.batch_axes(jm)
        assert mesh_lib.data_parallel_size(tm) == \
            jmesh.data_parallel_size(jm)


@pytest.mark.parametrize("spec", ["2", "a:b", "0:1", "4:4", "2:1"])
def test_parse_mesh_spec_matches_reference(spec):
    try:
        want = jmesh.parse_mesh_spec(spec, 8)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_lib.parse_mesh_spec(spec, 8)
        assert str(got.value) == str(e)
    else:
        assert mesh_lib.parse_mesh_spec(spec, 8) == want
    with pytest.raises(ValueError, match="exactly 256 ranks"):
        mesh_lib.make_production_mesh()


def test_mesh_is_the_autotuner_mapping():
    """A port mesh is a mapping of axis to size (what ``mesh_tag`` keys the
    tuning cache by) and tags as the reference's mesh does."""
    from repro.engine import autotune as jautotune
    from repro_torch.engine import autotune
    tm = mesh_lib.make_host_mesh(4, 1, rank=2)
    assert dict(tm) == {"data": 4, "model": 1} and tm.rank == 2
    assert autotune.mesh_tag(tm) == jautotune.mesh_tag(host_mesh(4))


# ---------------------------------------------------------------------------
# the launcher under torchrun, against the reference's launcher path
# ---------------------------------------------------------------------------

def _reference_launcher_losses(executor, params, steps):
    """The reference's ShardedExecutor on host_mesh(2), driven as its
    launcher drives it (build_plan, build_executor, Pipeline with the
    executor's batch shardings, Trainer), from ``params``."""
    import argparse
    from repro.data import LMDataset as JLMDataset
    from repro.launch import train as jtrain
    ns = argparse.Namespace(
        arch="qwen2-1.5b", reduced=True, mini_batch=16, microbatches=4,
        executor=executor, normalization="paper", remat_policy="auto",
        hbm_budget_gb=16.0, calibrate="off", tuning_cache=None, seq=64,
        lr=0.05, dtype="float32", mesh="host", prefetch=0, supervise=False,
        fsdp=False)
    mesh = host_mesh(2)
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    opt = jtrain.default_optimizer(ns)
    plan = jtrain.build_plan(cfg, ns, optimizer=opt, mesh=mesh)
    ex, _ = jtrain.build_executor(cfg, plan, ns, optimizer=opt, mesh=mesh)
    pipe = jengine.Pipeline(JLMDataset(cfg.vocab_size, 64, seed=0), plan,
                            prefetch=0, sharding=ex.batch_shardings)
    losses = []
    jengine.Trainer(ex.step_split, pipe, log_every=1,
                    log_fn=lambda s, m, t: losses.append(m["loss"])).fit(
        jax.tree.map(jnp.asarray, params),
        opt.init(jax.tree.map(jnp.asarray, params)), steps)
    return plan, losses


def test_launcher_on_two_gloo_ranks_matches_reference(tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train --device
    cpu --reduced --mesh 2:1 --executor flat``, resumed on both ranks from
    one checkpoint of the reference's initial params: rank 0 prints the
    plan and the losses, each rank reports them, and they match the
    reference's sharded launcher path on host_mesh(2); the ranks agree
    bit for bit and rank 0 alone writes the final checkpoint."""
    import json
    from repro.models import transformer as jtransformer
    params = jax.tree.map(np.asarray, jtransformer.init_params(
        jconfigs.get_reduced("qwen2-1.5b"), jax.random.PRNGKey(0)))
    tparams = weights.from_reference(params, "cpu")
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    ckpt = str(tmp_path / "ckpt")
    ckpt_lib.save(ckpt, 0, {"params": tparams,
                            "opt_state": opt.init(tparams)})
    report = str(tmp_path / "run.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
           "--mesh", "2:1", "--executor", "flat", "--microbatches", "4",
           "--hbm-budget-gb", "16", "--calibrate", "off", "--prefetch", "0",
           "--steps", "3", "--log-every", "1", "--ckpt-dir", ckpt,
           "--resume", "--report", report]
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    jplan, want = _reference_launcher_losses("flat", params, 3)
    assert f"{jplan.describe()}" in out.stdout
    assert "[mesh] 2 ranks on the data axis" in out.stdout
    assert "backend gloo" in out.stdout
    assert out.stdout.count("step    0  loss") == 1  # rank 0 alone
    assert "[mesh] all-reduce: 3 calls in 3 steps" in out.stdout
    reps = [json.load(open(str(tmp_path / f"run.rank{r}.json")))
            for r in range(2)]
    got = [[h["loss"] for h in rep["history"]] for rep in reps]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, atol=ATOL, rtol=0)
    for rep in reps:
        assert rep["all_reduce"]["calls"] == 3 and rep["backend"] == "gloo"
        assert rep["local_micro"] == 2 and rep["num_micro_batches"] == 4
    assert ckpt_lib.committed_steps(ckpt) == [0, 3]
    assert all(math.isfinite(x) for x in got[0])


def test_launcher_refuses_what_is_not_ported(capsys):
    """The production meshes at a world of the wrong size are refused
    naming the size they need, with --supervise too (ported on a GSPMD
    mesh: the size is what is refused); a spec larger than the world, and
    --fsdp off a pipelined mesh, with the reference's words (its
    parse-time --fsdp error)."""
    from repro_torch.launch import train
    for argv, words in [(["--mesh", "production"], "exactly 256 ranks"),
                        (["--multi-pod"], "exactly 512 ranks"),
                        (["--mesh", "production", "--supervise"],
                         "exactly 256 ranks"),
                        (["--mesh", "2:1"], "needs 2 devices but only 1"),
                        (["--mesh", "1:1", "--fsdp"],
                         "--fsdp applies to the pipelined path: pass an "
                         "explicit 'DATA:MODEL' mesh spec with MODEL > 1")]:
        with pytest.raises(SystemExit):
            train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                        "cpu", "--steps", "1", *argv])
        assert words in capsys.readouterr().err, argv


def _reference_pipelined_run(params, steps):
    """The reference's PipelinedExecutor on ``pipeline_mesh(1, 2)``,
    driven as its launcher drives ``--mesh 1:2`` (build_plan,
    build_executor, Pipeline with the executor's batch shardings,
    Trainer), from ``params``: (plan, losses, final params, final
    optimizer state)."""
    import argparse
    from conftest import pipeline_mesh
    from repro.data import LMDataset as JLMDataset
    from repro.launch import train as jtrain
    ns = argparse.Namespace(
        arch="qwen2-1.5b", reduced=True, mini_batch=16, microbatches=4,
        executor="compiled", normalization="paper", remat_policy="auto",
        hbm_budget_gb=16.0, calibrate="off", tuning_cache=None, seq=64,
        lr=0.05, dtype="float32", mesh="1:2", prefetch=0, supervise=False,
        fsdp=False)
    mesh = pipeline_mesh(1, 2)
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    opt = jtrain.default_optimizer(ns)
    plan = jtrain.build_plan(cfg, ns, optimizer=opt, mesh=mesh)
    ex, _ = jtrain.build_executor(cfg, plan, ns, optimizer=opt, mesh=mesh)
    pipe = jengine.Pipeline(JLMDataset(cfg.vocab_size, 64, seed=0), plan,
                            prefetch=0, sharding=ex.batch_shardings)
    losses = []
    p, s, _ = jengine.Trainer(
        ex.step_split, pipe, log_every=1,
        log_fn=lambda st, m, t: losses.append(m["loss"])).fit(
            jax.tree.map(jnp.asarray, params),
            opt.init(jax.tree.map(jnp.asarray, params)), steps)
    return plan, losses, p, s


def test_pipelined_launcher_checkpoint_round_trips_both_packages(tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.train --mesh
    1:2``: both ranks resume their stage from a reference-format
    checkpoint of the reference's initial params, train 3 steps with the
    reference's pipelined launcher's plan and losses (on every rank), and
    the checkpoint rank 0 writes from the gathered state restores in the
    JAX package to the reference's trained params and momentum."""
    import json
    from repro.checkpoint import checkpoint as jckpt
    from repro.models import transformer as jtransformer
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    params = jax.tree.map(np.asarray, jtransformer.init_params(
        cfg, jax.random.PRNGKey(0)))
    tparams = weights.from_reference(params, "cpu")
    opt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    ckpt = str(tmp_path / "ckpt")
    ckpt_lib.save(ckpt, 0, {"params": tparams,
                            "opt_state": opt.init(tparams)})
    report = str(tmp_path / "run.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
           "--mesh", "1:2", "--microbatches", "4", "--hbm-budget-gb", "16",
           "--calibrate", "off", "--prefetch", "0", "--steps", "3",
           "--log-every", "1", "--ckpt-dir", ckpt, "--resume",
           "--report", report]
    out = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    jplan, want, jparams, jstate = _reference_pipelined_run(params, 3)
    assert jplan.describe() in out.stdout
    assert "[mesh] 2 ranks as data x model pipeline stages" in out.stdout
    reps = [json.load(open(str(tmp_path / f"run.rank{r}.json")))
            for r in range(2)]
    got = [[h["loss"] for h in rep["history"]] for rep in reps]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], want, atol=ATOL, rtol=0)
    for r, rep in enumerate(reps):
        assert rep["all_reduce"]["by_axis"] == {"data+model": 3}
        assert rep["mesh"] == {"data": 1, "model": 2}
    assert ckpt_lib.committed_steps(ckpt) == [0, 3]
    template = {"params": jparams, "opt_state": jstate}
    back = jckpt.restore(ckpt, template, 3)
    assert_close(back["params"], jparams, "checkpointed params")
    assert_close(back["opt_state"]["mom"], jstate["mom"],
                 "checkpointed momentum")
