"""The port's pipeline parallelism against the JAX package's:
``tests/test_pipeline_parallel.py`` case for case, on the same numpy
inputs and parameters (``weights`` carries them across).

The reference runs on ``conftest.pipeline_mesh(data, stages)`` (forced
host devices); the port on gloo worlds of 2, 4 and 8 CPU ranks
(``repro_torch.launch.world.LocalWorld``: one world a size, started once
for the module, one intra-op thread a rank, every call under a timeout),
each rank building its ``(data, model)`` mesh over the world
(``launch.mesh.pipeline_mesh``). The ranks run
``tests/torch_pipeline_cases.py``, which imports no JAX.

The schedule's tables are ``np.array_equal``; gradients, losses, params
and optimizer state agree within ``DTYPE_ATOL`` (fp32: 2e-6) and
``grad_norm`` within 1e-5, on every rank. The reference's JX005/HLO005
census (jaxpr and HLO; HLO005 fails under jax 0.9.0, ROADMAP.md queue 3)
becomes the port's call census (``engine.collective_stats``): exactly one
data-axis and one (data+model) all-reduce a deferred step, and the
point-to-point calls of the schedule's closed form
(``engine.p2p_counts``); the ``defer_sync=False`` baseline fails the
deferred count. HLO001's aliasing becomes the donation contract: each
rank holds ``donated_state_bytes`` and the update keeps every leaf's
storage.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_pipeline_cases as cases  # noqa: E402
from conftest import (DTYPE_ATOL, GOLDEN_STAGED_LOSSES,  # noqa: E402
                      STAGED_NUM_LAYERS, staged_batch, staged_params,
                      staged_ref_loss, tiny_optimizer)
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs, engine, tree, weights  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402

ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
# the (stages, dp) conformance grid, the reference's
GRID = [(2, 1), (2, 2), (4, 1), (4, 2)]


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


def tmesh(data: int, stages: int):
    return {"data": data, "model": stages}


def params_np(seed: int = 0):
    return jax.tree.map(np.asarray, staged_params(seed))


def batch_np(n: int, seed: int = 0):
    return jax.tree.map(np.asarray, staged_batch(n, seed))


def plans(mini, micro, data, stages, **kw):
    """(reference plan on ``pipeline_mesh``, port plan on the same axes),
    asserted equal field for field."""
    from conftest import pipeline_mesh
    jp = jengine.plan_mbs(mini, micro_batch_size=micro, mesh=pipeline_mesh(
        data, stages), pipeline=True, **kw)
    tp = engine.plan_mbs(mini, micro_batch_size=micro,
                         mesh=tmesh(data, stages), pipeline=True,
                         device="cpu", **kw)
    for f in cases.PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    return jp, tp


def reference(mini=8, micro=2):
    plan = jengine.plan_mbs(mini, micro_batch_size=micro,
                            normalization="exact")
    return jengine.CompiledScanExecutor(staged_ref_loss, tiny_optimizer(),
                                        plan), plan


def assert_close(got, want, what, atol=ATOL):
    gl = jax.tree.leaves(got)
    wl = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      want))
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        err = float(np.max(np.abs(np.asarray(g, np.float32) - w)))
        assert err <= atol, f"{what}: leaf {i} differs by {err:.3e}"


def same_on_every_rank(results, what):
    for r in results[1:]:
        for a, b in zip(jax.tree.leaves(r), jax.tree.leaves(results[0])):
            assert np.array_equal(np.asarray(a), np.asarray(b)), what
    return results[0]


def deferred_census(census, dp, stages, n_micro, rank):
    """The closed form of a deferred, non-FSDP step on rank ``rank``."""
    want_axes = {"data+model": 1}
    if dp > 1:
        want_axes["data"] = 1
    p2p = {k: v for k, v in engine.p2p_counts(
        stages, n_micro, rank % stages).items() if v}
    assert census["by_axis"] == want_axes, (rank, census)
    assert census["all_reduce"] == len(want_axes), (rank, census)
    assert census["p2p"] == p2p, (rank, census)


# ---------------------------------------------------------------------------
# the closed-form schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,micros", [(2, 2), (2, 4), (4, 4), (4, 7),
                                           (3, 5), (8, 8)])
def test_schedule_1f1b_invariants(stages, micros):
    got = engine.schedule_1f1b(stages, micros)
    want = jengine.schedule_1f1b(stages, micros)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3] == 2 * (micros + stages - 1)
    fwd, bwd, recv, _ = got
    assert not ((fwd >= 0) & (bwd >= 0)).any()
    for s in range(stages):
        assert sorted(fwd[fwd[:, s] >= 0, s]) == list(range(micros))
        assert sorted(bwd[bwd[:, s] >= 0, s]) == list(range(micros))
        counts = engine.p2p_counts(stages, micros, s)
        assert counts["fwd_send"] == (micros if s < stages - 1 else 0)
        assert counts["fwd_recv"] == (micros if s > 0 else 0)
        assert counts["bwd_send"] == counts["fwd_recv"]
        assert counts["bwd_recv"] == counts["fwd_send"]


def test_schedule_rejects_degenerate():
    with pytest.raises(ValueError, match="stages >= 1"):
        engine.schedule_1f1b(0, 4)


# ---------------------------------------------------------------------------
# numerical equivalence vs the reference's single device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stages,dp", GRID)
def test_pipelined_matches_single_device(world, stages, dp):
    _, plan = plans(8, 2, dp, stages, normalization="exact")
    ref, ref_plan = reference()
    batch = batch_np(8)
    split = plan.split(batch)
    w = world(stages * dp)
    got = w.run(cases.gradients, dp, stages, plan, params_np(), split)
    g_ref, loss_ref = ref.gradients(staged_params(),
                                    ref_plan.device_split(batch))
    g, loss = same_on_every_rank([r[:2] for r in got], "gradients")
    assert abs(loss - float(loss_ref)) <= ATOL
    assert_close(g, g_ref, f"grads s{stages} dp{dp}")
    for rank, (_, _, census) in enumerate(got):
        deferred_census(census, dp, stages, plan.num_micro_batches, rank)

    steps_ = w.run(cases.step, dp, stages, plan, params_np(), split)
    opt = tiny_optimizer()
    p2, o2, m2 = ref.step_split(staged_params(), opt.init(staged_params()),
                                ref_plan.device_split(batch))
    p1, o1, m1 = same_on_every_rank([r[:3] for r in steps_], "step")
    assert_close(p1, p2, f"params s{stages} dp{dp}")
    assert_close(o1["mom"], o2["mom"], f"opt state s{stages} dp{dp}")
    assert int(o1["step"]) == int(o2["step"])
    assert abs(m1["loss"] - float(m2["loss"])) <= ATOL
    assert abs(m1["grad_norm"] - float(m2["grad_norm"])) <= 1e-5


@pytest.mark.parametrize("stages,dp", [(2, 2), (4, 1)])
def test_fsdp_matches_single_device(world, stages, dp):
    _, plan = plans(8, 2, dp, stages, normalization="exact")
    ref, ref_plan = reference()
    batch = batch_np(8)
    got = world(stages * dp).run(cases.gradients, dp, stages, plan,
                                 params_np(), plan.split(batch), True)
    g, loss = same_on_every_rank([r[:2] for r in got], "fsdp gradients")
    g_ref, loss_ref = ref.gradients(staged_params(),
                                    ref_plan.device_split(batch))
    assert abs(loss - float(loss_ref)) <= ATOL
    assert_close(g, g_ref, f"fsdp grads s{stages} dp{dp}")
    gathers = {r[2]["all_gather"] for r in got}
    assert gathers == ({0} if dp == 1 else {3})  # w_in, w_out, mid
    assert {r[2]["reduce_scatter"] for r in got} == gathers


@pytest.mark.parametrize("stages", [2, 4])
def test_golden_staged_trajectory(world, stages):
    _, plan = plans(8, 2, 2, stages, normalization="exact")
    splits = [plan.split(batch_np(8, seed=t))
              for t in range(len(GOLDEN_STAGED_LOSSES))]
    got = same_on_every_rank(
        world(2 * stages).run(cases.trajectory, 2, stages, plan,
                              params_np(), splits), "trajectory")
    np.testing.assert_allclose(got, GOLDEN_STAGED_LOSSES, atol=ATOL, rtol=0)


def test_ragged_plan_auto_upgrades_and_matches(world):
    jp, plan = plans(7, 4, 2, 2, normalization="paper")
    assert plan.normalization == "exact" and plan.pad == 1
    ref, ref_plan = reference(7, 4)
    batch = batch_np(7)
    got = world(4).run(cases.gradients, 2, 2, plan, params_np(),
                       plan.split(batch))
    g, loss = same_on_every_rank([r[:2] for r in got], "ragged")
    g_ref, loss_ref = ref.gradients(staged_params(),
                                    ref_plan.device_split(batch))
    assert abs(loss - float(loss_ref)) <= ATOL
    assert_close(g, g_ref, "ragged grads")


# ---------------------------------------------------------------------------
# admission / construction errors (no process group needed)
# ---------------------------------------------------------------------------

def _executor(plan, data, stages, **kw):
    return engine.PipelinedExecutor(
        cases.staged_spec(), cases.make_opt(cases.TINY_OPT), plan,
        mesh=mesh_lib.make_host_mesh(data=data, model=stages), **kw)


def test_paper_ragged_plan_refused():
    _, plan = plans(7, 4, 2, 2, normalization="paper")
    forced = dataclasses.replace(plan, normalization="paper")
    with pytest.raises(ValueError, match="cannot be pipelined exactly"):
        _executor(forced, 2, 2)


def test_non_dividing_stage_count_raises():
    _, plan = plans(8, 2, 2, 3, normalization="exact")
    with pytest.raises(ValueError, match="does not divide the"):
        _executor(plan, 2, 3)
    with pytest.raises(ValueError, match="does not divide the block"):
        cases.staged_spec().partition(
            weights.from_reference(params_np(), "cpu"), 3)


def test_single_stage_mesh_refused():
    plan = engine.plan_mbs(8, micro_batch_size=2, normalization="exact",
                           mesh=tmesh(2, 1), device="cpu")
    with pytest.raises(ValueError, match="model axis of >= 2"):
        _executor(plan, 2, 1)


def test_fsdp_requires_deferred_sync():
    _, plan = plans(8, 2, 2, 2, normalization="exact")
    with pytest.raises(ValueError, match="per-micro"):
        _executor(plan, 2, 2, fsdp=True, defer_sync=False)


def test_partition_combine_roundtrip():
    spec = cases.staged_spec()
    params = weights.from_reference(params_np(), "cpu")
    shared, staged = spec.partition(params, 2)
    assert tuple(tree.leaves(staged)[0].shape[:2]) == \
        (2, STAGED_NUM_LAYERS // 2)
    jshared, jstaged = jengine.StagedLoss(
        STAGED_NUM_LAYERS, None, None, None, stacked_key="mid").partition(
            staged_params(), 2)
    assert_close(staged, jstaged, "staged leaves")
    assert_close(shared, jshared, "shared leaves")
    back = spec.combine(shared, staged)
    for k in params:
        assert np.array_equal(back[k].numpy(), params[k].numpy())


# ---------------------------------------------------------------------------
# the port's census — positive AND negative controls
# ---------------------------------------------------------------------------

def test_jx005_census_deferred_clean(world):
    _, plan = plans(8, 2, 2, 2, normalization="exact")
    got = world(4).run(cases.step, 2, 2, plan, params_np(),
                       plan.split(batch_np(8)))
    for rank, r in enumerate(got):
        deferred_census(r[3], 2, 2, plan.num_micro_batches, rank)


def test_jx005_fires_on_per_micro_negative_control(world):
    _, plan = plans(8, 2, 2, 2, normalization="exact")
    batch = batch_np(8)
    got = world(4).run(cases.step, 2, 2, plan, params_np(),
                       plan.split(batch), False, False)
    n = plan.num_micro_batches
    for rank, r in enumerate(got):
        census = r[3]
        with pytest.raises(AssertionError):
            deferred_census(census, 2, 2, n, rank)
        # the census of its own mode: a data-axis all-reduce a backward
        assert census["by_axis"] == {"data": n, "model": 1,
                                     "data+model": 1}, census
    # and the baseline computes the same step
    ref, ref_plan = reference()
    opt = tiny_optimizer()
    p2, _, _ = ref.step_split(staged_params(), opt.init(staged_params()),
                              ref_plan.device_split(batch))
    assert_close(same_on_every_rank([r[0] for r in got], "baseline"), p2,
                 "per-micro params")


def test_jx005_ppermute_count_is_schedule_exact(world):
    _, plan = plans(8, 2, 1, 4, normalization="exact")
    got = world(4).run(cases.step, 1, 4, plan, params_np(),
                       plan.split(batch_np(8)))
    fwd, bwd, _, _ = engine.schedule_1f1b(4, plan.num_micro_batches)
    sends = sum(sum(v for k, v in r[3]["p2p"].items() if "send" in k)
                for r in got)
    recvs = sum(sum(v for k, v in r[3]["p2p"].items() if "recv" in k)
                for r in got)
    # one send and one receive per stage boundary a micro-batch crosses,
    # each way: the forward tables' entries off the last stage, the
    # backward tables' entries off the first
    want = int((fwd[:, :-1] >= 0).sum() + (bwd[:, 1:] >= 0).sum())
    assert sends == recvs == want


def test_hlo005_compiled_schedule(world):
    """The reference compiles the step and counts its HLO collectives
    (failing under jax 0.9.0); the port's twin counts the calls of every
    rank at 4 stages × 2 replicas, deferred and per-micro."""
    _, plan = plans(8, 2, 2, 4, normalization="exact")
    split = plan.split(batch_np(8))
    n = plan.num_micro_batches
    for rank, r in enumerate(world(8).run(cases.step, 2, 4, plan,
                                          params_np(), split)):
        deferred_census(r[3], 2, 4, n, rank)
    for rank, r in enumerate(world(8).run(cases.step, 2, 4, plan,
                                          params_np(), split, False,
                                          False)):
        with pytest.raises(AssertionError):
            deferred_census(r[3], 2, 4, n, rank)


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
def test_pipelined_state_fully_aliased(world, fsdp):
    _, plan = plans(8, 2, 2, 2, normalization="exact")
    for held, floor, kept in world(4).run(
            cases.aliasing, 2, 2, plan, params_np(),
            plan.split(batch_np(8)), fsdp):
        assert held == floor and kept


# ---------------------------------------------------------------------------
# launcher surface: mesh specs + staged transformer losses
# ---------------------------------------------------------------------------

def test_parse_mesh_spec():
    assert mesh_lib.parse_mesh_spec("2:4", device_count=8) == (2, 4)
    assert mesh_lib.parse_mesh_spec("8:1", device_count=8) == (8, 1)
    with pytest.raises(ValueError, match="DATA:MODEL"):
        mesh_lib.parse_mesh_spec("2x4", device_count=8)
    with pytest.raises(ValueError, match="DATA:MODEL"):
        mesh_lib.parse_mesh_spec("2:banana", device_count=8)
    with pytest.raises(ValueError, match=">= 1"):
        mesh_lib.parse_mesh_spec("0:4", device_count=8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        mesh_lib.parse_mesh_spec("4:4", device_count=8)


def test_build_mesh_from_spec(world):
    got = world(4).run(cases.launcher_mesh, "2:2")
    for rank, (dims, dp, model, groups) in enumerate(got):
        assert dims == {"data": 2, "model": 2} and dp == 2 and model == 2
        assert groups == [[rank % 2, 2 + rank % 2],
                          [2 * (rank // 2), 2 * (rank // 2) + 1]]
    host = world(4).run(cases.launcher_mesh, "host")
    assert all(r[:3] == ({"data": 4, "model": 1}, 4, 1) for r in host)
    bad = world(4).run(cases.launcher_mesh, "9:9")
    assert all("devices" in r for r in bad)


def test_train_cli_rejects_bad_mesh_specs(capsys):
    from repro_torch.launch import train
    for argv, words in [(["--mesh", "2x4"], "DATA:MODEL"),
                        (["--mesh", "64:64"], "devices"),
                        (["--fsdp"], "DATA:MODEL")]:
        with pytest.raises(SystemExit) as e:
            train.main(["--arch", "qwen2-1.5b", "--reduced", "--device",
                        "cpu", "--steps", "1", *argv])
        assert e.value.code == 2
        assert words in capsys.readouterr().err, argv


def test_make_staged_loss_matches_flat_forward(world):
    jcfg = jconfigs.get_reduced("qwen2-1.5b")
    _, plan = plans(8, 2, 2, 2, normalization="exact")
    jstaged = jsteps.make_staged_loss(jcfg, jnp.float32,
                                      remat_policy=plan.remat_policy)
    assert jstaged.num_layers == jcfg.num_periods
    assert steps.make_staged_loss(
        configs.get_reduced("qwen2-1.5b"), remat_policy=plan.remat_policy
    ).num_layers == jstaged.num_layers
    from repro.models import transformer
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: transformer.init_params(jcfg, k))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (8, 32)
                                    ).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (8, 32)
                                    ).astype(np.int32)}
    ref_plan = jengine.plan_mbs(8, micro_batch_size=2, normalization="exact")
    ref = jengine.CompiledScanExecutor(
        jsteps.make_loss_fn(jcfg, jnp.float32,
                            remat_policy=ref_plan.remat_policy),
        jsteps.make_optimizer(jcfg), ref_plan)
    g_ref, loss_ref = ref.gradients(jax.tree.map(jnp.asarray, params),
                                    ref_plan.device_split(batch))
    got = world(4).run(cases.staged_lm, 2, 2,
                       configs.get_reduced("qwen2-1.5b"), plan, params,
                       plan.split(batch))
    g, loss = same_on_every_rank(got, "staged qwen2")
    assert abs(loss - float(loss_ref)) <= 5e-6
    assert_close(g, g_ref, "staged qwen2 grads", atol=5e-5)


@pytest.mark.parametrize("arch,family", [
    ("mixtral-8x22b", "MoE"),
    ("qwen2-vl-72b", "VLM"),
    ("seamless-m4t-medium", "encoder-decoder"),
])
def test_make_staged_loss_rejects_unstageable_families(arch, family):
    with pytest.raises(ValueError, match="do not factor"):
        steps.make_staged_loss(configs.get_reduced(arch))
    with pytest.raises(ValueError, match="do not factor"):
        jsteps.make_staged_loss(jconfigs.get_reduced(arch))
