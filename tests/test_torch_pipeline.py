"""The port's input pipeline, Trainer, checkpoints and fault harness
against the JAX package's: ``tests/test_pipeline.py``'s cases on the tiny
tanh MLP, the checkpoint and Trainer cases of ``tests/test_supervisor.py``
that need no supervisor, and cross-package cases — checkpoints restore in
the other package bit for bit, both ``Pipeline``s yield the same splits,
and both packages' Trainer + Pipeline give the same losses at reduced
qwen2 from the reference's parameters.

Tolerances: fp32 gradients 2e-6 against the full-batch gradient (the
reference tests'), cross-package losses rtol 1e-5 and params atol/rtol
1e-5 (``test_torch_engine``'s); save → resume and checkpoint round trips
are bit for bit.
"""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import ToyDataset, make_executor, tiny_params  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.data import LMDataset as JLMDataset  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core.streaming import prefetch_iterator  # noqa: E402
from repro_torch.data import LMDataset, MBSLoader  # noqa: E402
from repro_torch.engine import exec_core, faults  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from test_torch_streaming import t_loss_fn  # noqa: E402

EXECUTOR_GRID = sorted(engine.EXECUTORS)
CPU = torch.device("cpu")
ARCH, SEQ = "qwen2-1.5b", 16


def _params():
    return weights.from_reference(
        jax.tree.map(np.asarray, tiny_params()), "cpu")


def _opt():
    return optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)


def _plan(mini=10, micro=4, **kw):
    return engine.plan_mbs(mini, micro_batch_size=micro, device="cpu", **kw)


def _pipe(plan, **kw):
    return engine.Pipeline(kw.pop("dataset", ToyDataset()), plan,
                           device="cpu", **kw)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _full_grad(params, batch):
    loss, _, g = exec_core.value_and_grad(
        lambda p: t_loss_fn(p, _torch_batch(batch)), params)
    return g, loss


def _max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# prefetch error propagation
# ---------------------------------------------------------------------------

def test_prefetch_propagates_worker_exception():
    def gen():
        yield 0
        yield 1
        raise ValueError("corrupt shard")

    it = prefetch_iterator(gen(), size=2)
    assert next(it) == 0 and next(it) == 1
    with pytest.raises(ValueError, match="corrupt shard"):
        next(it)


def test_prefetch_propagates_immediate_exception():
    def gen():
        raise RuntimeError("boom")
        yield  # pragma: no cover

    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch_iterator(gen(), size=1))


def test_pipeline_propagates_dataset_exception():
    class Bad:
        def batch(self, batch_size, seed):
            if seed >= 2:
                raise OSError("read failed")
            return {"x": np.zeros((batch_size, 4), np.float32)}

    pipe = _pipe(_plan(6, 2), dataset=Bad(), prefetch=2, stage=False)
    with pytest.raises(OSError, match="read failed"):
        list(pipe.batches(5))


# ---------------------------------------------------------------------------
# plan-aware splitting: ragged + weighted batches through the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_pipeline_ragged_batch_matches_full_batch(executor):
    plan = _plan()
    assert plan.normalization == "exact" and plan.pad == 2
    split = next(iter(_pipe(plan, prefetch=2).batches(1)))
    assert isinstance(split["x"], torch.Tensor)
    assert split["x"].shape == (3, 4, 8)
    params = _params()
    ex = engine.get_executor(executor)(t_loss_fn, optim.sgd(0.1), plan)
    g, loss = ex.gradients(params, split)
    ref, ref_loss = _full_grad(params, ToyDataset().batch(10, 0))
    assert _max_err(g, ref) < 2e-6
    assert abs(float(loss) - float(ref_loss)) < 2e-6


def test_mbs_loader_goes_through_planner():
    loader = MBSLoader(ToyDataset(), mini_batch_size=10, micro_batch_size=4,
                       prefetch=0)
    assert loader.plan.normalization == "exact"
    assert loader.plan.auto_normalization
    batches = list(loader(2))
    assert len(batches) == 2
    assert isinstance(batches[0]["x"], np.ndarray)
    assert batches[0]["x"].shape == (3, 4, 8)
    assert batches[0]["sample_weight"].sum() == 10


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_split_composes_dataset_sample_weight(executor):
    rng = np.random.default_rng(5)
    w = rng.uniform(0.25, 1.0, 10).astype(np.float32)
    batch = ToyDataset().batch(10, 0)
    batch["sample_weight"] = w
    plan = _plan(normalization="exact")
    split = plan.split(batch)
    sw = split["sample_weight"].reshape(-1)
    np.testing.assert_allclose(sw[:10], w, rtol=1e-6)  # weights kept
    np.testing.assert_array_equal(sw[10:], 0)  # padding masked
    params = _params()
    ex = engine.get_executor(executor)(t_loss_fn, optim.sgd(0.1), plan)
    g, loss = ex.gradients(params, plan.device_split(batch, "cpu"))
    ref, ref_loss = _full_grad(params, batch)
    assert _max_err(g, ref) < 2e-6
    assert abs(float(loss) - float(ref_loss)) < 2e-6


def test_split_rejects_nonuniform_weights_in_paper_mode():
    batch = ToyDataset().batch(12, 0)
    batch["sample_weight"] = np.linspace(0.2, 1.0, 12).astype(np.float32)
    plan = _plan(12, 4)
    assert plan.normalization == "paper"
    with pytest.raises(ValueError, match="exact"):
        plan.split(batch)
    batch["sample_weight"] = np.full(12, 0.5, np.float32)
    assert plan.split(batch)["x"].shape == (3, 4, 8)


# ---------------------------------------------------------------------------
# streaming executor: no per-micro-batch host sync
# ---------------------------------------------------------------------------

def test_streaming_step_returns_device_metrics():
    plan = _plan(8, 4)
    ex = engine.StreamingExecutor(t_loss_fn, optim.sgd(0.1), plan)
    params = _params()
    _, _, m = ex.step(params, optim.sgd(0.1).init(params),
                      ToyDataset().batch(8, 0))
    assert isinstance(m["loss"], torch.Tensor) and m["loss"].dim() == 0
    assert isinstance(m["grad_norm"], torch.Tensor)


def test_streaming_step_split_matches_step():
    plan = _plan()
    opt = optim.sgd(0.1, momentum=0.9)
    ex = engine.StreamingExecutor(t_loss_fn, opt, plan)
    params = _params()
    batch = ToyDataset().batch(10, 0)
    p1, s1, m1 = ex.step(params, opt.init(params), dict(batch))
    p2, s2, m2 = ex.step_split(params, opt.init(params),
                               plan.device_split(batch, "cpu"))
    assert _equal(p1, p2) and _equal(s1, s2)
    assert torch.equal(m1["loss"], m2["loss"])


# ---------------------------------------------------------------------------
# trainer: save -> resume bitwise round trip
# ---------------------------------------------------------------------------

def _trainer(tmp_path, subdir, *, executor="compiled", prefetch=2, **kw):
    plan = _plan()
    ex = engine.get_executor(executor)(t_loss_fn, _opt(), plan)
    return engine.Trainer(ex.step_split, _pipe(plan, prefetch=prefetch),
                          ckpt_dir=str(tmp_path / subdir), log_fn=None, **kw)


def _fit(tmp_path, num_steps, *, ckpt_every=0, resume=False, subdir="a",
         executor="compiled"):
    trainer = _trainer(tmp_path, subdir, executor=executor,
                       ckpt_every=ckpt_every)
    params, opt_state = _params(), _opt().init(_params())
    start = 0
    if resume:
        restored = trainer.restore(params, opt_state)
        assert restored is not None
        params, opt_state, start = restored
    return trainer.fit(params, opt_state, num_steps, start_step=start)


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_save_resume_matches_uninterrupted_run_bitwise(tmp_path, executor):
    p_full, s_full, _ = _fit(tmp_path, 6, subdir="full", executor=executor)
    _fit(tmp_path, 3, ckpt_every=3, subdir="resumed", executor=executor)
    p_res, s_res, _ = _fit(tmp_path, 6, resume=True, subdir="resumed",
                           executor=executor)
    assert _equal(p_full, p_res)
    assert _equal(s_full, s_res)


def test_trainer_final_checkpoint_and_restore_placement(tmp_path):
    _, _, last = _fit(tmp_path, 4, subdir="final")
    assert ckpt_lib.latest_step(str(tmp_path / "final")) == 4
    trainer = _trainer(tmp_path, "final", prefetch=0)
    params, opt_state, step = trainer.restore(_params(), _opt().init(
        _params()))
    assert step == 4
    assert all(isinstance(x, torch.Tensor) and x.device == CPU
               for x in tree.leaves((params, opt_state)))
    assert opt_state["step"].dtype == torch.int32 and int(
        opt_state["step"]) == 4
    assert "loss" in last and isinstance(last["loss"], float)
    assert [r["op"] for r in trainer.ckpt_log] == ["restore"]


def test_trainer_restores_legacy_params_only_checkpoint(tmp_path):
    params = _params()
    ckpt_lib.save(str(tmp_path), 7, params)
    trainer = _trainer(tmp_path, "", prefetch=0)
    fresh = _opt().init(params)
    p, s, step = trainer.restore(params, fresh)
    assert step == 7
    assert _equal(p, params)
    assert s is fresh


def test_trainer_fit_past_end_does_not_mislabel_checkpoint(tmp_path):
    _fit(tmp_path, 4, subdir="past")
    trainer = _trainer(tmp_path, "past")
    params, opt_state, start = trainer.restore(_params(),
                                               _opt().init(_params()))
    trainer.fit(params, opt_state, 2, start_step=start)  # already past 2
    assert ckpt_lib.latest_step(str(tmp_path / "past")) == 4
    assert not os.path.exists(str(tmp_path / "past" / "ckpt_00000002.npz"))


def test_trainer_fit_finalizes_pipeline_stats():
    plan = _plan()
    ex = engine.CompiledScanExecutor(t_loss_fn, optim.sgd(0.1), plan)
    pipe = _pipe(plan, prefetch=2)
    trainer = engine.Trainer(ex.step_split, pipe, log_fn=None)
    trainer.fit(_params(), optim.sgd(0.1).init(_params()), 3)
    assert pipe.stats.batches == 3
    assert pipe.stats.elapsed_s > 0  # finalized by exhaustion, not GC
    # every step read back once, in order, with its host clock
    assert [h["step"] for h in trainer.history] == [0, 1, 2]
    clocks = [h["readback_s"] for h in trainer.history]
    assert clocks == sorted(clocks)


def test_pipeline_stats_track_input_wait():
    pipe = _pipe(_plan(8, 4), prefetch=2, stage=False)
    n = sum(1 for _ in pipe.batches(5))
    assert n == 5
    assert pipe.stats.batches == 5
    assert 0.0 <= pipe.stats.input_wait_fraction <= 1.0
    assert pipe.stats.elapsed_s > 0


def test_pipeline_seeding_is_step_indexed():
    pipe = _pipe(_plan(6, 3), prefetch=0, stage=False)
    full = list(pipe.batches(4))
    tail = list(pipe.batches(2, start=2))
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(pipe.rebatch(3)["x"], full[3]["x"])


def test_pipeline_mesh_waits_for_data_parallelism():
    """Data parallelism is ported (ROADMAP.md queue 1 item 11): with
    a mesh each rank stages its own block of the sample dim — the blocks
    of all ranks are the whole split, retries and rebatches included —
    and ``mesh=`` with ``sharding=`` is refused."""
    from repro_torch.launch import mesh as mesh_lib
    plan = _plan(16, 8, mesh={"data": 2, "model": 1})
    whole = next(iter(_pipe(plan).batches(1)))
    blocks = [_pipe(plan, mesh=mesh_lib.make_host_mesh(2, rank=r))
              for r in range(2)]
    for k, v in whole.items():
        got = [next(iter(p.batches(1)))[k] for p in blocks]
        assert got[0].shape[1] == plan.local_micro
        assert torch.equal(torch.cat(got, dim=1), v)
        assert torch.equal(blocks[1].rebatch(0)[k], got[1])
    with pytest.raises(ValueError, match="not both"):
        _pipe(plan, mesh=mesh_lib.make_host_mesh(2),
              sharding=lambda split: split)


# ---------------------------------------------------------------------------
# checkpoints and faults without the supervisor (tests/test_supervisor.py)
# ---------------------------------------------------------------------------

def _tree():
    params = _params()
    return {"params": params, "opt_state": _opt().init(params)}


def test_crc_detects_silent_payload_corruption(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 1, _tree())
    ckpt_lib.save(d, 2, _tree())
    path = os.path.join(d, "ckpt_00000002.npz")
    data = dict(np.load(path))
    data[list(data)[0]] = data[list(data)[0]] + 1.0
    with open(path, "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ckpt_lib.CheckpointCorruptError):
        ckpt_lib.restore(d, _tree(), 2)
    restored = _trainer(tmp_path, "").restore(_params(),
                                              _opt().init(_params()))
    assert restored is not None and restored[2] == 1


def test_orphan_npz_does_not_break_latest_step(tmp_path):
    d = str(tmp_path)
    ckpt_lib.save(d, 3, _tree())
    with open(os.path.join(d, "ckpt_00000007.npz"), "wb") as f:
        np.savez(f, junk=np.zeros(3))
    assert ckpt_lib.committed_steps(d) == [3]
    assert ckpt_lib.latest_step(d) == 3
    assert _equal(ckpt_lib.restore(d, _tree()), _tree())


def test_keep_last_k_rotation(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3, 4):
        ckpt_lib.save(d, step, _tree(), keep=2)
    assert ckpt_lib.committed_steps(d) == [3, 4]
    assert sorted(os.listdir(d)) == [
        "ckpt_00000003.json", "ckpt_00000003.npz",
        "ckpt_00000004.json", "ckpt_00000004.npz"]


def test_trainer_ckpt_keep_and_corrupt_skip(tmp_path):
    trainer = _trainer(tmp_path, "", ckpt_every=1, ckpt_keep=3)
    trainer.fit(_params(), _opt().init(_params()), 5)
    d = str(tmp_path)
    assert ckpt_lib.committed_steps(d) == [3, 4, 5]
    os.remove(os.path.join(d, "ckpt_00000005.json"))
    restored = trainer.restore(_params(), _opt().init(_params()))
    assert restored is not None and restored[2] == 4


def test_torn_write_is_invisible_then_resume_matches_clean(tmp_path):
    d = str(tmp_path / "ckpt")
    trainer = _trainer(tmp_path, "ckpt", ckpt_every=1)
    with faults.inject(faults.FaultPlan(faults.torn_write_at(2))) as fp:
        with pytest.raises(faults.InjectedCrash):
            trainer.fit(_params(), _opt().init(_params()), 5)
    assert fp.fired == [("torn_write", 2)]
    assert os.path.exists(os.path.join(d, "ckpt_00000002.npz"))
    assert not os.path.exists(os.path.join(d, "ckpt_00000002.json"))
    assert ckpt_lib.committed_steps(d) == [1]
    p_got, s_got, _ = _fit(tmp_path, 5, resume=True, subdir="ckpt")
    p_ref, s_ref, _ = _fit(tmp_path, 5, subdir="clean")
    assert _equal(p_got, p_ref) and _equal(s_got, s_ref)


def test_ckpt_io_fault_touches_no_file(tmp_path):
    d = str(tmp_path)
    with faults.inject(faults.FaultPlan(faults.ckpt_io_at(1))):
        with pytest.raises(faults.InjectedIOError):
            ckpt_lib.save(d, 1, _tree())
        ckpt_lib.save(d, 2, _tree())  # one charge: the next save commits
    assert sorted(os.listdir(d)) == ["ckpt_00000002.json",
                                     "ckpt_00000002.npz"]


def test_worker_fault_absorbed_by_pipeline_retry():
    plan = _plan(8, 4)
    clean = list(_pipe(plan, prefetch=2).batches(4))
    pipe = _pipe(plan, prefetch=2, retry_backoff_s=0.0)
    with faults.inject(faults.FaultPlan(faults.worker_at(2))) as fp:
        got = list(pipe.batches(4))
    assert fp.fired == [("worker", 2)] and pipe.stats.retries == 1
    for a, b in zip(got, clean):
        assert _equal(a, b)
    # a persistent fault exhausts the bounded retries and propagates
    with faults.inject(faults.FaultPlan(faults.worker_at(1, times=9))):
        with pytest.raises(faults.TransientWorkerError):
            list(_pipe(plan, prefetch=2, retries=2,
                       retry_backoff_s=0.0).batches(3))


def test_nan_fault_poisons_one_micro_batch():
    plan = _plan(8, 4)
    with faults.inject(faults.FaultPlan(faults.nan_at(1, micro=1))):
        got = list(_pipe(plan, prefetch=0, stage=False).batches(3))
    w = [b["sample_weight"] for b in got]
    assert np.isnan(w[1][1, 0]) and np.isfinite(np.delete(w[1], 4)).all()
    assert np.isfinite(w[0]).all() and np.isfinite(w[2]).all()


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_oom_fault_at_dispatch(executor):
    plan = _plan(8, 4)
    ex = engine.get_executor(executor)(t_loss_fn, _opt(), plan)
    split = plan.device_split(ToyDataset().batch(8, 0), "cpu")
    params = _params()
    with faults.inject(faults.FaultPlan(faults.oom_at(1))) as fp:
        params, state, _ = ex.step_split(params, _opt().init(params), split)
        with pytest.raises(torch.OutOfMemoryError) as info:
            ex.step_split(params, state, split)
    assert fp.fired == [("oom", 1)]
    assert faults.classify(info.value) == "oom"


def test_fault_taxonomy_classification():
    assert faults.classify(faults.injected_oom()) == "oom"
    assert faults.classify(RuntimeError("RESOURCE_EXHAUSTED: oom")) == "oom"
    assert faults.classify(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom"
    assert faults.classify(faults.TransientWorkerError("x")) == "transient"
    assert faults.classify(faults.InjectedIOError("x")) == "transient"
    assert faults.classify(OSError("disk")) == "transient"
    assert faults.classify(faults.InjectedCrash("x")) == "crash"
    assert faults.classify(ValueError("bug")) == "fatal"
    assert isinstance(faults.InjectedIOError("x"), OSError)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultSpec("bit_flip")


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, jtransformer.init_params(
        jconfigs.get_reduced(ARCH), jax.random.PRNGKey(0)))


def _ref_state(ref_params):
    """A reference-shaped SGD-m state with non-zero momentum."""
    rng = np.random.default_rng(7)
    mom = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(x.dtype),
                       ref_params)
    return {"params": ref_params,
            "opt_state": {"mom": mom, "step": np.asarray(3, np.int32)}}


def _manifest(d, step):
    import json
    with open(os.path.join(d, f"ckpt_{step:08d}.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(tmp_path, ref_params):
    state = _ref_state(ref_params)
    jckpt.save(str(tmp_path / "ref"), 2, jax.tree.map(jnp.asarray, state))
    want = weights.from_reference(state, "cpu")
    template = {"params": weights.from_reference(ref_params, "cpu"),
                "opt_state": optim.sgd(0.1, 0.9).init(
                    weights.from_reference(ref_params, "cpu"))}
    got = ckpt_lib.restore(str(tmp_path / "ref"), template, 2)
    assert _equal(got, want)
    # the same tree saved by the port: same keys, same stored bytes
    ckpt_lib.save(str(tmp_path / "port"), 2, want)
    jm, tm = _manifest(str(tmp_path / "ref"), 2), _manifest(
        str(tmp_path / "port"), 2)
    assert jm["keys"] == tm["keys"] and jm["crc"] == tm["crc"]


def test_port_checkpoint_restores_in_the_reference(tmp_path, ref_params):
    state = weights.from_reference(_ref_state(ref_params), "cpu")
    ckpt_lib.save(str(tmp_path), 5, state)
    template = jax.tree.map(jnp.asarray, _ref_state(ref_params))
    template["opt_state"]["mom"] = jax.tree.map(jnp.zeros_like,
                                                template["params"])
    got = jckpt.restore(str(tmp_path), template, 5)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(_ref_state(ref_params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(got["opt_state"]["step"]) == 3


def test_bf16_leaf_is_refused_by_both_packages(tmp_path):
    x = np.linspace(-2, 2, 6).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16)}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16)}
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    ckpt_lib.save(str(tmp_path / "port"), 1, ttree)
    assert _manifest(str(tmp_path / "ref"), 1)["crc"] == _manifest(
        str(tmp_path / "port"), 1)["crc"]  # the same raw bf16 bytes
    for d in ("ref", "port"):
        with pytest.raises(ValueError):
            jckpt.restore(str(tmp_path / d), jtree, 1)
        with pytest.raises(ValueError, match="ROADMAP.md queue 3"):
            ckpt_lib.restore(str(tmp_path / d), ttree, 1)


def test_pipelines_yield_the_same_splits():
    jplan = jengine.plan_mbs(10, micro_batch_size=4)
    plan = _plan()
    jds, ds = JLMDataset(512, SEQ, seed=0), LMDataset(512, SEQ, seed=0)
    want = list(jengine.Pipeline(jds, jplan, prefetch=2, stage=False)
                .batches(3, start=2))
    host = list(_pipe(plan, dataset=ds, prefetch=2, stage=False)
                .batches(3, start=2))
    staged = list(_pipe(plan, dataset=ds, prefetch=2).batches(3, start=2))
    assert len(want) == len(host) == len(staged) == 3
    for w, h, s in zip(want, host, staged):
        assert sorted(w) == sorted(h) == sorted(s)
        for k in w:
            np.testing.assert_array_equal(h[k], w[k])
            np.testing.assert_array_equal(s[k].numpy(), w[k])


@pytest.mark.parametrize("executor", ["compiled", "streaming", "flat"])
def test_trainer_pipeline_trajectory_matches_reference(ref_params, executor):
    mini, n_steps = 8, 3
    jplan = jengine.plan_mbs(mini, num_microbatches=4, remat_policy="none")
    plan = engine.plan_mbs(mini, num_microbatches=4, remat_policy="none",
                           device="cpu")
    jopt = joptim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    topt = optim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    jex = make_executor(executor, jsteps.make_loss_fn(
        jconfigs.get_reduced(ARCH), dtype=jnp.float32, remat_policy="none"),
        jopt, jplan, donate=False)
    tex = engine.get_executor(executor)(steps.make_loss_fn(
        configs.get_reduced(ARCH), dtype=torch.float32,
        remat_policy="none"), topt, plan)
    want = []
    jtrainer = jengine.Trainer(
        jex.step_split, jengine.Pipeline(JLMDataset(512, SEQ, seed=0),
                                         jplan, prefetch=2),
        log_every=1, log_fn=lambda s, m, t: want.append(m["loss"]))
    jp = jax.tree.map(jnp.asarray, ref_params)
    jp, js, _ = jtrainer.fit(jp, jopt.init(jp), n_steps)

    trainer = engine.Trainer(
        tex.step_split, _pipe(plan, dataset=LMDataset(512, SEQ, seed=0),
                              prefetch=2), log_fn=None)
    tp = weights.from_reference(ref_params, "cpu")
    ts = topt.init(tp)
    if executor == "flat":
        tp, ts = tex.prepare(tp, ts)
    tp, ts, _ = trainer.fit(tp, ts, n_steps)
    np.testing.assert_allclose([h["loss"] for h in trainer.history], want,
                               rtol=1e-5, atol=0)
    for got, ref in ((tp, jp), (ts["mom"], js["mom"])):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=1e-5, rtol=1e-5)


LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--seq", str(SEQ),
          "--mini-batch", "8", "--microbatches", "4", "--log-every", "1"]


@pytest.mark.parametrize("executor", ["flat", "streaming"])
def test_launcher_resume_reproduces_uninterrupted_run(tmp_path, executor):
    argv = LAUNCH + ["--executor", executor]
    d = str(tmp_path / "ckpt")
    full = train.main(argv + ["--steps", "4"])
    first = train.main(argv + ["--steps", "2", "--ckpt-dir", d,
                               "--ckpt-every", "2"])
    resumed = train.main(argv + ["--steps", "4", "--ckpt-dir", d,
                                 "--resume"])
    assert [r["op"] for r in resumed["checkpoints"]] == ["restore", "save"]
    losses = [h["loss"] for h in first["history"] + resumed["history"]]
    assert losses == [h["loss"] for h in full["history"]]
    assert _equal(resumed["params"], full["params"])
    assert _equal(resumed["opt_state"], full["opt_state"])
    assert 0.0 <= resumed["pipeline"].input_wait_fraction <= 1.0


def test_launcher_resume_needs_a_ckpt_dir():
    with pytest.raises(SystemExit):
        train.main(LAUNCH + ["--resume"])


# ---------------------------------------------------------------------------
# memory: no tensor waits for the cyclic garbage collector
# ---------------------------------------------------------------------------

def _tensors_in_cyclic_garbage(fn) -> int:
    """Run ``fn`` with the cyclic collector off, then count the tensors
    that only the collector could free: each would hold its memory (a
    whole parameter tree, at full width) until a collection happens to
    run."""
    import gc
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        fn()
        gc.collect()
        return sum(isinstance(x, torch.Tensor) for x in gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_a_step_leaves_no_tensor_in_cyclic_garbage(executor):
    plan = _plan()
    ex = engine.get_executor(executor)(t_loss_fn, _opt(), plan)
    split = plan.device_split(ToyDataset().batch(10, 0), "cpu")

    def two_steps():
        params, state = _params(), _opt().init(_params())
        for _ in range(2):
            params, state, _ = ex.step_split(params, state, split)
        tree.map(torch.zeros_like, params)

    assert _tensors_in_cyclic_garbage(two_steps) == 0


def test_fit_leaves_no_tensor_in_cyclic_garbage(tmp_path):
    def fit():
        _fit(tmp_path, 3, ckpt_every=1, subdir="gc", executor="streaming")

    assert _tensors_in_cyclic_garbage(fit) == 0


# ---------------------------------------------------------------------------
# ownership: the launcher keeps no reference to the initial state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "executor,extra",
    [("compiled", []), ("fused", []), ("streaming", []),
     ("compiled", ["--supervise"]), ("fused", ["--supervise"]),
     ("streaming", ["--supervise"])],
    ids=["compiled", "fused", "streaming", "compiled-supervise",
         "fused-supervise", "streaming-supervise"])
def test_launcher_frees_the_initial_state_after_the_first_step(
        monkeypatch, executor, extra):
    """Under the executors whose update makes new trees, every initial
    param and momentum leaf is dead once the first step has returned: the
    launcher hands the initial state to the Trainer (or the Supervisor,
    whose anchor is a host copy) and keeps no name for it (at full
    qwen2-1.5b width those trees are 11.5 GiB)."""
    import weakref
    seen = {"calls": 0, "refs": [], "alive_at_step_1": None}
    real_make_build = train.make_build

    def watch(step_fn):
        def step(params, opt_state, batch):
            if seen["calls"] == 0:  # the initial state, as fit got it
                seen["refs"] = [weakref.ref(t) for t in tree.leaves(
                    (params, opt_state["mom"]))]
            elif seen["calls"] == 1:
                seen["alive_at_step_1"] = sum(
                    r() is not None for r in seen["refs"])
            seen["calls"] += 1
            return step_fn(params, opt_state, batch)
        return step

    def make_build(*args, **kw):
        build = real_make_build(*args, **kw)

        def watched(plan):
            executor, step_fn, pipeline = build(plan)
            return executor, watch(step_fn), pipeline
        return watched

    monkeypatch.setattr(train, "make_build", make_build)
    train.main(LAUNCH + ["--executor", executor, "--steps", "2"] + extra)
    assert seen["calls"] == 2 and len(seen["refs"]) > 0
    assert seen["alive_at_step_1"] == 0, (
        f"{seen['alive_at_step_1']} of {len(seen['refs'])} initial param "
        f"and momentum leaves are still alive after the first step")


@pytest.mark.parametrize("executor", ["flat", "streaming"])
def test_supervised_launcher_gives_up_with_the_exit_codes(executor):
    """``--supervise`` on the CPU: a NaN under ``--on-nan halt`` exits 44
    (NaNHalt); an OOM with ``--max-restarts 0`` exits 41
    (RestartBudgetExceeded); a NaN under the default policy is retried
    and the run equals the unfaulted one."""
    argv = LAUNCH + ["--executor", executor, "--steps", "3", "--supervise"]
    for spec, extra, code in ((faults.nan_at(1), ["--on-nan", "halt"], 44),
                              (faults.oom_at(1), ["--max-restarts", "0"],
                               41)):
        with faults.inject(faults.FaultPlan(spec)):
            with pytest.raises(SystemExit) as info:
                train.main(argv + extra)
        assert info.value.code == code
    clean = train.main(argv)
    with faults.inject(faults.FaultPlan(faults.nan_at(1))):
        retried = train.main(argv)
    [rec] = retried["supervisor"]["faults"]
    assert rec["kind"] == "nonfinite" and rec["action"].startswith("retried")
    assert [h["loss"] for h in retried["history"]] == \
        [h["loss"] for h in clean["history"]]
    assert _equal((retried["params"], retried["opt_state"]),
                  (clean["params"], clean["opt_state"]))
