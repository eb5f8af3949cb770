"""The port's engine against the JAX package's: ``FlatSpec`` layout,
``MBSPlan`` fields, the executors' gradients and steps, and the launcher
loop's loss trajectory, on reduced qwen2 in fp32 with the reference's
parameters and the same numpy batches.

Plans are pure arithmetic and must be equal. Gradients, params and
optimizer state agree to atol 1e-5 / rtol 1e-5 (XLA and torch order the
matmul sums differently); Pallas kernels run in interpret mode.
"""
import argparse
import dataclasses
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_executor  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import LMDataset as JLMDataset  # noqa: E402
from repro.engine import flat as jflat  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.data import LMDataset  # noqa: E402
from repro_torch.engine import flat  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402

ATOL = RTOL = 1e-5
SEQ = 16
ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, jtransformer.init_params(
        jconfigs.get_reduced(ARCH), jax.random.PRNGKey(0)))


def _close(got, want, what):
    got_l = [np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                        else x, np.float32) for x in tree.leaves(got)]
    want_l = [np.asarray(jnp.asarray(x, jnp.float32))
              for x in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what}: leaf {i}")


# ---------------------------------------------------------------------------
# FlatSpec
# ---------------------------------------------------------------------------

def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"emb": f32(7, 5),
            "blocks": ({"w": f32(3, 11), "b": f32(11)},
                       {"w": f32(13), "b": f32(2, 2, 3)}),
            "head": f32(1)}


def _bf16_tree(t):
    """Cast the trees' ``b`` leaves to bf16 in both packages."""
    jt = jax.tree.map(jnp.asarray, t)
    jt["blocks"] = tuple(dict(b, b=b["b"].astype(jnp.bfloat16))
                         for b in jt["blocks"])
    tt = weights.from_reference(t, "cpu")
    tt["blocks"] = tuple(dict(b, b=b["b"].to(torch.bfloat16))
                         for b in tt["blocks"])
    return jt, tt


@pytest.mark.parametrize("which", ["qwen2-reduced", "mixed-dtypes"])
def test_flat_spec_matches_reference(ref_params, which):
    if which == "qwen2-reduced":
        jt = jax.tree.map(jnp.asarray, ref_params)
        tt = weights.from_reference(ref_params, "cpu")
    else:
        jt, tt = _bf16_tree(_mixed_tree())
    jspec, spec = jflat.FlatSpec.for_tree(jt), flat.FlatSpec.for_tree(tt)
    assert spec.bucket_sizes == jspec.bucket_sizes
    assert [str(d).replace("torch.", "") for d in spec.bucket_dtypes] == \
        [jnp.dtype(d).name for d in jspec.bucket_dtypes]
    assert [(s.bucket, s.offset, s.size, s.shape) for s in spec.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in jspec.slots]
    for got, want in zip(spec.flatten(tt), jspec.flatten(jt)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def test_flat_views_alias_the_buffers():
    _, tt = _bf16_tree(_mixed_tree(1))
    spec = flat.FlatSpec.for_tree(tt)
    assert spec.buffers_of(tt) is None  # separate tensors, not flat views
    bufs, views = spec.as_flat(tt)
    assert spec.buffers_of(views) == bufs
    assert spec.as_flat(views)[0] == bufs  # already flat: no copy
    for a, b in zip(tree.leaves(views), tree.leaves(tt)):
        assert torch.equal(a, b)
    for b in bufs:  # writes through the buffers show in the views
        b.add_(1.0)
    for a, b in zip(tree.leaves(views), tree.leaves(tt)):
        assert torch.equal(a, b + 1.0)


# ---------------------------------------------------------------------------
# MBSPlan
# ---------------------------------------------------------------------------

JAX_ONLY_DEFAULTS = {"data_parallel": 1, "calibrated": False,
                     "correction": None, "pipeline_stages": 1, "unroll": 1,
                     "remat_micro_step": False}

PLAN_SWEEP = list(itertools.product(
    [7, 16, 64],  # mini-batch
    [(None, None), (3, None), (None, 4)],  # (micro, num_microbatches) pins
    [64 * 2 ** 20, 2 ** 30, 16 * 2 ** 30, 80 * 10 ** 9],  # budget
    [None, "auto", "dots", "full"],  # remat policy
    [False, True],  # fused_update
    ["paper", "exact"],
))


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_plans_equal_reference(reduced, opt_name):
    get = configs.get_reduced if reduced else configs.get
    jget = jconfigs.get_reduced if reduced else jconfigs.get
    cfg, jcfg = get(ARCH), jget(ARCH)
    seq = 64 if reduced else 1024
    topt = (optim.sgd(0.1, momentum=0.9) if opt_name == "sgd"
            else optim.adam(1e-3))
    jopt = (joptim.sgd(0.1, momentum=0.9) if opt_name == "sgd"
            else joptim.adam(1e-3))
    fields = [f.name for f in dataclasses.fields(engine.MBSPlan)]
    for mini, (micro, nmb), budget, policy, fused, norm in PLAN_SWEEP:
        kw = dict(micro_batch_size=micro, num_microbatches=nmb,
                  model_cfg=None if micro == 3 and reduced else cfg,
                  seq_len=seq, budget_bytes=budget, normalization=norm,
                  remat_policy=policy, remat=not reduced)
        jkw = dict(kw, model_cfg=None if kw["model_cfg"] is None else jcfg)
        got = engine.plan_mbs(mini, device="cpu", **kw,
                              **optim.memory_model_kw(topt, fused=fused))
        want = jengine.plan_mbs(mini, **jkw,
                                **joptim.memory_model_kw(jopt, fused=fused))
        case = (mini, micro, nmb, budget, policy, fused, norm)
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if f == "accum_dtype":
                g, w = str(g).replace("torch.", ""), jnp.dtype(w).name
            assert g == w, f"{f}: {g!r} != {w!r} for {case}"
        for f, default in JAX_ONLY_DEFAULTS.items():
            assert getattr(want, f) == default, (f, case)
        assert want.local_micro == want.micro_batch_size
        assert got.describe() == want.describe(), case


def test_memory_model_kw_counts_optimizer_slots():
    assert optim.memory_model_kw(optim.sgd(0.1)) == {
        "opt_slots": 0, "fused_update": False}
    assert optim.memory_model_kw(optim.sgd(0.1, momentum=0.9),
                                 fused=True) == {"opt_slots": 1,
                                                 "fused_update": True}
    assert optim.memory_model_kw(optim.adamw(0.1))["opt_slots"] == 2


def test_default_budget_needs_a_card_or_a_caller():
    with pytest.raises(ValueError, match="pass budget_bytes"):
        engine.plan_mbs(16, model_cfg=configs.get(ARCH), seq_len=1024,
                        device="cpu")
    # a pinned micro size needs no budget
    plan = engine.plan_mbs(16, num_microbatches=4, device="cpu")
    assert plan.micro_batch_size == 4


# ---------------------------------------------------------------------------
# executors: gradients and one step against the JAX executors
# ---------------------------------------------------------------------------

def _opts(kind):
    if kind == "sgd":
        return joptim.sgd(0.05, 0.9, 5e-4), optim.sgd(0.05, 0.9, 5e-4)
    if kind == "sgd-clip":
        return (joptim.clip_by_global_norm(joptim.sgd(0.05, 0.9, 5e-4,
                                                      nesterov=True), 0.05),
                optim.clip_by_global_norm(optim.sgd(0.05, 0.9, 5e-4,
                                                    nesterov=True), 0.05))
    # eps well above rounding noise: the key bias's true gradient is 0 (the
    # softmax ignores a shift shared by all keys), and Adam would scale the
    # two frameworks' different rounding noise there up to a full ±lr step
    return (joptim.adamw(1e-3, eps=1e-4, weight_decay=1e-2),
            optim.adamw(1e-3, eps=1e-4, weight_decay=1e-2))


EXEC_CASES = {  # name: (mini-batch, pinned micro, optimizer)
    "uniform": (8, 2, "sgd"),
    "ragged": (10, 4, "sgd"),  # 3 x 4, pad 2 → exact mode auto-selected
    "clipped": (8, 4, "sgd-clip"),
    "adamw": (10, 4, "adam"),
}


def _setup(ref_params, case, executor):
    mini, micro, opt_kind = EXEC_CASES[case]
    jopt, topt = _opts(opt_kind)
    jplan = jengine.plan_mbs(mini, micro_batch_size=micro,
                             remat_policy="none")
    plan = engine.plan_mbs(mini, micro_batch_size=micro, remat_policy="none",
                           device="cpu")
    assert plan.normalization == jplan.normalization
    assert plan.normalization == ("exact" if case in ("ragged", "adamw")
                                  else "paper")
    jex = make_executor(executor, jsteps.make_loss_fn(
        jconfigs.get_reduced(ARCH), dtype=jnp.float32, remat_policy="none"),
        jopt, jplan, donate=False)
    tex = engine.get_executor(executor)(steps.make_loss_fn(
        configs.get_reduced(ARCH), dtype=torch.float32, remat_policy="none"),
        topt, plan)
    batch = LMDataset(512, SEQ, seed=3).batch(mini, 0)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tp = weights.from_reference(ref_params, "cpu")
    return (jex, jopt, jp, jplan.device_split(batch),
            tex, topt, tp, plan.device_split(batch, "cpu"))


@pytest.mark.parametrize("executor", ["fused", "flat"])
@pytest.mark.parametrize("case", ["uniform", "ragged"])
def test_gradients_match_reference(ref_params, executor, case):
    jex, _, jp, jsplit, tex, _, tp, split = _setup(ref_params, case,
                                                   executor)
    jgrads, jloss = jex.gradients(jp, jsplit)
    grads, loss = tex.gradients(tp, split)
    _close(grads, jgrads, f"{executor}/{case} grads")
    _close(loss, jloss, f"{executor}/{case} loss")


@pytest.mark.parametrize("executor", ["compiled", "fused", "flat"])
@pytest.mark.parametrize("case", list(EXEC_CASES))
def test_step_matches_reference(ref_params, executor, case):
    jex, jopt, jp, jsplit, tex, topt, tp, split = _setup(ref_params, case,
                                                         executor)
    jnew, jstate, jm = jex.step_split(jp, jopt.init(jp), jsplit)
    new, state, m = tex.step_split(tp, topt.init(tp), split)
    _close(new, jnew, f"{executor}/{case} params")
    _close(state, jstate, f"{executor}/{case} optimizer state")
    for k in ("loss", "grad_norm"):
        _close(m[k], jm[k], f"{executor}/{case} {k}")
    if executor == "flat":  # state stays flat, and was written in place
        spec = flat.FlatSpec.for_tree(new)
        assert spec.buffers_of(new) is not None
        new2, state2, _ = tex.step_split(new, state, split)
        assert spec.buffers_of(new2) == spec.buffers_of(new)


# ---------------------------------------------------------------------------
# the launcher's loop
# ---------------------------------------------------------------------------

def test_train_loop_trajectory_matches_reference(ref_params):
    mini, steps_n = 8, 3
    jplan = jengine.plan_mbs(mini, num_microbatches=4, remat_policy="none")
    jopt = joptim.sgd(0.05, momentum=0.9, weight_decay=5e-4)
    jex = make_executor("flat", jsteps.make_loss_fn(
        jconfigs.get_reduced(ARCH), dtype=jnp.float32, remat_policy="none"),
        jopt, jplan, donate=False)
    jds = JLMDataset(512, SEQ, seed=0)
    jp = jax.tree.map(jnp.asarray, ref_params)
    js = jopt.init(jp)
    want = []
    for step in range(steps_n):
        jp, js, jm = jex.step_split(jp, js, jplan.device_split(
            jds.batch(mini, step)))
        want.append(float(jm["loss"]))

    args = train.build_parser().parse_args([
        "--arch", ARCH, "--reduced", "--mini-batch", str(mini),
        "--microbatches", "4", "--executor", "flat", "--seq", str(SEQ),
        "--remat-policy", "none", "--device", "cpu"])
    cfg = configs.get_reduced(ARCH)
    opt = train.default_optimizer(args)
    device = torch.device("cpu")
    plan = train.build_plan(cfg, args, opt, device)
    ex, step_fn, pipeline = train.make_build(
        cfg, args, LMDataset(512, SEQ, seed=0), opt, device)(plan)
    params = weights.from_reference(ref_params, "cpu")
    params, state = ex.prepare(params, opt.init(params))
    trainer = engine.Trainer(step_fn, pipeline, log_every=0)
    trainer.fit(params, state, steps_n)
    np.testing.assert_allclose([h["loss"] for h in trainer.history], want,
                               rtol=1e-5, atol=0)


def test_schedules_match_reference():
    pairs = [(joptim.constant(0.1), optim.constant(0.1)),
             (joptim.linear_decay(0.1, 10, 0.2), optim.linear_decay(0.1, 10, 0.2)),
             (joptim.cosine_decay(0.1, 10, warmup=3, min_factor=0.1),
              optim.cosine_decay(0.1, 10, warmup=3, min_factor=0.1))]
    for jsched, sched in pairs:
        for step in range(0, 13):
            got = sched(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(
                float(got), float(jsched(jnp.asarray(step, jnp.int32))),
                rtol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_engine.py case for case: the planner's geometry, the four
# executors against the full batch and the no-MBS baseline, the launcher's
# ragged path and build_train_step — each in both packages on the same
# numpy inputs (fp32 within DTYPE_ATOL; the reference's own bounds hold)
# ---------------------------------------------------------------------------

from conftest import (DTYPE_ATOL, EXECUTOR_GRID, tiny_batch,  # noqa: E402
                      tiny_loss_fn, tiny_params)
from repro.core import losses as jlosses  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.core import losses, memory_model  # noqa: E402
from repro_torch.engine import exec_core  # noqa: E402
from test_torch_mbs import max_err, t_batch  # noqa: E402
from test_torch_streaming import t_loss_fn  # noqa: E402

F32_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
V5E = jmemory_model.V5E_HBM_BYTES


def _tparams(seed=0):
    np_p = jax.tree.map(np.asarray, tiny_params(seed))
    return weights.from_reference(np_p, "cpu"), jax.tree.map(jnp.asarray,
                                                             np_p)


def _both_plans(*args, **kw):
    return (engine.plan_mbs(*args, device="cpu", **kw),
            jengine.plan_mbs(*args, **kw))


def _same_geometry(got, want):
    for f in ("mini_batch_size", "micro_batch_size", "num_micro_batches",
              "pad", "normalization", "auto_micro", "auto_normalization",
              "remat_policy", "auto_policy"):
        assert getattr(got, f) == getattr(want, f), f


def test_plan_pins_micro_batch_size():
    plan, jplan = _both_plans(16, micro_batch_size=4)
    assert (plan.micro_batch_size, plan.num_micro_batches, plan.pad) == \
        (4, 4, 0)
    assert not plan.auto_micro and plan.normalization == "paper"
    _same_geometry(plan, jplan)


def test_plan_pins_num_microbatches_with_ragged_tail():
    plan, jplan = _both_plans(10, num_microbatches=3)
    assert (plan.micro_batch_size, plan.num_micro_batches, plan.pad) == \
        (4, 3, 2)
    assert plan.normalization == "exact" and plan.auto_normalization
    _same_geometry(plan, jplan)


def test_plan_auto_micro_from_memory_model():
    """The reference's default budget (one v5e), passed explicitly: the
    port's default is the card's memory."""
    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    plan = engine.plan_mbs(64, model_cfg=cfg, seq_len=16, budget_bytes=V5E,
                           device="cpu")
    jplan = jengine.plan_mbs(64, model_cfg=jcfg, seq_len=16)
    assert plan.auto_micro
    suggested = memory_model.suggest_micro_batch_size(cfg, 16, 64,
                                                      budget_bytes=V5E)
    assert plan.micro_batch_size == (suggested or 1)
    est = memory_model.estimate(cfg, 16)
    assert est.total(plan.micro_batch_size) <= V5E
    _same_geometry(plan, jplan)


def test_plan_auto_micro_respects_tight_budget():
    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    act = memory_model.activation_bytes_per_sample(cfg, 16)
    est = memory_model.estimate(cfg, 16)
    cap = est.total(0) + act * 3  # room for <= 3 samples of activations
    assert cap == jmemory_model.estimate(jcfg, 16).total(0) + 3 * \
        jmemory_model.activation_bytes_per_sample(jcfg, 16)
    plan = engine.plan_mbs(64, model_cfg=cfg, seq_len=16, budget_bytes=cap,
                           device="cpu")
    assert plan.auto_micro and plan.micro_batch_size <= 3
    _same_geometry(plan, jengine.plan_mbs(64, model_cfg=jcfg, seq_len=16,
                                          budget_bytes=cap))


def test_plan_split_is_masked_partition():
    plan, jplan = _both_plans(10, num_microbatches=3)
    batch = tiny_batch(10)
    split = plan.split(batch)
    assert split["x"].shape == (3, 4, 8)
    w = split["sample_weight"].reshape(-1)
    assert w.sum() == 10
    np.testing.assert_array_equal(split["x"].reshape(-1, 8)[w > 0],
                                  batch["x"])
    for k, v in jplan.split(batch).items():
        np.testing.assert_array_equal(split[k], v)


def test_plan_from_legacy_config_roundtrip():
    cfg = engine.MBSConfig(4, "exact", torch.bfloat16)
    plan = engine.MBSPlan.from_config(cfg, 12)
    assert plan.micro_batch_size == 4 and plan.num_micro_batches == 3
    assert plan.as_config() == cfg
    jplan = jengine.MBSPlan.from_config(
        jengine.MBSConfig(4, "exact", jnp.bfloat16), 12)
    _same_geometry(plan, jplan)


def _executor_split(plan, batch):
    return plan.device_split(batch, "cpu")


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
@pytest.mark.parametrize("n_b,n_mu,normalization", [
    (12, 4, "paper"), (16, 8, "paper"),
    (12, 4, "exact"), (10, 4, "exact"), (13, 5, "exact"),
])
def test_executor_gradients_match_full_batch(executor, n_b, n_mu,
                                             normalization):
    tp, jp = _tparams()
    batch = tiny_batch(n_b)
    ref_loss, _, ref = exec_core.value_and_grad(
        lambda p: t_loss_fn(p, t_batch(batch)), tp)
    plan = engine.plan_mbs(n_b, micro_batch_size=n_mu,
                           normalization=normalization, device="cpu")
    assert plan.normalization == "exact" or n_b % n_mu == 0
    ex = engine.get_executor(executor)(t_loss_fn, optim.sgd(0.1), plan)
    g, loss = ex.gradients(tp, _executor_split(plan, batch))
    assert max_err(g, {k: v.detach().numpy() for k, v in ref.items()}) \
        < 2e-6
    assert abs(float(loss) - float(ref_loss)) < 2e-6
    jplan = jengine.plan_mbs(n_b, micro_batch_size=n_mu,
                             normalization=normalization)
    jg, jloss = make_executor(executor, tiny_loss_fn, joptim.sgd(0.1),
                              jplan).gradients(jp, jplan.device_split(batch))
    assert max_err(g, jg) <= F32_ATOL
    assert abs(float(loss) - float(jloss)) <= F32_ATOL


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_executor_step_matches_baseline_update(executor):
    """One optimizer step via any executor == the no-MBS baseline."""
    tp, jp = _tparams(2)
    batch = tiny_batch(16, seed=2)
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    p_ref, _, m_ref = engine.make_baseline_train_step(t_loss_fn, opt)(
        tp, opt.init(tp), t_batch(batch))
    plan = engine.plan_mbs(16, micro_batch_size=4, device="cpu")
    ex = engine.get_executor(executor)(t_loss_fn, opt, plan)
    state = opt.init(tp)
    params = tp
    if executor == "flat":
        params, state = ex.prepare(
            tree.map(torch.clone, tp), state)
    p, _, m = ex.step_split(params, state, _executor_split(plan, batch))
    assert max_err(p, {k: v.detach().numpy() for k, v in p_ref.items()}) \
        < 2e-6
    assert abs(float(m["loss"]) - float(m_ref["loss"])) < 2e-6
    assert abs(float(m["grad_norm"]) - float(m_ref["grad_norm"])) < 2e-5
    jopt = joptim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    jex = make_executor(executor, tiny_loss_fn, jopt,
                        jengine.plan_mbs(16, micro_batch_size=4),
                        donate=False)
    jp2, _, jm = jex.step(jp, jopt.init(jp), dict(batch))
    assert max_err(p, jp2) <= F32_ATOL
    assert abs(float(m["loss"]) - float(jm["loss"])) <= F32_ATOL


def _aux_loss_fn(p, batch, exact_denom=None):
    """test_engine.py's CE + an additive (non-per-sample) regularizer under
    the exact-mode contract, in PyTorch."""
    h = torch.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    ce = losses.cross_entropy(logits, batch["y"],
                              sample_weight=batch.get("sample_weight"),
                              exact_denom=exact_denom)
    aux = 0.1 * torch.mean(torch.square(h))
    if exact_denom is not None:
        sw = batch.get("sample_weight")
        n_valid = (torch.sum(sw) if sw is not None
                   else float(batch["x"].shape[0]))
        aux = aux * (n_valid / exact_denom)
    return ce + aux, {}


def _j_aux_loss_fn(p, batch, exact_denom=None):
    h = jnp.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    ce = jlosses.cross_entropy(logits, batch["y"],
                               sample_weight=batch.get("sample_weight"),
                               exact_denom=exact_denom)
    aux = 0.1 * jnp.mean(jnp.square(h))
    if exact_denom is not None:
        sw = batch.get("sample_weight")
        n_valid = (jnp.sum(sw) if sw is not None
                   else jnp.asarray(float(batch["x"].shape[0])))
        aux = aux * (n_valid / exact_denom)
    return ce + aux, {}


@pytest.mark.parametrize("n_b,n_mu", [(12, 4), (10, 4)])
def test_additive_aux_loss_consistent_across_executors(n_b, n_mu):
    """Additive regularizers (the MoE router's aux) get the same weight
    from every executor in exact mode, ragged tails included."""
    tp, jp = _tparams()
    batch = tiny_batch(n_b)
    plan = engine.plan_mbs(n_b, micro_batch_size=n_mu,
                           normalization="exact", device="cpu")
    split = _executor_split(plan, batch)
    grads, ls = {}, {}
    for name in EXECUTOR_GRID:
        ex = engine.get_executor(name)(_aux_loss_fn, optim.sgd(0.1), plan)
        grads[name], ls[name] = ex.gradients(tp, split)
    for name in ("streaming", "fused", "flat"):
        assert max_err(grads[name], {k: v.detach().numpy() for k, v in
                                     grads["compiled"].items()}) < 2e-6
        assert abs(float(ls[name]) - float(ls["compiled"])) < 2e-6
    if n_b % n_mu == 0:  # uniform split: exact == paper == mean-of-micro aux
        plan_p = engine.plan_mbs(n_b, micro_batch_size=n_mu, device="cpu")
        g_p, _ = engine.CompiledScanExecutor(
            _aux_loss_fn, optim.sgd(0.1), plan_p).gradients(tp, split)
        assert max_err(g_p, {k: v.detach().numpy() for k, v in
                             grads["compiled"].items()}) < 2e-6
    jplan = jengine.plan_mbs(n_b, micro_batch_size=n_mu,
                             normalization="exact")
    jg, jl = jengine.CompiledScanExecutor(
        _j_aux_loss_fn, joptim.sgd(0.1), jplan).gradients(
        jp, jplan.device_split(batch))
    assert max_err(grads["compiled"], jg) <= F32_ATOL
    assert abs(float(ls["compiled"]) - float(jl)) <= F32_ATOL


def test_fused_accum_dtype_is_respected():
    executor = "fused"
    tp, jp = _tparams()
    batch = tiny_batch(8)
    plan = engine.plan_mbs(8, micro_batch_size=4, accum_dtype=torch.bfloat16,
                           device="cpu")
    ex = engine.get_executor(executor)(t_loss_fn, optim.sgd(0.1), plan)
    g, _ = ex.gradients(tp, _executor_split(plan, batch))
    assert all(x.dtype == torch.bfloat16 for x in tree.leaves(g))
    jplan = jengine.plan_mbs(8, micro_batch_size=4, accum_dtype=jnp.bfloat16)
    jg, _ = make_executor(executor, tiny_loss_fn, joptim.sgd(0.1),
                          jplan).gradients(jp, jplan.device_split(batch))
    assert max_err(g, jg) <= DTYPE_ATOL[jnp.dtype(jnp.bfloat16)]


def _train_argv(executor):
    return ["--arch", ARCH, "--reduced", "--mini-batch", "10",
            "--microbatches", "3", "--executor", executor, "--seq", "16",
            "--dtype", "float32", "--lr", "0.05", "--normalization",
            "paper", "--device", "cpu"]


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_ragged_train_path_matches_full_batch(executor, ref_params):
    """mini-batch 10, micro 4 through the launcher's plan and executor:
    the same update as the full-batch baseline, and as the reference's
    launcher path."""
    args = train.build_parser().parse_args(_train_argv(executor))
    cfg = configs.get_reduced(ARCH)
    opt = train.default_optimizer(args)
    plan = train.build_plan(cfg, args, opt, torch.device("cpu"))
    assert plan.micro_batch_size == 4 and plan.pad == 2
    assert plan.normalization == "exact"  # auto-upgraded for the ragged tail
    ex = train.build_executor(cfg, plan, args, opt)
    mini = LMDataset(cfg.vocab_size, 16, seed=0).batch(10, 0)
    params = weights.from_reference(ref_params, "cpu")
    p_ref, _, m_ref = engine.make_baseline_train_step(ex.loss_fn, opt)(
        params, opt.init(params), t_batch(mini))
    state = opt.init(params)
    if executor == "flat":
        params, state = ex.prepare(tree.map(torch.clone, params), state)
    p, _, m = ex.step_split(params, state, plan.device_split(mini, "cpu"))
    assert max_err(p, jax.tree.map(lambda t: t.detach().numpy(), p_ref)) \
        < 1e-5
    assert abs(float(m["loss"]) - float(m_ref["loss"])) < 1e-5
    jargs = argparse.Namespace(
        microbatches=3, executor="compiled", normalization="paper",
        hbm_budget_gb=None, seq=16, mini_batch=10, dtype="float32",
        lr=0.05, reduced=True)
    jcfg = jconfigs.get_reduced(ARCH)
    jex, jopt = jtrain.build_executor(jcfg, jtrain.build_plan(jcfg, jargs),
                                      jargs)
    jp = jax.tree.map(jnp.asarray, ref_params)
    jp2, _, jm = jex.step(jp, jopt.init(jp), mini)
    assert max_err(p, jp2) <= 1e-5
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5


def test_build_train_step_auto_micro_and_mask_shapes():
    """steps.build_train_step goes through the planner: no divisibility
    assert, the sample-weight mask in the abstract batch."""
    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    shape = configs.SHAPES["train_4k"]
    bundle = steps.build_train_step(cfg, shape, num_microbatches=8,
                                    dtype=torch.float32, remat=False,
                                    device="cpu")
    batch = bundle.arg_shapes[2]
    assert batch["tokens"].shape[:2] == (8, 32)
    assert batch["sample_weight"].shape == (8, 32)
    auto = steps.build_train_step(cfg, shape, dtype=torch.float32,
                                  remat=False, budget_bytes=V5E,
                                  device="cpu")
    n, m = auto.arg_shapes[2]["tokens"].shape[:2]
    assert n * m >= shape.global_batch
    assert m == (memory_model.suggest_micro_batch_size(
        cfg, shape.seq_len, shape.global_batch, budget_bytes=V5E) or 1)
    jauto = jsteps.build_train_step(jcfg, shape, dtype=jnp.float32,
                                    remat=False)
    assert (n, m) == jauto.arg_shapes[2]["tokens"].shape[:2]
