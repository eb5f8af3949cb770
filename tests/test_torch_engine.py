"""The port's engine against the JAX package's: ``FlatSpec`` layout,
``MBSPlan`` fields, the executors' gradients and steps, and the launcher
loop's loss trajectory, on reduced qwen2 in fp32 with the reference's
parameters and the same numpy batches.

Plans are pure arithmetic and must be equal. Gradients, params and
optimizer state agree to atol 1e-5 / rtol 1e-5 (XLA and torch order the
matmul sums differently); Pallas kernels run in interpret mode.
"""
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
