"""``tests/test_remat_policy.py`` case for case in the port: graded
activation checkpointing chosen jointly with the micro-batch size.

  * checkpointing is invisible to the numbers: every policy × executor
    gives the ``none`` gradients on reduced qwen2 (ragged tail, exact
    normalization, the global-norm clip), and the reference's;
  * the planner's joint (policy, micro) choice equals the reference's
    and escalates only when the budget forces it;
  * ``build_train_step`` hands the loss the plan's policy;
  * the 5-step golden trajectory (``conftest.GOLDEN_LOSSES``) holds on
    all four executors.

fp32 results agree with the reference's within ``DTYPE_ATOL``'s rtol
twin 1e-5 on the transformer (XLA and torch order the matmul sums
differently) and within the reference's own bounds across policies.
XLA's ``memory_analysis`` of the compiled step has the allocator's peak
for twin: that case needs the card (``gpu`` marker).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, engine, optim, tree, weights
from repro_torch.configs.shapes import InputShape
from repro_torch.core import memory_model
from repro_torch.data import LMDataset
from repro_torch.launch import steps
from repro_torch.models import remat

# the card's machine has no JAX: there its gpu case runs alone, with
# ``--noconftest`` (the suite's conftest imports JAX), and every other
# case skips
try:
    import jax
    import jax.numpy as jnp
    from conftest import (GOLDEN_LOSSES, EXECUTOR_GRID, ToyDataset,
                          make_executor)
    from repro import configs as jconfigs
    from repro import engine as jengine
    from repro import optim as joptim
    from repro.core import memory_model as jmemory_model
    from repro.launch import steps as jsteps
    from repro.models import transformer as jtransformer
    from test_torch_mbs import max_err
    from test_torch_streaming import t_loss_fn
    JCFG = jconfigs.get_reduced("qwen2-1.5b")
    V5E = jmemory_model.V5E_HBM_BYTES
except (ImportError, pytest.skip.Exception):
    jax = None
    EXECUTOR_GRID = sorted(engine.EXECUTORS)

CFG = configs.get_reduced("qwen2-1.5b")
SEQ = 16
ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


def _batch(n_b, seed=0):
    return LMDataset(vocab_size=CFG.vocab_size, seq_len=SEQ,
                     seed=seed).batch(n_b, 0)


def _loss(policy):
    return steps.make_loss_fn(CFG, dtype=torch.float32, remat_policy=policy)


def _np_params(seed=0):
    return jax.tree.map(np.asarray, jtransformer.init_params(
        JCFG, jax.random.PRNGKey(seed)))


def _run(executor, loss_fn, opt, plan, params, split, step=False):
    ex = engine.get_executor(executor)(loss_fn, opt, plan)
    params = tree.map(torch.clone, params)
    if not step:
        return ex.gradients(params, split)
    state = opt.init(params)
    if executor == "flat":
        params, state = ex.prepare(params, state)
    return ex.step_split(params, state, split)


def _close(got, want, what):
    g = [np.asarray(x.detach().float()) for x in tree.leaves(got)]
    w = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{what}: leaf {i}")


# ---------------------------------------------------------------------------
# gradient equivalence: every policy == "none", on every executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
@pytest.mark.parametrize("policy", [p for p in remat.POLICIES if p != "none"])
def test_policy_gradients_match_none(executor, policy):
    """Ragged mini-batch (5 % 2 != 0 → exact normalization): checkpointing
    changes the schedule, never the accumulated gradient."""
    plan = engine.plan_mbs(5, micro_batch_size=2, device="cpu")
    assert plan.normalization == "exact"
    batch = _batch(5)
    split = plan.device_split(batch, "cpu")
    np_p = _np_params()
    params = weights.from_reference(np_p, "cpu")
    g_ref, l_ref = _run(executor, _loss("none"), optim.sgd(0.1), plan,
                        params, split)
    g, loss = _run(executor, _loss(policy), optim.sgd(0.1), plan, params,
                   split)
    assert max_err(g, jax.tree.map(lambda x: x.detach().numpy(), g_ref)) \
        <= 1e-5
    assert abs(float(loss) - float(l_ref)) <= 1e-5
    jplan = jengine.plan_mbs(5, micro_batch_size=2)
    jg, _ = make_executor(executor, jsteps.make_loss_fn(
        JCFG, dtype=jnp.float32, remat_policy=policy), joptim.sgd(0.1),
        jplan).gradients(jax.tree.map(jnp.asarray, np_p),
                         jplan.device_split(batch))
    _close(g, jg, f"{executor}/{policy} gradients")


@pytest.mark.parametrize("policy", [p for p in remat.POLICIES if p != "none"])
def test_policy_step_matches_none_with_clip(policy):
    """Global-norm clipping on top: one step under a remat policy equals
    the unchecked step (uniform split, paper mode)."""
    opt = optim.clip_by_global_norm(optim.sgd(0.1, momentum=0.9), 0.05)
    plan = engine.plan_mbs(4, micro_batch_size=2, device="cpu")
    assert plan.normalization == "paper"
    batch = _batch(4)
    split = plan.device_split(batch, "cpu")
    np_p = _np_params(1)
    params = weights.from_reference(np_p, "cpu")
    p_ref, _, m_ref = _run("compiled", _loss("none"), opt, plan, params,
                           split, step=True)
    p, _, m = _run("compiled", _loss(policy), opt, plan, params, split,
                   step=True)
    assert max_err(p, jax.tree.map(lambda x: x.detach().numpy(), p_ref)) \
        <= 1e-5
    assert abs(float(m["loss"]) - float(m_ref["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) - float(m_ref["grad_norm"])) <= 1e-4
    jopt = joptim.clip_by_global_norm(joptim.sgd(0.1, momentum=0.9), 0.05)
    jplan = jengine.plan_mbs(4, micro_batch_size=2)
    jp = jax.tree.map(jnp.asarray, np_p)
    jp2, _, _ = make_executor("compiled", jsteps.make_loss_fn(
        JCFG, dtype=jnp.float32, remat_policy=policy), jopt, jplan,
        donate=False).step_split(jp, jopt.init(jp),
                                 jplan.device_split(batch))
    _close(p, jp2, f"clip/{policy} params")


# ---------------------------------------------------------------------------
# the analytic model vs the card's own peak (the reference reads XLA's
# memory_analysis of the compiled step)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_memory_analysis_monotone_along_lattice():
    """The train bundle's step at every policy on the card, at 2 layers of
    qwen2-1.5b's full width (the reduced config's activations are too
    small for the allocator to tell the policies apart): the peak above
    the resident state is monotone non-increasing along the lattice,
    ``full`` strictly below ``none``, and the analytic activation term
    orders them the same way."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (reads the caching allocator's "
                    "peak)")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("qwen2-1.5b"), num_layers=2)
    shape = InputShape("train_check", "train", 1024, 4)
    peaks = {}
    for policy in remat.POLICIES:
        bundle = steps.build_train_step(cfg, shape, num_microbatches=2,
                                        dtype=torch.float32,
                                        remat_policy=policy, device=dev)
        params = steps.init_params(cfg, seed=0, device=dev)
        state = bundle.optimizer.init(params)
        split = steps.device_split(bundle.plan, LMDataset(
            cfg.vocab_size, 1024, seed=0).batch(4, 0), dev)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = bundle.fn(params, state, split)
        torch.cuda.synchronize(dev)
        peaks[policy] = torch.cuda.max_memory_allocated(dev) - base
        del out, params, state, split
        torch.cuda.empty_cache()
    for cheap, heavy in zip(remat.POLICIES, remat.POLICIES[1:]):
        assert peaks[heavy] <= peaks[cheap], peaks
    assert peaks["full"] < peaks["none"], peaks
    acts = [memory_model.activation_bytes_per_sample(cfg, 1024, act_bytes=4,
                                                     remat_policy=p)
            for p in remat.POLICIES]
    assert acts == sorted(acts, reverse=True)


# ---------------------------------------------------------------------------
# the joint planner: auto escalation buys batch
# ---------------------------------------------------------------------------

def _tight_budget():
    """A budget that fits a few samples without remat but many with it."""
    est = memory_model.estimate(CFG, SEQ, remat_policy="none")
    return est.total(0) + 3 * est.activation_bytes_per_sample


def _plans(*args, **kw):
    """The port's plan (on the CPU) and the reference's, geometry equal."""
    got = engine.plan_mbs(*args, device="cpu",
                          **{**kw, "model_cfg": kw.get("model_cfg") and CFG})
    want = jengine.plan_mbs(*args,
                            **{**kw, "model_cfg": kw.get("model_cfg")
                               and JCFG})
    for f in ("micro_batch_size", "num_micro_batches", "pad",
              "remat_policy", "auto_policy", "auto_micro"):
        assert getattr(got, f) == getattr(want, f), f
    return got


def test_auto_policy_admits_strictly_more_than_none_at_tight_budget():
    cap = _tight_budget()
    kw = dict(model_cfg=True, seq_len=SEQ, budget_bytes=cap)
    plan_none = _plans(64, remat_policy="none", **kw)
    plan_auto = _plans(64, remat_policy="auto", **kw)
    assert plan_auto.micro_batch_size > plan_none.micro_batch_size
    assert plan_auto.auto_policy and plan_auto.auto_micro
    assert remat.policy_weight(plan_auto.remat_policy) > 0  # escalated
    est = memory_model.estimate(CFG, SEQ,
                                remat_policy=plan_auto.remat_policy)
    assert est.total(plan_auto.micro_batch_size) <= cap


def test_auto_policy_stays_cheap_when_budget_is_roomy():
    """The reference's default budget (one v5e), passed explicitly: a whole
    device for a reduced config keeps the recompute-free policy."""
    plan = _plans(4, model_cfg=True, seq_len=SEQ, budget_bytes=V5E,
                  remat_policy="auto")
    assert plan.remat_policy == "none"
    assert plan.micro_batch_size == 4


def test_auto_policy_with_pinned_micro_picks_cheapest_fitting():
    cap = _tight_budget()
    kw = dict(model_cfg=True, seq_len=SEQ, budget_bytes=cap,
              remat_policy="auto")
    assert _plans(16, micro_batch_size=2, **kw).remat_policy == "none"
    plan8 = _plans(16, micro_batch_size=8, **kw)
    assert plan8.micro_batch_size == 8
    assert remat.policy_weight(plan8.remat_policy) > 0


def test_explicit_policy_and_legacy_bool_resolution():
    plan = _plans(8, micro_batch_size=4, remat_policy="dots")
    assert plan.remat_policy == "dots" and not plan.auto_policy
    assert _plans(8, micro_batch_size=4).remat_policy == "period"
    assert _plans(8, micro_batch_size=4, remat=False).remat_policy == "none"
    with pytest.raises(ValueError, match="remat policy"):
        engine.plan_mbs(8, micro_batch_size=4, remat_policy="everything",
                        device="cpu")


def test_build_train_step_threads_plan_policy_into_loss(monkeypatch):
    """``remat_policy="auto"`` end to end: build_train_step hands
    make_loss_fn the plan's chosen policy — not the "auto" sentinel, not
    the legacy bool — and the step built under the heaviest policy runs
    and equals the reference's."""
    shape = InputShape("train_tiny", "train", SEQ, 8)
    seen = {}
    real = steps.make_loss_fn

    def spy(cfg, *a, **kw):
        seen["remat_policy"] = kw.get("remat_policy")
        return real(cfg, *a, **kw)

    monkeypatch.setattr(steps, "make_loss_fn", spy)
    kw = dict(num_microbatches=2, dtype=torch.float32, budget_bytes=V5E,
              device="cpu")
    steps.build_train_step(CFG, shape, remat_policy="auto", **kw)
    assert seen["remat_policy"] == "none"
    bundle = steps.build_train_step(CFG, shape, remat_policy="full", **kw)
    assert seen["remat_policy"] == "full"
    np_p = _np_params(2)
    params = weights.from_reference(np_p, "cpu")
    batch = _batch(8)
    split = bundle.plan.device_split(batch, "cpu")
    p, _, m = bundle.fn(params, bundle.optimizer.init(params), split)
    assert np.isfinite(float(m["loss"]))
    jb = jsteps.build_train_step(JCFG, shape, num_microbatches=2,
                                 dtype=jnp.float32, remat_policy="full")
    jp = jax.tree.map(jnp.asarray, np_p)
    jp2, _, jm = jax.jit(jb.fn)(jp, jb.optimizer.init(jp),
                                jb.plan.device_split(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= ATOL
    _close(p, jp2, "full-remat bundle step params")


def test_auto_policy_flag_only_set_when_search_ran():
    """Without a model config there is nothing to search: "auto" falls
    back to the legacy bool and the plan does not claim a search."""
    plan = _plans(8, micro_batch_size=4, remat_policy="auto")
    assert plan.remat_policy == "period" and not plan.auto_policy
    with_cfg = _plans(8, micro_batch_size=4, model_cfg=True, seq_len=SEQ,
                      budget_bytes=V5E, remat_policy="auto")
    assert with_cfg.auto_policy


# ---------------------------------------------------------------------------
# golden-trajectory regression (all four executors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_five_step_loss_trajectory_matches_golden(executor):
    """The reference's recorded 5-step trajectory (conftest.GOLDEN_LOSSES:
    the tiny model, seed 0, ragged 10 → 3 × 4, SGD-m 0.1/0.9/1e-4)."""
    from conftest import tiny_params
    plan = engine.plan_mbs(10, micro_batch_size=4, device="cpu")
    ds = ToyDataset()
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    ex = engine.get_executor(executor)(t_loss_fn, opt, plan)
    params = weights.from_reference(jax.tree.map(np.asarray, tiny_params()),
                                    "cpu")
    state = opt.init(params)
    if executor == "flat":
        params, state = ex.prepare(params, state)
    losses = []
    for step in range(5):
        params, state, m = ex.step_split(
            params, state, plan.device_split(ds.batch(10, step), "cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, GOLDEN_LOSSES, atol=5e-4, rtol=0)
