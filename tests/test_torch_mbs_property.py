"""``tests/test_mbs_property.py`` case for case in the port (hypothesis):
for any batch size, micro-batch size, model shape and data, the
loss-normalized accumulated gradient equals the mini-batch gradient
(paper eq. 15–17), and the reference's, within the reference's own
bound (2e-5); and the planner's invariants: admission
monotone in the budget and in the remat-policy weight, the joint
(policy, N_μ) choice within the budget it was admitted under, the
data-parallel plan covering the global batch within the per-device
budget, and the pipeline-aware admission (``plan_mbs(pipeline=True)``:
monotone in the budget, within the per-device budget, non-dividing stage
counts refused) — each plan equal to the reference's for the same draw.
Beyond the reference's properties: ``pipeline_activation_bytes_per_sample``
and ``plan_mbs(pipeline=True)`` equal the reference's exactly over full
configs, stage counts and remat policies.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

pytest.importorskip("hypothesis",
                    reason="property tests need hypothesis "
                           "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import mbs as JM  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro_torch import configs, engine  # noqa: E402
from repro_torch.core import losses, mbs as M, memory_model  # noqa: E402
from repro_torch.engine import exec_core  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from test_torch_mbs import max_err, t_batch  # noqa: E402


def _t_loss(p, batch, exact_denom=None):
    h = torch.tanh(batch["x"] @ p["w1"])
    return losses.cross_entropy(
        h @ p["w2"], batch["y"], sample_weight=batch.get("sample_weight"),
        exact_denom=exact_denom), {}


def _j_loss(p, batch, exact_denom=None):
    h = jnp.tanh(batch["x"] @ p["w1"])
    return jlosses.cross_entropy(
        h @ p["w2"], batch["y"], sample_weight=batch.get("sample_weight"),
        exact_denom=exact_denom), {}


def _draw(seed, n_b, din, dh):
    rng = np.random.default_rng(seed)
    p = {"w1": rng.normal(0, 0.4, (din, dh)).astype(np.float32),
         "w2": rng.normal(0, 0.4, (dh, 3)).astype(np.float32)}
    batch = {"x": rng.normal(size=(n_b, din)).astype(np.float32),
             "y": rng.integers(0, 3, n_b).astype(np.int32)}
    return p, batch


def _check_equivalence(p, batch, n_mu, normalization):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, _, ref = exec_core.value_and_grad(
        lambda q: _t_loss(q, t_batch(batch)), tp)
    split = M.split_minibatch(batch, n_mu)
    g, _ = M.mbs_gradients(_t_loss, tp, t_batch(split),
                           M.MBSConfig(n_mu, normalization))
    assert max_err(g, {k: v.detach().numpy() for k, v in ref.items()}) \
        < 2e-5
    jg, _ = JM.mbs_gradients(_j_loss, jax.tree.map(jnp.asarray, p),
                             {k: jnp.asarray(v) for k, v in split.items()},
                             JM.MBSConfig(n_mu, normalization))
    assert max_err(g, jg) < 2e-5


@settings(max_examples=25, deadline=None)
@given(n_b=st.integers(2, 24), n_mu=st.integers(1, 24),
       din=st.integers(2, 10), dh=st.integers(2, 12),
       seed=st.integers(0, 2 ** 16))
def test_mbs_gradient_equivalence(n_b, n_mu, din, dh, seed):
    """Exact mode is correct for every (n_b, n_mu), ragged tails too."""
    p, batch = _draw(seed, n_b, din, dh)
    _check_equivalence(p, batch, n_mu, "exact")


@settings(max_examples=25, deadline=None)
@given(n_b=st.integers(2, 24), n_mu=st.integers(1, 24),
       seed=st.integers(0, 2 ** 16))
def test_paper_mode_equivalence_when_uniform(n_b, n_mu, seed):
    """Algorithm 1 (paper mode) is exact whenever the split is uniform —
    the paper's own experimental setting."""
    n_mu_eff = min(n_mu, n_b)
    if n_b % n_mu_eff:
        n_b = (n_b // n_mu_eff) * n_mu_eff
    p, batch = _draw(seed, n_b, 6, 8)
    _check_equivalence(p, batch, n_mu, "paper")


# ---------------------------------------------------------------------------
# the planner's invariants (remat policy × micro-batch admission)
# ---------------------------------------------------------------------------

_ARCHS = ["qwen2-1.5b", "mixtral-8x22b", "mamba2-780m", "recurrentgemma-2b"]
_CFGS = {a: configs.get_reduced(a) for a in _ARCHS}
_JCFGS = {a: jconfigs.get_reduced(a) for a in _ARCHS}


def _budget_around(cfg, seq, frac):
    """From 'nothing fits' to 'everything fits': the steady state plus
    ``frac`` of the whole-mini-batch no-remat activation range."""
    est = memory_model.estimate(cfg, seq, remat_policy="none")
    return int(est.total(0) + frac * 64 * est.activation_bytes_per_sample)


def _plan(arch, *args, mesh=None, model=1, cfgs=None, **kw):
    """The port's plan, and the reference's equal to it field by field
    (``mesh``: the data extent; ``model``: the model axis)."""
    cfgs = cfgs or (_CFGS, _JCFGS)
    got = engine.plan_mbs(*args, model_cfg=cfgs[0][arch], device="cpu",
                          mesh=None if mesh is None else
                          {"data": mesh, "model": model}, **kw)
    want = jengine.plan_mbs(*args, model_cfg=cfgs[1][arch],
                            mesh=None if mesh is None else
                            _FakeMesh(mesh, model), **kw)
    for f in ("micro_batch_size", "num_micro_batches", "pad",
              "normalization", "remat_policy", "auto_policy",
              "data_parallel", "local_micro", "pipeline_stages"):
        assert getattr(got, f) == getattr(want, f), f
    return got


class _FakeMesh:
    """The reference's planner-level mesh stand-in (``shape`` and
    ``axis_names``): device counts beyond the forced host platform."""

    def __init__(self, data, model=1):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


@settings(max_examples=25, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64, 256]),
       f1=st.floats(0.0, 1.0), f2=st.floats(0.0, 1.0),
       policy=st.sampled_from(remat.POLICIES))
def test_admission_monotone_in_budget(arch, seq, f1, f2, policy):
    """More memory never admits a smaller micro-batch (fixed policy)."""
    cfg = _CFGS[arch]
    lo, hi = sorted([_budget_around(cfg, seq, f1),
                     _budget_around(cfg, seq, f2)])
    m_lo = memory_model.suggest_micro_batch_size(
        cfg, seq, 64, budget_bytes=lo, remat_policy=policy) or 0
    m_hi = memory_model.suggest_micro_batch_size(
        cfg, seq, 64, budget_bytes=hi, remat_policy=policy) or 0
    assert m_lo <= m_hi
    assert m_lo == (jmemory_model.suggest_micro_batch_size(
        _JCFGS[arch], seq, 64, budget_bytes=lo, remat_policy=policy) or 0)


@settings(max_examples=25, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64, 256]),
       frac=st.floats(0.0, 1.0))
def test_admission_monotone_in_policy_weight(arch, seq, frac):
    """Heavier remat never admits a smaller micro-batch (fixed budget)."""
    cfg = _CFGS[arch]
    budget = _budget_around(cfg, seq, frac)
    admitted = [memory_model.suggest_micro_batch_size(
        cfg, seq, 64, budget_bytes=budget, remat_policy=p) or 0
        for p in remat.POLICIES]
    assert admitted == sorted(admitted), dict(zip(remat.POLICIES, admitted))


@settings(max_examples=25, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64, 256]),
       frac=st.floats(0.0, 1.0), mini=st.integers(1, 64))
def test_joint_choice_satisfies_analytic_budget(arch, seq, frac, mini):
    """The (policy, N_μ) pair "auto" picks fits the budget it was admitted
    under, and no cheaper policy admits strictly more."""
    cfg = _CFGS[arch]
    budget = _budget_around(cfg, seq, frac)
    plan = _plan(arch, mini, seq_len=seq, budget_bytes=budget,
                 remat_policy="auto")
    est = memory_model.estimate(cfg, seq, remat_policy=plan.remat_policy)
    if est.total(1) <= budget:
        assert est.total(plan.micro_batch_size) <= budget
    w = remat.policy_weight(plan.remat_policy)
    for p in remat.POLICIES[:w]:
        cheaper = memory_model.suggest_micro_batch_size(
            cfg, seq, mini, budget_bytes=budget, remat_policy=p) or 0
        assert cheaper <= plan.micro_batch_size


# ---------------------------------------------------------------------------
# mesh-aware admission (data parallelism)
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64]),
       frac=st.floats(0.0, 1.0), dpe=st.integers(1, 6),
       mini=st.integers(64, 512))
def test_mesh_plan_covers_global_batch(arch, seq, frac, dpe, mini):
    """local_micro × data_parallel × N_Sμ covers the global mini-batch,
    and the global micro-batch divides over the data axis."""
    cfg = _CFGS[arch]
    plan = _plan(arch, mini, seq_len=seq,
                 budget_bytes=_budget_around(cfg, seq, frac), mesh=2 ** dpe,
                 fsdp_params=False)
    assert plan.data_parallel == 2 ** dpe
    assert plan.micro_batch_size == plan.local_micro * plan.data_parallel
    assert (plan.local_micro * plan.data_parallel * plan.num_micro_batches
            >= mini)


@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64]),
       frac=st.floats(0.0, 1.0), d1=st.integers(0, 6), d2=st.integers(0, 6))
def test_mesh_admission_monotone_in_device_count(arch, seq, frac, d1, d2):
    """More data-parallel workers never admit a smaller global batch at a
    fixed per-device budget."""
    budget = _budget_around(_CFGS[arch], seq, frac)
    lo, hi = sorted([2 ** d1, 2 ** d2])

    def admitted(dp):
        return _plan(arch, 512, seq_len=seq, budget_bytes=budget, mesh=dp,
                     fsdp_params=False).micro_batch_size

    assert admitted(lo) <= admitted(hi)


@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(_ARCHS), seq=st.sampled_from([16, 64]),
       frac=st.floats(0.0, 1.0), dpe=st.integers(1, 5),
       fsdp=st.booleans())
def test_mesh_plan_never_exceeds_per_device_budget(arch, seq, frac, dpe,
                                                   fsdp):
    """The plan's own per-device estimate at its local micro-batch fits
    the budget it was admitted under (whenever anything fits)."""
    cfg = _CFGS[arch]
    mesh = {"data": 2 ** dpe, "model": 1}
    budget = _budget_around(cfg, seq, frac)
    plan = _plan(arch, 256, seq_len=seq, budget_bytes=budget, mesh=2 ** dpe,
                 fsdp_params=fsdp)
    est = memory_model.estimate(cfg, seq, remat_policy=plan.remat_policy,
                                mesh=mesh, fsdp_params=fsdp)
    if est.total(1) <= budget:
        assert est.total(plan.local_micro) <= budget


# ---------------------------------------------------------------------------
# pipeline-aware admission (plan_mbs(pipeline=True))
# ---------------------------------------------------------------------------

# archs whose reduced block stacks split over 2 stages (num_periods = 2)
_PIPE_ARCHS = ["qwen2-1.5b", "mamba2-780m"]


@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(_PIPE_ARCHS), seq=st.sampled_from([16, 64]),
       f1=st.floats(0.0, 1.0), f2=st.floats(0.0, 1.0),
       dpe=st.integers(0, 4))
def test_pipeline_admission_monotone_in_budget(arch, seq, f1, f2, dpe):
    """More per-device memory never admits a smaller micro-batch on a
    pipelined 2-D mesh (fixed stage count)."""
    cfg = _CFGS[arch]
    lo, hi = sorted([_budget_around(cfg, seq, f1),
                     _budget_around(cfg, seq, f2)])

    def admitted(budget):
        return _plan(arch, 256, seq_len=seq, budget_bytes=budget,
                     mesh=2 ** dpe, model=2, fsdp_params=False,
                     pipeline=True).micro_batch_size

    assert admitted(lo) <= admitted(hi)


@settings(max_examples=20, deadline=None)
@given(arch=st.sampled_from(_PIPE_ARCHS), seq=st.sampled_from([16, 64]),
       frac=st.floats(0.0, 1.0), dpe=st.integers(0, 4))
def test_pipeline_plan_never_exceeds_per_device_budget(arch, seq, frac,
                                                       dpe):
    """The pipelined plan's own per-device estimate (stage-local
    activations × the warmup depth) fits the budget it was admitted under
    whenever anything fits, and records the mesh's stage count."""
    cfg = _CFGS[arch]
    budget = _budget_around(cfg, seq, frac)
    plan = _plan(arch, 256, seq_len=seq, budget_bytes=budget, mesh=2 ** dpe,
                 model=2, fsdp_params=False, pipeline=True)
    assert plan.pipeline_stages == 2
    est = memory_model.estimate(cfg, seq, remat_policy=plan.remat_policy,
                                mesh={"data": 2 ** dpe, "model": 2},
                                fsdp_params=False, pipeline=True)
    if est.total(1) <= budget:
        assert est.total(plan.local_micro) <= budget


@settings(max_examples=15, deadline=None)
@given(arch=st.sampled_from(_PIPE_ARCHS), seq=st.sampled_from([16, 64]),
       stages=st.integers(3, 7))
def test_pipeline_non_dividing_stages_raise(arch, seq, stages):
    """A model axis that does not divide the block stack is refused at
    plan time, in both packages, with the same words."""
    if _CFGS[arch].num_periods % stages == 0:
        return  # a dividing count: nothing to refuse
    for plan_mbs, cfg, mesh in (
            (engine.plan_mbs, _CFGS[arch], {"data": 1, "model": stages}),
            (jengine.plan_mbs, _JCFGS[arch], _FakeMesh(1, stages))):
        with pytest.raises(ValueError,
                           match="does not divide the block stack"):
            plan_mbs(256, model_cfg=cfg, seq_len=seq, mesh=mesh,
                     pipeline=True)


# full configs whose period stacks divide 2, 4 and 7 stages or some of them
_FULL_PIPE = ["qwen2-1.5b", "mamba2-780m", "gemma2-9b"]
_FULL_CFGS = ({a: configs.get(a) for a in _FULL_PIPE},
              {a: jconfigs.get(a) for a in _FULL_PIPE})


@pytest.mark.parametrize("arch", _FULL_PIPE)
@pytest.mark.parametrize("stages", [2, 4, 7])
def test_pipeline_plans_equal_the_reference(arch, stages):
    """``pipeline_activation_bytes_per_sample`` and the whole
    ``plan_mbs(pipeline=True)`` (auto micro-batch and, with ``"auto"``,
    the joint policy) equal the reference's at full width, for every remat
    policy, at a budget around the stage's state."""
    cfg, jcfg = _FULL_CFGS[0][arch], _FULL_CFGS[1][arch]
    if cfg.num_periods % stages:
        with pytest.raises(ValueError, match="does not divide"):
            _plan(arch, 64, seq_len=512, mesh=1, model=stages,
                  pipeline=True, budget_bytes=1 << 34, cfgs=_FULL_CFGS)
        return
    for policy in remat.POLICIES:
        for act_bytes in (2, 4):
            got = memory_model.pipeline_activation_bytes_per_sample(
                cfg, 512, stages, act_bytes, remat_policy=policy)
            want = jmemory_model.pipeline_activation_bytes_per_sample(
                jcfg, 512, stages, act_bytes, remat_policy=policy)
            assert got == want, (policy, act_bytes)
    for dp in (1, 2):
        mesh = {"data": dp, "model": stages}
        state = memory_model.estimate(cfg, 512, mesh=mesh,
                                      fsdp_params=False,
                                      pipeline=True).total(0)
        for frac in (0.5, 2.0, 8.0):
            budget = int(state + frac * (1 << 30))
            for policy in list(remat.POLICIES) + ["auto"]:
                _plan(arch, 64, seq_len=512, mesh=dp, model=stages,
                      pipeline=True, fsdp_params=False, budget_bytes=budget,
                      remat_policy=policy, cfgs=_FULL_CFGS)


@settings(max_examples=30, deadline=None)
@given(n_b=st.integers(1, 40), n_mu=st.integers(1, 40))
def test_split_partition_invariants(n_b, n_mu):
    """eq. (1)-(3): the micro-batches partition the mini-batch; N_mu <=
    N_B and N_Smu = ceil(N_B / N_mu); the split equals the reference's."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(n_b, 3)).astype(np.float32)}
    split = M.split_minibatch(batch, n_mu)
    n_s, mu = split["x"].shape[:2]
    assert mu <= n_b
    assert n_s == -(-n_b // mu)
    w = split["sample_weight"].reshape(-1)
    assert w.sum() == n_b
    np.testing.assert_array_equal(split["x"].reshape(-1, 3)[w > 0],
                                  batch["x"])
    for k, v in JM.split_minibatch(batch, n_mu).items():
        np.testing.assert_array_equal(split[k], v)
