"""``tests/test_flat_update.py`` case for case in the port: the flat-buffer
update path — ``FlatSpec`` round trips, stable ordering and bucketing;
the fused SGD-m / Adam / AdamW updates (kernels K2–K4; on the CPU their
plain versions) against the unfused tree update, on flat buffers and end
to end through every executor (ragged tails, exact normalization, the
global-norm clip); the state a step consumes; and the memory model's
step-❺ transient.

Each case runs in both packages on the same numpy inputs: the reference's
Pallas kernels in interpret mode, the port's wrappers on CPU tensors.
fp32 results agree within ``DTYPE_ATOL`` (conftest) where the reference's
own bounds are 1e-6 and within the reference's bound where it is looser.

The reference's ``donate_argnums`` frees the buffers a step consumes; the
port's ``flat`` step writes params and optimizer state in place and
hands the same buffers back, and ``compiled`` returns new trees and
leaves its inputs alone — so the donation twins check those contracts.
XLA's ``memory_analysis`` of the donated step has the allocator's peak
for twin: that case needs the card (``gpu`` marker).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, engine, kernels, optim, tree
from repro_torch import weights
from repro_torch.core import losses, memory_model
from repro_torch.engine import exec_core, flat
from repro_torch.kernels import ref

# the card's machine has no JAX: there its gpu case runs alone, with
# ``--noconftest`` (the suite's conftest imports JAX), and every other
# case skips
try:
    import jax
    import jax.numpy as jnp
    from conftest import (DTYPE_ATOL, EXECUTOR_GRID, make_executor,
                          tiny_batch, tiny_loss_fn, tiny_params)
    from repro import configs as jconfigs
    from repro import engine as jengine
    from repro import optim as joptim
    from repro.core import memory_model as jmemory_model
    from repro.engine import exec_core as jexec_core
    from repro.engine import flat as jflat
    from repro.kernels import fused_update as jfused_update
    from test_torch_mbs import max_err, t_batch
    F32_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
except (ImportError, pytest.skip.Exception):
    jax = None
    EXECUTOR_GRID = sorted(engine.EXECUTORS)


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("needs JAX and the JAX package (the reference)")


def t_loss_fn(p, batch, exact_denom=None):
    """``conftest.tiny_loss_fn`` in PyTorch."""
    h = torch.tanh(batch["x"] @ p["w1"])
    return losses.cross_entropy(
        h @ p["w2"], batch["y"], sample_weight=batch.get("sample_weight"),
        exact_denom=exact_denom), {}


def _np_mixed(seed=0):
    """test_flat_update.py's mixed tree as numpy (fp32): nested, ragged
    sizes."""
    rng = np.random.default_rng(seed)
    return {
        "emb": rng.normal(size=(7, 5)).astype(np.float32),
        "blocks": [{"w": rng.normal(size=(3, 11)).astype(np.float32),
                    "b": rng.normal(size=(11,)).astype(np.float32)},
                   {"w": rng.normal(size=(13,)).astype(np.float32),
                    "b": rng.normal(size=(2, 2, 3)).astype(np.float32)}],
        "head": rng.normal(size=(1,)).astype(np.float32),
    }


def _mixed(seed=0, bf16=True):
    """(port tree, reference tree) of the mixed tree, its ``b`` leaves
    bf16 unless ``bf16`` is False."""
    t = _np_mixed(seed)
    tt = weights.from_reference(t, "cpu")
    jt = jax.tree.map(jnp.asarray, t)
    if bf16:
        for tb, jb in zip(tt["blocks"], jt["blocks"]):
            tb["b"] = tb["b"].to(torch.bfloat16)
            jb["b"] = jb["b"].astype(jnp.bfloat16)
    return tt, jt


def _tiny(seed=0):
    np_p = jax.tree.map(np.asarray, tiny_params(seed))
    return weights.from_reference(np_p, "cpu"), jax.tree.map(jnp.asarray,
                                                             np_p)


def _np(t):
    return jax.tree.map(lambda x: x.detach().float().numpy(), t)


# ---------------------------------------------------------------------------
# FlatSpec round trip
# ---------------------------------------------------------------------------

def test_flat_roundtrip_mixed_dtypes():
    tt, jt = _mixed()
    spec = flat.FlatSpec.for_tree(tt)
    assert spec.num_leaves == len(tree.leaves(tt))
    assert spec.num_buckets == 2  # fp32 + bf16
    bufs = spec.flatten(tt)
    assert all(b.dim() == 1 for b in bufs)
    assert [b.dtype for b in bufs] == list(spec.bucket_dtypes)
    assert sum(b.numel() for b in bufs) == sum(x.numel()
                                               for x in tree.leaves(tt))
    back = spec.unflatten(bufs)
    assert tree.flatten(back)[1] == tree.flatten(tt)[1]
    for a, b in zip(tree.leaves(back), tree.leaves(tt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    jbufs = jflat.FlatSpec.for_tree(jt).flatten(jt)
    for b, jb in zip(bufs, jbufs):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(jb, np.float32))


def test_flat_ordering_is_stable_and_offsets_contiguous():
    tt, jt = _mixed()
    spec1 = flat.FlatSpec.for_tree(tt)
    spec2 = flat.FlatSpec.for_tree(tree.map(lambda x: x * 2, tt))
    assert spec1.slots == spec2.slots  # same structure -> same layout
    fill = [0] * spec1.num_buckets
    for slot in spec1.slots:  # leaf order fills each bucket densely
        assert slot.offset == fill[slot.bucket]
        fill[slot.bucket] += slot.size
    assert tuple(fill) == spec1.bucket_sizes
    jspec = jflat.FlatSpec.for_tree(jt)
    assert [(s.bucket, s.offset, s.size, s.shape) for s in spec1.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in jspec.slots]


def test_flat_grads_share_param_layout():
    """Gradients flattened into the fp32 accumulator line up with the
    param buckets (the fused kernels' contract)."""
    tt, _ = _mixed()
    spec = flat.FlatSpec.for_tree(tt)
    gbufs = spec.flatten(tt, dtype=torch.float32)
    assert all(b.dtype == torch.float32 for b in gbufs)
    assert tuple(b.numel() for b in gbufs) == spec.bucket_sizes
    gtree = spec.unflatten(gbufs, cast=False)
    assert all(x.dtype == torch.float32 for x in tree.leaves(gtree))


def test_flat_roundtrip_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.tuples(st.integers(1, 60), st.booleans()),
                    min_size=1, max_size=12),
           st.integers(0, 2 ** 16))
    def run(shapes, seed):
        rng = np.random.default_rng(seed)
        t = {f"l{i}": torch.from_numpy(rng.normal(size=n)).to(
            torch.bfloat16 if bf else torch.float32)
            for i, (n, bf) in enumerate(shapes)}
        spec = flat.FlatSpec.for_tree(t)
        back = spec.unflatten(spec.flatten(t))
        for a, b in zip(tree.leaves(back), tree.leaves(t)):
            assert a.dtype == b.dtype and torch.equal(a, b)

    run()


# ---------------------------------------------------------------------------
# the fused updates vs the unfused reference (flat buffers, ragged blocks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.0, False, 0.0), (0.9, False, 5e-4), (0.9, True, 1e-4)])
def test_fused_sgd_kernel_matches_reference(momentum, nesterov, wd):
    rng = np.random.default_rng(1)
    N = 1000  # not a multiple of the block: masked final block
    p, g = rng.normal(size=N).astype(np.float32), \
        rng.normal(size=N).astype(np.float32)
    m = rng.normal(size=N).astype(np.float32) if momentum else None
    kw = dict(momentum=momentum, weight_decay=wd, nesterov=nesterov)
    tp, tm = torch.from_numpy(p.copy()), (torch.from_numpy(m.copy())
                                          if momentum else None)
    out = kernels.fused_sgd(tp, torch.from_numpy(g), tm, 0.1, 0.7, **kw)
    p2, m2 = out if momentum else (out, None)
    pr, mr = ref.fused_sgd_ref(torch.from_numpy(p), torch.from_numpy(g),
                               None if m is None else torch.from_numpy(m),
                               torch.tensor(0.1), torch.tensor(0.7), **kw)
    np.testing.assert_allclose(p2, pr, atol=1e-6, rtol=1e-6)
    jout = jfused_update.fused_sgd(
        jnp.asarray(p), jnp.asarray(g), None if m is None else jnp.asarray(m),
        0.1, 0.7, block=256, interpret=True, **kw)
    jp2, jm2 = jout if momentum else (jout, None)
    np.testing.assert_allclose(p2, np.asarray(jp2), atol=F32_ATOL, rtol=0)
    if momentum:
        np.testing.assert_allclose(m2, mr, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(m2, np.asarray(jm2), atol=F32_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("decoupled", [False, True])
def test_fused_adam_kernel_matches_reference(decoupled):
    rng = np.random.default_rng(2)
    N = 777
    p, g, m = (rng.normal(size=N).astype(np.float32) for _ in range(3))
    v = np.abs(rng.normal(size=N)).astype(np.float32)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2,
              decoupled=decoupled)
    t = [torch.from_numpy(x.copy()) for x in (p, g, m, v)]
    p2, m2, v2 = kernels.fused_adam(*t, 0.01, 0.1, 0.002, 0.9, **kw)
    sc = [torch.tensor(x) for x in (0.01, 0.1, 0.002, 0.9)]
    pr, mr, vr = ref.fused_adam_ref(*[torch.from_numpy(x) for x in
                                      (p, g, m, v)], *sc, **kw)
    jouts = jfused_update.fused_adam(
        *[jnp.asarray(x) for x in (p, g, m, v)], 0.01, 0.1, 0.002, 0.9,
        block=128, interpret=True, **kw)
    for got, want, jwant in zip((p2, m2, v2), (pr, mr, vr), jouts):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jwant), atol=F32_ATOL,
                                   rtol=0)


def _optimizers(pkg):
    return [
        ("sgd", pkg.sgd(0.1)),
        ("sgd-m", pkg.sgd(0.1, momentum=0.9, weight_decay=5e-4)),
        ("sgd-nesterov", pkg.sgd(0.1, momentum=0.9, nesterov=True)),
        ("adam", pkg.adam(0.01, weight_decay=5e-4)),
        ("adamw", pkg.adamw(0.01)),
        ("clip-sgd-m",
         pkg.clip_by_global_norm(pkg.sgd(0.1, momentum=0.9), 0.05)),
        ("clip-adam", pkg.clip_by_global_norm(pkg.adam(0.01), 0.05)),
    ]


OPT_NAMES = [n for n, _ in _optimizers(optim)]


@pytest.mark.parametrize("name", OPT_NAMES)
def test_apply_update_flat_matches_reference(name):
    """Two consecutive fused flat updates == two unfused tree updates
    (state threading included), on the mixed ragged tree in fp32."""
    opt, jopt = dict(_optimizers(optim))[name], dict(_optimizers(joptim))[name]
    tt, jt = _mixed(bf16=False)
    rng = np.random.default_rng(3)
    np_g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), _np_mixed())
    grads = weights.from_reference(np_g, "cpu")
    spec = flat.FlatSpec.for_tree(tt)
    p_ref, s_ref = tt, opt.init(tt)
    _, p_fl = spec.as_flat(tree.map(torch.clone, tt))
    s_fl = opt.init(p_fl)
    s_fl = {k: (spec.as_flat(v)[1] if isinstance(v, dict) else v)
            for k, v in s_fl.items()}
    for _ in range(2):
        p_ref, s_ref = exec_core.apply_update(opt, grads, s_ref, p_ref)
        p_fl, s_fl = exec_core.apply_update_flat(
            opt, spec, spec.flatten(grads, dtype=torch.float32), s_fl, p_fl)
    assert max_err(p_fl, _np(p_ref)) < 1e-6
    assert int(s_fl["step"]) == int(s_ref["step"]) == 2
    assert max_err(s_fl, _np(s_ref)) < 1e-6
    jspec = jflat.FlatSpec.for_tree(jt)
    jg = jax.tree.map(jnp.asarray, np_g)
    jp, js = jt, jopt.init(jt)
    for _ in range(2):
        jp, js = jexec_core.apply_update_flat(
            jopt, jspec, jspec.flatten(jg, dtype=jnp.float32), js, jp,
            interpret=True, block=64)
    assert max_err(p_fl, jp) <= F32_ATOL
    assert max_err(s_fl, js) <= F32_ATOL


def test_double_clip_drops_fused_hook():
    """One clip scalar rides into the kernel: a double-wrapped clip falls
    back to the tree update (both clips applied)."""
    opt = optim.clip_by_global_norm(
        optim.clip_by_global_norm(optim.sgd(0.1, momentum=0.9), 0.5), 0.05)
    assert opt.fused is None
    tp, jp = _tiny()
    spec = flat.FlatSpec.for_tree(tp)
    grads = tree.map(torch.ones_like, tp)
    p1, _ = exec_core.apply_update_flat(
        opt, spec, spec.flatten(grads, dtype=torch.float32), opt.init(tp),
        tp)
    p2, _ = exec_core.apply_update(opt, grads, opt.init(tp), tp)
    assert max_err(p1, _np(p2)) < 1e-7
    jopt = joptim.clip_by_global_norm(
        joptim.clip_by_global_norm(joptim.sgd(0.1, momentum=0.9), 0.5), 0.05)
    jp2, _ = jexec_core.apply_update(jopt, jax.tree.map(jnp.ones_like, jp),
                                     jopt.init(jp), jp)
    assert max_err(p1, jp2) <= F32_ATOL


def test_apply_update_flat_falls_back_without_hook():
    """An optimizer with no fused spec routes through the tree update."""
    base = optim.sgd(0.1, momentum=0.9)
    nohook = optim.Optimizer(base.init, base.update)  # fused defaults None
    tp, _ = _tiny()
    spec = flat.FlatSpec.for_tree(tp)
    grads = tree.map(torch.ones_like, tp)
    p1, s1 = exec_core.apply_update_flat(
        nohook, spec, spec.flatten(grads, dtype=torch.float32),
        nohook.init(tp), tp)
    p2, s2 = exec_core.apply_update(base, grads, base.init(tp), tp)
    assert max_err(p1, _np(p2)) < 1e-7
    assert max_err(s1["mom"], _np(s2["mom"])) < 1e-7


# ---------------------------------------------------------------------------
# end to end: the flat executor vs every other executor and the baseline
# ---------------------------------------------------------------------------

def _flat_step(opt, plan, tp, batch):
    ex = engine.FlatFusedExecutor(t_loss_fn, opt, plan)
    params, state = ex.prepare(tree.map(torch.clone, tp), opt.init(tp))
    return ex.step_split(params, state, plan.device_split(batch, "cpu"))


@pytest.mark.parametrize("n_b,n_mu,normalization", [
    (16, 4, "paper"), (10, 4, "exact"), (13, 5, "exact")])
@pytest.mark.parametrize("opt_name", ["sgd-m", "adam", "clip-sgd-m"])
def test_flat_executor_step_matches_baseline(n_b, n_mu, normalization,
                                             opt_name):
    """Ragged tails, exact normalization, clipping: the flat step equals
    the no-MBS baseline update, and the reference's flat step."""
    opt = dict(_optimizers(optim))[opt_name]
    tp, jp = _tiny(4)
    batch = tiny_batch(n_b, seed=4)
    p_ref, _, m_ref = engine.make_baseline_train_step(t_loss_fn, opt)(
        tp, opt.init(tp), t_batch(batch))
    plan = engine.plan_mbs(n_b, micro_batch_size=n_mu,
                           normalization=normalization, device="cpu")
    p, _, m = _flat_step(opt, plan, tp, batch)
    assert max_err(p, _np(p_ref)) < 2e-6
    assert abs(float(m["loss"]) - float(m_ref["loss"])) < 2e-6
    assert abs(float(m["grad_norm"]) - float(m_ref["grad_norm"])) < 2e-5
    jopt = dict(_optimizers(joptim))[opt_name]
    jplan = jengine.plan_mbs(n_b, micro_batch_size=n_mu,
                             normalization=normalization)
    jex = jengine.FlatFusedExecutor(tiny_loss_fn, jopt, jplan,
                                    interpret=True, donate=False)
    jp2, _, jm = jex.step(jp, jopt.init(jp), dict(batch))
    assert max_err(p, jp2) <= F32_ATOL
    assert abs(float(m["loss"]) - float(jm["loss"])) <= F32_ATOL


def test_flat_executor_matches_other_executors():
    """All four executors produce the same update from the same split."""
    tp, jp = _tiny(5)
    batch = tiny_batch(12, seed=5)
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    plan = engine.plan_mbs(12, micro_batch_size=4, device="cpu")
    results = {}
    for name in EXECUTOR_GRID:
        ex = engine.get_executor(name)(t_loss_fn, opt, plan)
        params, state = tree.map(torch.clone, tp), opt.init(tp)
        if name == "flat":
            params, state = ex.prepare(params, state)
        results[name] = ex.step_split(params, state,
                                      plan.device_split(batch, "cpu"))
    for name in ("streaming", "fused", "flat"):
        assert max_err(results[name][0], _np(results["compiled"][0])) < 2e-6
        assert abs(float(results[name][2]["loss"])
                   - float(results["compiled"][2]["loss"])) < 2e-6
    jopt = joptim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    jplan = jengine.plan_mbs(12, micro_batch_size=4)
    jp2, _, _ = make_executor("compiled", tiny_loss_fn, jopt, jplan,
                              donate=False).step(jp, jopt.init(jp),
                                                 dict(batch))
    assert max_err(results["flat"][0], jp2) <= F32_ATOL


def test_flat_executor_respects_accum_dtype():
    tp, jp = _tiny()
    batch = tiny_batch(8)
    plan = engine.plan_mbs(8, micro_batch_size=4, accum_dtype=torch.bfloat16,
                           device="cpu")
    ex = engine.FlatFusedExecutor(t_loss_fn, optim.sgd(0.1), plan)
    g, _ = ex.gradients(tp, plan.device_split(batch, "cpu"))
    assert all(x.dtype == torch.bfloat16 for x in tree.leaves(g))
    jplan = jengine.plan_mbs(8, micro_batch_size=4, accum_dtype=jnp.bfloat16)
    jg, _ = jengine.FlatFusedExecutor(tiny_loss_fn, joptim.sgd(0.1), jplan,
                                      interpret=True).gradients(
        jp, jplan.device_split(batch))
    assert max_err(g, jg) <= DTYPE_ATOL[jnp.dtype(jnp.bfloat16)]


# ---------------------------------------------------------------------------
# the state a step consumes (the reference's donation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["compiled", "flat"])
def test_step_split_donation_safety(executor):
    """Thread the state through three steps as a caller of a donating step
    does: every output stays readable and equals the reference's, and
    ``flat`` consumed its state — params and momentum written in place,
    the same buffers handed back each step."""
    opt = optim.sgd(0.1, momentum=0.9)
    plan = engine.plan_mbs(8, micro_batch_size=4, device="cpu")
    ex = engine.get_executor(executor)(t_loss_fn, opt, plan)
    tp, jp = _tiny(6)
    params, state = tp, opt.init(tp)
    if executor == "flat":
        params, state = ex.prepare(tree.map(torch.clone, tp), state)
        spec = flat.FlatSpec.for_tree(params)
        bufs = spec.buffers_of(params) + spec.buffers_of(state["mom"])
    jopt = joptim.sgd(0.1, momentum=0.9)
    jex = make_executor(executor, tiny_loss_fn, jopt,
                        jengine.plan_mbs(8, micro_batch_size=4))
    js = jopt.init(jp)
    for i in range(3):
        batch = tiny_batch(8, seed=10 + i)
        params, state, metrics = ex.step_split(
            params, state, plan.device_split(batch, "cpu"))
        jp, js, _ = jex.step_split(
            jp, js, jengine.plan_mbs(8, micro_batch_size=4).device_split(
                batch))
        for leaf in tree.leaves((params, state)):
            assert torch.isfinite(leaf.float()).all()
        float(metrics["loss"])
        if executor == "flat":
            assert spec.buffers_of(params) + spec.buffers_of(state["mom"]) \
                == bufs
    assert max_err(params, jp) <= F32_ATOL
    assert max_err(state["mom"], js["mom"]) <= F32_ATOL


def test_step_split_inputs_reusable_when_not_consumed():
    """The reference's ``donate=False`` lets a caller run one step twice on
    the same buffers. The port's ``compiled`` step leaves its inputs
    alone, so that holds as it is; ``flat`` consumes its state, so a
    caller passes it copies."""
    opt = optim.sgd(0.1)
    plan = engine.plan_mbs(8, micro_batch_size=4, device="cpu")
    tp, _ = _tiny()
    split = plan.device_split(tiny_batch(8), "cpu")
    ex = engine.CompiledScanExecutor(t_loss_fn, opt, plan)
    state = opt.init(tp)
    before = tree.map(torch.clone, tp)
    p1, _, _ = ex.step_split(tp, state, split)
    p2, _, _ = ex.step_split(tp, state, split)
    assert max_err(p1, _np(p2)) == 0
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(tp),
                                                 tree.leaves(before)))
    fex = engine.FlatFusedExecutor(t_loss_fn, opt, plan)
    flat_p, flat_s = fex.prepare(tree.map(torch.clone, tp), opt.init(tp))
    runs = []
    for _ in range(2):
        cp = tree.map(torch.clone, flat_p)
        cp, cs = fex.prepare(cp, {k: v for k, v in flat_s.items()})
        runs.append(fex.step_split(cp, cs, split)[0])
    assert max_err(runs[0], _np(runs[1])) == 0
    assert max_err(runs[0], _np(p1)) < 1e-7


# ---------------------------------------------------------------------------
# memory model: the step-❺ transient changes admission
# ---------------------------------------------------------------------------

def test_update_transient_term_and_fused_admission():
    cfg, jcfg = configs.get_reduced("qwen2-1.5b"), \
        jconfigs.get_reduced("qwen2-1.5b")
    est_u = memory_model.estimate(cfg, 16)
    est_f = memory_model.estimate(cfg, 16, fused_update=True)
    for got, want in ((est_u, jmemory_model.estimate(jcfg, 16)),
                      (est_f, jmemory_model.estimate(jcfg, 16,
                                                     fused_update=True))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert est_u.update_transient_bytes == \
        memory_model.update_transient_bytes(est_u.params_bytes, "sgd")
    assert est_f.update_transient_bytes == 0
    assert est_u.total(4) - est_f.total(4) == est_u.update_transient_bytes
    est_a = memory_model.estimate(cfg, 16, optimizer="adam")
    assert est_a.update_transient_bytes == 3 * est_a.params_bytes
    budget = est_u.total(4) - 1
    mu_u = memory_model.suggest_micro_batch_size(cfg, 16, 64,
                                                 budget_bytes=budget)
    mu_f = memory_model.suggest_micro_batch_size(
        cfg, 16, 64, budget_bytes=budget, fused_update=True)
    assert (mu_u or 0) < 4 <= (mu_f or 0)
    plan_u = engine.plan_mbs(64, model_cfg=cfg, seq_len=16,
                             budget_bytes=budget, device="cpu")
    plan_f = engine.plan_mbs(64, model_cfg=cfg, seq_len=16,
                             budget_bytes=budget, fused_update=True,
                             device="cpu")
    assert plan_f.micro_batch_size > plan_u.micro_batch_size
    assert plan_f.micro_batch_size == jengine.plan_mbs(
        64, model_cfg=jcfg, seq_len=16, budget_bytes=budget,
        fused_update=True).micro_batch_size


def test_fused_admission_gated_on_optimizer_hook():
    hooked = optim.sgd(0.05, momentum=0.9)
    nohook = optim.Optimizer(hooked.init, hooked.update)
    assert optim.memory_model_kw(hooked, fused=True) == {
        "opt_slots": 1, "fused_update": True}
    assert optim.memory_model_kw(nohook, fused=True) == {
        "opt_slots": 1, "fused_update": False}
    adam = optim.adam(1e-3)
    assert optim.memory_model_kw(optim.Optimizer(adam.init, adam.update),
                                 fused=True) == {
        "opt_slots": 2, "fused_update": False}
    assert optim.memory_model_kw(optim.sgd(0.1), fused=True) == {
        "opt_slots": 0, "fused_update": True}
    jadam = joptim.adam(1e-3)
    assert joptim.memory_model_kw(
        joptim.Optimizer(jadam.init, jadam.update), fused=True) == \
        optim.memory_model_kw(optim.Optimizer(adam.init, adam.update),
                              fused=True)


@pytest.mark.gpu
def test_allocator_peak_reflects_in_place_update():
    """The twin of the reference's ``memory_analysis`` of the donated
    step, on the card. Above the resident state, the unfused
    (``compiled``) step holds the fp32 accumulator and then the update's
    new trees — updates, momentum, params: at least (2 + slots) × params
    bytes — while ``flat`` writes params and momentum in place, so its
    peak stays at least one params-sized tree below."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (reads the caching allocator's "
                    "peak)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    np_p = {"w1": rng.normal(0, 0.3, (8, 1 << 20)).astype(np.float32),
            "w2": rng.normal(0, 0.3, (1 << 20, 4)).astype(np.float32)}
    params_bytes = sum(x.nbytes for x in np_p.values())
    opt = optim.sgd(0.1, momentum=0.9)
    plan = engine.plan_mbs(8, micro_batch_size=4, device=dev)
    batch = {"x": rng.normal(size=(8, 8)).astype(np.float32),
             "y": rng.integers(0, 4, 8).astype(np.int32)}
    excess = {}
    for name in ("compiled", "flat"):
        ex = engine.get_executor(name)(t_loss_fn, opt, plan)
        params = weights.from_reference(np_p, dev)
        state = opt.init(params)
        if name == "flat":
            params, state = ex.prepare(params, state)
        split = plan.device_split(batch, dev)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, m = ex.step_split(params, state, split)
        torch.cuda.synchronize(dev)
        excess[name] = torch.cuda.max_memory_allocated(dev) - base
        del params, state, m, split, ex
        torch.cuda.empty_cache()
    slots = 1  # SGD-m's momentum
    assert excess["compiled"] >= (2 + slots) * params_bytes, excess
    assert excess["compiled"] - excess["flat"] >= params_bytes, excess
