"""The port's numeric guard (the supervisor's finite check in front of step
❺) against the JAX package's ``exec_core.finite_all`` /
``guarded_update`` / ``guarded_update_flat`` and the executors'
``guard=True``, on the same numpy inputs.

  * K2–K4's plain versions and CPU wrappers under the flag: 1 gives the
    unguarded update bit for bit, 0 every buffer back unchanged;
  * ``finite_all`` equals the reference's on finite, NaN, ±inf, empty and
    bf16 leaves and across its slices, and reads each leaf in slices of at
    most ``FINITE_CHUNK`` elements;
  * the guarded flat update (SGD-m, SGD, Adam) equals the reference's
    ``guarded_update_flat`` on a finite and a poisoned accumulator;
  * every executor's guarded step: on a clean batch bit-identical to the
    unguarded step, on a poisoned one the state (the step counter
    included) bit-identical to what went in, and both equal to the
    reference's guarded step.

Tolerances: cross-package values within ``DTYPE_ATOL`` (fp32 2e-6); within
the port, bit for bit. Card-only cases (the Triton ``GUARD`` kernels, the
sync count) carry the ``gpu`` marker and skip here.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import (DTYPE_ATOL, ToyDataset, make_executor,  # noqa: E402
                      tiny_loss_fn, tiny_optimizer, tiny_params)
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.engine import exec_core as jcore  # noqa: E402
from repro_torch import engine, optim, tree, weights  # noqa: E402
from repro_torch.engine import exec_core, faults  # noqa: E402
from repro_torch.kernels import fused_adam, fused_sgd, ref  # noqa: E402
from test_torch_streaming import t_loss_fn  # noqa: E402

ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
EXECUTOR_GRID = sorted(engine.EXECUTORS)
OPTIMIZERS = {
    "sgd_mom": (lambda o: o.sgd(0.1, momentum=0.9, weight_decay=1e-4)),
    "sgd": (lambda o: o.sgd(0.1, weight_decay=1e-4)),
    "adam": (lambda o: o.adam(1e-2, weight_decay=1e-4)),
}


def _rng_bufs(n, k, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dtype)
            for _ in range(k)]


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _close(got, want, what=""):
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=ATOL, rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# K2-K4's plain versions and CPU wrappers under the flag
# ---------------------------------------------------------------------------

def _plain(kind, bufs, ok):
    lr, clip = torch.tensor(0.05), torch.tensor(0.7)
    if kind == "adam":
        p, g, m, v = bufs
        return ref.fused_adam_ref(p, g, m, v.abs(), lr, torch.tensor(0.1),
                                  torch.tensor(0.01), clip,
                                  weight_decay=1e-2, ok=ok)
    p, g, m = bufs
    return ref.fused_sgd_ref(p, g, m if kind == "sgd_mom" else None, lr,
                             clip, momentum=0.9, weight_decay=5e-4,
                             nesterov=True, ok=ok)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["sgd_mom", "sgd", "adam"])
def test_plain_versions_follow_the_flag(kind, dtype):
    bufs = _rng_bufs(1001, 4 if kind == "adam" else 3, seed=1)
    bufs = [b.to(dtype) if i != 1 else b for i, b in enumerate(bufs)]
    want = _plain(kind, bufs, None)
    assert _equal(_plain(kind, bufs, torch.ones(1)), want)
    bufs[1][7] = float("nan")  # a poisoned accumulator, skipped
    got = _plain(kind, bufs, torch.zeros(1))
    olds = ([bufs[0], bufs[2], bufs[3].abs()] if kind == "adam"
            else [bufs[0], bufs[2] if kind == "sgd_mom" else None])
    for g, o in zip(got, olds):
        assert (g is None and o is None) or torch.equal(g, o)


@pytest.mark.parametrize("kind", ["sgd_mom", "sgd", "adam"])
def test_cpu_wrappers_follow_the_flag(kind):
    for flag in (True, False):
        bufs = _rng_bufs(333, 4, seed=2)
        bufs[3] = bufs[3].abs()
        before = [b.clone() for b in bufs]
        want = [b.clone() for b in bufs]
        ok = torch.tensor(flag)
        if kind == "adam":
            args = (0.01, 0.1, 0.01, 0.5)
            fused_adam(*bufs, *args, weight_decay=1e-2, ok=ok)
            fused_adam(*want, *args, weight_decay=1e-2)
        else:
            m = bufs[2] if kind == "sgd_mom" else None
            wm = want[2] if kind == "sgd_mom" else None
            fused_sgd(bufs[0], bufs[1], m, 0.05, 0.5, momentum=0.9, ok=ok)
            fused_sgd(want[0], want[1], wm, 0.05, 0.5, momentum=0.9)
        assert _equal(bufs, want if flag else before)


# ---------------------------------------------------------------------------
# finite_all
# ---------------------------------------------------------------------------

FINITE_CASES = {
    "finite": {},
    "nan": {"a": (5, float("nan"))},
    "+inf": {"b": (0, float("inf"))},
    "-inf": {"c": (-1, float("-inf"))},
    "nan_last_slice": {"b": (99, float("nan"))},
}


@pytest.mark.parametrize("case", sorted(FINITE_CASES))
def test_finite_all_matches_reference(case, monkeypatch):
    monkeypatch.setattr(exec_core, "FINITE_CHUNK", 16)  # several slices
    rng = np.random.default_rng(3)
    leaves = {"a": rng.normal(size=(7, 6)).astype(np.float32),
              "b": rng.normal(size=100).astype(np.float32),
              "c": rng.normal(size=(3,)).astype(np.float32),
              "empty": np.zeros((0, 4), np.float32)}
    for name, (i, val) in FINITE_CASES[case].items():
        leaves[name].reshape(-1)[i] = val
    want = bool(jcore.finite_all(jax.tree.map(jnp.asarray, leaves)))
    got = exec_core.finite_all({k: torch.from_numpy(v.copy())
                                for k, v in leaves.items()})
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == want == (case == "finite")
    assert bool(ref.finite_all_ref([torch.from_numpy(v) for v in
                                    leaves.values()])) == want
    bf16 = exec_core.finite_all([torch.from_numpy(v).to(torch.bfloat16)
                                 for v in leaves.values()])
    assert bool(bf16) == want


def test_finite_all_reads_in_slices(monkeypatch):
    """No temporary the size of a bucket: each reduction reads at most
    ``FINITE_CHUNK`` elements and makes no elementwise mask."""
    monkeypatch.setattr(exec_core, "FINITE_CHUNK", 64)
    seen, real = [], torch.aminmax

    def aminmax(x, **kw):
        seen.append(x.numel())
        return real(x, **kw)

    monkeypatch.setattr(torch, "aminmax", aminmax)
    monkeypatch.setattr(torch, "isfinite", lambda x: (
        pytest.fail(f"isfinite over {x.numel()} elements")
        if x.numel() > 1 else torch.eq(x, x) & (x.abs() != float("inf"))))
    buf = torch.zeros(1000)
    assert bool(exec_core.finite_all([buf]))
    assert seen == [64] * 15 + [40]
    assert bool(exec_core.finite_all([])) is True


# ---------------------------------------------------------------------------
# the guarded flat update against the reference's guarded_update_flat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("poisoned", [False, True])
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_guarded_update_flat_matches_reference(opt_name, poisoned):
    np_params = jax.tree.map(np.asarray, tiny_params(0))
    rng = np.random.default_rng(4)
    np_grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), np_params)
    if poisoned:
        np_grads["w2"][1, 2] = np.nan
    jopt, topt = OPTIMIZERS[opt_name](joptim), OPTIMIZERS[opt_name](optim)
    # one clean step first, so the state (momentum, Adam's moments, the
    # counter) is not the initial one
    jp = jax.tree.map(jnp.asarray, np_params)
    jspec = jengine.FlatSpec.for_tree(jp)
    js = jopt.init(jp)
    jacc = jspec.flatten(jax.tree.map(jnp.asarray, np_grads))
    clean = jspec.flatten(jax.tree.map(lambda x: jnp.asarray(x) * 0.5,
                                       np_params))
    jp, js = jcore.apply_update_flat(jopt, jspec, clean, js, jp,
                                     interpret=True)
    jp2, js2, jok = jcore.guarded_update_flat(jopt, jspec, jacc, js, jp,
                                              interpret=True)

    tp = weights.from_reference(np_params, "cpu")
    ex = engine.FlatFusedExecutor(t_loss_fn, topt, engine.plan_mbs(
        4, micro_batch_size=4, device="cpu"))
    tp, ts = ex.prepare(tp, topt.init(tp))
    spec = engine.FlatSpec.for_tree(tp)
    tclean = spec.flatten(tree.map(lambda x: x * 0.5, tp))
    tp, ts = exec_core.apply_update_flat(topt, spec, tclean, ts, tp)
    before = tree.map(torch.clone, (tp, ts))
    tacc = spec.flatten(weights.from_reference(np_grads, "cpu"))
    tp2, ts2, tok = exec_core.guarded_update_flat(topt, spec, tacc, ts, tp)
    assert bool(tok) == bool(jok) == (not poisoned)
    _close((tp2, {k: v for k, v in ts2.items() if k != "step"}),
           (jp2, {k: v for k, v in js2.items() if k != "step"}),
           f"{opt_name} guarded flat update")
    assert int(ts2["step"]) == int(js2["step"]) == (1 if poisoned else 2)
    if poisoned:
        assert _equal((tp2, ts2), before)


# ---------------------------------------------------------------------------
# every executor's guarded step
# ---------------------------------------------------------------------------

def _plan(jax_side=False):
    kw = dict(micro_batch_size=4, normalization="exact")
    return (jengine.plan_mbs(10, **kw) if jax_side
            else engine.plan_mbs(10, device="cpu", **kw))


def _batches():
    """(clean split, split with micro-batch 1 poisoned by faults.nan_at)."""
    plan = _plan()
    clean = plan.split(ToyDataset().batch(10, 0))
    with faults.inject(faults.FaultPlan(faults.nan_at(0, micro=1))):
        bad = faults.corrupt_batch(clean, 0)
    return clean, bad


def _port_state(opt):
    p = weights.from_reference(jax.tree.map(np.asarray, tiny_params()),
                               "cpu")
    return p, opt.init(p)


def _port_step(executor, guard, params, state, split):
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    ex = engine.get_executor(executor)(t_loss_fn, opt, _plan(), guard=guard)
    if executor == "flat":
        params, state = ex.prepare(params, state)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in split.items()}
    return ex.step_split(params, state, batch)


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_guarded_step_skips_a_poisoned_update_bitwise(executor):
    clean, bad = _batches()
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    # on a clean batch the guard changes nothing
    p_u, s_u, m_u = _port_step(executor, False, *_port_state(opt), clean)
    p_g, s_g, m_g = _port_step(executor, True, *_port_state(opt), clean)
    assert _equal((p_g, s_g), (p_u, s_u))
    assert "nonfinite" not in m_u and float(m_g["nonfinite"]) == 0.0
    assert isinstance(m_g["nonfinite"], torch.Tensor)
    # a poisoned batch: state (and the step counter) as it went in
    params, state = p_g, s_g
    before = tree.map(torch.clone, (params, state))
    p_b, s_b, m_b = _port_step(executor, True, params, state, bad)
    assert float(m_b["nonfinite"]) == 1.0
    assert _equal((p_b, s_b), before)
    assert int(s_b["step"]) == 1


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_guarded_step_matches_reference(executor):
    clean, bad = _batches()
    jex = make_executor(executor, tiny_loss_fn, tiny_optimizer(),
                        _plan(jax_side=True), guard=True, donate=False)
    jp = tiny_params()
    js = tiny_optimizer().init(jp)
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    tp, ts = _port_state(opt)
    for split in (clean, bad):
        jp, js, jm = jex.step_split(jp, js, jax.tree.map(jnp.asarray, split))
        tp, ts, tm = _port_step(executor, True, tp, ts, split)
        assert float(tm["nonfinite"]) == float(jm["nonfinite"])
        _close((tp, ts["mom"]), (jp, js["mom"]), f"{executor} guarded step")
        assert int(ts["step"]) == int(js["step"]) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the GUARD variants of K2-K4 are "
                    "Triton kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["sgd_mom", "sgd", "adam"])
def test_guard_kernels_on_the_card(card, kind):
    """Flag 1: bit-identical to the unguarded kernel; flag 0: every buffer
    unchanged, a NaN in the accumulator included."""
    n = 1_000_003
    for flag in (True, False):
        bufs = [b.to(card) for b in _rng_bufs(n, 4, seed=5)]
        bufs[3] = bufs[3].abs()
        bufs[1][n // 2] = float("nan")
        before = [b.clone() for b in bufs]
        want = [b.clone() for b in bufs]
        ok = torch.tensor(flag, device=card)
        if kind == "adam":
            fused_adam(*bufs, 0.01, 0.1, 0.01, 0.5, ok=ok)
            fused_adam(*want, 0.01, 0.1, 0.01, 0.5)
        else:
            m = bufs[2] if kind == "sgd_mom" else None
            wm = want[2] if kind == "sgd_mom" else None
            fused_sgd(bufs[0], bufs[1], m, 0.05, 0.5, momentum=0.9, ok=ok)
            fused_sgd(want[0], want[1], wm, 0.05, 0.5, momentum=0.9)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(
            bufs, want if flag else before))
