"""The port's streaming executor (paper Fig. 1) against the JAX package's
(``tests/test_streaming.py``): the same numpy params and batches go
through ``repro.core.streaming.MBSStreamExecutor`` and
``repro_torch.core.streaming.MBSStreamExecutor`` on the tiny tanh MLP.

fp32 params and gradients agree within 1e-6 abs and losses within 1e-5
(XLA and torch order the matmul sums differently); within the port,
``step`` and ``step_split`` run the same ops on the same values and are
bit-identical.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_loss_fn, tiny_params  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import mbs as JM  # noqa: E402
from repro.core.streaming import MBSStreamExecutor as JStream  # noqa: E402
from repro.engine import CompiledScanExecutor as JCompiled  # noqa: E402
from repro_torch import engine, optim, tree, weights  # noqa: E402
from repro_torch.core import losses, mbs as M  # noqa: E402
from repro_torch.core.streaming import (MBSStreamExecutor,  # noqa: E402
                                        prefetch_iterator)
from repro_torch.engine import exec_core  # noqa: E402


def t_loss_fn(p, batch, exact_denom=None):
    """``conftest.tiny_loss_fn`` in PyTorch."""
    h = torch.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    return losses.cross_entropy(
        logits, batch["y"], sample_weight=batch.get("sample_weight"),
        exact_denom=exact_denom), {}


def _make_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 8)).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}


def _params(seed=0):
    """(reference params, port params) from the same numpy values."""
    np_params = jax.tree.map(np.asarray, tiny_params(seed))
    return (jax.tree.map(jnp.asarray, np_params),
            weights.from_reference(np_params, "cpu"))


def _max_err(got, want) -> float:
    return max(float(np.max(np.abs(
        np.asarray(g.detach().float()) - np.asarray(w, np.float32))))
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)))


def _split(batch, micro):
    return {k: torch.from_numpy(v)
            for k, v in M.split_minibatch(batch, micro).items()}


def test_step_matches_compiled_step():
    jp, tp = _params()
    batch = _make_batch(12)
    jopt, topt = joptim.sgd(0.1, momentum=0.9), optim.sgd(0.1, momentum=0.9)

    ex = MBSStreamExecutor(t_loss_fn, topt, M.MBSConfig(4))
    p_stream, s_stream, m_stream = ex.step(tp, topt.init(tp), dict(batch))
    assert m_stream["loss"].dim() == 0  # a tensor: nothing read back

    split = {k: jnp.asarray(v)
             for k, v in JM.split_minibatch(batch, 4).items()}
    jstep = JM.make_mbs_train_step(tiny_loss_fn, jopt, JM.MBSConfig(4))
    p_comp, s_comp, m_comp = jax.jit(jstep)(jp, jopt.init(jp), split)
    assert _max_err(p_stream, p_comp) < 1e-6
    assert _max_err(s_stream["mom"], s_comp["mom"]) < 1e-6
    assert abs(float(m_stream["loss"]) - float(m_comp["loss"])) < 1e-5

    # and the reference's own streaming step, on the same inputs
    p_js, _, m_js = JStream(tiny_loss_fn, jopt, JM.MBSConfig(4)).step(
        jp, jopt.init(jp), dict(batch))
    assert _max_err(p_stream, p_js) < 1e-6
    assert abs(float(m_stream["loss"]) - float(m_js["loss"])) < 1e-5


def test_prefetch_iterator_order_and_completeness():
    out = list(prefetch_iterator(iter(range(57)), size=3))
    assert out == list(range(57))


@pytest.mark.parametrize("normalization,n_b", [("paper", 12), ("exact", 12),
                                               ("exact", 10)])
def test_stream_executor_honors_normalization(normalization, n_b):
    jp, tp = _params(3)
    batch = _make_batch(n_b)
    jcfg = JM.MBSConfig(4, normalization=normalization)
    cfg = M.MBSConfig(4, normalization=normalization)
    jsplit = {k: jnp.asarray(v)
              for k, v in JM.split_minibatch(batch, 4).items()}
    g_s, l_s = MBSStreamExecutor(t_loss_fn, optim.sgd(0.1), cfg).gradients(
        tp, _split(batch, 4))
    g_js, l_js = JStream(tiny_loss_fn, joptim.sgd(0.1), jcfg).gradients(
        jp, jsplit)
    g_jc, _ = JCompiled(tiny_loss_fn, joptim.sgd(0.1), jcfg).gradients(
        jp, jsplit)
    assert _max_err(g_s, g_js) < 1e-6
    assert _max_err(g_s, g_jc) < 1e-6
    assert abs(float(l_s) - float(l_js)) < 1e-6
    # exact mode equals the full-batch gradient even with a ragged tail
    if normalization == "exact":
        full = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, _, ref = exec_core.value_and_grad(
            lambda p: t_loss_fn(p, full), tp)
        for a, b in zip(tree.leaves(g_s), tree.leaves(ref)):
            assert float((a - b).abs().max()) < 1e-6


def test_stream_executor_honors_accum_dtype():
    jp, tp = _params(4)
    batch = _make_batch(8)
    g, _ = MBSStreamExecutor(
        t_loss_fn, optim.sgd(0.1),
        M.MBSConfig(4, accum_dtype=torch.bfloat16)).gradients(
            tp, _split(batch, 4))
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree.leaves(g))
    jg, _ = JStream(tiny_loss_fn, joptim.sgd(0.1),
                    JM.MBSConfig(4, accum_dtype=jnp.bfloat16)).gradients(
        jp, {k: jnp.asarray(v)
             for k, v in JM.split_minibatch(batch, 4).items()})
    assert _max_err(g, jg) < 2e-2  # conftest.DTYPE_ATOL for bf16


@pytest.mark.parametrize("n_b", [8, 10])
def test_step_equals_step_split(n_b):
    """``step`` (host mini-batch, micro-batches staged one by one) and
    ``step_split`` (a staged split) run the same ops on the same values."""
    _, tp = _params()
    plan = engine.plan_mbs(n_b, micro_batch_size=4, device="cpu")
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    ex = engine.StreamingExecutor(t_loss_fn, opt, plan)
    batch = _make_batch(n_b, seed=1)
    p1, s1, m1 = ex.step(tp, opt.init(tp), dict(batch))
    p2, s2, m2 = ex.step_split(tp, opt.init(tp),
                               plan.device_split(batch, "cpu"))
    for a, b in zip(tree.leaves((p1, s1, m1)), tree.leaves((p2, s2, m2))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(engine.EXECUTORS))
def test_guard_waits_for_the_supervisor(name):
    """``guard=True`` (the supervisor's finite check) is accepted by every
    executor; on a clean batch the guarded step is the unguarded one,
    with ``nonfinite`` 0 as a tensor beside the metrics."""
    plan = engine.plan_mbs(8, micro_batch_size=4, device="cpu")
    split = plan.device_split(_make_batch(8), "cpu")
    outs = []
    for guard in (False, True):
        opt = optim.sgd(0.1, momentum=0.9)
        ex = engine.get_executor(name)(t_loss_fn, opt, plan, guard=guard)
        p = _params()[1]
        outs.append(ex.step_split(p, opt.init(p), split))
    (p1, s1, m1), (p2, s2, m2) = outs
    assert isinstance(m2["nonfinite"], torch.Tensor)
    assert float(m2["nonfinite"]) == 0.0 and "nonfinite" not in m1
    for a, b in zip(tree.leaves((p1, s1)), tree.leaves((p2, s2))):
        assert torch.equal(a, b)


def test_get_executor_resolves_streaming():
    assert engine.get_executor("streaming") is engine.StreamingExecutor
    assert MBSStreamExecutor is engine.StreamingExecutor
    with pytest.raises(ValueError, match="unknown executor"):
        engine.get_executor("pipelined")


def test_legacy_facade_matches_reference():
    """``core.mbs``: ``make_mbs_train_step`` and ``mbs_gradients`` against
    the JAX package's, ragged exact split; the baseline step equals one
    micro-batch holding the whole mini-batch."""
    jp, tp = _params(5)
    batch = _make_batch(10, seed=2)
    jcfg, cfg = (JM.MBSConfig(4, normalization="exact"),
                 M.MBSConfig(4, normalization="exact"))
    jsplit = {k: jnp.asarray(v)
              for k, v in JM.split_minibatch(batch, 4).items()}
    g, loss = M.mbs_gradients(t_loss_fn, tp, _split(batch, 4), cfg)
    jg, jloss = JM.mbs_gradients(tiny_loss_fn, jp, jsplit, jcfg)
    assert _max_err(g, jg) < 1e-6
    assert abs(float(loss) - float(jloss)) < 1e-6
    topt, jopt = optim.sgd(0.1, momentum=0.9), joptim.sgd(0.1, momentum=0.9)
    p, _, m = M.make_mbs_train_step(t_loss_fn, topt, cfg)(
        tp, topt.init(tp), _split(batch, 4))
    jp2, _, jm = JM.make_mbs_train_step(tiny_loss_fn, jopt, jcfg)(
        jp, jopt.init(jp), jsplit)
    assert _max_err(p, jp2) < 1e-6
    assert abs(float(m["loss"]) - float(jm["loss"])) < 1e-5
    full = {k: torch.from_numpy(v) for k, v in batch.items()}
    pb, _, mb = M.make_baseline_train_step(t_loss_fn, topt)(
        tp, topt.init(tp), full)
    p1, _, m1 = M.make_mbs_train_step(t_loss_fn, topt, M.MBSConfig(10))(
        tp, topt.init(tp), _split(batch, 10))
    for a, b in zip(tree.leaves(pb), tree.leaves(p1)):
        assert float((a - b).abs().max()) < 1e-6
    assert abs(float(mb["loss"]) - float(m1["loss"])) < 1e-6
