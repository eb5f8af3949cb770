"""``tests/test_mbs.py`` case for case in the port: the paper's core claim
(eq. 15–17) — MBS-accumulated, loss-normalized gradients equal the
full-mini-batch gradients — and Algorithm 1's behaviours (ragged tails,
the N_μ clamp), each on the reference's numpy inputs in both packages.

The port's claims hold to the reference's own bounds (1e-6); the port's
gradients, steps and metrics equal the reference's within ``DTYPE_ATOL``
(fp32, conftest). Also the tiny model's torch twin that the other
``test_torch_*`` twins of reference tests share (``t_params``,
``t_batch``, ``t_grads``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import mbs as JM  # noqa: E402
from repro_torch import optim, tree, weights  # noqa: E402
from repro_torch.core import losses, mbs as M  # noqa: E402
from repro_torch.engine import exec_core  # noqa: E402

F32_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]


# ---------------------------------------------------------------------------
# the tiny model in both packages (test_mbs.py's, with its accuracy metric)
# ---------------------------------------------------------------------------

def j_loss_fn(p, batch, exact_denom=None):
    h = jnp.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    loss = jlosses.cross_entropy(logits, batch["y"],
                                 sample_weight=batch.get("sample_weight"),
                                 exact_denom=exact_denom)
    return loss, {"acc": jlosses.accuracy(logits, batch["y"])}


def t_loss_fn(p, batch, exact_denom=None):
    h = torch.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    loss = losses.cross_entropy(logits, batch["y"],
                                sample_weight=batch.get("sample_weight"),
                                exact_denom=exact_denom)
    return loss, {"acc": losses.accuracy(logits, batch["y"])}


def np_params(seed, din=8, dh=16, dout=4):
    """test_mbs.py's ``tiny_params(PRNGKey(seed))`` as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": np.asarray(jax.random.normal(k1, (din, dh)) * 0.3),
            "w2": np.asarray(jax.random.normal(k2, (dh, dout)) * 0.3)}


def t_params(p):
    return weights.from_reference(p, "cpu")


def j_params(p):
    return jax.tree.map(jnp.asarray, p)


def make_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 8)).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}


def t_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def t_grads(loss_fn, params, batch):
    """(loss, grads) of the whole batch in the port."""
    loss, _, grads = exec_core.value_and_grad(
        lambda p: loss_fn(p, t_batch(batch)), params)
    return loss, grads


def max_err(got, want) -> float:
    """Largest |got - want| over two trees, either package's leaves."""
    def arr(x):
        return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x, np.float32))
    return max(float(np.max(np.abs(arr(a) - arr(b))))
               for a, b in zip(tree.leaves(got), jax.tree.leaves(want)))


def _split(batch, n_mu):
    return M.split_minibatch(batch, n_mu)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalization,n_b,n_mu", [
    ("paper", 12, 4), ("paper", 16, 8), ("paper", 16, 2), ("paper", 9, 3),
    ("exact", 12, 5), ("exact", 13, 4), ("exact", 7, 3), ("exact", 10, 7)])
def test_split_matches_full_batch(normalization, n_b, n_mu):
    """test_uniform_split_matches_full_batch (paper) and
    test_ragged_split_exact_mode (exact): one parametrised test."""
    seed = 0 if normalization == "paper" else 1
    p = np_params(seed)
    batch = make_batch(n_b, seed=seed)
    ref_loss, ref_g = t_grads(t_loss_fn, t_params(p), batch)
    split = _split(batch, n_mu)
    g, loss = M.mbs_gradients(t_loss_fn, t_params(p), t_batch(split),
                              M.MBSConfig(n_mu, normalization))
    assert max_err(g, ref_g) < 1e-6
    if normalization == "paper":
        assert abs(float(loss) - float(ref_loss)) < 1e-6
    jg, jloss = JM.mbs_gradients(
        j_loss_fn, j_params(p), {k: jnp.asarray(v) for k, v in split.items()},
        JM.MBSConfig(n_mu, normalization))
    assert max_err(g, jg) <= F32_ATOL
    assert abs(float(loss) - float(jloss)) <= F32_ATOL


def test_algorithm1_n_mu_clamp():
    for n_b, n_mu in ((4, 16), (16, 4), (17, 4)):
        assert M.num_micro_batches(n_b, n_mu) == \
            JM.num_micro_batches(n_b, n_mu)
    assert M.num_micro_batches(4, 16) == 1
    assert M.num_micro_batches(16, 4) == 4
    assert M.num_micro_batches(17, 4) == 5  # round-up (line 5)
    split = M.split_minibatch(make_batch(4), 16)
    assert split["x"].shape == (1, 4, 8)


def test_split_minibatch_is_partition():
    batch = make_batch(13)
    split = M.split_minibatch(batch, 5)
    n_s, n_mu = split["x"].shape[:2]
    assert n_s == 3 and n_mu == 5
    flat = split["x"].reshape(-1, 8)[split["sample_weight"].reshape(-1) > 0]
    np.testing.assert_array_equal(flat, batch["x"])
    assert split["sample_weight"].sum() == 13
    want = JM.split_minibatch(batch, 5)
    for k in want:
        np.testing.assert_array_equal(split[k], want[k])


def test_compiled_step_matches_baseline_update():
    """One optimizer step via MBS == one step via the no-MBS baseline."""
    p = np_params(2)
    batch = make_batch(16, seed=2)
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    params = t_params(p)
    p1, _, m1 = M.make_baseline_train_step(t_loss_fn, opt)(
        params, opt.init(params), t_batch(batch))
    split = _split(batch, 4)
    step = M.make_mbs_train_step(t_loss_fn, opt, M.MBSConfig(4, "paper"))
    p2, _, m2 = step(params, opt.init(params), t_batch(split))
    assert max_err(p1, {k: v.detach().numpy() for k, v in p2.items()}) \
        < 1e-6
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-6
    jopt = joptim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    jstep = jax.jit(JM.make_mbs_train_step(j_loss_fn, jopt,
                                           JM.MBSConfig(4, "paper")))
    jp = j_params(p)
    jp2, _, jm2 = jstep(jp, jopt.init(jp),
                        {k: jnp.asarray(v) for k, v in split.items()})
    assert max_err(p2, jp2) <= F32_ATOL
    assert abs(float(m2["loss"]) - float(jm2["loss"])) <= F32_ATOL


def test_without_normalization_grads_differ():
    """eq. (13): raw accumulation (no 1/N_Smu) does NOT equal the
    mini-batch gradient — the normalization is load-bearing."""
    p = np_params(3)
    batch = make_batch(12, seed=3)
    params = t_params(p)
    _, ref_g = t_grads(t_loss_fn, params, batch)
    split = t_batch(_split(batch, 4))
    acc = tree.map(torch.zeros_like, params)
    for i in range(3):
        mb = {k: v[i] for k, v in split.items()}
        _, _, g = exec_core.value_and_grad(lambda q: t_loss_fn(q, mb),
                                           params)
        acc = tree.map(torch.add, acc, g)
    err = max_err(acc, {k: v.detach().numpy() for k, v in ref_g.items()})
    assert err > 1e-3  # ~3x too large


def test_metrics_averaged_over_microbatches():
    p = np_params(4)
    batch = make_batch(16, seed=4)
    opt = optim.sgd(0.0)
    split = _split(batch, 4)
    step = M.make_mbs_train_step(t_loss_fn, opt, M.MBSConfig(4, "paper"))
    params = t_params(p)
    _, _, metrics = step(params, opt.init(params), t_batch(split))
    full_acc = t_loss_fn(params, t_batch(batch))[1]["acc"]
    assert abs(float(metrics["acc"]) - float(full_acc)) < 1e-6
    jfull = j_loss_fn(j_params(p), {k: jnp.asarray(v)
                                    for k, v in batch.items()})[1]["acc"]
    assert float(metrics["acc"]) == pytest.approx(float(jfull), abs=1e-7)
