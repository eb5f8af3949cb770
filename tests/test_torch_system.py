"""``tests/test_system.py`` case for case in the port — the paper's
headline result in miniature: a small LM that CANNOT train at mini-batch
64 under a simulated memory cap (Table 4's "w/o MBS: Failed") DOES train
with MBS, and the MBS loss curve matches the full-batch run.

Both packages start from the reference's parameters (reduced qwen2, fp32,
no remat) and see the same numpy batches. The port's claims hold to the
reference's own bounds; its loss curves equal the reference's within
``DTYPE_ATOL`` (fp32, conftest).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import mbs as JM  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, optim, weights  # noqa: E402
from repro_torch.core import mbs as M, memory_model  # noqa: E402
from repro_torch.data import LMDataset  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from test_torch_mbs import t_batch  # noqa: E402

CURVE_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
ARCH = "qwen2-1.5b"


def _make():
    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    np_params = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return (cfg, jcfg, np_params,
            steps.make_loss_fn(cfg, dtype=torch.float32, remat=False),
            jsteps.make_loss_fn(jcfg, dtype=jnp.float32, remat=False))


def _jcurve(jstep, jopt, np_params, batches):
    p = jax.tree.map(jnp.asarray, np_params)
    s = jopt.init(p)
    out = []
    for b in batches:
        p, s, m = jstep(p, s, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def _curve(step, opt, np_params, batches):
    p = weights.from_reference(np_params, "cpu")
    s = opt.init(p)
    out = []
    for b in batches:
        p, s, m = step(p, s, t_batch(b))
        out.append(float(m["loss"]))
    return out


def test_mbs_training_curve_matches_full_batch():
    """Fig. 3 of the paper, as an exact statement: per-step losses of the
    MBS run and the full-batch run coincide."""
    cfg, _, np_params, loss_fn, jloss_fn = _make()
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=16, seed=0)
    opt = optim.sgd(0.3, momentum=0.9)
    full = [ds.batch(16, i) for i in range(10)]
    split = [M.split_minibatch(b, 4) for b in full]
    full_losses = _curve(M.make_baseline_train_step(loss_fn, opt), opt,
                         np_params, full)
    mbs_losses = _curve(M.make_mbs_train_step(loss_fn, opt, M.MBSConfig(4)),
                        opt, np_params, split)
    np.testing.assert_allclose(mbs_losses, full_losses, rtol=2e-3,
                               atol=2e-3)
    jopt = joptim.sgd(0.3, momentum=0.9)
    jmbs = _jcurve(jax.jit(JM.make_mbs_train_step(jloss_fn, jopt,
                                                  JM.MBSConfig(4))),
                   jopt, np_params, split)
    np.testing.assert_allclose(mbs_losses, jmbs, rtol=0, atol=CURVE_ATOL)


def test_mbs_trains_beyond_simulated_memory_cap():
    """Table 4 in miniature: an activation budget below the mini-batch's
    need; MBS picks a micro-batch that fits, and trains."""
    cfg, jcfg, np_params, loss_fn, jloss_fn = _make()
    seq, mini = 16, 64
    act = memory_model.activation_bytes_per_sample(cfg, seq, act_bytes=4,
                                                   remat=False)
    est = memory_model.estimate(cfg, seq, act_bytes=4, remat=False)
    cap = est.total(0) + act * 8  # room for <= 8 samples of activations
    assert cap == jmemory_model.estimate(jcfg, seq, act_bytes=4,
                                         remat=False).total(0) + 8 * \
        jmemory_model.activation_bytes_per_sample(jcfg, seq, act_bytes=4,
                                                  remat=False)
    assert est.total(mini) > cap, "the mini-batch must exceed the cap"
    assert memory_model.max_minibatch_without_mbs(
        cfg, seq, budget_bytes=cap, act_bytes=4, remat=False) == 8
    micro = memory_model.suggest_micro_batch_size(cfg, seq, mini,
                                                  budget_bytes=cap,
                                                  act_bytes=4, remat=False)
    assert micro is not None and micro <= 8
    assert micro == jmemory_model.suggest_micro_batch_size(
        jcfg, seq, mini, budget_bytes=cap, act_bytes=4, remat=False)
    ds = LMDataset(vocab_size=cfg.vocab_size, seq_len=seq, seed=1)
    batches = [M.split_minibatch(ds.batch(mini, i), micro) for i in range(4)]
    opt = optim.sgd(0.05, momentum=0.9)
    curve = _curve(M.make_mbs_train_step(loss_fn, opt, M.MBSConfig(micro)),
                   opt, np_params, batches)
    assert np.isfinite(curve).all() and curve[-1] < curve[0]
    jopt = joptim.sgd(0.05, momentum=0.9)
    jcurve = _jcurve(jax.jit(JM.make_mbs_train_step(jloss_fn, jopt,
                                                    JM.MBSConfig(micro))),
                     jopt, np_params, batches)
    np.testing.assert_allclose(curve, jcurve, rtol=0, atol=CURVE_ATOL)
