"""``tests/test_substrates.py`` case for case in the port: the optimizers
against their analytic references, the losses (paper eq. 18–20), the
data pipeline, the checkpoint round trip and the memory model (the
paper's max-batch "Failed" boundary, made analytic) — each in both
packages on the same numpy inputs, fp32 results within ``DTYPE_ATOL``
(conftest), the memory model's bytes equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro import checkpoint as jcheckpoint  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.data import MBSLoader as JMBSLoader  # noqa: E402
from repro_torch import checkpoint, configs, optim, tree  # noqa: E402
from repro_torch.core import losses, memory_model  # noqa: E402
from repro_torch.data import (ClassificationDataset, LMDataset,  # noqa: E402
                              MBSLoader, SegmentationDataset)

F32_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _run_updates(pkg, opt, params, g, steps):
    """``steps`` updates of ``opt`` with a constant gradient in either
    package; the last params as numpy."""
    state = opt.init(params)
    for _ in range(steps):
        upd, state = opt.update(g, state, params)
        params = pkg(params, upd)
    return {k: np.asarray(v, np.float32) for k, v in params.items()}


def _add_t(p, u):
    return tree.map(lambda a, b: a + b, p, u)


def _add_j(p, u):
    return jax.tree.map(lambda a, b: a + b, p, u)


def _both(make, params, g, steps):
    """(port params, reference params) after the same updates."""
    got = _run_updates(_add_t, make(optim), {k: _t(v) for k, v in
                                             params.items()},
                       {k: _t(v) for k, v in g.items()}, steps)
    want = _run_updates(_add_j, make(joptim), {k: jnp.asarray(v, jnp.float32)
                                               for k, v in params.items()},
                        {k: jnp.asarray(v, jnp.float32)
                         for k, v in g.items()}, steps)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL, rtol=0)
    return got


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_sgd_momentum_matches_manual():
    got = _both(lambda o: o.sgd(0.1, momentum=0.9, weight_decay=0.0),
                {"w": [1.0, -2.0]}, {"w": [0.5, 1.0]}, 3)
    mom, w = np.zeros(2), np.array([1.0, -2.0])
    for _ in range(3):
        mom = 0.9 * mom + np.array([0.5, 1.0])
        w = w - 0.1 * mom
    np.testing.assert_allclose(got["w"], w, rtol=1e-6)


def test_sgd_weight_decay_coupled():
    params = {"w": torch.tensor([2.0])}
    opt = optim.sgd(0.1, momentum=0.0, weight_decay=0.5)
    upd, _ = opt.update({"w": torch.tensor([0.0])}, opt.init(params), params)
    np.testing.assert_allclose(upd["w"].numpy(), [-0.1 * 0.5 * 2.0],
                               rtol=1e-6)
    jp = {"w": jnp.asarray([2.0])}
    jopt = joptim.sgd(0.1, momentum=0.0, weight_decay=0.5)
    jupd, _ = jopt.update({"w": jnp.asarray([0.0])}, jopt.init(jp), jp)
    np.testing.assert_allclose(upd["w"].numpy(), np.asarray(jupd["w"]),
                               atol=F32_ATOL, rtol=0)


def test_adam_matches_manual():
    got = _both(lambda o: o.adam(0.01, b1=0.9, b2=0.999, eps=1e-8),
                {"w": [1.0]}, {"w": [0.3]}, 3)
    m = v = 0.0
    w = 1.0
    for t in range(1, 4):
        m = 0.9 * m + 0.1 * 0.3
        v = 0.999 * v + 0.001 * 0.09
        w = w - 0.01 * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t))
                                               + 1e-8)
    np.testing.assert_allclose(got["w"], [w], rtol=1e-5)


def test_schedules():
    lin, jlin = optim.linear_decay(1.0, 10), joptim.linear_decay(1.0, 10)
    cos = optim.cosine_decay(1.0, 10, warmup=2)
    jcos = joptim.cosine_decay(1.0, 10, warmup=2)
    assert float(lin(torch.tensor(0))) == pytest.approx(1.0)
    assert float(lin(torch.tensor(10))) == pytest.approx(0.0)
    assert float(cos(torch.tensor(0))) == pytest.approx(0.0)
    assert float(cos(torch.tensor(2))) == pytest.approx(1.0)
    for s in range(12):
        assert float(lin(torch.tensor(s))) == pytest.approx(
            float(jlin(jnp.asarray(s))), abs=F32_ATOL)
        assert float(cos(torch.tensor(s))) == pytest.approx(
            float(jcos(jnp.asarray(s))), abs=F32_ATOL)


def test_clip_by_global_norm():
    opt = optim.clip_by_global_norm(optim.sgd(1.0), max_norm=1.0)
    params = {"w": torch.zeros(4)}
    upd, _ = opt.update({"w": torch.full((4,), 10.0)}, opt.init(params),
                        params)
    assert float(torch.linalg.norm(upd["w"])) == pytest.approx(1.0, rel=1e-4)
    jopt = joptim.clip_by_global_norm(joptim.sgd(1.0), max_norm=1.0)
    jp = {"w": jnp.zeros(4)}
    jupd, _ = jopt.update({"w": jnp.full((4,), 10.0)}, jopt.init(jp), jp)
    np.testing.assert_allclose(upd["w"].numpy(), np.asarray(jupd["w"]),
                               atol=F32_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# losses (paper eq. 18-20)
# ---------------------------------------------------------------------------

def test_dice_loss_perfect_prediction():
    target = np.random.default_rng(0).integers(0, 2, (2, 8, 8, 1)).astype(
        np.float32)
    logits = (target * 2 - 1) * 20.0  # saturated correct prediction
    assert float(losses.dice_loss(_t(logits), _t(target))) < 0.05
    assert float(losses.iou(_t(logits), _t(target))) > 0.99
    for fn, jfn in ((losses.dice_loss, jlosses.dice_loss),
                    (losses.iou, jlosses.iou)):
        assert float(fn(_t(logits), _t(target))) == pytest.approx(
            float(jfn(jnp.asarray(logits), jnp.asarray(target))),
            abs=F32_ATOL)


def test_bce_dice_is_sum():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    target = rng.integers(0, 2, (2, 8, 8, 1)).astype(np.float32)
    total = losses.bce_dice_loss(_t(logits), _t(target))
    parts = losses.bce_with_logits(_t(logits), _t(target)) + \
        losses.dice_loss(_t(logits), _t(target))
    assert float(torch.abs(total - parts)) < 1e-6
    assert float(total) == pytest.approx(float(jlosses.bce_dice_loss(
        jnp.asarray(logits), jnp.asarray(target))), abs=F32_ATOL)


def test_cross_entropy_token_weights():
    w = np.asarray([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
    out = losses.cross_entropy(torch.zeros((2, 4, 8)),
                               torch.zeros((2, 4), dtype=torch.int32),
                               token_weight=_t(w))
    assert float(out) == pytest.approx(np.log(8), rel=1e-5)
    jout = jlosses.cross_entropy(jnp.zeros((2, 4, 8)),
                                 jnp.zeros((2, 4), jnp.int32),
                                 token_weight=jnp.asarray(w))
    assert float(out) == pytest.approx(float(jout), abs=F32_ATOL)


# ---------------------------------------------------------------------------
# data pipeline (the datasets are the reference's numpy, shared)
# ---------------------------------------------------------------------------

def test_lm_dataset_deterministic_and_learnable():
    ds = LMDataset(vocab_size=128, seq_len=16, seed=3)
    b1, b2 = ds.batch(4, 7), ds.batch(4, 7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 16)
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    from repro.data import LMDataset as JLMDataset
    jb = JLMDataset(vocab_size=128, seq_len=16, seed=3).batch(4, 7)
    for k in jb:
        np.testing.assert_array_equal(b1[k], jb[k])


def test_mbs_loader_splits():
    ds = ClassificationDataset(num_classes=4, image_size=8)
    loader = MBSLoader(ds, mini_batch_size=10, micro_batch_size=4,
                       prefetch=0)
    batches = list(loader(2))
    assert len(batches) == 2
    assert batches[0]["image"].shape == (3, 4, 8, 8, 3)
    assert batches[0]["sample_weight"].sum() == 10
    from repro.data import ClassificationDataset as JClassificationDataset
    jbatches = list(JMBSLoader(JClassificationDataset(num_classes=4,
                                                      image_size=8),
                               mini_batch_size=10, micro_batch_size=4,
                               prefetch=0)(2))
    for b, jb in zip(batches, jbatches):
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k])


def test_segmentation_masks_nontrivial():
    b = SegmentationDataset(image_size=16).batch(4, 0)
    assert 0 < b["mask"].mean() < 1


# ---------------------------------------------------------------------------
# checkpoint (the reference's format: either package restores the other's)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    t = {"a": {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
         "c": (torch.ones(4), torch.zeros((), dtype=torch.int32))}
    checkpoint.save(str(tmp_path), 3, t)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    out = checkpoint.restore(str(tmp_path), t)
    for x, y in zip(tree.leaves(t), tree.leaves(out)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    jt = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    jout = jcheckpoint.restore(str(tmp_path), jt)
    for x, y in zip(tree.leaves(t), jax.tree.leaves(jout)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# memory model (the paper's max-batch "Failed" boundary, made analytic)
# ---------------------------------------------------------------------------

def test_memory_model_micro_batch_fits_where_mini_batch_fails():
    cfg, jcfg = configs.get("qwen2-1.5b"), jconfigs.get("qwen2-1.5b")
    budget = 16 * 1024 ** 3
    kw = dict(budget_bytes=budget, tp=16, fsdp=16)
    max_nomb = memory_model.max_minibatch_without_mbs(cfg, seq=4096, **kw)
    assert max_nomb == jmemory_model.max_minibatch_without_mbs(
        jcfg, seq=4096, **kw)
    mini = 64 * max(max_nomb, 1)
    micro = memory_model.suggest_micro_batch_size(cfg, seq=4096,
                                                  mini_batch=mini, **kw)
    assert micro is not None and micro >= 1
    assert micro == jmemory_model.suggest_micro_batch_size(
        jcfg, seq=4096, mini_batch=mini, **kw)
    est = memory_model.estimate(cfg, 4096, tp=16, fsdp=16)
    assert est.total(micro) <= budget < est.total(mini)
    assert dataclasses.asdict(est) == dataclasses.asdict(
        jmemory_model.estimate(jcfg, 4096, tp=16, fsdp=16))


def test_memory_model_monotone_in_image_of_seq():
    cfg, jcfg = configs.get("qwen2-1.5b"), jconfigs.get("qwen2-1.5b")
    short = memory_model.activation_bytes_per_sample(cfg, 1024)
    long = memory_model.activation_bytes_per_sample(cfg, 8192)
    assert long > short  # larger items -> smaller feasible micro-batch
    assert (short, long) == (
        jmemory_model.activation_bytes_per_sample(jcfg, 1024),
        jmemory_model.activation_bytes_per_sample(jcfg, 8192))
