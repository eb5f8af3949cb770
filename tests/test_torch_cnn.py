"""The paper's own workloads in the port against the JAX package's:
``repro_torch.models.cnn`` (ResNet, U-Net), the image datasets and the
segmentation losses, on the same numpy inputs and the reference's
parameters (conv kernels through ``weights.from_reference``, HWIO →
OIHW).

Sizes: ``resnet-mini`` (``stage_sizes=(1, 1)``, width 16, 24 px, and an
odd 25 px so the SAME-padding alignment of every stride-2 window is
exercised both ways) and ``unet-mini`` (depth 2, width 8, 32 px and
36 px).

Tolerance: fp32 atol 1e-4 and rtol 1e-4 on logits, BN state, gradients
and params after one step (XLA and PyTorch order the convolution and
reduction sums differently; BN divides by a per-channel standard
deviation that amplifies those differences). The datasets are
bit-identical; the losses agree to atol/rtol 1e-6 (the same elementwise
arithmetic, summed in another order). The frozen-BN MBS test keeps the
reference's own bound, 1e-5.
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import resnet50 as jresnet50  # noqa: E402
from repro.configs import unet as junet  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import mbs as jmbs  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import engine, optim, tree, weights  # noqa: E402
from repro_torch.configs import resnet50, unet  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import cnn, remat  # noqa: E402

ATOL = RTOL = 1e-4
CPU = "cpu"


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    got_l = [np.asarray(x.detach(), np.float32) if isinstance(x, torch.Tensor)
             else np.asarray(x, np.float32) for x in tree.leaves(got)]
    want_l = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(got_l) == len(want_l), what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        assert g.shape == w.shape, f"{what}: leaf {i} {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=f"{what}: leaf {i}")


@functools.lru_cache(maxsize=None)
def _ref_init(kind):
    """The reference's reduced model from PRNGKey(0), as numpy trees (one
    init a kind per test process: JAX's op-by-op init takes seconds)."""
    if kind == "resnet":
        cfg = resnet50.reduced()
        init = functools.partial(jcnn.resnet_init,
                                 num_classes=cfg.num_classes,
                                 stage_sizes=cfg.stage_sizes,
                                 width=cfg.width)
    else:
        cfg = unet.reduced()
        init = functools.partial(jcnn.unet_init, base=cfg.width,
                                 depth=cfg.depth)
    jp, js = jax.jit(init)(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


def _model(kind):
    """(cfg, (ref params, ref state, port params, port state)), the port's
    fresh tensors each call."""
    cfg, jp, js = _ref_init(kind)
    return cfg, (jp, js, weights.from_reference(jp, CPU),
                 weights.from_reference(js, CPU))


def _resnet():
    return _model("resnet")


def _unet():
    return _model("unet")


def _images(n, size, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _jforward(cfg, jp, js, x, train):
    if cfg.kind == "resnet":
        return jcnn.resnet_forward(jp, js, x, stage_sizes=cfg.stage_sizes,
                                   train=train)
    return jcnn.unet_forward(jp, js, x, depth=cfg.depth, train=train)


def _jforward_jit(cfg, jp, js, x, train):
    return jax.jit(functools.partial(_jforward, cfg, train=train))(jp, js, x)


# ---------------------------------------------------------------------------
# configs, datasets, losses
# ---------------------------------------------------------------------------

def test_configs_equal_the_reference():
    import dataclasses
    for port, ref in ((resnet50.config(), jresnet50.config()),
                      (resnet50.config_101(), jresnet50.config_101()),
                      (resnet50.reduced(), jresnet50.reduced()),
                      (unet.config(), junet.config()),
                      (unet.reduced(), junet.reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_datasets_bit_identical():
    for port, ref, kw in (
            (synthetic.ClassificationDataset(10, 12, seed=3),
             jsynthetic.ClassificationDataset(10, 12, seed=3), {}),
            (synthetic.ClassificationDataset(10, 12, seed=3),
             jsynthetic.ClassificationDataset(10, 12, seed=3),
             {"train": False}),
            (synthetic.SegmentationDataset(20, seed=1),
             jsynthetic.SegmentationDataset(20, seed=1), {})):
        got = list(synthetic.minibatch_stream(port, 5, 3, start_seed=2, **kw))
        want = list(jsynthetic.minibatch_stream(ref, 5, 3, start_seed=2,
                                                **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("weighted", [False, True])
def test_segmentation_losses_match_reference(weighted):
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(4, 9, 9, 1))).astype(np.float32)
    mask = (rng.random((4, 9, 9, 1)) > 0.6).astype(np.float32)
    kw_j, kw_t = {}, {}
    if weighted:
        w = np.array([1, 1, 1, 0], np.float32)
        kw_j = {"sample_weight": jnp.asarray(w), "exact_denom": 5.0}
        kw_t = {"sample_weight": torch.from_numpy(w), "exact_denom": 5.0}
    tl, tm = torch.from_numpy(logits), torch.from_numpy(mask)
    for name in ("bce_with_logits", "dice_loss", "bce_dice_loss"):
        got = getattr(losses, name)(tl, tm, **kw_t)
        want = getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(mask),
                                      **kw_j)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        float(losses.iou(tl, tm)),
        float(jlosses.iou(jnp.asarray(logits), jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# layout, padding, upsampling
# ---------------------------------------------------------------------------

def test_weights_convert_conv_kernels_both_ways():
    _, (jp, _, tp, _) = _resnet()
    assert tuple(tp["stem"]["w"].shape) == (16, 3, 7, 7)  # OIHW
    assert tp["stem"]["w"].is_contiguous()
    back = weights.to_reference(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_conv_same_padding_matches_reference(size, k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jcnn.conv({"w": jnp.asarray(w)}, jnp.asarray(x), stride)
    got = cnn.conv(weights.from_reference({"w": w}, CPU),
                   torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    _close(got.permute(0, 2, 3, 1), want, f"conv {k}x{k}/{stride} @{size}",
           atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [8, 9])
def test_stem_max_pool_same_padding(size):
    x = np.random.default_rng(size).normal(
        size=(2, size, size, 4)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = cnn._max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    _close(got.permute(0, 2, 3, 1), want, "max pool", atol=0, rtol=0)


def test_upsampling_equals_jax_nearest_resize():
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 4)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 10, 6, 4), "nearest")
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=2, mode="nearest")
    _close(got.permute(0, 2, 3, 1), want, "upsample", atol=0, rtol=0)


# ---------------------------------------------------------------------------
# forward, BN state, gradients
# ---------------------------------------------------------------------------

CASES = [("resnet", 24), ("resnet", 25), ("unet", 32), ("unet", 36)]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind,size", CASES)
def test_forward_and_state_match_reference(kind, size, train):
    cfg, (jp, js, tp, ts) = _resnet() if kind == "resnet" else _unet()
    if not train:  # non-trivial running statistics for eval mode
        rng = np.random.default_rng(5)
        js = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)
                                     ).astype(np.float32), js)
        ts = weights.from_reference(js, CPU)
    x = _images(3, size)
    want_logits, want_state = _jforward_jit(cfg, jp, js, jnp.asarray(x),
                                            train)
    got_logits, got_state = cnn.forward(cfg, tp, ts, torch.from_numpy(x),
                                        train=train)
    assert tuple(got_logits.shape) == want_logits.shape
    _close(got_logits, want_logits, "logits")
    _close(got_state, want_state, "new_state")


@pytest.mark.parametrize("kind,size", CASES[::2] + CASES[1:2])
def test_gradients_match_reference(kind, size):
    cfg, (jp, js, tp, ts) = _resnet() if kind == "resnet" else _unet()
    rng = np.random.default_rng(2)
    x = _images(4, size, seed=3)
    if kind == "resnet":  # a nonzero head, so every gradient is nonzero
        jp = dict(jp, head={"w": rng.normal(size=jp["head"]["w"].shape
                                            ).astype(np.float32),
                            "b": jp["head"]["b"]})
        tp = weights.from_reference(jp, CPU)
        batch = {"image": x, "label": rng.integers(
            0, cfg.num_classes, 4).astype(np.int32)}
    else:
        batch = {"image": x, "mask": (rng.random((4, size, size, 1)) > 0.5
                                      ).astype(np.float32)}
    jloss = _jloss_fn(cfg, js)
    want = jax.jit(jax.grad(lambda p, b: jloss(p, b)[0]))(
        jp, jax.tree.map(jnp.asarray, batch))
    loss_fn = cnn.make_loss_fn(cfg, ts)
    req = tree.map(lambda t: t.detach().requires_grad_(), tp)
    loss, _ = loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, tree.leaves(req))
    got = weights.to_reference(tree.unflatten(tree.flatten(tp)[1],
                                              list(got)))
    _close(got, want, f"{kind} gradients")


def _jloss_fn(cfg, js):
    """The reference's drivers' loss: train-mode BN over the initial
    state, which is dropped."""
    def loss_fn(p, b, exact_denom=None):
        logits, _ = _jforward(cfg, p, js, b["image"], True)
        w = b.get("sample_weight")
        if cfg.kind == "resnet":
            return jlosses.cross_entropy(
                logits, b["label"], sample_weight=w,
                exact_denom=exact_denom), {
                "acc": jlosses.accuracy(logits, b["label"])}
        return jlosses.bce_dice_loss(logits, b["mask"], sample_weight=w,
                                     exact_denom=exact_denom), {}
    return loss_fn


# ---------------------------------------------------------------------------
# one MBS step through the port's executors against the reference's
# ---------------------------------------------------------------------------

def _step_case(kind, mini, micro):
    if kind == "resnet":
        cfg, (jp, js, tp, ts) = _resnet()
        ds = jsynthetic.ClassificationDataset(cfg.num_classes,
                                              cfg.image_size, seed=0)
        jopt = joptim.sgd(0.01, momentum=0.9, weight_decay=5e-4)
        topt = optim.sgd(0.01, momentum=0.9, weight_decay=5e-4)
    else:
        cfg, (jp, js, tp, ts) = _unet()
        ds = jsynthetic.SegmentationDataset(cfg.image_size, seed=0)
        jopt = joptim.adam(0.01, weight_decay=5e-4)
        topt = optim.adam(0.01, weight_decay=5e-4)
    return cfg, jp, js, tp, ts, ds.batch(mini, 0), jopt, topt


@functools.lru_cache(maxsize=None)
def _ref_mbs(kind, mini, micro, normalization):
    """The reference's accumulated MBS gradients and loss, and for SGD its
    whole step's params (one compile a case, shared by both executors)."""
    cfg, jp, js, _, _, batch, jopt, _ = _step_case(kind, mini, micro)
    jloss = _jloss_fn(cfg, js)
    jcfg = jmbs.MBSConfig(micro, normalization)
    jsplit = {k: jnp.asarray(v)
              for k, v in jmbs.split_minibatch(batch, micro).items()}
    grads, loss = jax.jit(lambda p, b: jmbs.mbs_gradients(
        jloss, p, b, jcfg))(jp, jsplit)
    whole_p = None
    if kind == "resnet":
        step = jmbs.make_mbs_train_step(jloss, jopt, jcfg)
        whole_p, _, _ = jax.jit(step)(jp, jopt.init(jp), jsplit)
    return grads, loss, whole_p


@pytest.mark.parametrize("executor", ["compiled", "flat"])
@pytest.mark.parametrize("kind,mini,micro", [("resnet", 4, 2),
                                             ("unet", 4, 2),
                                             ("resnet", 5, 2)])
def test_mbs_step_matches_reference(kind, mini, micro, executor):
    """One step through the port's executor against the reference's
    ``make_mbs_train_step``: SGD-m for ResNet, Adam for U-Net (the paper's
    optimizers); the 5 / 2 case is ragged — the tail micro-batch holds one
    sample and one zero sample, which BN's statistics include in both
    packages.

    The accumulated gradients and the loss are held against the
    reference's, and the new params and optimizer state against the
    reference's update applied to the port's gradients. Under SGD the
    params are also held against the reference's whole step; under Adam
    they cannot be: its first step is lr·g/(|g| + eps), so an element
    whose gradient is ~1e-9 (BN after a conv zeroes whole directions of
    its kernel's gradient) moves by up to 2·lr on a gradient difference
    of 1e-10 — on the CPU one such U-Net element moved 6.7e-4 apart."""
    cfg, jp, js, tp, ts, batch, jopt, topt = _step_case(kind, mini, micro)
    plan = engine.plan_mbs(mini, micro_batch_size=micro, device=CPU)
    want_g, want_loss, whole_p = _ref_mbs(kind, mini, micro,
                                          plan.normalization)
    ex = engine.get_executor(executor)(cnn.make_loss_fn(cfg, ts), topt, plan)
    split = plan.device_split(batch, CPU)
    grads, loss = ex.gradients(tp, split)
    _close(weights.to_reference(grads), want_g, f"{executor} gradients")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    state = topt.init(tp)
    if executor == "flat":
        tp, state = ex.prepare(tp, state)
    got_p, got_s, got_m = ex.step_split(tp, state, split)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_loss),
                               rtol=RTOL, atol=ATOL)
    want_p, want_s = jengine.exec_core.apply_update(
        jopt, jax.tree.map(jnp.asarray, weights.to_reference(grads)),
        jopt.init(jp), jp)
    slots = ("mom",) if kind == "resnet" else ("m", "v")
    _close(weights.to_reference(got_p), want_p, f"{executor} params")
    for k in slots:
        _close(weights.to_reference(got_s[k]), want_s[k], f"{executor} {k}")
    if whole_p is not None:
        _close(weights.to_reference(got_p), whole_p,
               f"{executor} params vs the reference's step")


# ---------------------------------------------------------------------------
# remat: "dots" saves the convolutions, as checkpoint_dots does
# ---------------------------------------------------------------------------

def _backward_ops(policy, cfg, tp, ts, x):
    """The ATen ops that run during backward (recomputation included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    req = tree.map(lambda t: t.detach().requires_grad_(), tp)
    logits, _ = cnn.forward(cfg, req, ts, x, remat_policy=policy)
    with Count() as c:
        torch.autograd.grad(logits.square().sum(), tree.leaves(req))
    return c.ops


def test_dots_policy_sees_the_convolution_op():
    """Find the ops ``dots``' policy function is shown for a convolution
    and a matmul: each convolution overload it sees must be saved."""
    seen = []

    def record(ctx, op, *args, **kwargs):
        seen.append(op)
        return remat._save_dots(ctx, op, *args, **kwargs)

    from torch.utils import checkpoint as ckpt
    x = torch.randn(2, 3, 9, 9, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    out = ckpt.checkpoint(
        lambda a, b: F.conv2d(a, b, stride=2, padding=1).relu().sum(),
        x, w, use_reentrant=False,
        context_fn=lambda: ckpt.create_selective_checkpoint_contexts(record))
    out.backward()
    convs = {op for op in seen if "conv" in str(op)}
    assert convs == {torch.ops.aten.convolution.default}
    assert convs <= set(remat._DOT_OPS)


@pytest.mark.parametrize("kind", ["resnet", "unet"])
def test_dots_does_not_recompute_convolutions(kind):
    """Under "period" backward recomputes every forward convolution of the
    checkpointed blocks; under "dots" it recomputes none (the convolutions
    are saved, the BN and ReLU around them recomputed) — the memory
    profile ``jax.checkpoint_policies.checkpoint_dots`` gives."""
    cfg, (_, _, tp, ts) = _resnet() if kind == "resnet" else _unet()
    x = torch.from_numpy(_images(2, cfg.image_size))
    conv = torch.ops.aten.convolution.default
    counts = {p: sum(op == conv for op in _backward_ops(p, cfg, tp, ts, x))
              for p in ("none", "dots", "period")}
    assert counts["dots"] == counts["none"]
    assert counts["period"] > counts["none"]


# ---------------------------------------------------------------------------
# tests/test_cnn_models.py, ported
# ---------------------------------------------------------------------------

def test_resnet_forward_shapes():
    params, state = cnn.resnet_init(0, num_classes=8, stage_sizes=(1, 1),
                                    width=16, device=CPU)
    x = torch.randn(2, 24, 24, 3)
    logits, new_state = cnn.resnet_forward(params, state, x,
                                           stage_sizes=(1, 1), train=True)
    assert tuple(logits.shape) == (2, 8)
    assert not bool(torch.isnan(logits).any())
    # BN running stats updated
    assert float((new_state["bn_stem"]["mean"]
                  - state["bn_stem"]["mean"]).abs().max()) > 0


def test_unet_forward_shapes():
    params, state = cnn.unet_init(1, base=8, depth=2, device=CPU)
    x = torch.randn(2, 32, 32, 3)
    logits, _ = cnn.unet_forward(params, state, x, depth=2, train=True)
    assert tuple(logits.shape) == (2, 32, 32, 1)
    assert not bool(torch.isnan(logits).any())


def test_mbs_equivalence_with_frozen_bn():
    """With BN in eval mode (batch-independent), MBS == full batch within
    the reference test's 1e-5. (In train mode BN statistics are
    per-micro-batch — the paper's own PyTorch semantics, §4.2.2.)"""
    params, state = cnn.resnet_init(2, num_classes=4, stage_sizes=(1,),
                                    width=8, device=CPU)
    params["head"]["w"] = torch.randn(params["head"]["w"].shape,
                                      generator=torch.Generator().manual_seed(
                                          0))
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 4, 8).astype(np.int32)}

    def loss_fn(p, b, exact_denom=None):
        logits, _ = cnn.resnet_forward(p, state, b["image"],
                                       stage_sizes=(1,), train=False)
        return losses.cross_entropy(
            logits, b["label"], sample_weight=b.get("sample_weight"),
            exact_denom=exact_denom), {}

    req = tree.map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = loss_fn(req, {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = torch.autograd.grad(loss, tree.leaves(req))
    plan = engine.plan_mbs(8, micro_batch_size=2, device=CPU)
    g, _ = engine.accumulate_gradients(loss_fn, params,
                                       plan.device_split(batch, CPU), plan)
    err = max(float((a - b).abs().max())
              for a, b in zip(tree.leaves(g), ref))
    assert err < 1e-5


def test_unet_trains_with_bce_dice():
    """A few MBS steps on the paper's segmentation setup (Adam lr .01,
    BCE+Dice — paper §4.2.4) decrease the loss."""
    params, state = cnn.unet_init(3, base=4, depth=1, device=CPU)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    m = (rng.random((4, 16, 16, 1)) > 0.5).astype(np.float32)
    opt = optim.adam(1e-2, weight_decay=5e-4)

    def loss_fn(p, b, exact_denom=None):
        logits, _ = cnn.unet_forward(p, state, b["image"], depth=1,
                                     train=True)
        return losses.bce_dice_loss(
            logits, b["mask"], sample_weight=b.get("sample_weight"),
            exact_denom=exact_denom), {}

    plan = engine.plan_mbs(4, micro_batch_size=2, device=CPU)
    ex = engine.CompiledScanExecutor(loss_fn, opt, plan)
    opt_state = opt.init(params)
    split = plan.device_split({"image": x, "mask": m}, CPU)
    losses_seq = []
    for _ in range(5):
        params, opt_state, metrics = ex.step_split(params, opt_state, split)
        losses_seq.append(float(metrics["loss"]))
    assert losses_seq[-1] < losses_seq[0]
