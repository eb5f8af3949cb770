"""The paper's own model families: ResNet (classification) and U-Net
(semantic segmentation) — the JAX package's ``models/cnn.py``, as plain
functions over param and state dicts keyed as the reference's trees.

Layout: images enter NHWC, as the reference's datasets give them, and
are computed on in NCHW (PyTorch's convolution layout); U-Net's logits
leave as (B, H, W, out) again, so losses and masks line up with the
reference's. Conv kernels are stored OIHW where the reference keeps HWIO;
``repro_torch.weights`` converts them both ways.

Padding is the reference's ``"SAME"``, which for a stride-2 window pads
⌊t/2⌋ low and ⌈t/2⌉ high (t the total): the 7×7/2 stem on 224 pads
(2, 3), a 3×3/2 conv or the stem's max-pool on an even size (0, 1).
PyTorch's ``padding=`` is symmetric — the same output shape with every
window shifted by one — so asymmetric pads go through ``F.pad`` (−inf
for the max-pool).

BatchNorm statistics are per *micro*-batch under MBS, over (N, H, W)
with the biased variance and eps 1e-5 — the paper's PyTorch semantics
(§4.2.2). A ragged split's zero samples are part of the statistics, as
in the reference. Running statistics are threaded as explicit state,
``0.9·old + 0.1·new`` with that biased variance (``F.batch_norm``'s own
running update uses the unbiased one, so the update is written here).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core import losses
from . import remat as remat_lib

BN_EPS = 1e-5


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, k: int, cin: int, cout: int, device):
    """He-normal kernel, OIHW (the reference's is HWIO, the same law)."""
    fan_in = k * k * cin
    return {"w": torch.randn((cout, cin, k, k), generator=gen,
                             device=device) * math.sqrt(2.0 / fan_in)}


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` for one spatial dim."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    """``x`` padded for a k×k window at ``stride`` and the symmetric
    padding left to the op: (x, (ph, pw)). Only an asymmetric pad copies
    ``x``."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(p, x, stride: int = 1):
    """NCHW convolution with the reference's SAME padding."""
    w = p["w"].to(x.dtype)
    x, pad = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride, padding=pad)


def bn_init(c: int, device):
    return ({"scale": torch.ones((c,), device=device),
             "bias": torch.zeros((c,), device=device)},
            {"mean": torch.zeros((c,), device=device),
             "var": torch.ones((c,), device=device)})


def batchnorm(p, state, x, train: bool, momentum: float = 0.9):
    """(normalized x, new state). ``train``: the micro-batch's statistics
    (biased variance) normalize ``x`` and move the running ones; else the
    running statistics normalize and the state is returned as it is."""
    if not train:
        y = F.batch_norm(x, state["mean"], state["var"], p["scale"],
                         p["bias"], training=False, eps=BN_EPS)
        return y, state
    with torch.no_grad():
        var, mu = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mu,
                     "var": momentum * state["var"] + (1 - momentum) * var}
    y = F.batch_norm(x, None, None, p["scale"], p["bias"], training=True,
                     eps=BN_EPS)
    return y, new_state


def _max_pool_same(x, k: int, stride: int):
    x, pad = _pad_same(x, k, stride, value=-math.inf)
    return F.max_pool2d(x, k, stride, padding=pad)


def _nchw(x):
    """The reference's NHWC image batch → NCHW."""
    return x.permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# ResNet (bottleneck, ResNet-50-style; depth configurable)
# ---------------------------------------------------------------------------

def _bottleneck_init(gen, cin: int, cmid: int, stride: int, device):
    cout = cmid * 4
    p: Dict[str, Any] = {"conv1": conv_init(gen, 1, cin, cmid, device),
                         "conv2": conv_init(gen, 3, cmid, cmid, device),
                         "conv3": conv_init(gen, 1, cmid, cout, device)}
    s: Dict[str, Any] = {}
    for i, c in [(1, cmid), (2, cmid), (3, cout)]:
        p[f"bn{i}"], s[f"bn{i}"] = bn_init(c, device)
    if stride != 1 or cin != cout:
        p["proj"] = conv_init(gen, 1, cin, cout, device)
        p["bn_proj"], s["bn_proj"] = bn_init(cout, device)
    return p, s


def _bottleneck(p, s, x, stride: int, train: bool):
    ns = {}
    h = conv(p["conv1"], x)
    h, ns["bn1"] = batchnorm(p["bn1"], s["bn1"], h, train)
    h = F.relu(h)
    h = conv(p["conv2"], h, stride)
    h, ns["bn2"] = batchnorm(p["bn2"], s["bn2"], h, train)
    h = F.relu(h)
    h = conv(p["conv3"], h)
    h, ns["bn3"] = batchnorm(p["bn3"], s["bn3"], h, train)
    if "proj" in p:
        x = conv(p["proj"], x, stride)
        x, ns["bn_proj"] = batchnorm(p["bn_proj"], s["bn_proj"], x, train)
    return F.relu(x + h), ns


def resnet_init(seed: int = 0, *, num_classes: int,
                stage_sizes: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                in_channels: int = 3, device="cuda"):
    """(params, state) from ``seed`` on ``device``; stage_sizes (3,4,6,3)
    == ResNet-50, (3,4,23,3) == ResNet-101. The values differ from the
    JAX package's (another generator); tests load the reference's
    through ``repro_torch.weights``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict[str, Any] = {"stem": conv_init(gen, 7, in_channels, width,
                                                device)}
    state: Dict[str, Any] = {}
    params["bn_stem"], state["bn_stem"] = bn_init(width, device)
    cin = width
    for si, n in enumerate(stage_sizes):
        cmid = width * (2 ** si)
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            p, s = _bottleneck_init(gen, cin, cmid, stride, device)
            params[f"s{si}b{bi}"], state[f"s{si}b{bi}"] = p, s
            cin = cmid * 4
    params["head"] = {"w": torch.zeros((cin, num_classes), device=device),
                      "b": torch.zeros((num_classes,), device=device)}
    return params, state


def resnet_forward(params, state, x, *, stage_sizes=(3, 4, 6, 3), train=True,
                   remat_policy: str = "none"):
    """x: (B, H, W, C) → (logits (B, num_classes), new_state).

    The remat unit is one bottleneck block: the CNNs have no period, so
    ``remat_policy`` grades per-block checkpointing ("dots" saves the
    convolutions, "period"/"full" only block boundaries)."""
    ns: Dict[str, Any] = {}
    h = conv(params["stem"], _nchw(x), stride=2)
    h, ns["bn_stem"] = batchnorm(params["bn_stem"], state["bn_stem"], h,
                                 train)
    h = _max_pool_same(F.relu(h), 3, 2)
    for si, n in enumerate(stage_sizes):
        for bi in range(n):
            stride = 2 if (bi == 0 and si > 0) else 1
            block = remat_lib.checkpoint_period(
                lambda bp, bs, bh, stride=stride: _bottleneck(
                    bp, bs, bh, stride, train), remat_policy)
            h, ns[f"s{si}b{bi}"] = block(
                params[f"s{si}b{bi}"], state[f"s{si}b{bi}"], h)
    h = torch.mean(h, dim=(2, 3))
    logits = h.float() @ params["head"]["w"] + params["head"]["b"]
    return logits, ns


# ---------------------------------------------------------------------------
# U-Net (the paper's segmentation model)
# ---------------------------------------------------------------------------

def _double_conv_init(gen, cin: int, cout: int, device):
    p = {"c1": conv_init(gen, 3, cin, cout, device),
         "c2": conv_init(gen, 3, cout, cout, device)}
    s = {}
    p["bn1"], s["bn1"] = bn_init(cout, device)
    p["bn2"], s["bn2"] = bn_init(cout, device)
    return p, s


def _double_conv(p, s, x, train):
    ns = {}
    h = conv(p["c1"], x)
    h, ns["bn1"] = batchnorm(p["bn1"], s["bn1"], h, train)
    h = F.relu(h)
    h = conv(p["c2"], h)
    h, ns["bn2"] = batchnorm(p["bn2"], s["bn2"], h, train)
    return F.relu(h), ns


def unet_init(seed: int = 0, *, in_channels: int = 3, out_channels: int = 1,
              base: int = 64, depth: int = 4, device="cuda"):
    """(params, state) from ``seed`` on ``device`` (see
    :func:`resnet_init`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    c = in_channels
    for d in range(depth + 1):
        cout = base * (2 ** d)
        params[f"down{d}"], state[f"down{d}"] = _double_conv_init(
            gen, c, cout, device)
        c = cout
    for d in reversed(range(depth)):
        cout = base * (2 ** d)
        params[f"up{d}"], state[f"up{d}"] = _double_conv_init(
            gen, c + cout, cout, device)
        c = cout
    params["head"] = conv_init(gen, 1, c, out_channels, device)
    return params, state


def unet_forward(params, state, x, *, depth: int = 4, train=True,
                 remat_policy: str = "none"):
    """x: (B, H, W, C) → (logits (B, H, W, out), new_state).

    The remat unit is one double-conv block (see :func:`resnet_forward`);
    the 2× upsampling is nearest-neighbour, each pixel repeated 2 × 2, as
    ``jax.image.resize(..., "nearest")`` is at an integer factor."""
    block = remat_lib.checkpoint_period(
        lambda bp, bs, bh: _double_conv(bp, bs, bh, train), remat_policy)
    ns: Dict[str, Any] = {}
    skips: List[torch.Tensor] = []
    h = _nchw(x)
    for d in range(depth + 1):
        h, ns[f"down{d}"] = block(params[f"down{d}"], state[f"down{d}"], h)
        if d < depth:
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
    for d in reversed(range(depth)):
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = torch.cat([skips[d], h], dim=1)
        h, ns[f"up{d}"] = block(params[f"up{d}"], state[f"up{d}"], h)
    return conv(params["head"], h).float().permute(0, 2, 3, 1), ns


# ---------------------------------------------------------------------------
# a config's model, and the training loss the reference's drivers use
# ---------------------------------------------------------------------------

def init(cfg, seed: int = 0, device="cuda"):
    """(params, state) of a ``configs.resnet50.CNNConfig``."""
    if cfg.kind == "resnet":
        return resnet_init(seed, num_classes=cfg.num_classes,
                           stage_sizes=cfg.stage_sizes, width=cfg.width,
                           in_channels=cfg.in_channels, device=device)
    if cfg.kind == "unet":
        return unet_init(seed, in_channels=cfg.in_channels,
                         out_channels=cfg.out_channels, base=cfg.width,
                         depth=cfg.depth, device=device)
    raise ValueError(f"unknown CNN kind {cfg.kind!r}")


def forward(cfg, params, state, x, *, train=True, remat_policy="none"):
    if cfg.kind == "resnet":
        return resnet_forward(params, state, x, stage_sizes=cfg.stage_sizes,
                              train=train, remat_policy=remat_policy)
    return unet_forward(params, state, x, depth=cfg.depth, train=train,
                        remat_policy=remat_policy)


def make_loss_fn(cfg, state, remat_policy: str = "none"):
    """``loss_fn(params, mb, exact_denom=None) -> (loss, metrics)`` as the
    reference's drivers build it (``examples/train_classifier.py``,
    ``benchmarks/table5_segmentation.py``): a train-mode forward (per
    micro-batch BN statistics) that closes over the initial ``state`` and
    drops the new one; CE with an ``acc`` metric for ResNet, BCE + Dice
    for U-Net."""
    def loss_fn(params, mb, exact_denom=None):
        logits, _ = forward(cfg, params, state, mb["image"], train=True,
                            remat_policy=remat_policy)
        w = mb.get("sample_weight")
        if cfg.kind == "resnet":
            return losses.cross_entropy(
                logits, mb["label"], sample_weight=w,
                exact_denom=exact_denom), {
                "acc": losses.accuracy(logits, mb["label"])}
        return losses.bce_dice_loss(logits, mb["mask"], sample_weight=w,
                                    exact_denom=exact_denom), {}
    return loss_fn
