"""Loss functions.

Every loss returns the *mean per-sample loss over the (micro-)batch*,
which is what the MBS loss normalization (paper §3.4, Algorithm 1)
consumes. ``sample_weight`` covers the ragged tail (N_B % N_μ != 0):
padded samples carry weight 0. With ``exact_denom`` set, the weighted sum
is divided by that count instead (exact-ragged MBS).
"""
from __future__ import annotations

import sys
from typing import Optional

import torch


def _weighted_mean(per_sample: torch.Tensor, sample_weight, exact_denom):
    if sample_weight is None:
        if exact_denom is not None:
            return torch.sum(per_sample) / exact_denom
        return torch.mean(per_sample)
    total = torch.sum(per_sample * sample_weight)
    denom = exact_denom if exact_denom is not None else torch.sum(sample_weight)
    return total / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  token_weight: Optional[torch.Tensor] = None,
                  sample_weight: Optional[torch.Tensor] = None,
                  exact_denom=None) -> torch.Tensor:
    """LM / classification CE. logits: (..., V); labels: int (...).

    Per-sample loss = mean over tokens (with ``token_weight``, the
    weighted mean, its denominator clamped at 1 so an all-zero row gives
    0); batch loss = mean over samples. DTensor logits (a GSPMD step)
    reduce over their vocab shards (:func:`sharded_nll`)."""
    if _is_dtensor(logits):
        nll = sharded_nll(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - gold
    if nll.dim() > 1:  # sequence models: mean over tokens per sample
        dims = tuple(range(1, nll.dim()))
        if token_weight is not None:
            per_sample = (torch.sum(nll * token_weight, dim=dims)
                          / torch.clamp(torch.sum(token_weight, dim=dims),
                                        min=1))
        else:
            per_sample = torch.mean(nll, dim=dims)
    else:
        per_sample = nll
    return _weighted_mean(per_sample, sample_weight, exact_denom)


def _is_dtensor(x) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported (a
    # GSPMD mesh imports it), so a one-device run never pays its import
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


class _VocabShardNLL(torch.autograd.Function):
    """Per-token NLL of logits split over the vocab (Megatron's
    vocab-parallel cross-entropy): each rank holds a (..., V/m) slice
    starting at ``lo``; the max, the sum of exponentials and the gold
    logit are all-reduced over ``group`` (None: the slice is the whole
    vocab), so no rank gathers the full-vocab logits. The gradient is
    ``softmax - onehot`` on the rank's slice, made in the backward from
    the saved slice and log-sum-exp."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        from torch.distributed import _functional_collectives as fc
        lg = logits.float()
        mx = lg.amax(-1)
        if group is not None:
            mx = fc.wait_tensor(fc.all_reduce(mx, "max", group))
        se = torch.exp(lg - mx[..., None]).sum(-1)
        lab = labels.long() - lo
        hit = (lab >= 0) & (lab < lg.shape[-1])
        gold = torch.gather(lg, -1, torch.where(hit, lab, 0)[..., None])
        gold = gold[..., 0] * hit
        if group is not None:
            se = fc.wait_tensor(fc.all_reduce(se, "sum", group))
            gold = fc.wait_tensor(fc.all_reduce(gold, "sum", group))
        lse = torch.log(se) + mx
        ctx.save_for_backward(lg, lse, torch.where(hit, lab, -1))
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        lg, lse, lab = ctx.saved_tensors
        grad = torch.exp(lg - lse[..., None])
        hit = lab >= 0
        rows = grad.gather(-1, torch.where(hit, lab, 0)[..., None])
        grad.scatter_(-1, torch.where(hit, lab, 0)[..., None],
                      rows - hit[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def sharded_nll(logits, labels):
    """Per-token NLL (fp32) of DTensor logits (..., V) on a GSPMD mesh:
    the vocab dim is sharded over ``model`` where it divides (the model's
    ``_lm_head`` hint makes it so) and the NLL reduces over the shards
    (:class:`_VocabShardNLL`). ``labels`` (a DTensor, or a plain tensor
    on every rank) keep their batch placement; the NLL is replicated over
    ``model``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..models import nn  # deferred: the models import this module
    mesh = nn.current_mesh()
    if mesh is None:
        raise ValueError("DTensor logits outside a GSPMD mesh context "
                         "(models.nn.use_mesh)")
    axes = list(mesh)
    v_dim = logits.dim() - 1
    m = mesh["model"] if "model" in mesh else 1
    sharded = m > 1 and logits.shape[-1] % m == 0
    lab_pl = (list(labels.placements) if _is_dtensor(labels)
              else [Replicate()] * len(axes))
    want = list(lab_pl)
    if "model" in mesh:
        want[axes.index("model")] = Shard(v_dim) if sharded else Replicate()
    local = logits.redistribute(mesh.device_mesh, want).to_local()
    lab = labels.to_local() if _is_dtensor(labels) else labels
    lo, group = 0, None
    if sharded:
        lo = mesh.coords()["model"] * local.shape[-1]
        group = mesh.groups["model"]
    nll = _VocabShardNLL.apply(local, lab, lo, group)
    return DTensor.from_local(nll, mesh.device_mesh, lab_pl,
                              run_check=False)


def bce_with_logits(logits, targets, *, sample_weight=None,
                    exact_denom=None) -> torch.Tensor:
    """Binary cross-entropy from logits; logits/targets (B, H, W, 1)."""
    logits = logits.float()
    per_px = (torch.clamp(logits, min=0) - logits * targets
              + torch.log1p(torch.exp(-torch.abs(logits))))
    per_sample = torch.mean(per_px, dim=tuple(range(1, per_px.dim())))
    return _weighted_mean(per_sample, sample_weight, exact_denom)


def dice_loss(logits, targets, *, sample_weight=None, exact_denom=None,
              eps: float = 1.0) -> torch.Tensor:
    """Paper eq. (19): L_dc = 1 - 2|A∩B| / (|A|+|B|), per sample."""
    probs = torch.sigmoid(logits.float())
    dims = tuple(range(1, probs.dim()))
    inter = torch.sum(probs * targets, dim=dims)
    denom = torch.sum(probs, dim=dims) + torch.sum(targets, dim=dims)
    per_sample = 1.0 - (2.0 * inter + eps) / (denom + eps)
    return _weighted_mean(per_sample, sample_weight, exact_denom)


def bce_dice_loss(logits, targets, **kw) -> torch.Tensor:
    """Paper eq. (20): L_total = L_bce + L_dc (the U-Net training loss)."""
    return bce_with_logits(logits, targets, **kw) + dice_loss(logits,
                                                              targets, **kw)


def iou(logits, targets, thresh: float = 0.5) -> torch.Tensor:
    """Intersection-over-union metric (paper §4.3.1)."""
    pred = (torch.sigmoid(logits.float()) > thresh).float()
    dims = tuple(range(1, pred.dim()))
    inter = torch.sum(pred * targets, dim=dims)
    union = torch.sum(torch.maximum(pred, targets), dim=dims)
    return torch.mean((inter + 1e-6) / (union + 1e-6))


def accuracy(logits, labels) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).float())
