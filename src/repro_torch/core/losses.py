"""Loss functions.

Every loss returns the *mean per-sample loss over the (micro-)batch*,
which is what the MBS loss normalization (paper §3.4, Algorithm 1)
consumes. ``sample_weight`` covers the ragged tail (N_B % N_μ != 0):
padded samples carry weight 0. With ``exact_denom`` set, the weighted sum
is divided by that count instead (exact-ragged MBS).
"""
from __future__ import annotations

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
    0); batch loss = mean over samples."""
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
