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


def accuracy(logits, labels) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).float())
