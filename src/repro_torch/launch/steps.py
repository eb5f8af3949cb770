"""Loss construction for the training step (the JAX package's
``launch/steps.make_loss_fn``, dense decoder-only family)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core import losses
from ..models import remat as remat_lib
from ..models import transformer
from ..models.config import ModelConfig


def make_loss_fn(cfg: ModelConfig, dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = None):
    """``loss_fn(params, mb, exact_denom=None) -> (loss, {"aux_loss"})``.
    Pass the plan's ``remat_policy`` so the loss checkpoints the way the
    planner admitted it."""
    transformer.check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)

    def loss_fn(params, mb, exact_denom=None):
        logits, aux = transformer.forward(params, cfg, mb["tokens"],
                                          dtype=dtype, remat_policy=policy)
        loss = losses.cross_entropy(logits, mb["labels"],
                                    sample_weight=mb.get("sample_weight"),
                                    exact_denom=exact_denom)
        return loss, {"aux_loss": aux}

    return loss_fn
