"""Loss construction for the training step (the JAX package's
``launch/steps.make_loss_fn``, decoder-only families: dense, MoE, SSM and
hybrid)."""
from __future__ import annotations

from typing import Optional

import torch

from .. import tree
from ..core import losses
from ..models import remat as remat_lib
from ..models import transformer
from ..models.config import ModelConfig


def make_loss_fn(cfg: ModelConfig, dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = None):
    """``loss_fn(params, mb, exact_denom=None) -> (loss, {"aux_loss"})``.
    Pass the plan's ``remat_policy`` so the loss checkpoints the way the
    planner admitted it.

    MoE configs add the router's load-balance term, ``router_aux_coef ·
    aux / num_layers``. Under exact normalization micro-batch losses must
    sum to the mini-batch's, so that term, which is not per sample,
    carries the micro-batch's share of the valid samples
    (``n_valid / exact_denom``): every executor then weights it alike,
    whatever the split."""
    transformer.check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)

    def loss_fn(params, mb, exact_denom=None):
        sw = mb.get("sample_weight")
        logits, aux = transformer.forward(params, cfg, mb["tokens"],
                                          dtype=dtype, remat_policy=policy)
        loss = losses.cross_entropy(logits, mb["labels"], sample_weight=sw,
                                    exact_denom=exact_denom)
        if cfg.is_moe:
            aux_term = cfg.router_aux_coef * aux / cfg.num_layers
            if exact_denom is not None:
                n_valid = (torch.sum(sw) if sw is not None
                           else float(tree.leaves(mb)[0].shape[0]))
                aux_term = aux_term * (n_valid / exact_denom)
            loss = loss + aux_term
        return loss, {"aux_loss": aux}

    return loss_fn
