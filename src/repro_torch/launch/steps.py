"""Loss construction for the training step (the JAX package's
``launch/steps.make_loss_fn``): every family — dense, MoE, SSM, hybrid,
the VLM (patch embeddings and M-RoPE positions when the batch has them)
and the encoder-decoder (frames and target tokens)."""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import tree
from ..core import losses
from ..data import LMDataset
from ..models import encdec, transformer
from ..models import remat as remat_lib
from ..models.config import ModelConfig

N_VISION_TOKENS = 256  # stubbed patch embeddings a sample (qwen2-vl)
AUDIO_TGT_FRACTION = 4  # enc-dec training: decoder length = seq / 4


def make_loss_fn(cfg: ModelConfig, dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: Optional[str] = None):
    """``loss_fn(params, mb, exact_denom=None) -> (loss, {"aux_loss"})``.
    Pass the plan's ``remat_policy`` so the loss checkpoints the way the
    planner admitted it. An enc-dec batch holds ``frames`` and
    ``tgt_tokens``; a VLM batch may add ``vision_embeds`` and
    ``mrope_positions`` (one micro-batch's (3, N_mu, S)) to ``tokens``.

    MoE configs add the router's load-balance term, ``router_aux_coef ·
    aux / num_layers``. Under exact normalization micro-batch losses must
    sum to the mini-batch's, so that term, which is not per sample,
    carries the micro-batch's share of the valid samples
    (``n_valid / exact_denom``): every executor then weights it alike,
    whatever the split."""
    if not cfg.is_encdec:
        transformer.check_supported(cfg)
    policy = remat_lib.resolve(remat, remat_policy)

    def loss_fn(params, mb, exact_denom=None):
        sw = mb.get("sample_weight")
        if cfg.is_encdec:
            logits, aux = encdec.forward(params, cfg, mb["frames"],
                                         mb["tgt_tokens"], dtype=dtype,
                                         remat_policy=policy)
        else:
            logits, aux = transformer.forward(
                params, cfg, mb["tokens"],
                vision_embeds=mb.get("vision_embeds"),
                mrope_positions=mb.get("mrope_positions"), dtype=dtype,
                remat_policy=policy)
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


# ---------------------------------------------------------------------------
# a family's train batch (the data twin of the reference's
# ``abstract_train_batch``)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """The family's ``init_params``: ``encdec``'s or ``transformer``'s."""
    init = encdec.init_params if cfg.is_encdec else transformer.init_params
    return init(cfg, seed=seed, device=device)


def mrope_positions(batch: int, seq_len: int, n_vis: int) -> np.ndarray:
    """qwen2-vl's M-RoPE streams (3, batch, seq_len) int32 for an image
    prefix of ``n_vis`` patches, then text: patch j of a grid ``w`` wide
    (w = ceil(sqrt(n_vis))) sits at (t, h, w) = (0, j // w, j % w); text
    token i after the image at start + i in all three streams, start one
    past the largest image position."""
    w = math.isqrt(n_vis - 1) + 1 if n_vis else 1
    j = np.arange(n_vis)
    img = np.stack([np.zeros_like(j), j // w, j % w])  # (3, n_vis)
    start = int(img.max()) + 1 if n_vis else 0
    text = np.arange(seq_len - n_vis) + start
    pos = np.concatenate([img, np.broadcast_to(text, (3, text.size))], 1)
    return np.broadcast_to(pos[:, None].astype(np.int32),
                           (3, batch, seq_len)).copy()


def family_batch(cfg: ModelConfig, seq_len: int, batch_size: int, *,
                 seed: int = 0, vision: bool = True
                 ) -> Dict[str, np.ndarray]:
    """A host mini-batch of ``cfg``'s family from ``seed``: an enc-dec
    config's ``frames`` (B, seq_len, d_model) fp32 with ``tgt_tokens`` and
    ``labels`` of seq_len // AUDIO_TGT_FRACTION; otherwise ``LMDataset``'s
    tokens and labels, and for a VLM (``vision``) ``vision_embeds`` (B,
    n_vis, VISION_EMBED_DIM) fp32, n_vis = min(N_VISION_TOKENS, seq_len),
    and their ``mrope_positions`` (3, B, seq_len)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        t = seq_len // AUDIO_TGT_FRACTION
        toks = LMDataset(cfg.vocab_size, t, seed=seed).batch(batch_size, 0)
        return {"frames": rng.standard_normal(
                    (batch_size, seq_len, cfg.d_model), np.float32),
                "tgt_tokens": toks["tokens"], "labels": toks["labels"]}
    batch = LMDataset(cfg.vocab_size, seq_len, seed=seed).batch(batch_size,
                                                                 0)
    if cfg.is_vlm and vision:
        n_vis = min(N_VISION_TOKENS, seq_len)
        batch["vision_embeds"] = rng.standard_normal(
            (batch_size, n_vis, transformer.VISION_EMBED_DIM), np.float32)
        batch["mrope_positions"] = mrope_positions(batch_size, seq_len,
                                                   n_vis)
    return batch


def device_split(plan, batch: Dict[str, np.ndarray], device,
                 dtype=None) -> Dict[str, torch.Tensor]:
    """``plan.device_split`` of a family batch, float leaves cast to
    ``dtype``. The plan's split cuts every leaf on axis 0, so the (3, B,
    S) ``mrope_positions`` stay out of it and are split here on their
    batch axis into (N_Smu, 3, N_mu, S); a ragged plan, which would pad
    them, is refused."""
    rest = {k: v for k, v in batch.items() if k != "mrope_positions"}
    out = plan.device_split(rest, device)
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() and
               k != "sample_weight" else v for k, v in out.items()}
    pos = batch.get("mrope_positions")
    if pos is not None:
        if plan.pad:
            raise ValueError(
                f"mrope_positions: a ragged plan pads the last micro-batch "
                f"({plan.describe()}); split the streams uniformly")
        n_s, n_mu = plan.num_micro_batches, plan.micro_batch_size
        s = np.asarray(pos).reshape(3, n_s, n_mu, pos.shape[-1])
        out["mrope_positions"] = torch.from_numpy(np.ascontiguousarray(
            s.transpose(1, 0, 2, 3))).to(device)
    return out
