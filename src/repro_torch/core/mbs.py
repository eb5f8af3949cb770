"""Micro-Batch Streaming (MBS) — the legacy facade (the JAX package's
``core/mbs.py``).

The paper's technique — split a mini-batch into N_Sμ micro-batches (§3.2,
eq. 1–3), normalize each micro loss by 1/N_Sμ (§3.4, eq. 14), accumulate
gradients (Fig. 2 step ❹) and apply one optimizer update per mini-batch
(step ❺) — lives in the execution engine (``repro_torch.engine``). This
module re-exports the legacy surface; new code imports from the engine.
"""
from __future__ import annotations

from typing import Callable

from ..engine import (MBSConfig, MBSPlan, num_micro_batches,  # noqa: F401
                      plan_mbs, split_minibatch)
from ..engine import (CompiledScanExecutor, accumulate_gradients,  # noqa: F401
                      make_baseline_train_step)


def make_mbs_train_step(loss_fn: Callable, optimizer, mbs: MBSConfig
                        ) -> Callable:
    """Legacy builder for the MBS training step: ``train_step(params,
    opt_state, micro_batches) -> (params, opt_state, metrics)`` over a
    split batch whose every leaf has leading shape ``(N_Sμ, N_μ, ...)`` —
    ``CompiledScanExecutor(loss_fn, optimizer, mbs).step_split``.

    ``loss_fn(params, micro_batch, exact_denom=None) -> (loss, metrics)``
    returns the mean per-sample loss of the micro-batch (honouring
    ``micro_batch['sample_weight']``); with ``exact_denom`` it divides the
    summed per-sample loss by that denominator instead."""
    return CompiledScanExecutor(loss_fn, optimizer, mbs).step_split


def mbs_gradients(loss_fn, params, micro_batches, mbs: MBSConfig):
    """Accumulated, normalized MBS gradients only (no optimizer) — the
    quantity eq. (15)–(17) prove equal to the mini-batch gradient."""
    return accumulate_gradients(loss_fn, params, micro_batches, mbs)
