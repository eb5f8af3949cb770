"""Data loader — a thin facade over the engine's async input pipeline
(the JAX package's ``data/loader.py``).

``MBSLoader`` yields host-side ``(N_Sμ, N_μ, ...)`` splits of a dataset's
mini-batches through :func:`repro_torch.engine.plan_mbs` and
:class:`repro_torch.engine.Pipeline` (``stage=False``), so it inherits the
planner's geometry (ragged tails pad + mask, paper normalization upgraded
to exact) and the pipeline's background prefetch with worker-exception
propagation. Code that also wants device staging uses ``engine.Pipeline``
directly."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..engine import Pipeline, plan_mbs


class MBSLoader:
    """Yields mini-batches pre-split into ``(N_Sμ, N_μ, ...)`` micro-batch
    stacks of host numpy arrays."""

    def __init__(self, dataset, mini_batch_size: int, micro_batch_size: int,
                 *, prefetch: int = 2, seed: int = 0,
                 normalization: str = "paper", **batch_kw):
        self.dataset = dataset
        self.mini_batch_size = mini_batch_size
        self.micro_batch_size = micro_batch_size
        self.prefetch = prefetch
        self.seed = seed
        self.batch_kw = batch_kw
        # weighted datasets need normalization="exact" — "paper" cannot
        # weight non-uniform samples correctly and plan.split refuses them
        self.plan = plan_mbs(mini_batch_size,
                             micro_batch_size=micro_batch_size,
                             normalization=normalization)
        self._pipeline = Pipeline(dataset, self.plan, prefetch=prefetch,
                                  stage=False, seed=seed, batch_kw=batch_kw)

    def __call__(self, num_batches: int) -> Iterator[Dict[str, np.ndarray]]:
        return self._pipeline.batches(num_batches)
