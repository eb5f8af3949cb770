"""Resumable training loop over a (step_fn, Pipeline) pair — the JAX
package's ``engine/trainer.py``.

  * **async metrics readback** — the step functions return *device*
    scalars; the Trainer holds step i's metrics while dispatching step
    i+1 and only then converts them to host floats, so reading a loss
    never drains the card's queue. Every step lands in ``history`` with
    the host clock at its readback;
  * **periodic checkpointing** — ``{"params", "opt_state"}`` saved every
    ``ckpt_every`` steps (plus a final save), tagged with the *next* step
    index so resume knows where to pick up; each save and restore is
    timed in ``ckpt_log``;
  * **resume** — :meth:`restore` reads the newest loadable checkpoint and
    places the state on the pipeline's device.

With the Pipeline's step-indexed seeding, a save → resume round trip
replays the identical data stream and op sequence, so it matches an
uninterrupted run bit for bit where the ops themselves are deterministic.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..checkpoint import checkpoint
from .pipeline import Pipeline


def _default_log(step: int, metrics: Dict[str, float], elapsed: float):
    extra = (f"  |g| {metrics['grad_norm']:.3f}"
             if "grad_norm" in metrics else "")
    print(f"step {step:4d}  loss {metrics['loss']:.4f}{extra}"
          f"  ({elapsed:.1f}s)", flush=True)


class Trainer:
    """Drives ``step_fn(params, opt_state, split_batch)`` over a
    :class:`Pipeline`; ``step_fn`` is an executor's ``step_split``.

    Each step's metrics are read back one step late and appended to
    ``history`` as ``{"step", metrics..., "readback_s"}``
    (``time.perf_counter()`` at the readback); the steps that ``log_every``
    selects, and the last, also go through ``log_fn``. :meth:`restore`
    places the state on the pipeline's device. ``writer=False`` (the
    ranks of a data-parallel world but rank 0, which all hold the same
    state) restores from ``ckpt_dir`` but never saves.

    ``layout`` is the executor of a state that each rank holds a part of
    (``engine.PipelinedExecutor``): a save first puts the reference-format
    state together on every rank (its ``gather_state``, a collective), and
    a restore reads the reference-format checkpoint (``full_template``)
    and keeps this rank's part (``prepare``)."""

    def __init__(self, step_fn: Callable, pipeline: Pipeline, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_keep: Optional[int] = None, log_every: int = 5,
                 log_fn: Optional[Callable] = _default_log,
                 writer: bool = True, layout: Any = None):
        self.step_fn = step_fn
        self.writer = writer
        self.layout = layout
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_keep = ckpt_keep
        self.log_every = log_every
        self.device = pipeline.device
        self.log_fn = log_fn
        self.history: List[Dict[str, float]] = []
        self.ckpt_log: List[Dict[str, Any]] = []

    # -- checkpointing ------------------------------------------------------

    def save(self, step: int, params, opt_state) -> Optional[str]:
        if not self.ckpt_dir:
            return None
        t0 = time.perf_counter()
        if self.layout is not None:  # every rank gathers, one writes
            params, opt_state = self.layout.gather_state(params, opt_state)
        if not self.writer:
            return None
        path = checkpoint.save(self.ckpt_dir, step,
                               {"params": params, "opt_state": opt_state},
                               keep=self.ckpt_keep)
        self.ckpt_log.append({"op": "save", "step": step,
                              "seconds": time.perf_counter() - t0,
                              "bytes": os.path.getsize(path)})
        return path

    def restore(self, params_template, opt_state_template
                ) -> Optional[Tuple[Any, Any, int]]:
        """(params, opt_state, start_step) from the newest *loadable*
        committed checkpoint in ``ckpt_dir``, on the pipeline's device —
        or ``None`` when there is nothing to resume from. Torn writes are
        invisible (no manifest) and checksum-failing checkpoints are
        skipped in favor of the previous committed step."""
        if not self.ckpt_dir:
            return None
        for step in reversed(checkpoint.committed_steps(self.ckpt_dir)):
            t0 = time.perf_counter()
            try:
                tree = self._restore_step(step, params_template,
                                          opt_state_template)
            except checkpoint.CheckpointCorruptError:
                continue  # fall back to the previous committed step
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # time the whole copy
            self.ckpt_log.append({"op": "restore", "step": step,
                                  "seconds": time.perf_counter() - t0})
            return tree["params"], tree["opt_state"], step
        return None

    def _restore_step(self, step: int, params_template, opt_state_template):
        if self.layout is not None:
            params_template, opt_state_template = self.layout.full_template(
                params_template, opt_state_template)
            t = checkpoint.restore(
                self.ckpt_dir, {"params": params_template,
                                "opt_state": opt_state_template}, step,
                device="cpu")
            params, opt_state = self.layout.prepare(
                t["params"], t["opt_state"], device=self.device)
            return {"params": params, "opt_state": opt_state}
        template = {"params": params_template,
                    "opt_state": opt_state_template}
        try:
            return checkpoint.restore(self.ckpt_dir, template, step,
                                      device=self.device)
        except KeyError:
            # legacy params-only checkpoint: restore what is there and
            # keep the caller's (fresh) optimizer state
            params = checkpoint.restore(self.ckpt_dir, params_template,
                                        step, device=self.device)
            return {"params": params, "opt_state": opt_state_template}

    # -- the loop -----------------------------------------------------------

    def fit(self, params, opt_state, num_steps: int, *, start_step: int = 0
            ) -> Tuple[Any, Any, Dict[str, float]]:
        """Run steps ``start_step .. num_steps``; returns the final state
        and the last step's metrics (as host floats)."""
        t0 = time.perf_counter()
        pending: Optional[Tuple[int, Dict[str, Any]]] = None
        last: Dict[str, float] = {}
        stream = self.pipeline.batches(num_steps - start_step,
                                       start=start_step)
        # drive iteration from the stream (not a zip'd range) so the
        # generator runs to completion and finalizes pipeline.stats
        for offset, batch in enumerate(stream):
            step = start_step + offset
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            del batch
            # read back the PREVIOUS step's metrics now that this step is
            # queued — the readback overlaps compute instead of gating it
            if pending is not None:
                self._flush(*pending, t0)
            pending = (step, metrics)
            if self.ckpt_every and (step + 1) % self.ckpt_every == 0 \
                    and step + 1 < num_steps:
                self.save(step + 1, params, opt_state)
        if pending is not None:
            last = self._flush(*pending, t0, final=True)
        if self.ckpt_dir and num_steps > start_step:
            self.save(num_steps, params, opt_state)
        return params, opt_state, last

    def _flush(self, step: int, metrics: Dict[str, Any], t0: float, *,
               final: bool = False) -> Dict[str, float]:
        logged = bool(self.log_every) and step % self.log_every == 0
        m = {k: float(v) for k, v in metrics.items()}
        self.history.append({"step": step, **m,
                             "readback_s": time.perf_counter()})
        if self.log_fn and (logged or final):
            self.log_fn(step, m, time.perf_counter() - t0)
        return m
