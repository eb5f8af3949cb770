"""Plan-aware async input pipeline (paper §3.1, Fig. 1) — the JAX
package's ``engine/pipeline.py`` on CUDA streams.

Micro-batch *transfer* must overlap *compute*. The overlap happens at two
granularities:

  * host work (dataset batch synthesis + the plan's pad-and-mask split,
    Fig. 2 step ❶, and on CUDA the copy into page-locked memory) runs in
    a background thread via ``core.streaming.prefetch_iterator`` — worker
    exceptions propagate to the consumer instead of truncating the epoch;
  * host→device staging is double-buffered at mini-batch granularity:
    batch i+1's copies are issued on a CUDA stream of the pipeline's own
    before batch i is yielded, so they land while step i computes. Each
    staged batch carries the event recorded after its copies; the
    consumer's stream waits on it (a device-side wait) as the batch is
    yielded, before its first use.

:class:`Pipeline` also measures how long the consumer was blocked waiting
on input (``stats.input_wait_fraction``) — an input-bound step loop shows
up here, not as mysteriously slow device time.
"""
from __future__ import annotations

import dataclasses
import functools
import random as _random
import time
from typing import Any, Dict, Iterator, Optional

import torch

from ..core.streaming import prefetch_iterator
from . import faults
from . import plan as plan_lib
from .plan import MBSPlan


@dataclasses.dataclass
class PipelineStats:
    """Input-side timing of one ``batches()`` pass."""
    batches: int = 0
    wait_s: float = 0.0  # consumer time blocked on host data / staging
    elapsed_s: float = 0.0  # total wall time of the pass
    retries: int = 0  # transient producer failures absorbed by backoff

    @property
    def input_wait_fraction(self) -> float:
        return self.wait_s / self.elapsed_s if self.elapsed_s > 0 else 0.0


class Pipeline:
    """Dataset → pre-split ``(N_Sμ, N_μ, ...)`` batches → ``device``.

    With ``stage=False`` no device placement happens and the pipeline
    yields host numpy batches (the ``MBSLoader`` facade). On CUDA the
    producer thread copies each split into page-locked memory and the
    copies to the card run on the pipeline's copy stream; on the CPU a
    batch is ``torch.from_numpy`` of the split.

    Batch ``i`` of a pass started at ``start`` is always drawn with seed
    ``seed + start + i``, so a resumed run consumes exactly the stream an
    uninterrupted run would have seen.

    Transient producer failures (the ``faults`` taxonomy's
    ``TransientError`` plus plain ``OSError``) get ``retries`` bounded
    retries with seeded jittered backoff before the failure propagates;
    absorbed retries are counted in ``stats.retries``. A retry re-draws
    the SAME seeded batch, so an absorbed fault never perturbs the data.

    With a data-parallel ``mesh`` (``launch.mesh.Mesh``) every rank
    draws the same global mini-batch from the seed and stages only its
    own block of the sample dim, ``[r·local, (r+1)·local)`` for rank r
    (``engine.sharded.local_block``). ``sharding`` is a function from a split
    host batch to the part of it this rank stages (an
    ``engine.ShardedExecutor``'s ``shard``); give one or the other.
    """

    def __init__(self, dataset, plan: MBSPlan, *, prefetch: int = 2,
                 stage: bool = True, device="cuda", seed: int = 0,
                 batch_kw: Optional[Dict[str, Any]] = None,
                 retries: int = 2, retry_backoff_s: float = 0.01,
                 mesh: Any = None, sharding: Any = None):
        if mesh is not None:
            if sharding is not None:
                raise ValueError("pass either mesh= or sharding=, not both")
            from .sharded import local_block  # deferred: no cycle
            sharding = functools.partial(
                local_block, micro=plan.micro_batch_size, mesh=mesh)
        if sharding is not None and not callable(sharding):
            raise TypeError("sharding= is a function from a split host batch "
                            "to the part this rank stages")
        self._shard = sharding
        self.dataset = dataset
        self.plan = plan
        self.prefetch = prefetch
        self.stage = stage
        self.device = torch.device(device)
        self.seed = seed
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        self.batch_kw = dict(batch_kw or {})
        self._cuda = stage and self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self.stats = PipelineStats()

    # -- staging ------------------------------------------------------------

    def _host(self, split):
        """Producer side: this rank's part of the split (with a mesh or a
        sharding), as page-locked host tensors when staging to CUDA."""
        if self._shard is not None:
            split = self._shard(split)
        return plan_lib.host_tensors(split, pin=True) if self._cuda else split

    def _put(self, host):
        """Issue the copies of one batch: (device tensors, event), or the
        host batch itself when not staging."""
        if not self.stage:
            return host, None
        if not self._cuda:
            host = plan_lib.host_tensors(host, pin=False)
        return plan_lib.stage(host, self.device, self._copy_stream)

    def rebatch(self, step: int):
        """Synthesize, split and stage global step ``step``'s batch again —
        identical to what ``batches()`` yielded for it (step-indexed
        seeding), but WITHOUT the fault-injection hooks (the supervisor's
        NaN retry path re-draws a poisoned batch this way)."""
        mini = self.dataset.batch(self.plan.mini_batch_size,
                                  self.seed + step, **self.batch_kw)
        return _ready(self._put(self._host(self.plan.split(mini))))

    # -- iteration ----------------------------------------------------------

    def batches(self, num_batches: int, start: int = 0
                ) -> Iterator[Dict[str, Any]]:
        """Yield ``num_batches`` staged split batches for global steps
        ``start .. start + num_batches``. Resets ``self.stats``."""
        self.stats = stats = PipelineStats()

        def host_gen():
            rng = _random.Random(self.seed ^ 0x5EED)  # jitter only, not data
            for i in range(start, start + num_batches):
                for attempt in range(self.retries + 1):
                    try:
                        faults.on_host_batch(i)
                        mini = self.dataset.batch(self.plan.mini_batch_size,
                                                  self.seed + i,
                                                  **self.batch_kw)
                        split = self.plan.split(mini)
                        break
                    except (faults.TransientError, OSError):
                        if attempt >= self.retries:
                            raise  # bounded: fail fast
                        stats.retries += 1
                        time.sleep(self.retry_backoff_s
                                   * (1 + rng.random()) * (2 ** attempt))
                yield self._host(faults.corrupt_batch(split, i))

        it = (prefetch_iterator(host_gen(), self.prefetch)
              if self.prefetch else host_gen())

        def run():
            t_begin = time.perf_counter()
            try:
                nxt = self._next_staged(it, stats)
                while nxt is not _DONE:
                    cur, nxt = nxt, self._next_staged(it, stats)
                    stats.batches += 1
                    yield _ready(cur)
            finally:
                stats.elapsed_s = time.perf_counter() - t_begin
                it.close()  # a stream closed early stops its producer

        return run()

    __call__ = batches  # loader-style invocation

    def _next_staged(self, it, stats: PipelineStats):
        """Pull + stage the next batch, charging the blocked time to
        ``stats.wait_s``. The copies are asynchronous — by staging batch
        i+1 before yielding batch i we get the double buffer."""
        t0 = time.perf_counter()
        try:
            staged = self._put(next(it))
        except StopIteration:
            return _DONE
        finally:
            stats.wait_s += time.perf_counter() - t0
        return staged


def _ready(staged):
    """The consumer's side of a staged batch: its stream waits on the
    copies' event before the first use."""
    batch, event = staged
    return plan_lib.wait_staged(batch, event)


_DONE = object()
