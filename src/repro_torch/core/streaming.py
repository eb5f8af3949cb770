"""Stream-based pipeline (paper §3.1, Fig. 1) — the legacy name of the
streaming executor plus the host-side prefetch iterator (the JAX
package's ``core/streaming.py``).

The executor lives in the engine (``engine.executors.StreamingExecutor``):
micro-batch i+1 is copied host→device on a CUDA stream of its own while
micro-batch i computes on the current stream, and the accumulator, loss
and metrics stay on the device for the whole loop.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

from ..engine.executors import StreamingExecutor

# Legacy name: the eager micro-batch streaming executor (paper Fig. 1).
MBSStreamExecutor = StreamingExecutor


class _WorkerError:
    """Queue sentinel carrying an exception out of the prefetch thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterator(it: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetch for host data pipelines.

    Exceptions raised by the producer are re-raised in the consumer (with
    the worker's traceback attached) rather than silently ending the
    stream — a failed data pipeline must never truncate an epoch.

    Closing the iterator (``close()``, or dropping it) stops the worker:
    it drains the queue, so a worker blocked on a full queue wakes, sees
    the stop and returns, and the batches it held are freed.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = object()
    closed = threading.Event()

    def worker():
        try:
            for item in it:
                q.put(item)
                del item
                if closed.is_set():
                    return
        except BaseException as exc:  # noqa: BLE001 — relayed to consumer
            q.put(_WorkerError(exc))
        else:
            q.put(stop)

    threading.Thread(target=worker, daemon=True,
                     name="repro-torch-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
            del item
    finally:
        closed.set()
        while True:  # wake a worker blocked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
