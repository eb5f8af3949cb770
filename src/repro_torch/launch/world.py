"""A data-parallel world of ranks in processes of their own on this host.

:class:`LocalWorld` starts ``n`` processes (the ``forkserver`` start
method, :func:`context`: a parent that has loaded other frameworks hands
none of them down, and a rank forks from a server that imported torch
once instead of importing it again), each of
which joins one ``torch.distributed`` world through a file rendezvous
(``launch.mesh.init_world``) and then serves calls: :meth:`LocalWorld.run`
sends ``fn`` and its arguments to every rank, each rank calls
``fn(mesh, *args)`` with its own :class:`launch.mesh.Mesh`, and the
results come back as a list by rank. ``fn`` must be a module-level
function (it is pickled by name) and its results picklable.

Every wait has a deadline: a rank that fails sends its traceback and the
call raises; a rank that dies or hangs fails the call at its timeout. A
failed world is closed — its processes terminated — and refuses further
calls. The world stops its processes on :meth:`close` (or leaving its
``with`` block).

Ranks on ``device="cuda"`` use ``launch.mesh.rank_device``'s choice: a
card each over NCCL, or all on one card over gloo.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


#: what the fork server imports once for every rank it starts: torch,
#: DTensor and the port's engine and launchers (none starts a thread or
#: touches a device)
_PRELOAD = ["torch", "torch.distributed", "torch.distributed.tensor",
            "repro_torch.launch.mesh", "repro_torch.engine",
            "repro_torch.launch.train", "repro_torch.launch.serve"]


def context():
    """The ranks' start method: a fork server (started at the first world,
    or ahead of it by ``multiprocessing.forkserver.ensure_running()``)
    that has imported :data:`_PRELOAD` and nothing of the parent's."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


def _serve(rank: int, n: int, device: str, store: str, threads: int,
           timeout_s: float, inbox, outbox) -> None:
    import torch
    from . import mesh as mesh_lib
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = mesh_lib.init_world(
            device, timeout_s=timeout_s, init_method="file://" + store,
            rank=rank, world=n, local_rank=rank, local_world=n)
    except BaseException:  # noqa: BLE001 (reported to the parent)
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, "ready"))
    try:
        while True:
            item = inbox.get()
            if item is None:
                break
            fn, args = item
            try:
                outbox.put((rank, True, fn(mesh, *args)))
            except BaseException:  # noqa: BLE001 (reported to the parent)
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        mesh_lib.shutdown()


class LocalWorld:
    """``n`` ranks in spawned processes (see the module doc). ``store_dir``
    holds the rendezvous file (default: a new temporary directory);
    ``timeout_s`` bounds the start and every call, and is the process
    group's collective timeout; ``threads`` caps each rank's intra-op
    threads (0 leaves torch's default)."""

    def __init__(self, n: int, *, device: str = "cpu",
                 store_dir: Optional[str] = None, timeout_s: float = 120.0,
                 threads: int = 1):
        self.n = n
        self.timeout_s = timeout_s
        self._tmp = None
        if store_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="world-")
            store_dir = self._tmp.name
        store = os.path.join(store_dir, f"rendezvous-{os.getpid()}-"
                                        f"{time.monotonic_ns()}")
        ctx = context()
        self._in = [ctx.Queue() for _ in range(n)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(
            target=_serve, args=(r, n, device, store, threads, timeout_s,
                                 self._in[r], self._out), daemon=True)
            for r in range(n)]
        self._broken: Optional[str] = None
        for p in self._procs:
            p.start()
        try:
            self._collect(timeout_s, "start")
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout_s: float, what: str) -> List[Any]:
        results: dict = {}
        deadline = time.monotonic() + timeout_s
        while len(results) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = self._out.get(timeout=max(min(left, 1.0),
                                                            0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in results]
                if dead or left <= 0:
                    why = (f"rank(s) {dead} exited" if dead
                           else f"no answer from rank(s) "
                                f"{sorted(set(range(self.n)) - set(results))}"
                                f" within {timeout_s:.0f}s")
                    self._broken = f"{what}: {why}"
                    raise RuntimeError(f"local world {what}: {why}")
                continue
            if not ok:
                self._broken = f"{what}: rank {rank} failed"
                raise RuntimeError(f"local world {what}: rank {rank} "
                                   f"failed:\n{value}")
            results[rank] = value
        return [results[r] for r in range(self.n)]

    def run(self, fn: Callable, *args, timeout_s: Optional[float] = None
            ) -> List[Any]:
        """``fn(mesh, *args)`` on every rank; the results by rank."""
        self.submit(fn, *args)
        return self.collect(fn.__name__, timeout_s=timeout_s)

    def submit(self, fn: Callable, *args) -> None:
        """Start ``fn(mesh, *args)`` on every rank and return at once; the
        caller works meanwhile and then takes the results with
        :meth:`collect` (one call in flight at a time)."""
        if self._broken is not None:
            raise RuntimeError(f"local world is broken ({self._broken})")
        for q in self._in:
            q.put((fn, args))

    def collect(self, what: str = "call", *,
                timeout_s: Optional[float] = None) -> List[Any]:
        """The results by rank of the call :meth:`submit` started."""
        try:
            return self._collect(timeout_s or self.timeout_s, what)
        except BaseException:
            self.close()
            raise

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop every rank: ask, then terminate, then kill."""
        for q, p in zip(self._in, self._procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join(2.0)
        if self._broken is None:
            self._broken = "closed"
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
