"""Recorded traces of one training or decode step — the port's
counterparts of the reference's ``trace_step`` (a jaxpr of the step) and
``lower_step(...).compile()`` (its executable's aliasing, memory and
collective schedule).

PyTorch runs eagerly, so there is nothing to inspect before the step
runs: :func:`record` runs it once under a ``TorchDispatchMode`` and keeps
what the reference's analysis reads off its IR:

  * every ATen op, with its operands' dtypes and shapes, whether it
    writes an operand in place (its schema), whether it ran inside the
    autograd engine (the backward) and inside which kernel wrapper;
  * every call of a wrapper of ``repro_torch.kernels`` (K1–K6), with its
    operands — the Triton and ctypes launches themselves are invisible
    to a dispatch mode, so the wrappers report their calls
    (``kernels._launch.kernel_scope``);
  * every ``torch.distributed`` call, seen as the ``c10d`` op it
    dispatches to (whatever API issued it, so a census never trusts the
    executor's own count), with its payload, its group's ranks and, for
    a point-to-point call, its peer;
  * every read of a device value by the host (``.item()``, ``nonzero``,
    ``equal``, a device-to-host copy) with the source line that made it,
    and on the card the synchronizing calls that
    ``torch.cuda.set_sync_debug_mode`` reports;
  * every ``torch.utils.checkpoint`` region: whether it is selective,
    how deeply it nests and whether its function ran again in the
    backward (the recomputation);
  * the live tensor bytes: each storage the step allocates is counted
    until it is freed, so ``peak_live_bytes`` is the step's peak over the
    bytes alive when it began (no allocator is asked, so this also holds
    under a ``FakeTensorMode``, where nothing is allocated).

:func:`state_storages` gives the storages a state lives in, before and
after a step, for the in-place contracts. Nothing here changes what the
step computes: the mode calls every op as it was called.
"""
from __future__ import annotations

import contextlib
import dataclasses
import linecache
import os
import re
import threading
import traceback
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import tree

_THIS_FILE = os.path.abspath(__file__)

# ATen ops that read a device value back to the host (or need a host
# round trip for their data-dependent output shape)
HOST_READ_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.nonzero.default",
    "aten.equal.default", "aten.masked_select.default",
    "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default",
})

# c10d ops by the collective they issue
_COLLECTIVES = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "all_reduce": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather",
    "all_gather_into_tensor": "all_gather",
    "reduce_scatter_": "reduce_scatter",
    "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "reduce_scatter_tensor": "reduce_scatter",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "barrier": "barrier", "alltoall_": "all_to_all",
    "alltoall_base_": "all_to_all", "gather_": "gather",
    "scatter_": "scatter", "reduce_": "reduce",
}

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\(([A-Za-z0-9_,\s]*)\))?")


@dataclasses.dataclass
class OpRecord:
    """One ATen op of the step."""
    name: str
    dtypes: Tuple[str, ...]  # tensor operands' dtypes, in argument order
    shapes: Tuple[Tuple[int, ...], ...]
    written: Tuple[int, ...]  # indices (into dtypes) of operands written
    backward: bool  # ran inside the autograd engine
    kernel: Optional[str]  # the kernel wrapper it ran inside
    nbytes: int  # operand and output bytes (bytes accessed); 0 for a
    # view or a metadata op (``prim.*``), which moves no data

    def written_dtypes(self) -> List[str]:
        return [self.dtypes[i] for i in self.written]


@dataclasses.dataclass
class KernelCall:
    """One call of a kernel wrapper: ``writes`` are the operands it
    updates in place (or returns), ``reads`` the others."""
    name: str
    device: str
    write_dtypes: Tuple[str, ...]
    write_shapes: Tuple[Tuple[int, ...], ...]
    read_dtypes: Tuple[str, ...]
    nbytes: int
    write_storages: Tuple[Optional[int], ...]
    launched: bool = True  # False: a fake tensor's call (nothing ran)


@dataclasses.dataclass
class Collective:
    """One ``torch.distributed`` call of the step."""
    kind: str  # all_reduce, all_gather, reduce_scatter, send, recv, ...
    op: str  # the c10d op
    numel: int
    nbytes: int
    ranks: Tuple[int, ...]  # the group's global ranks
    peer: Optional[int]  # a point-to-point call's global peer rank
    location: str


@dataclasses.dataclass
class HostRead:
    op: str
    location: str  # file:line of the source that made it
    source: str  # that line


@dataclasses.dataclass
class RematRegion:
    selective: bool
    depth: int
    calls: int = 0  # runs of its function: 1 forward, more = recomputed

    @property
    def recomputed(self) -> bool:
        return self.calls > 1


@dataclasses.dataclass
class StepTrace:
    """What :func:`record` saw of one step (see the module doc)."""
    ops: List[OpRecord] = dataclasses.field(default_factory=list)
    kernels: List[KernelCall] = dataclasses.field(default_factory=list)
    collectives: List[Collective] = dataclasses.field(default_factory=list)
    host_reads: List[HostRead] = dataclasses.field(default_factory=list)
    sync_calls: List[HostRead] = dataclasses.field(default_factory=list)
    remat: List[RematRegion] = dataclasses.field(default_factory=list)
    base_live_bytes: int = 0
    peak_live_bytes: int = 0
    bytes_accessed: int = 0
    device: str = "cpu"
    output: Any = None  # what the step returned

    def collective_census(self) -> Dict[str, Dict[str, int]]:
        """Calls and bytes by collective kind."""
        out: Dict[str, Dict[str, int]] = {}
        for c in self.collectives:
            d = out.setdefault(c.kind, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += c.nbytes
        return out


def waived(location: str, rule: str) -> bool:
    """True when the source line at ``location`` (``file:line``) carries
    ``# repro: noqa(RULE)`` (or a bare ``# repro: noqa``)."""
    path, _, line = location.rpartition(":")
    if not path or not line.isdigit():
        return False
    m = _NOQA_RE.search(linecache.getline(path, int(line)))
    if not m:
        return False
    rules = m.group(1)
    return not rules or rule in {r.strip().upper()
                                 for r in rules.split(",")}


def _site() -> Tuple[str, str]:
    """(file:line, source) of the innermost frame of the caller's code:
    the first outside torch, the standard library and this module."""
    skip = (os.path.dirname(os.path.abspath(torch.__file__)),
            os.path.dirname(os.path.abspath(os.__file__)))
    for fr in reversed(traceback.extract_stack()[:-2]):
        path = os.path.abspath(fr.filename)
        if path != _THIS_FILE and not path.startswith(skip):
            return f"{path}:{fr.lineno}", (fr.line or "").strip()
    return "?", ""


def _storage_id(t: torch.Tensor) -> Optional[int]:
    """The identity of the storage ``t`` lives in (a view's is its
    base's), fake tensors' included; None where there is none."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class _LiveBytes:
    """Bytes of the storages alive, each counted once from its first
    sight until it is freed (a weak reference's callback)."""

    def __init__(self):
        self._refs: Dict[Any, weakref.ref] = {}
        self._lock = threading.Lock()
        self.live = 0
        self.peak = 0

    def see(self, t: torch.Tensor) -> None:
        key = _storage_id(t)
        if key is None or key in self._refs:
            return
        st = t.untyped_storage()
        n = st.nbytes()

        def gone(_ref, key=key, n=n):
            with self._lock:
                if self._refs.pop(key, None) is not None:
                    self.live -= n

        with self._lock:
            self._refs[key] = weakref.ref(st, gone)
            self.live += n
            self.peak = max(self.peak, self.live)

    def close(self) -> None:
        with self._lock:
            self._refs.clear()


class _State(threading.local):
    def __init__(self):
        self.kernel: List[str] = []  # the kernel wrappers entered
        self.remat_depth = 0  # the checkpoint regions entered


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: StepTrace, live: _LiveBytes):
        super().__init__()
        self.trace = trace
        self.live = live
        self.state = _State()

    @staticmethod
    def _group_ranks(pg) -> Tuple[int, ...]:
        """The global ranks of a c10d op's process group (it reaches the
        dispatcher boxed as a ``ScriptObject``)."""
        import torch.distributed as dist
        if isinstance(pg, torch.ScriptObject):
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(pg)
        return tuple(dist.get_process_group_ranks(pg))

    def _collective(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name, name)
        ts = [t for a in list(args) + list(kwargs.values())
              for t in _tensors(a)]
        pg = next((a for a in args if type(a).__name__ in
                   ("ProcessGroup", "ScriptObject")), None)
        ranks = self._group_ranks(pg) if pg is not None else ()
        ints = [a for a in args if isinstance(a, int)
                and not isinstance(a, bool)]
        peer = None
        if kind in ("send", "recv") and ints:
            local = ints[0]
            peer = ranks[local] if 0 <= local < len(ranks) else local
        loc, _ = _site()
        self.trace.collectives.append(Collective(
            kind, str(func), sum(t.numel() for t in ts),
            sum(t.numel() * t.element_size() for t in ts), ranks, peer, loc))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name.startswith(("c10d.", "_c10d_functional.")):
            self._collective(func, args, kwargs)
        if name in HOST_READ_OPS and any(
                t.device.type == self.trace.device
                for t in _tensors(list(args))):
            loc, src = _site()
            self.trace.host_reads.append(HostRead(name, loc, src))
        out = func(*args, **kwargs)
        if name.startswith("c10d."):
            return out
        ts, written = [], []
        for i, a in enumerate(func._schema.arguments):
            v = kwargs.get(a.name) if a.kwarg_only else (
                args[i] if i < len(args) else kwargs.get(a.name))
            for t in _tensors(v):
                if a.alias_info is not None and a.alias_info.is_write:
                    written.append(len(ts))
                ts.append(t)
        if (name in ("aten._to_copy.default", "aten.copy_.default")
                and ts and any(t.device.type == "cuda" for t in ts)):
            dst = _tensors(out)[0] if name.startswith("aten._to") else ts[0]
            if dst.device.type == "cpu":
                loc, src = _site()
                self.trace.host_reads.append(HostRead(name, loc, src))
        outs = _tensors(out)
        for t in outs:
            self.live.see(t)
        kernel = self.state.kernel
        moves = not (func.is_view or name.startswith("prim."))
        self.trace.ops.append(OpRecord(
            name, tuple(str(t.dtype).removeprefix("torch.") for t in ts),
            tuple(tuple(t.shape) for t in ts), tuple(written),
            torch._C._current_autograd_node() is not None,
            kernel[-1] if kernel else None,
            sum(t.numel() * t.element_size() for t in ts + outs)
            if moves else 0))
        self.trace.bytes_accessed += self.trace.ops[-1].nbytes
        return out


    @contextlib.contextmanager
    def kernel(self, name: str, writes, reads):
        """A kernel wrapper's call (``kernels._launch.kernel_scope``):
        recorded, and the ops it runs inside (its plain version on the
        CPU) tagged as the kernel's."""
        ws, rs = _tensors(list(writes)), _tensors(list(reads))
        dev = (ws or rs)[0].device.type if ws or rs else "cpu"
        self.trace.kernels.append(KernelCall(
            name, dev,
            tuple(str(t.dtype).removeprefix("torch.") for t in ws),
            tuple(tuple(t.shape) for t in ws),
            tuple(str(t.dtype).removeprefix("torch.") for t in rs),
            sum(t.numel() * t.element_size() for t in ws + rs),
            tuple(_storage_id(t) for t in ws),
            not any(_is_fake(t) for t in ws + rs)))
        self.state.kernel.append(name)
        try:
            yield
        finally:
            self.state.kernel.pop()


def _traced_checkpoint(orig, rec: _Recorder):
    def checkpoint(fn, *args, **kwargs):
        st = rec.state
        region = RematRegion(selective=kwargs.get("context_fn") is not None,
                             depth=st.remat_depth + 1)
        rec.trace.remat.append(region)

        def run(*a, **k):
            region.calls += 1
            s = rec.state  # the backward may run on another thread
            s.remat_depth += 1
            try:
                return fn(*a, **k)
            finally:
                s.remat_depth -= 1

        return orig(run, *args, **kwargs)
    return checkpoint


@contextlib.contextmanager
def watch_syncs(device=None):
    """Collect the card's synchronizing calls made inside the block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: yields a
    list that holds their ``HostRead``s (the call's message and source
    line) once the block ends."""
    found: List[HostRead] = []
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)
    found.extend(HostRead(str(w.message), f"{w.filename}:{w.lineno}",
                          linecache.getline(w.filename, w.lineno).strip())
                 for w in seen if "called a synchronizing" in str(w.message))


def sync_calls(fn: Callable) -> List[str]:
    """The synchronizing calls ``fn()`` makes on the card (see
    :func:`watch_syncs`), as sorted ``"file:line: message"`` strings."""
    with watch_syncs() as found:
        fn()
    return sorted(f"{r.location}: {r.op}" for r in found)


def record(fn: Callable, *args, inputs=None, device=None) -> StepTrace:
    """Run ``fn(*args)`` once under the recorder and return its
    :class:`StepTrace` (its result in ``output``). ``inputs`` (default
    ``args``) are the trees whose storages count as alive before the
    step. On a CUDA ``device`` the card's synchronizing calls are
    recorded too (``torch.cuda.set_sync_debug_mode("warn")``)."""
    import torch.utils.checkpoint as ckpt
    trace = StepTrace()
    live = _LiveBytes()
    for t in tree.leaves(args if inputs is None else inputs):
        if isinstance(t, torch.Tensor):
            live.see(t)
    trace.base_live_bytes = live.live
    live.peak = live.live
    if device is None:
        first = next((t for t in tree.leaves(args)
                      if isinstance(t, torch.Tensor)), None)
        device = first.device if first is not None else torch.device("cpu")
    device = torch.device(device)
    trace.device = device.type
    rec = _Recorder(trace, live)
    from ..kernels import _launch
    orig = ckpt.checkpoint
    cuda = device.type == "cuda" and torch.cuda.is_available()
    ckpt.checkpoint = _traced_checkpoint(orig, rec)
    _launch.set_kernel_observer(rec.kernel)
    try:
        with (watch_syncs(device) if cuda else contextlib.nullcontext([])
              ) as syncs:
            with rec:
                trace.output = fn(*args)
    finally:
        _launch.set_kernel_observer(None)
        ckpt.checkpoint = orig
        trace.peak_live_bytes = live.peak
        live.close()
    trace.sync_calls = syncs
    return trace


def state_storages(*trees) -> List[Optional[int]]:
    """The storage identity of every tensor leaf of ``trees`` (None where
    a leaf has none), for before/after comparisons of a step."""
    return [_storage_id(t) if isinstance(t, torch.Tensor) else None
            for t in tree.leaves(trees)]


@dataclasses.dataclass
class StepRun:
    """One real step (:func:`measure`): the counterpart of the
    reference's compiled step — which state storages the step kept
    (its aliasing), its collectives (``trace``) and its peak."""
    trace: StepTrace
    before: List[Optional[int]]  # storage of each (params, opt_state) leaf
    after: List[Optional[int]]  # and of the state the step returned
    leaf_bytes: List[int]
    peak_bytes: int
    peak_source: str  # "max_memory_allocated" or "live tensor bytes"

    def kept_bytes(self, min_bytes: int = 64) -> Tuple[int, int]:
        """(state bytes, bytes kept in their storage): leaves of at least
        ``min_bytes`` (a 0-d step counter is made anew each step)."""
        total = kept = 0
        for b, a, n in zip(self.before, self.after, self.leaf_bytes):
            if n < min_bytes:
                continue
            total += n
            kept += n if (b is not None and b == a) else 0
        return total, kept


def measure(fn: Callable, params, opt_state, batch, device=None) -> StepRun:
    """Run the step ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` once, recorded, with the state's storages before and
    after it and its peak: on CUDA the allocator's
    (``max_memory_allocated``) above what was alive before the step, plus
    the step's inputs; on the CPU, or for fake tensors (a dry run), the
    trace's live tensor bytes."""
    leaves = tree.leaves((params, opt_state))
    nbytes = [t.numel() * t.element_size() if isinstance(t, torch.Tensor)
              else 0 for t in leaves]
    before = state_storages(params, opt_state)
    first = next((t for t in leaves if isinstance(t, torch.Tensor)), None)
    dev = torch.device(device if device is not None else
                       first.device if first is not None else "cpu")
    fake = first is not None and _is_fake(first)
    cuda = dev.type == "cuda" and torch.cuda.is_available() and not fake
    if cuda:
        torch.cuda.synchronize(dev)
        alive = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    trace = record(fn, params, opt_state, batch,
                   device="cpu" if fake else dev)
    new_p, new_o = trace.output[0], trace.output[1]
    after = state_storages(new_p, new_o)
    if len(after) != len(before):
        after = [None] * len(before)
    if cuda:  # the allocator's peak over the step's inputs alone
        peak = (torch.cuda.max_memory_allocated(dev) - alive
                + trace.base_live_bytes)
        source = "max_memory_allocated"
    else:
        peak, source = trace.peak_live_bytes, "live tensor bytes"
    return StepRun(trace, before, after, nbytes, int(peak), source)


class Traceable:
    """``trace_step`` / ``measure_step`` for an executor with a
    ``step_split`` — the reference's ``trace_step`` / ``lower_step`` (see
    the module doc). Both run one real step on the state they are given
    (an executor that updates in place writes it)."""
    #: the update writes params and optimizer state in their own storage
    #: (the reference's donation), the contract HLO001 holds
    updates_in_place = False

    def trace_step(self, params, opt_state, micro_batches) -> StepTrace:
        """One whole mini-batch step, recorded (:func:`record`)."""
        return record(self.step_split, params, opt_state, micro_batches)

    def measure_step(self, params, opt_state, micro_batches) -> StepRun:
        """One whole mini-batch step with its storages and peak
        (:func:`measure`)."""
        return measure(self.step_split, params, opt_state, micro_batches)
