"""Meshes of the port: the ``torch.distributed`` world as named axes.

The JAX package's mesh is one controller over many devices. The port's is
SPMD: one process per rank, and a :class:`Mesh` is what one rank knows of
the world — a mapping of axis name to size (``{"data": 2, "model": 1}``,
the form ``engine.autotune.mesh_tag`` takes), the process group its
collectives run on, its rank and its device.

Axes, ``batch_axes``, ``axis_size`` and ``data_parallel_size`` are the
reference's (``pod`` and ``data`` are batch axes, ``model`` splits the
model). On a ``(data, 1)`` mesh every rank holds the whole model
(``engine.ShardedExecutor``); on a ``(data, model)`` mesh with ``model``
> 1 the model axis runs the stages of a 1F1B pipeline
(``engine.PipelinedExecutor``): rank ``r`` is stage ``r % model`` of data
replica ``r // model`` (the reference's row-major device layout), and
``Mesh.groups`` holds the process groups of its two axis lines
(:func:`axis_groups`). A GSPMD mesh (:func:`gspmd_mesh`, and the
reference's production meshes :func:`make_production_mesh`: 16×16, and
2×16×16 with the pod axis) splits the model itself: parameters,
gradients and optimizer state by the reference's ``param_specs`` (tensor
parallel over ``model``, FSDP over ``data``), the activations by the
model's shard hints (``models.nn``), through ``torch.distributed.tensor``
over a ``DeviceMesh`` with the reference's axis names in its row-major
order (``engine.GspmdExecutor``). ``Mesh.mode`` says which of the three a
mesh is: ``"data"``, ``"pipeline"`` or ``"gspmd"``.

:func:`init_world` starts or joins the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) with a finite
timeout. A rank uses ``cuda:LOCAL_RANK`` when the host has a card for
every local rank and ``cuda:0`` when the ranks share one card (each then
capped at an equal share of its memory); the CPU only when asked. The
backend is NCCL when every rank has its own card, and gloo when ranks
share a card (NCCL refuses two ranks on one device) or run on the CPU.
There is no fallback from one to the other. A GSPMD mesh whose ranks
share a card over gloo moves its collectives' CUDA tensors through the
host explicitly (:func:`host_staged_collectives`), since gloo takes a
CUDA tensor for few of the collectives DTensor issues.

A GSPMD step issues collectives inside the model, so a rank that fails
between two of them leaves its peers blocked in the next. The reference
has one controller and cannot meet this. Here the failing rank posts its
fault to the world's rendezvous store and drops its connections
(:func:`post_fault`): its peers' pending collectives then fail at once,
and each of them, finding the fault posted, drops its own. Then every
rank leaves the broken process groups and starts the world's anew on
the same store, each under its old name (:func:`reform`), so the world
agrees on the fault over them and every ``DeviceMesh`` made before runs
on. gloo's own ``abort`` leaves a peer's pending receive waiting out the
timeout: dropping a rank's connections means shutting down its TCP
sockets, all but the store's.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
POD_AXIS = "pod"

# seconds a collective may wait for a peer before the process group
# raises (a rank that died leaves the others an error, not a hang)
DEFAULT_TIMEOUT_S = 600.0
# share of one card's memory that the ranks sharing it may hold in all
# (the rest is their CUDA contexts')
SHARED_CARD_FRACTION = 0.96


class Mesh(Mapping):
    """Axis name → size (insertion order is the reference's axis order),
    plus this rank's view of the world: ``rank``, ``group`` (the process
    group the collectives run on; None is the default group) and
    ``device``. ``memory_fraction`` is the share of the device's memory
    this rank may hold (below 1 when ranks share a card). ``groups`` maps
    an axis name to the process group of this rank's line along it (a
    pipeline or GSPMD mesh's ``"data"`` and ``"model"``).

    ``mode`` is ``"data"`` (every rank holds the whole model), ``"pipeline"``
    (the model axis runs 1F1B stages) or ``"gspmd"`` (the model split by
    ``param_specs``; ``device_mesh`` is its ``torch`` ``DeviceMesh``). By
    default a mesh with a model axis above 1 is a pipeline, as a
    ``DATA:MODEL`` spec on the launcher means. ``timeout_s`` is its
    collectives' timeout; a GSPMD mesh also keeps the world's rendezvous
    ``store``, on which :func:`reform` starts its groups anew."""

    def __init__(self, dims: Dict[str, int], *, rank: int = 0, group=None,
                 device="cpu", backend: Optional[str] = None,
                 memory_fraction: float = 1.0,
                 groups: Optional[Dict[str, Any]] = None,
                 mode: Optional[str] = None, device_mesh=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S, store=None):
        self._dims = {str(k): int(v) for k, v in dict(dims).items()}
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)
        self.backend = backend
        self.memory_fraction = float(memory_fraction)
        self.timeout_s = float(timeout_s)
        self.store = store
        self.groups = dict(groups or {})
        if mode is None:
            mode = ("pipeline" if self._dims.get(MODEL_AXIS, 1) > 1
                    else "data")
        if mode not in MODES:
            raise ValueError(f"mesh mode must be one of {MODES}, got "
                             f"{mode!r}")
        if (mode == "gspmd") != (device_mesh is not None):
            raise ValueError("a GSPMD mesh, and only it, has a device mesh")
        self.mode = mode
        self.device_mesh = device_mesh

    def __getitem__(self, name: str) -> int:
        return self._dims[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._dims)

    def __len__(self) -> int:
        return len(self._dims)

    def __repr__(self) -> str:
        return (f"Mesh({self._dims}, rank={self.rank}, device={self.device}"
                f", backend={self.backend}, mode={self.mode})")

    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis: rank ``r`` of a row-major
        ``(data, model)`` mesh sits at ``(r // model, r % model)``."""
        out, r = {}, self.rank
        for ax in reversed(list(self._dims)):
            out[ax] = r % self._dims[ax]
            r //= self._dims[ax]
        return {ax: out[ax] for ax in self._dims}


MODES = ("data", "pipeline", "gspmd")
PRODUCTION_DIMS = {False: {DATA_AXIS: 16, MODEL_AXIS: 16},
                   True: {POD_AXIS: 2, DATA_AXIS: 16, MODEL_AXIS: 16}}


def make_production_mesh(*, multi_pod: bool = False,
                         world_mesh: Optional[Mesh] = None) -> Mesh:
    """This rank's view of the reference's production mesh: GSPMD over
    ``{data: 16, model: 16}`` (256 ranks), or ``{pod: 2, data: 16, model:
    16}`` (512) with ``multi_pod``. The world must hold exactly that many
    ranks (a fake process group stands in for them in the dry run);
    ``world_mesh`` is this rank's world (:func:`init_world`), by default
    a CPU rank of the process group already started."""
    dims = PRODUCTION_DIMS[bool(multi_pod)]
    need = math.prod(dims.values())
    n = world_size()
    if n != need:
        flag = " --multi-pod" if multi_pod else ""
        raise ValueError(
            f"--mesh production{flag} is the {'x'.join(map(str, dims.values()))}"
            f" GSPMD mesh: it needs a world of exactly {need} ranks, and "
            f"this one has {n}")
    return gspmd_mesh(world_mesh, **{k: v for k, v in dims.items()})


def gspmd_mesh(world_mesh: Optional[Mesh], data: int, model: int,
               pod: int = 0) -> Mesh:
    """This rank's GSPMD mesh ``(data, model)`` or ``(pod, data, model)``
    over the whole world: a ``DeviceMesh`` with the reference's axis names
    in its row-major order and the process group of each axis line in
    ``groups``. The production meshes are this at 16×16 and 2×16×16; the
    tests and the card build it at 2×2. ``world_mesh`` (its rank, device,
    backend and memory share) defaults to a CPU rank of the process group
    already started. On CUDA over gloo the collectives move through the
    host (:func:`host_staged_collectives`). Every rank of the world calls
    it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dims = ({POD_AXIS: pod, DATA_AXIS: data, MODEL_AXIS: model} if pod
            else {DATA_AXIS: data, MODEL_AXIS: model})
    n = world_size()
    if math.prod(dims.values()) != n or min(dims.values()) < 1:
        raise ValueError(f"a GSPMD mesh {dims} needs {math.prod(dims.values())}"
                         f" ranks; the world has {n}")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a GSPMD mesh spans a process group: start one "
                         "first (init_world, or a fake world for a dry run)")
    if world_mesh is None:
        world_mesh = Mesh({DATA_AXIS: n, MODEL_AXIS: 1},
                          rank=dist.get_rank(), device="cpu",
                          backend=dist.get_backend())
    device = world_mesh.device
    if device.type == "cuda" and world_mesh.backend == "gloo":
        host_staged_collectives()
    dm = init_device_mesh(device.type, tuple(dims.values()),
                          mesh_dim_names=tuple(dims))
    return Mesh(dims, rank=world_mesh.rank, group=world_mesh.group,
                device=device, backend=world_mesh.backend,
                memory_fraction=world_mesh.memory_fraction,
                groups={ax: dm.get_group(ax) for ax in dims},
                mode="gspmd", device_mesh=dm,
                timeout_s=world_mesh.timeout_s,
                store=dist.distributed_c10d._get_default_store())


# the CUDA kernels of the functional collectives, once replaced
_HOST_STAGED: Dict[str, Any] = {}
STAGED_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor",
              "all_reduce", "all_to_all_single")


def host_staged_collectives() -> None:
    """Route the functional collectives (``torch.ops._c10d_functional``,
    the ones DTensor issues) on CUDA tensors through the host: the input
    is copied to the CPU, the collective runs there on the process
    group's gloo backend, and the result is copied back to the input's
    device. Ranks that share one card run over gloo (NCCL refuses two
    ranks on a device), and gloo takes CUDA tensors for few collectives;
    this makes the copy explicit for all of them, so none is refused and
    none moves to the CPU unseen. Process-wide, made once; only a GSPMD
    mesh on CUDA over gloo calls it."""
    if _HOST_STAGED:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    ops = torch.ops._c10d_functional

    def staged(op):
        def impl(inp, *rest):
            out = ops.wait_tensor(op(inp.cpu(), *rest))
            return out.to(inp.device)
        return impl

    for name in STAGED_OPS:
        lib.impl(name, staged(getattr(ops, name).default), "CUDA")
    _HOST_STAGED["lib"] = lib


def fake_world(world: int, rank: int = 0) -> None:
    """Start a fake process group of ``world`` ranks in this one process
    (``torch``'s fake backend: every collective returns at once, moving
    nothing) — one rank's view of a production mesh for the dry run.
    :func:`shutdown` leaves it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process; a fake world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *,
                   rank: int = 0, group=None, device="cpu",
                   backend: Optional[str] = None,
                   memory_fraction: float = 1.0,
                   groups: Optional[Dict[str, Any]] = None) -> Mesh:
    """The reference's small mesh: ``(data, model)`` or ``(pod, data,
    model)`` axes, as this rank sees them."""
    dims = ({POD_AXIS: pod, DATA_AXIS: data, MODEL_AXIS: model} if pod
            else {DATA_AXIS: data, MODEL_AXIS: model})
    return Mesh(dims, rank=rank, group=group, device=device,
                backend=backend, memory_fraction=memory_fraction,
                groups=groups)


def parse_mesh_spec(spec: str, device_count: Optional[int] = None):
    """Parse a launcher ``--mesh`` axis spec ``"DATA:MODEL"`` (e.g.
    ``"2:1"``) into ``(data, model)``, validated against the number of
    ranks (the reference's "devices"): ``device_count=None`` reads the
    world size (1 without a process group)."""
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"mesh spec {spec!r} is not of the form DATA:MODEL (two "
            "integers, e.g. '2:4' for a 2-way data x 4-stage pipeline "
            "mesh)")
    try:
        data, model = (int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not of the form DATA:MODEL (two "
            "integers, e.g. '2:4')") from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh spec {spec!r}: axis sizes must be >= 1")
    n = world_size() if device_count is None else device_count
    if data * model > n:
        raise ValueError(
            f"mesh spec {spec!r} needs {data * model} devices but only "
            f"{n} are visible")
    return data, model


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dimension is sharded over."""
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if a in mesh)


def axis_size(mesh, name: str) -> int:
    return mesh[name] if name in mesh else 1


def data_parallel_size(mesh) -> int:
    """Number of data-parallel workers: the product of the batch axes
    ((pod, data) when the pod axis exists, else data) — the factor the
    planner divides the global micro-batch by to get ``local_micro``."""
    dp = 1
    for a in batch_axes(mesh):
        dp *= axis_size(mesh, a)
    return dp


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def world_size() -> int:
    """Ranks in the world: the process group's size once it is up, else
    torchrun's ``WORLD_SIZE`` (1 outside torchrun)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device_type: str, local_rank: int, local_world: int):
    """``(device, backend, memory_fraction)`` for one rank: its own card
    (NCCL) when the host has one for every local rank, ``cuda:0`` shared
    (gloo, an equal share of the memory each) when it has one card, the
    CPU (gloo) when asked."""
    if device_type == "cpu":
        return torch.device("cpu"), "gloo", 1.0
    if device_type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {device_type!r}")
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return torch.device("cuda", local_rank), "nccl", 1.0
    if cards == 1:
        return (torch.device("cuda", 0), "gloo",
                SHARED_CARD_FRACTION / local_world)
    raise ValueError(
        f"{local_world} ranks on a host with {cards} cards: give every rank "
        "its own card, or run them all on one")


def init_world(device_type: str = "cuda", *,
               timeout_s: float = DEFAULT_TIMEOUT_S,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world: Optional[int] = None, local_rank: Optional[int] = None,
               local_world: Optional[int] = None, model: int = 1) -> Mesh:
    """Start or join the process group and return this rank's mesh: the
    data-parallel ``{"data": world, "model": 1}``, or with ``model`` > 1
    the pipeline mesh ``{"data": world // model, "model": model}`` and
    its axis groups (:func:`pipeline_mesh`).

    Rank, world size and local rank come from the arguments, else from a
    process group already started in this process, else from torchrun's
    environment; a world of 1 starts no process group. The
    rendezvous is ``init_method`` (default ``env://``: torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``); collectives raise after
    ``timeout_s`` seconds without their peers. On CUDA the rank's device
    becomes the current device, and ranks that share a card are each
    capped at ``SHARED_CARD_FRACTION / ranks`` of its memory."""
    import torch.distributed as dist
    env = os.environ
    if dist.is_available() and dist.is_initialized():  # joined already
        rank = dist.get_rank() if rank is None else rank
        world = dist.get_world_size() if world is None else world
    rank = int(env.get("RANK", "0")) if rank is None else rank
    world = int(env.get("WORLD_SIZE", "1")) if world is None else world
    local_rank = (int(env.get("LOCAL_RANK", str(rank))) if local_rank is None
                  else local_rank)
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    device, backend, fraction = rank_device(device_type, local_rank,
                                            local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if fraction < 1.0:
            torch.cuda.set_per_process_memory_fraction(fraction, device)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    mesh = make_host_mesh(data=world, model=1, rank=rank, device=device,
                          backend=backend if world > 1 else None,
                          memory_fraction=fraction)
    mesh.timeout_s = float(timeout_s)
    if model > 1:
        return pipeline_mesh(mesh, world // model, model,
                             timeout_s=timeout_s)
    return mesh


# the axis groups made so far, by (data, model): making a group is a
# collective call, so a world makes each layout's groups once
_AXIS_GROUPS: Dict[Tuple[int, int], Dict[str, Any]] = {}


def axis_groups(data: int, model: int, rank: int, *,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Dict[str, Any]:
    """The process groups of rank ``rank``'s two lines of a ``(data,
    model)`` mesh over the world (rank ``d·model + s``): ``"data"``, the
    ranks of its stage ``s`` across the replicas, and ``"model"``, the
    stages of its replica ``d``. Every rank of the world calls this in
    the same order (``torch.distributed.new_group`` is collective)."""
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=timeout_s)
    out = {}
    for s in range(model):
        g = dist.new_group([d * model + s for d in range(data)],
                           timeout=timeout)
        if rank % model == s:
            out[DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * model + s for s in range(model)],
                           timeout=timeout)
        if rank // model == d:
            out[MODEL_AXIS] = g
    return out


def pipeline_mesh(world_mesh: Mesh, data: int, model: int, *,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's ``(data, model)`` mesh over the world of ``world_mesh``
    (its rank, device, backend and memory share), with the axis groups
    (:func:`axis_groups`, made once a layout). Every rank of the world
    calls it."""
    n = world_size()
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the world has {n}")
    if (data, model) not in _AXIS_GROUPS:
        _AXIS_GROUPS[(data, model)] = axis_groups(
            data, model, world_mesh.rank, timeout_s=timeout_s)
    return make_host_mesh(data=data, model=model, rank=world_mesh.rank,
                          group=world_mesh.group, device=world_mesh.device,
                          backend=world_mesh.backend,
                          memory_fraction=world_mesh.memory_fraction,
                          groups=_AXIS_GROUPS[(data, model)])


def broadcast_object(obj, mesh: Optional[Mesh], src: int = 0):
    """``obj`` as rank ``src`` holds it, on every rank of ``mesh`` (what
    one rank decides — a plan — every rank then holds). Identity on a
    mesh of one rank."""
    if mesh is None or math.prod(mesh.values()) < 2:
        return obj
    import torch.distributed as dist
    box = [obj if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=mesh.group,
                               device=(mesh.device if mesh.backend == "nccl"
                                       else None))
    return box[0]


# ---------------------------------------------------------------------------
# a fault inside a GSPMD step: agreed over groups started anew
# ---------------------------------------------------------------------------

# groups started anew in this process, the same count on every rank of a
# world: each round's keys on the store are its own
_REFORMS = [0]


def post_fault(mesh: Mesh, fault: bool) -> bool:
    """Called where this rank's GSPMD step failed: posts the fault to the
    world's rendezvous store when it is this rank's own (``fault``: it ran
    out of memory), and says whether any rank posted one this round. Then
    the failure is the world's to agree on, and this rank drops its
    connections (:func:`_drop_connections`), so that every peer still
    waiting on a collective with it fails at once. A failure with nothing
    posted is the caller's to raise."""
    key = f"repro_torch/fault/{_REFORMS[0]}"
    if fault:
        mesh.store.set(key, str(mesh.rank))
    if not mesh.store.check([key]):
        return False
    _drop_connections(mesh)
    return True


def _store_ports(store) -> set:
    ports = set()
    while store is not None:
        port = getattr(store, "port", None)
        if port:
            ports.add(port)
        store = getattr(store, "underlying_store", None)
    return ports


def _drop_connections(mesh: Mesh) -> None:
    """Make every collective pending with this rank fail on its peers:
    NCCL aborts its communicators; over gloo, whose ``abort`` leaves a
    peer's receive waiting, the rank's connected TCP sockets are shut
    down, all but the rendezvous store's (its port, as server or
    client)."""
    import torch.distributed as dist
    if mesh.backend == "nccl":
        dist.distributed_c10d._abort_process_group()
        return
    keep = _store_ports(mesh.store)
    for name in os.listdir("/proc/self/fd"):
        try:
            if not os.readlink(f"/proc/self/fd/{name}").startswith(
                    "socket:"):
                continue
            sock = socket.socket(fileno=os.dup(int(name)))
        except OSError:  # gone meanwhile, or not ours to read
            continue
        try:
            if sock.family in (socket.AF_INET, socket.AF_INET6) and \
                    sock.type == socket.SOCK_STREAM:
                try:
                    peer = sock.getpeername()[1]
                except OSError:  # listening, not connected
                    continue
                if peer not in keep and sock.getsockname()[1] not in keep:
                    sock.shutdown(socket.SHUT_RDWR)
        finally:
            sock.close()


def reform(mesh: Mesh) -> None:
    """After :func:`post_fault` on every rank: leave the broken process
    groups and start the world's anew on its rendezvous store, then every
    group the old world had, under its old name and over the same ranks,
    and write the mesh's axis groups into ``mesh``. A ``DeviceMesh``
    finds its groups by name, so every one made before — the mesh's own,
    and those DTensor keeps in its layout caches (a cached layout carries
    the first ``DeviceMesh`` it met that equals the current one) — runs
    on the new groups. Every rank of the world calls it."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    world = math.prod(mesh.values())
    mine = {pg.group_name: sorted(ranks, key=ranks.get)
            for pg, ranks in c10d._world.pg_group_ranks.items()
            if isinstance(pg, dist.ProcessGroup)
            and pg is not c10d._get_default_group()}
    names = {ax: g.group_name for ax, g in mesh.groups.items()}
    dist.destroy_process_group()
    _AXIS_GROUPS.clear()
    _REFORMS[0] += 1
    timeout = datetime.timedelta(seconds=mesh.timeout_s)
    dist.init_process_group(
        mesh.backend, store=dist.PrefixStore(
            f"repro_torch/world/{_REFORMS[0]}", mesh.store),
        rank=mesh.rank, world_size=world, timeout=timeout)
    every = [None] * world
    dist.all_gather_object(every, mine)
    old = {name: ranks for part in every for name, ranks in part.items()}
    made = {}
    for name in sorted(old, key=int):  # names are the world's group count
        c10d._world.group_count = int(name)
        made[name] = dist.new_group(old[name], timeout=timeout)
    mesh.groups = {ax: made[name] for ax, name in names.items()}
    mesh.group = None


def shutdown() -> None:
    """Leave the process group (if one was started)."""
    import torch.distributed as dist
    _AXIS_GROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
