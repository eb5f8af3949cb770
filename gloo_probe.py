"""Which collectives gloo takes on CUDA tensors when two ranks share one
card, and whether DTensor runs there through the GSPMD mesh's host-staged
collectives (``repro_torch.launch.mesh.host_staged_collectives``).

Two spawned ranks on ``cuda:0`` over gloo, twice: once with the
functional collectives' CUDA kernels replaced by the host-staged ones
(DTensor's matmul, backward and resharding checked against the whole
tensors, and the input rate of a 256 MB all-gather), once as gloo has
them (each c10d collective, then the functional collectives). Every
result prints as it comes, so a hang shows where; a pair that gives no
result within 120 s is reported and stopped. Last, rank 3's view of a
16 × 16 mesh over torch's fake process group of 256 ranks.

  python3 gloo_probe.py                   # on one CUDA card
  python3 gloo_probe.py cpu               # the same on CPU tensors
"""
import datetime
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

DEV = sys.argv[1] if len(sys.argv) > 1 else "cuda"


def _dtensor_case(world, rank, dev):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh(DEV, (world,), mesh_dim_names=("model",))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 8, generator=g).to(dev)
    a = torch.randn(4, 16, generator=g).to(dev)
    dw = DTensor.from_local(w.chunk(world)[rank].clone(), mesh,
                            [Shard(0)]).requires_grad_(True)
    da = DTensor.from_local(a.chunk(world, 1)[rank].clone(), mesh,
                            [Shard(1)])
    y = da @ dw
    if not torch.allclose(y.redistribute(mesh, [Replicate()]).to_local(),
                          a @ w, atol=1e-5):
        raise AssertionError("matmul")
    y.full_tensor().sum().backward()
    if not torch.allclose(da.redistribute(mesh, [Shard(0)]).full_tensor(), a):
        raise AssertionError("all-to-all")
    return f"{y.placements} grad {dw.grad.placements}"


def _rate(world, dev):
    import torch.distributed._functional_collectives as fc
    big = torch.randn(64 << 20, device=dev)  # 256 MB
    fc.wait_tensor(fc.all_gather_tensor(big, 0, dist.group.WORLD))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fc.wait_tensor(fc.all_gather_tensor(big, 0, dist.group.WORLD))
    torch.cuda.synchronize()
    gbs = 3 * big.numel() * 4 / (time.perf_counter() - t0) / 1e9
    return f"{gbs:.3f} GB/s of input gathered ({world} ranks, 256 MB each)"


def run(rank, world, port, q, staged):
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=40))
    dev = torch.device(DEV, 0) if DEV == "cuda" else torch.device("cpu")
    out = {}

    def case(name, fn):
        try:
            r = fn()
            if DEV == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok" if r is None else r
        except Exception as e:  # noqa: BLE001 (the probe reports it)
            out[name] = (f"FAIL {type(e).__name__}: "
                         f"{(str(e).splitlines() or [''])[0][:160]}")
        print(f"[rank{rank}] {name}: {out[name]}", flush=True)

    import torch.distributed._functional_collectives as fc
    x = torch.arange(8., device=dev) + rank
    if staged:
        from repro_torch.launch import mesh as mesh_lib
        mesh_lib.host_staged_collectives()
        case("dtensor_staged", lambda: _dtensor_case(world, rank, dev))
        case("funcol_all_gather_staged", lambda: fc.wait_tensor(
            fc.all_gather_tensor(x, 0, dist.group.WORLD)).sum().item()
            and None)
        case("staged_all_gather_rate", lambda: _rate(world, dev))
    else:
        case("all_reduce", lambda: dist.all_reduce(x.clone()))
        case("broadcast", lambda: dist.broadcast(x.clone(), 0))
        case("all_gather_list", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x))
        case("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), x))
        case("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=dev), x))
        case("reduce_scatter_list", lambda: dist.reduce_scatter(
            torch.empty(8 // world, device=dev), list(x.chunk(world))))
        case("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x))
        case("funcol_all_gather", lambda: fc.wait_tensor(
            fc.all_gather_tensor(x, 0, dist.group.WORLD)).sum().item()
            and None)
        case("dtensor_raw", lambda: _dtensor_case(world, rank, dev))
    if rank == 0:
        q.put(out)
    dist.destroy_process_group()


def fake_world():
    """Rank 3's block of a (1536, 8960) leaf split [Shard(0), Shard(1)]
    over a 16 × 16 mesh of a fake world of 256, and a product's
    placements — under a fake-tensor mode, nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=256)
    try:
        mesh = init_device_mesh(DEV, (16, 16),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            d = distribute_tensor(torch.empty(1536, 8960, device=DEV), mesh,
                                  [Shard(0), Shard(1)])
            a = distribute_tensor(torch.empty(64, 1536, device=DEV), mesh,
                                  [Shard(0), Replicate()])
            y = a @ d
            return (str(d.to_local().shape), str(d.to_local().device),
                    str(y.placements))
    finally:
        dist.destroy_process_group()


def main():
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0) if DEV == "cuda" else "cpu",
          flush=True)
    ctx = mp.get_context("spawn")
    pairs = ((True, 29611), (False, 29612)) if DEV == "cuda" \
        else ((False, 29612),)
    for staged, port in pairs:
        q = ctx.Queue()
        print("== host-staged" if staged else "== gloo as it is", flush=True)
        ps = [ctx.Process(target=run, args=(r, 2, port, q, staged))
              for r in range(2)]
        for p in ps:
            p.start()
        try:
            print(json.dumps(q.get(timeout=120), indent=1), flush=True)
        except Exception:  # noqa: BLE001 (a hung pair is a result)
            print("no result from rank 0 within 120 s", flush=True)
        for p in ps:
            p.join(5)
            if p.is_alive():
                p.terminate()
                p.join(5)
    try:
        print("fake world:", fake_world(), flush=True)
    except Exception:  # noqa: BLE001 (the probe reports it)
        traceback.print_exc()


if __name__ == "__main__":
    main()
