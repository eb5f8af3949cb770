"""The port's side of the GSPMD serving cases, run on every rank of a
``repro_torch.launch.world.LocalWorld`` (gloo ranks on the CPU).

This module imports no JAX and nothing of the JAX package: the ranks
import it by name. Each case takes numpy inputs (the reference's
parameters and tokens), places them on this rank's GSPMD mesh as the
reference's dry run places a prefill and a decode step
(``launch.steps.GspmdServe``: params by ``param_specs``, the cache by
``cache_specs``), runs the port and returns numpy results gathered whole.
"""
import torch

from repro_torch import configs, engine, weights
from repro_torch.launch import sharding, steps
from repro_torch.models import transformer

from torch_gspmd_cases import gspmd
from torch_mesh_cases import to_np


def prefill_decode(world, dims, arch, params_np, prompt_np, next_np,
                   max_len):
    """Reduced ``arch`` in fp32: a prefill of ``prompt_np`` (B, S) into a
    cache of ``max_len``, then one decode step a column of ``next_np``
    (B, n) at positions S, S + 1, …. Returns the prefill's logits, each
    decode step's logits, the cache after the last step (all gathered
    whole), the collectives of the last decode step by kind and axis,
    and the cache's layout on this rank (placements and block shapes)."""
    mesh = gspmd(world, dims)
    cfg = configs.get_reduced(arch)
    f32 = torch.float32

    def prefill_fn(p, tokens):
        return transformer.prefill(p, cfg, tokens, max_len, dtype=f32)

    def decode_fn(p, token, cache, pos):
        return transformer.decode_step(p, cfg, token, cache, pos, dtype=f32)

    pre = steps.GspmdServe("prefill", prefill_fn, mesh)
    dec = steps.GspmdServe("decode", decode_fn, mesh)
    params = pre.place_params(weights.from_reference(params_np, "cpu"))
    logits, cache = pre.step(params, pre.place(torch.from_numpy(prompt_np)))
    out = {"prefill": to_np(pre.gather(logits)), "decode": []}
    B, S = prompt_np.shape
    for j in range(next_np.shape[1]):
        tok = dec.place(torch.from_numpy(next_np[:, j:j + 1].copy()))
        pos = dec.place(torch.full((B,), S + j, dtype=torch.int32))
        with engine.CollectiveCensus(mesh) as cc:
            logits, cache = dec.step(params, tok, cache, pos)
        out["decode"].append(to_np(dec.gather(logits)))
    out["census"] = cc.summary()
    out["cache"] = to_np(dec.gather(cache))
    out["layout"] = [{k: (str(v.placements), tuple(v.to_local().shape))
                      for k, v in c.items()} for c in cache]
    out["coords"] = mesh.coords()
    out["cache_bytes"] = sharding.local_bytes(cache)
    return out


def production_serve_dryruns():
    """The production dry run of reduced serving steps, in a process of
    its own (each run starts and leaves a fake world of 256 or 512
    ranks): mamba2-780m ``decode_32k`` on the 16 × 16 mesh through the
    CLI with ``--check`` (the twin of the reference's
    ``test_reduced_dryrun_single_pod[mamba2-780m-decode_32k]``),
    qwen2-1.5b ``decode_32k`` on the 2 × 16 × 16 mesh, and qwen2-1.5b
    ``prefill_32k`` on the 16 × 16 mesh through the CLI over a
    ``--budget``. Returns each run's report (the CLI's parsed) and the
    CLI's exit codes and stderr."""
    import contextlib
    import io
    import json

    from repro_torch.launch import dryrun

    def cli(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = dryrun.main(argv)
        return code, json.loads(out.getvalue().strip().splitlines()[-1]), \
            err.getvalue()

    base = ["--reduced", "--device", "cpu", "--no-probe"]
    res = {}
    res["check"] = cli(["--arch", "mamba2-780m", "--shape", "decode_32k",
                        "--mesh", "production", "--check"] + base)
    res["multi"] = dryrun.run_dryrun("qwen2-1.5b", "decode_32k",
                                     multi_pod=True, reduced=True,
                                     device="cpu", probe=False,
                                     verbose=False)
    res["budget"] = cli(["--arch", "qwen2-1.5b", "--shape", "prefill_32k",
                         "--mesh", "production", "--budget", "0.001"] + base)
    return res


def encdec_decode(world, dims, arch, params_np, frames_np, next_np,
                  max_len):
    """Reduced enc-dec ``arch`` in fp32, all on the mesh: the
    teacher-forced ``encdec.forward`` over ``next_np`` (the encoder's
    heads split over ``model``, the cross attention on its DTensor keys);
    ``encdec.init_decode_cache`` (the encoder and each layer's cross keys
    and values), the cache then laid out by ``cache_specs``; one decode
    step a column of ``next_np``. Returns the forward's logits, the cross
    keys and values and each step's logits, the cache's self-attention
    rings (all gathered) and its cross layout on this rank."""
    from repro_torch.models import encdec
    mesh = gspmd(world, dims)
    cfg = configs.get_reduced(arch)
    f32 = torch.float32
    params = weights.from_reference(params_np, "cpu")
    fwd = steps.GspmdServe("prefill", lambda p, f, t: encdec.forward(
        p, cfg, f, t, dtype=f32, remat=False)[0], mesh)
    init = steps.GspmdServe("prefill", lambda p, f: encdec.init_decode_cache(
        p, cfg, f, max_len, f32), mesh)
    dec = steps.GspmdServe("decode", lambda p, t, c, pos: encdec.decode_step(
        p, cfg, t, c, pos, dtype=f32), mesh)
    placed = dec.place_params(params)
    frames = init.place(torch.from_numpy(frames_np))
    out = {"decode": []}
    with torch.no_grad():
        out["forward"] = to_np(fwd.gather(fwd.step(
            placed, frames, fwd.place(torch.from_numpy(next_np)))))
    whole = init.gather(init.step(placed, frames))
    out["cross"] = to_np(whole["cross"])
    cache = dec.place(whole, stacked=True)
    for j in range(next_np.shape[1]):
        tok = dec.place(torch.from_numpy(next_np[:, j:j + 1].copy()))
        pos = dec.place(torch.full((next_np.shape[0],), j,
                                   dtype=torch.int32))
        logits, cache = dec.step(placed, tok, cache, pos)
        out["decode"].append(to_np(dec.gather(logits)))
    out["self"] = to_np(dec.gather(cache["self"]))
    out["layout"] = {k: (str(v.placements), tuple(v.to_local().shape))
                     for k, v in cache["cross"].items()}
    return out


def serve_each(start, calls):
    """Runs ``calls`` — ``(key, prepare)`` pairs, ``prepare()`` giving
    ``(fn, args, reference)`` — one after another on a world that
    ``start()`` makes: ``fn(mesh, *args)`` on every rank while
    ``reference()`` (or nothing, where it is None) runs here. Returns
    ``{key: (ranks' results, reference's) or the exception the call
    raised}``. A failed call closes its world and the next call starts a
    new one, so that a failure is only its own key's. The host side of
    the harness: the ranks never call it."""
    out, world = {}, None
    try:
        for key, prepare in calls:
            try:
                fn, args, reference = prepare()
                if world is None:
                    world = start()
                world.submit(fn, *args)
                ref = reference() if reference is not None else None
                out[key] = (world.collect(key), ref)
            except Exception as e:  # noqa: BLE001 (kept for key's tests)
                out[key] = e
                if world is not None:
                    world.close()
                    world = None
    finally:
        if world is not None:
            world.close()
    return out


def rank_times(world, x):
    """This rank's number times ``x`` (a call that succeeds)."""
    return world.rank * x


def fail_on_rank(world, rank):
    """Raises on rank ``rank`` (a call that fails)."""
    if world.rank == rank:
        raise ValueError(f"rank {rank} fails here")
    return world.rank


def census_by_ranks(world, dims):
    """A collective over a group of another name but the ranks of this
    rank's ``model`` line (as over an equal ``DeviceMesh`` made earlier,
    whose layouts DTensor's caches keep) and one over a group of other
    ranks, under the census: the axis each is counted on."""
    import torch.distributed as dist
    mesh = gspmd(world, dims)
    mine = sorted(dist.get_process_group_ranks(
        mesh.device_mesh.get_group("model")))
    n = dist.get_world_size()
    model = dims[-1]
    groups = {tuple(range(i, i + model)): dist.new_group(
        list(range(i, i + model))) for i in range(0, n, model)}
    odd = dist.new_group([0, n - 1])  # a line of no axis
    ops = torch.ops._c10d_functional
    with engine.CollectiveCensus(mesh) as cc:
        ops.wait_tensor(ops.all_reduce(torch.ones(2), "sum",
                                       groups[tuple(mine)].group_name))
        if dist.get_rank() in (0, n - 1):
            ops.wait_tensor(ops.all_reduce(torch.ones(2), "sum",
                                           odd.group_name))
    return cc.summary()["by_kind_and_axis"]
