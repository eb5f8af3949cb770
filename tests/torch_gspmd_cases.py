"""The port's side of the GSPMD conformance cases, run on every rank of a
``repro_torch.launch.world.LocalWorld`` (gloo ranks on the CPU).

This module imports no JAX and nothing of the JAX package: the ranks are
spawned processes that import it by name. Each case takes numpy inputs
(the reference's parameters and batches), builds this rank's GSPMD mesh
over the world (``launch.mesh.gspmd_mesh``), runs the port and returns
numpy results.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import configs, engine, optim, tree, weights
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import nn

from torch_mesh_cases import TINY_OPT, ToyDataset, make_opt, t_loss_fn, to_np

_MESHES = {}


def gspmd(world, dims):
    """This rank's GSPMD mesh of ``dims`` ((data, model) or (pod, data,
    model)) over the world, made once a layout (a collective call)."""
    if dims not in _MESHES:
        if len(dims) == 3:
            _MESHES[dims] = mesh_lib.gspmd_mesh(world, dims[1], dims[2],
                                                pod=dims[0])
        else:
            _MESHES[dims] = mesh_lib.gspmd_mesh(world, *dims)
    return _MESHES[dims]


def coords(world, dims):
    return gspmd(world, dims).coords()


def golden(world, dims, inner, params_np, steps_n):
    """The tiny MLP's 5-step trajectory (conftest's GOLDEN_LOSSES setup:
    mini-batch 10 → 3 × 4, exact normalization, SGD-m) on a GSPMD mesh."""
    mesh = gspmd(world, dims)
    plan = engine.plan_mbs(10, micro_batch_size=4, normalization="exact",
                           mesh=mesh)
    opt = make_opt(TINY_OPT)
    ex = engine.GspmdExecutor(t_loss_fn, opt, plan, mesh=mesh, inner=inner)
    params = weights.from_reference(params_np, "cpu")
    p, s = ex.prepare(params, opt.init(params))
    ds, out = ToyDataset(), []
    for i in range(steps_n):
        split = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 plan.split(ds.batch(10, i)).items()}
        p, s, m = ex.step_split(p, s, ex.shard(split))
        out.append(float(m["loss"]))
    return out


def _route_recorder():
    """Wrap ``moe.route``: the token count of every call, and the first
    call's tokens, router weight and plan (keep, idx, C). Returns (record,
    undo)."""
    from repro_torch.models import moe
    real, rec = moe.route, {"token_counts": set()}

    def route(p, cfg, xt, blocks=None):
        out = real(p, cfg, xt, blocks)
        rec["token_counts"].add(xt.shape[0])
        if "idx" not in rec:
            rec.update(tokens=to_np(xt), router=to_np(p["router"]["w"]),
                       keep=out[2].numpy().copy(), idx=out[3].numpy().copy(),
                       C=out[4], blocked=blocks is not None)
        return out

    moe.route = route

    def undo():
        moe.route = real
    return rec, undo


def lm_train(world, dims, arch, inner, params_np, batches_np, seq, batch,
             n_micro, clip=None, overrides=None, record_route=False):
    """``len(batches_np)`` train steps of reduced ``arch`` (fp32; the
    config fields ``overrides`` replaced) built by
    ``steps.build_train_step`` on the GSPMD mesh: (losses, grad norms,
    this rank's local params and momentum, the gathered params and
    momentum, the collectives of the first step by kind and axis, the
    local parameter bytes; with ``record_route``, MoE's routing as
    :func:`_route_recorder` keeps it)."""
    mesh = gspmd(world, dims)
    cfg = dataclasses.replace(configs.get_reduced(arch), **(overrides or {}))
    route, undo = _route_recorder() if record_route else (None, None)
    opt = steps.make_optimizer(cfg)
    if clip is not None:
        opt = optim.clip_by_global_norm(opt, clip)
    shape = InputShape("gspmd_test", "train", seq, batch)
    bundle = steps.build_train_step(
        cfg, shape, num_microbatches=n_micro, optimizer=opt,
        dtype=torch.float32, executor=inner, mesh=mesh,
        budget_bytes=1 << 34, device="cpu")
    ex = bundle.fn.__self__
    params = weights.from_reference(params_np, "cpu")
    p, s = ex.prepare(params, opt.init(params))
    del params
    losses, norms, census = [], [], None
    for i, b in enumerate(batches_np):
        split = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in bundle.plan.split(b).items()}
        with engine.CollectiveCensus(mesh) as cc:
            p, s, m = bundle.fn(p, s, ex.shard(split))
        if i == 0:
            census = cc.summary()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if undo is not None:
        undo()
    full_p, full_s = ex.gather_state(p, s)
    return {"losses": losses, "grad_norms": norms, "route": route,
            "local_params": to_np(p), "local_mom": to_np(s["mom"]),
            "params": to_np(full_p), "mom": to_np(full_s["mom"]),
            "census": census,
            "local_param_bytes": ex.local_param_bytes(p),
            "coords": mesh.coords(), "plan": bundle.plan.describe()}


def hint_placements(world, dims, seq_shard, moe, S):
    """The placements the hints give a (B, S, D) residual and the
    attention's q / k / out at (H, K) heads, as strings, on the mesh."""
    from repro_torch.models import attention
    mesh = gspmd(world, dims)
    B, D, hd = 4, 8, 2
    out = {}
    with nn.use_mesh(mesh):
        nn.set_seq_shard(False if moe else seq_shard)
        x = sharding.as_dtensor(torch.zeros(B // mesh["data"], S, D),
                                sharding.P("data", None, None), mesh)
        out["seq_sharded"] = str(nn.seq_sharded(x).placements)
        out["seq_gathered"] = str(nn.seq_gathered(
            nn.seq_sharded(x)).placements)
        for H, K in ((4, 2), (3, 1)):
            q = sharding.as_dtensor(torch.zeros(B // mesh["data"], S, H, hd),
                                    sharding.P("data"), mesh)
            k = sharding.as_dtensor(torch.zeros(B // mesh["data"], S, K, hd),
                                    sharding.P("data"), mesh)
            q2, k2, _, spec = attention._head_hints(q, k, k, H, K, S)
            out[f"q{H}{K}"] = str(q2.placements)
            out[f"k{H}{K}"] = str(k2.placements)
            out[f"out_spec{H}{K}"] = repr(tuple(spec))
    return out


def vocab_ce(world, dims, logits_np, labels_np, weights_np):
    """``losses.cross_entropy`` of logits split over the vocab (the
    ``_lm_head`` hint's layout) and its gradient, gathered."""
    from repro_torch.core import losses
    mesh = gspmd(world, dims)
    c = mesh.coords()
    full = torch.from_numpy(logits_np)
    spec = sharding.P("data", None, "model")
    local = full[sharding.local_slices(full.shape, spec, mesh, c)]
    local = local.clone().requires_grad_()
    lab = torch.from_numpy(labels_np)
    sw = torch.from_numpy(weights_np)
    with nn.use_mesh(mesh):
        lg = sharding.as_dtensor(local, spec, mesh)
        lb = sharding.as_dtensor(
            lab[sharding.local_slices(lab.shape, sharding.P("data"), mesh,
                                      c)], sharding.P("data"), mesh)
        w = sharding.as_dtensor(
            sw[sharding.local_slices(sw.shape, sharding.P("data"), mesh,
                                     c)], sharding.P("data"), mesh)
        loss = losses.cross_entropy(lg, lb, sample_weight=w).full_tensor()
        loss.backward()
        grad = sharding.as_dtensor(local.grad, spec, mesh).full_tensor()
    return float(loss), grad.numpy()


def production_layout(world_size, rank, multi_pod, arch):
    """In a fresh process: a fake world of ``world_size`` ranks, rank
    ``rank``'s production mesh (its axes and coordinates) and its local
    shape of every leaf of reduced ``arch`` under
    ``param_specs(fsdp_over_pod=multi_pod)``."""
    mesh_lib.fake_world(world_size, rank)
    try:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        cfg = configs.get_reduced(arch)
        shapes = steps.abstract_params(cfg)
        specs = sharding.param_specs(shapes, mesh, fsdp_over_pod=multi_pod)
        c = mesh.coords()
        local = [tuple(len(range(*s.indices(n))) for s, n in zip(
            sharding.local_slices(x.shape, sp, mesh, c), x.shape))
            for x, sp in zip(tree.leaves(shapes),
                             sharding.spec_leaves(specs))]
        return dict(mesh), c, local
    finally:
        mesh_lib.shutdown()


def _tiny_executor(world, dims, p_np, guard=False):
    mesh = gspmd(world, dims)
    plan = engine.plan_mbs(8, micro_batch_size=4, mesh=mesh)
    opt = make_opt(TINY_OPT)
    ex = engine.GspmdExecutor(t_loss_fn, opt, plan, mesh=mesh, inner="flat",
                              guard=guard)
    params = weights.from_reference(p_np, "cpu")
    return ex, plan, params, opt


def save_after_steps(world, dims, p_np, directory, steps_n):
    """``steps_n`` tiny-MLP steps on the GSPMD mesh, then a checkpoint in
    the reference format (every rank gathers, rank 0 writes); returns
    what was saved."""
    from repro_torch.checkpoint import checkpoint
    ex, plan, params, opt = _tiny_executor(world, dims, p_np)
    p, s = ex.prepare(params, opt.init(params))
    ds = ToyDataset()
    for i in range(steps_n):
        split = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                 plan.split(ds.batch(8, i)).items()}
        p, s, _ = ex.step_split(p, s, ex.shard(split))
    full_p, full_s = ex.gather_state(p, s)
    if world.rank == 0:
        checkpoint.save(directory, steps_n, {"params": full_p,
                                             "opt_state": full_s})
    torch.distributed.barrier()
    return {"params": to_np(full_p), "mom": to_np(full_s["mom"])}


def restore_blocks(world, dims, p_np, directory):
    """A reference-format checkpoint restored on the GSPMD mesh: this
    rank's parameter blocks and the step."""
    from repro_torch.checkpoint import checkpoint
    ex, plan, params, opt = _tiny_executor(world, dims, p_np)
    state = opt.init(params)
    ex.prepare(params, state)  # learns the layout
    full_p, full_s = ex.full_template(params, state)
    t = checkpoint.restore(directory, {"params": full_p,
                                       "opt_state": full_s},
                           device="cpu")
    p, s = ex.prepare(t["params"], t["opt_state"])
    return {"params": to_np(p), "step": int(s["step"])}


def production_dryrun():
    """The dry run of reduced qwen2-1.5b ``train_4k`` on the 256-rank
    production mesh (its own fake world, in this process): the report."""
    from repro_torch.launch import dryrun
    return dryrun.run_dryrun("qwen2-1.5b", "train_4k", reduced=True,
                             mesh_spec="production", num_microbatches=1,
                             device="cpu", probe=False, verbose=False)


# ---------------------------------------------------------------------------
# the guard and the fault agreement on a GSPMD mesh
# ---------------------------------------------------------------------------

def guarded_lm(world, dims, arch, inner, params_np, splits_np, seq, batch,
               n_micro):
    """The guarded GSPMD step (``GspmdExecutor(guard=True)``) of reduced
    ``arch`` (fp32), one step a split batch: each step's loss and
    ``nonfinite``, whether it left this rank's blocks bit-identical, and
    the gathered params and momentum after it."""
    mesh = gspmd(world, dims)
    cfg = configs.get_reduced(arch)
    opt = steps.make_optimizer(cfg)
    bundle = steps.build_train_step(
        cfg, InputShape("gspmd_guard", "train", seq, batch),
        num_microbatches=n_micro, optimizer=opt, dtype=torch.float32,
        executor=inner, mesh=mesh, budget_bytes=1 << 34, device="cpu")
    ex = engine.GspmdExecutor(bundle.loss_fn, opt, bundle.plan, mesh=mesh,
                              inner=inner, guard=True)
    params = weights.from_reference(params_np, "cpu")
    p, s = ex.prepare(params, opt.init(params))
    out = {"losses": [], "nonfinite": [], "unchanged": [], "params": [],
           "mom": []}
    for split_np in splits_np:
        before = [t.clone() for t in tree.leaves((p, s))]
        split = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in split_np.items()}
        p, s, m = ex.step_split(p, s, ex.shard(split))
        out["unchanged"].append(all(torch.equal(a, b) for a, b in zip(
            before, tree.leaves((p, s)))))
        out["losses"].append(float(m["loss"]))
        out["nonfinite"].append(float(m["nonfinite"]))
        full_p, full_s = ex.gather_state(p, s)
        out["params"].append(to_np(full_p))
        out["mom"].append(to_np(full_s["mom"]))
    return out


def world_flag(world, dims, p_np, bad_rank):
    """The guard's flag of a tiny-MLP step where one element of
    ``bad_rank``'s accumulator blocks alone is made NaN after step ❹:
    every rank's ``nonfinite`` and whether its blocks stayed
    bit-identical."""
    ex, plan, params, opt = _tiny_executor(world, dims, p_np, guard=True)
    p, s = ex.prepare(params, opt.init(params))
    accumulated = ex.inner._accumulated_flat

    def poisoned(*a, **kw):
        out = accumulated(*a, **kw)
        if world.rank == bad_rank:
            out[1][0].view(-1)[0] = float("nan")
        return out
    ex.inner._accumulated_flat = poisoned
    before = [t.clone() for t in tree.leaves((p, s))]
    split = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             plan.split(ToyDataset().batch(8, 0)).items()}
    p, s, m = ex.step_split(p, s, ex.shard(split))
    return {"nonfinite": float(m["nonfinite"]),
            "unchanged": all(torch.equal(a, b) for a, b in zip(
                before, tree.leaves((p, s))))}


def supervised(world, dims, p_np, specs, in_forward, steps_n,
               ckpt_dir=None):
    """A supervised run of the guarded tiny-MLP GSPMD step (``flat``)
    under the fault plan ``specs``; with ``in_forward=(rank, call)`` that
    rank alone raises an out-of-memory error at that call of its loss,
    after the first layer and before the second (and the loss's
    collectives). Without ``ckpt_dir`` the supervisor anchors each
    rank's blocks; with it, the gathered state every step, which rank 0
    checkpoints there. Every rank's records, the faults fired, the final
    plan, the losses, the gathered final state, the anchors' bytes, the
    seconds and the calls of the loss."""
    import time
    from repro_torch.core import losses
    from repro_torch.engine import faults
    mesh = gspmd(world, dims)
    calls = [0]

    def loss_fn(p, mb, exact_denom=None):
        h = torch.tanh(mb["x"] @ p["w1"])
        calls[0] += 1
        if in_forward is not None and (world.rank, calls[0]) == in_forward:
            raise faults.injected_oom("inside the forward")
        return losses.cross_entropy(
            h @ p["w2"], mb["y"], sample_weight=mb.get("sample_weight"),
            exact_denom=exact_denom), {}

    ds = ToyDataset()

    def build(plan):
        ex = engine.GspmdExecutor(loss_fn, make_opt(TINY_OPT), plan,
                                  mesh=mesh, inner="flat", guard=True)
        return ex, ex.step_split, engine.Pipeline(
            ds, plan, prefetch=0, device="cpu", sharding=ex.shard)

    plan = engine.plan_mbs(8, micro_batch_size=4, mesh=mesh)
    sup = engine.Supervisor(build, plan, log_fn=None,
                            writer=world.rank == 0, ckpt_dir=ckpt_dir,
                            ckpt_every=1 if ckpt_dir else 0)
    params = weights.from_reference(p_np, "cpu")
    params, state = sup.executor.prepare(params,
                                         make_opt(TINY_OPT).init(params))
    t0 = time.perf_counter()
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        params, state, _ = sup.fit(params, state, steps_n)
    seconds = time.perf_counter() - t0
    full_p, full_s = sup.executor.gather_state(params, state)
    return {"records": [(r.kind, r.step, r.action, r.steps_lost)
                        for r in sup.records],
            "details": [r.detail for r in sup.records],
            "fired": list(fp.fired), "plan": sup.plan.describe(),
            "history": dict(sup.history), "params": to_np(full_p),
            "mom": to_np(full_s["mom"]), "seconds": seconds,
            "anchor_bytes": [a["bytes"] for a in sup.anchor_log],
            "calls": calls[0]}


def serve_world(world, argv):
    """The serve launcher's ``main(argv)`` on this rank of the world: the
    plan's fields, the report over every rank, each rank's finished
    request ids, and this rank's requests' tokens by id."""
    from repro_torch.engine import serving
    from repro_torch.launch import serve
    out = serve.main(argv)
    return {"plan": dataclasses.asdict(out["plan"]),
            "report": out["report"], "ranks": out["ranks"],
            "tokens": {r.rid: list(r.tokens) for r in out["requests"]},
            "states": sorted({r.state for r in out["requests"]}),
            "finished": serving.FINISHED}


def dryrun_exit(argv):
    """In a fresh process: ``launch.dryrun.main(argv)``'s exit code, its
    report (the last JSON line of its output) and its standard error."""
    import contextlib
    import io
    import json
    from repro_torch.launch import dryrun
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = dryrun.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()
