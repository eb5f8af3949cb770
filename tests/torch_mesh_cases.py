"""The port's side of the data-parallel conformance cases, run on every
rank of a ``repro_torch.launch.world.LocalWorld`` (gloo ranks on the
CPU).

This module imports no JAX and nothing of the JAX package: the ranks are
spawned processes that import it by name. Each case takes numpy inputs
(the reference's parameters and batches), runs the port on this rank's
mesh and returns numpy results, with the count of all-reduces the case
issued (``engine.collective_stats``).
"""
import dataclasses

import numpy as np
import torch

from repro_torch import engine, optim, tree, weights
from repro_torch.core import losses
from repro_torch.engine import faults


def leaked_modules(mesh):
    """The JAX and JAX-package modules loaded on this rank (none should
    be: the ranks are spawned, and nothing of the port imports them)."""
    import sys
    return sorted(k for k in sys.modules if k.startswith("jax")
                  or k == "repro" or k.startswith("repro."))


def t_loss_fn(p, batch, exact_denom=None):
    """``conftest.tiny_loss_fn`` in PyTorch."""
    h = torch.tanh(batch["x"] @ p["w1"])
    logits = h @ p["w2"]
    return losses.cross_entropy(
        logits, batch["y"], sample_weight=batch.get("sample_weight"),
        exact_denom=exact_denom), {}


@dataclasses.dataclass
class ToyDataset:
    """``conftest.ToyDataset`` (numpy, deterministic in (seed, step))."""
    n_features: int = 8
    n_classes: int = 4
    seed: int = 0

    def batch(self, batch_size, seed):
        rng = np.random.default_rng((self.seed, seed))
        return {"x": rng.normal(size=(batch_size, self.n_features)
                                ).astype(np.float32),
                "y": rng.integers(0, self.n_classes, batch_size
                                  ).astype(np.int32)}


def make_opt(spec):
    """``("sgd", kwargs)`` or ``("sgd", kwargs, clip_norm)``."""
    kind, kw = spec[0], spec[1]
    opt = getattr(optim, kind)(**kw)
    if len(spec) > 2 and spec[2] is not None:
        opt = optim.clip_by_global_norm(opt, spec[2])
    return opt


TINY_OPT = ("sgd", {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4})


def to_np(t):
    return tree.map(lambda x: x.detach().float().numpy().copy(), t)


def _state(params_np, opt):
    params = weights.from_reference(params_np, "cpu")
    return params, opt.init(params)


def _tensors(split_np):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in split_np.items()}


def sharded(mesh, inner, plan, opt_spec=TINY_OPT, **kw):
    return engine.ShardedExecutor(t_loss_fn, make_opt(opt_spec), plan,
                                  mesh=mesh, inner=inner, **kw)


def gradients(mesh, inner, plan, params_np, split_np):
    """The sharded normalized gradients and loss from the global split
    (this rank keeps its block), and the all-reduces issued."""
    ex = sharded(mesh, inner, plan)
    params = weights.from_reference(params_np, "cpu")
    engine.reset_collective_stats()
    g, loss = ex.gradients(params, ex.shard(_tensors(split_np)))
    return to_np(g), float(loss), engine.collective_stats()["calls"]


def step(mesh, inner, plan, params_np, split_np, opt_spec=TINY_OPT,
         via="step_split", minibatch_np=None, defer_sync=True):
    """One sharded step: (params, optimizer state, metrics, all-reduces).
    ``via="step"`` hands the executor the global host mini-batch."""
    opt = make_opt(opt_spec)
    ex = engine.ShardedExecutor(t_loss_fn, opt, plan, mesh=mesh,
                                inner=inner, defer_sync=defer_sync)
    params, state = _state(params_np, opt)
    engine.reset_collective_stats()
    if via == "step":
        p, s, m = ex.step(params, state, dict(minibatch_np))
    else:
        p, s, m = ex.step_split(params, state, ex.shard(_tensors(split_np)))
    calls = engine.collective_stats()["calls"]
    return (to_np(p), to_np({k: v for k, v in s.items() if v is not None}),
            {k: float(v) for k, v in m.items()}, calls)


def trajectory(mesh, inner, plan, params_np, steps):
    """``steps`` sharded steps on ``ToyDataset`` batches through
    :meth:`ShardedExecutor.step`: the losses."""
    opt = make_opt(TINY_OPT)
    ex = sharded(mesh, inner, plan)
    params, state = _state(params_np, opt)
    ds, out = ToyDataset(), []
    for i in range(steps):
        params, state, m = ex.step(params, state,
                                   ds.batch(plan.mini_batch_size, i))
        out.append(float(m["loss"]))
    return out


def census(mesh, inner, plan, params_np, split_np, defer_sync=True):
    """All-reduces of one ``step_split`` (the port's collective census)."""
    return step(mesh, inner, plan, params_np, split_np, TINY_OPT,
                "step_split", None, defer_sync)[3]


def pipeline_block(mesh, plan, steps):
    """What ``Pipeline(mesh=...)`` stages on this rank: each batch's
    leaves as numpy, for ``steps`` steps."""
    pipe = engine.Pipeline(ToyDataset(), plan, prefetch=0, device="cpu",
                           mesh=mesh)
    return [{k: v.numpy().copy() for k, v in b.items()}
            for b in pipe.batches(steps)]


def _sup_build(mesh, guard):
    """``tests/test_supervisor.py``'s rebuild factory on a mesh: a
    ShardedExecutor over ``compiled`` and a Pipeline staging this rank's
    block."""
    ds = ToyDataset()

    def build(plan):
        ex = engine.ShardedExecutor(t_loss_fn, make_opt(TINY_OPT), plan,
                                    mesh=mesh, guard=guard)
        return ex, ex.step_split, engine.Pipeline(
            ds, plan, prefetch=0, device="cpu", sharding=ex.shard)
    return build


PLAN_FIELDS = ("mini_batch_size", "micro_batch_size", "num_micro_batches",
               "pad", "normalization", "remat_policy", "data_parallel",
               "local_micro", "auto_micro", "calibrated")


def supervised(mesh, plan, specs, guard, params_np, steps):
    """A supervised run on this rank under the fault plan ``specs``: its
    records, the faults fired, the final plan, the losses and state."""
    opt = make_opt(TINY_OPT)
    sup = engine.Supervisor(_sup_build(mesh, guard), plan, log_fn=None,
                            writer=mesh.rank == 0)
    params, state = _state(params_np, opt)
    with faults.inject(faults.FaultPlan(*specs)) as fp:
        params, state, _ = sup.fit(params, state, steps)
    return {"records": [(r.kind, r.step, r.action, r.steps_lost)
                        for r in sup.records],
            "fired": list(fp.fired),
            "plan": {f: getattr(sup.plan, f) for f in PLAN_FIELDS},
            "history": dict(sup.history), "params": to_np(params),
            "opt_state": to_np(state)}


def unsupervised(mesh, plan, guard, params_np, steps):
    """The bare Trainer over the same runtime: (params, optimizer state)."""
    _, step_fn, pipeline = _sup_build(mesh, guard)(plan)
    params, state, _ = engine.Trainer(step_fn, pipeline, log_fn=None).fit(
        *_state(params_np, make_opt(TINY_OPT)), steps)
    return to_np(params), to_np(state)


def agreed_first_step(mesh, inner, cfg, plan):
    """One sharded step of ``cfg``'s loss (fp32, on LMDataset batches)
    with an OOM injected on rank 1 at the first dispatch: the error this
    rank raised (None if none) and the all-reduces issued."""
    from repro_torch.data import LMDataset
    from repro_torch.launch import steps
    loss_fn = steps.make_loss_fn(cfg, torch.float32,
                                 remat_policy=plan.remat_policy)
    opt = make_opt(TINY_OPT)
    ex = engine.ShardedExecutor(loss_fn, opt, plan, mesh=mesh, inner=inner)
    params = steps.init_params(cfg, seed=0, device="cpu")
    split = ex.stage(plan.split(LMDataset(cfg.vocab_size, 16, seed=0)
                                .batch(plan.mini_batch_size, 0)))
    engine.reset_collective_stats()
    err = None
    with faults.inject(faults.FaultPlan(faults.oom_at(0, rank=1))):
        try:
            ex.step_split(params, opt.init(params), split)
        except torch.OutOfMemoryError as e:
            err = str(e)
    return err, engine.collective_stats()["calls"]
