"""The port's side of the contract checker's data-parallel cases, run on
every rank of a ``repro_torch.launch.world.LocalWorld`` (gloo ranks on
the CPU). Imports no JAX: the ranks import it by name.

Each case builds the tiny model's plan for the rank's mesh, runs one
recorded step of a ``ShardedExecutor`` and returns the rule ids the
checks raise, by check and expectation."""
import numpy as np
import torch

from repro_torch import analysis, engine, optim
from repro_torch.analysis import step_checks, trace_checks
from torch_mesh_cases import t_loss_fn


def _tiny(mesh, n_micro: int = 4):
    plan = engine.plan_mbs(4 * n_micro, num_microbatches=n_micro, mesh=mesh)
    rng = np.random.default_rng(0)
    params = {"w1": torch.tensor(rng.normal(0, 0.3, (8, 16)),
                                 dtype=torch.float32),
              "w2": torch.tensor(rng.normal(0, 0.3, (16, 4)),
                                 dtype=torch.float32)}
    brng = np.random.default_rng(100)
    batch = {"x": brng.normal(size=(4 * n_micro, 8)).astype(np.float32),
             "y": brng.integers(0, 4, 4 * n_micro).astype(np.int32)}
    return plan, params, batch


def _rules(findings):
    return sorted({f.rule for f in findings})


def _run(mesh, loss_fn, defer_sync: bool):
    plan, params, batch = _tiny(mesh)
    opt = optim.sgd(0.1, momentum=0.9)
    ex = engine.ShardedExecutor(loss_fn, opt, plan, mesh=mesh,
                                inner="compiled", defer_sync=defer_sync)
    run = ex.measure_step(params, opt.init(params),
                          ex.stage(plan.split(batch)))
    return plan, params, run


def _census(plan, params, run):
    n = plan.num_micro_batches
    out = {}
    for expect in ("deferred", "per-micro"):
        out[f"JX004 {expect}"] = _rules(trace_checks.check_collectives(
            run.trace, params, n_micro=n, expect=expect))
        out[f"HLO004 {expect}"] = _rules(step_checks.check_gradient_sync(
            run, expect=expect, n_micro=n))
    out["all_reduces"] = analysis.allreduce_count(run)
    return out


def per_micro_census(mesh):
    """The ``defer_sync=False`` baseline's step against both
    expectations."""
    return _census(*_run(mesh, t_loss_fn, defer_sync=False))


def deferred_census(mesh):
    """The deferred step against both expectations."""
    return _census(*_run(mesh, t_loss_fn, defer_sync=True))


def stray_all_reduce_census(mesh):
    """A loss that all-reduces a gradient-sized buffer of its own inside
    every micro-batch (a per-micro sync slipped in past the executor):
    the executor's count does not see it, the census does."""
    import torch.distributed as dist

    def chatty_loss(p, b, exact_denom=None):
        loss, metrics = t_loss_fn(p, b, exact_denom)
        stray = torch.cat([p["w1"].detach().reshape(-1),
                           p["w2"].detach().reshape(-1)])
        dist.all_reduce(stray)
        return loss, metrics

    engine.reset_collective_stats()
    out = _census(*_run(mesh, chatty_loss, defer_sync=True))
    out["executor_count"] = engine.collective_stats()["calls"]
    return out
