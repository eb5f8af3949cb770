"""``--supervise`` on a GSPMD mesh: the port's guarded GSPMD step
(``GspmdExecutor(guard=True)``) held against the reference's guarded
GSPMD step, and a one-rank out-of-memory error agreed by every rank of
the mesh, at dispatch and inside the forward. First, the production dry
run's gates: ``--budget`` on the rank's peak and ``--check`` over what
one rank gives, the rest refused by name (run in a spawned process while
the ranks work).

The reference's step runs on a 2 × 2 ``jax.sharding.Mesh`` with Auto
axes built here from the forced host devices (never ``jax.make_mesh``,
whose axes are Explicit under jax 0.9 and refuse the embedding gather),
placed as its dry run places it (``test_torch_gspmd._placed``). The port
runs on a gloo ``LocalWorld`` of four CPU ranks, started once for the
module with a 60 s timeout (its process group's too, so no call waits
longer), whose ranks run ``tests/torch_gspmd_cases.py`` (no JAX).

Tolerance: fp32; the port's sums over the mesh run in other orders than
XLA's, so a finite step agrees to ``test_torch_gspmd.ATOL`` (1e-5); a
skipped step leaves every rank's blocks bit-identical.
"""
import concurrent.futures
import functools
import multiprocessing

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_gspmd_cases as cases  # noqa: E402
from conftest import tiny_params  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.configs.shapes import InputShape  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.engine import faults  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402
from test_torch_gspmd import (ATOL, BATCH, N_MICRO, SEQ, _batches,  # noqa: E402
                              _close, _init, _jcfg, _jmesh, _placed)

ARCH = "qwen2-1.5b"
TIMEOUT_S = 60


DRYRUN = ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--reduced",
          "--no-probe", "--device", "cpu", "--mesh", "production",
          "--check"]


@pytest.fixture(scope="module", autouse=True)
def dryruns():
    """The production dry run with ``--check``, with and without a budget
    of 0.0001 GiB, in one spawned process (each run starts and leaves its
    own fake world of 256 ranks), started at the module's first test."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        yield {"budget": pool.submit(cases.dryrun_exit,
                                     DRYRUN + ["--budget", "0.0001"]),
               "check": pool.submit(cases.dryrun_exit, DRYRUN)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with LocalWorld(4, store_dir=str(tmp_path_factory.mktemp("guard")),
                    timeout_s=TIMEOUT_S) as w:
        yield w


@functools.lru_cache(maxsize=None)
def _splits():
    """Two split batches of the guarded test: the second's first sample
    weight is NaN, which only the ranks of data coordinate 0 hold."""
    jcfg = _jcfg(ARCH)
    plan = _bundle().plan
    splits = [{k: np.array(v) for k, v in plan.split(b).items()}
              for b in _batches(jcfg.vocab_size)]
    splits[1]["sample_weight"][0, 0] = np.nan
    return splits


@functools.lru_cache(maxsize=None)
def _bundle():
    return jsteps.build_step(_jcfg(ARCH), InputShape("gspmd_test", "train",
                                                     SEQ, BATCH),
                             num_microbatches=N_MICRO, dtype=jnp.float32)


def _reference_guarded():
    """The reference's guarded GSPMD step (its ``compiled`` executor with
    ``guard=True``, as its launcher's ``make_build`` builds it under
    ``--supervise``) on the Auto-axis 2 × 2 mesh: after each split,
    the loss, ``nonfinite``, params and momentum (numpy)."""
    mesh, bundle = _jmesh(), _bundle()
    fn = jengine.get_executor("compiled")(
        bundle.loss_fn, bundle.optimizer, bundle.plan,
        guard=True).make_train_step()
    guarded = bundle.__class__(**{**bundle.__dict__, "fn": fn})
    ins, outs = _placed(guarded, mesh)
    params = jax.tree.map(jnp.asarray, _init(ARCH))
    out = []
    with mesh:
        step = jax.jit(fn, in_shardings=tuple(jsharding.named(s, mesh)
                                              for s in ins),
                       out_shardings=jsharding.named(outs, mesh))
        p = jax.device_put(params, jsharding.named(ins[0], mesh))
        s = jax.device_put(bundle.optimizer.init(params),
                           jsharding.named(ins[1], mesh))
        for split in _splits():
            p, s, m = step(p, s, split)
            out.append({"loss": float(m["loss"]),
                        "nonfinite": float(m["nonfinite"]),
                        "params": jax.tree.map(np.asarray, p),
                        "mom": jax.tree.map(np.asarray, s["mom"])})
    return out


def test_guarded_gspmd_step_matches_the_reference(world):
    """A finite step agrees with the reference's guarded GSPMD step within
    ATOL on every rank; a NaN in one data block skips the update on every
    rank (``nonfinite`` 1.0 everywhere, as the reference's), each rank's
    blocks bit-identical to what they were before it."""
    world.submit(cases.guarded_lm, (2, 2), ARCH, "flat", _init(ARCH),
                 _splits(), SEQ, BATCH, N_MICRO)
    ref = _reference_guarded()
    runs = world.collect("guarded_lm")
    assert [r["nonfinite"] for r in ref] == [0.0, 1.0]
    for rank, out in enumerate(runs):
        assert out["nonfinite"] == [0.0, 1.0], rank
        assert out["unchanged"] == [False, True], rank
        np.testing.assert_allclose(out["losses"][0], ref[0]["loss"],
                                   atol=ATOL, rtol=0)
        for i in (0, 1):
            _close(out["params"][i], ref[i]["params"], f"rank {rank} {i}")
            _close(out["mom"][i], ref[i]["mom"], f"rank {rank} {i}")


@pytest.mark.parametrize("bad_rank", [0, 3])
def test_one_ranks_nonfinite_block_skips_every_rank(world, bad_rank):
    """The flag is the AND over the world: one element of one rank's
    accumulator blocks made NaN after step ❹ skips the update on all
    four ranks, each keeping its blocks bit-identical."""
    p = jax.tree.map(np.asarray, tiny_params())
    for r in world.run(cases.world_flag, (2, 2), p, bad_rank):
        assert r == {"nonfinite": 1.0, "unchanged": True}


def _supervised(world, specs, in_forward=None, ckpt_dir=None):
    runs = world.run(cases.supervised, (2, 2),
                     jax.tree.map(np.asarray, tiny_params()), specs,
                     in_forward, 4, ckpt_dir, timeout_s=TIMEOUT_S)
    for r in runs:
        assert r["seconds"] < TIMEOUT_S
        for key in ("records", "details", "plan", "history"):
            assert r[key] == runs[0][key], key
        for a, b in zip(jax.tree.leaves((r["params"], r["mom"])),
                        jax.tree.leaves((runs[0]["params"],
                                         runs[0]["mom"]))):
            assert np.array_equal(a, b)
    return runs


@pytest.mark.parametrize("where", ["dispatch", "forward",
                                   "forward, checkpointed"])
def test_one_rank_oom_is_agreed_on_a_gspmd_mesh(world, where, tmp_path):
    """An out-of-memory error on rank 1 alone at step 2 — at its dispatch
    (``oom_at(2, rank=1)``), or inside its forward between the first
    layer's collectives and the loss's (its fifth loss call: step 2's
    first micro-batch) — is recorded alike by every rank's supervisor,
    naming rank 1, and the run finishes on rank 0's degraded plan from
    the agreed step, equal to the run where the fault fires on every rank
    at dispatch; no call waits out the 60 s timeout. Without a
    checkpoint directory each rank anchors its own blocks (a quarter of
    the reference-format bytes here); with one, the gathered state, and
    the recovery resumes from rank 0's checkpoint of step 2."""
    ckpt = str(tmp_path) if "checkpointed" in where else None
    if where == "dispatch":
        one = _supervised(world, [faults.oom_at(2, rank=1)])
        assert [r["fired"] for r in one] == [[], [("oom", 2)], [], []]
        assert "by the step's all-reduce" in one[0]["details"][0]
    else:
        one = _supervised(world, [], in_forward=(1, 5), ckpt_dir=ckpt)
        assert "by the world's groups started anew" in one[0]["details"][0]
    assert "rank(s) [1] of 4" in one[0]["details"][0]
    lost = 0 if ckpt else 2
    assert one[0]["records"] == [("oom", 2, "remat period->full", lost)]
    assert "remat full" in one[0]["plan"]
    whole = sum(np.asarray(x).nbytes for x in jax.tree.leaves(
        (one[0]["params"], one[0]["mom"]))) + 4  # and the step counter
    if ckpt:
        assert one[0]["anchor_bytes"][0] == whole
    else:
        assert one[0]["anchor_bytes"][0] < whole
    every = _supervised(world, [faults.oom_at(2)])
    assert [r[:3] for r in one[0]["records"]] == \
        [r[:3] for r in every[0]["records"]]
    for key in ("plan", "history"):
        assert one[0][key] == every[0][key], key
    for a, b in zip(jax.tree.leaves((one[0]["params"], one[0]["mom"])),
                    jax.tree.leaves((every[0]["params"], every[0]["mom"]))):
        assert np.array_equal(a, b)


def test_production_dry_run_gates_the_budget(dryruns):
    """``--mesh production --budget 0.0001`` exits 2 (the rank's peak over
    the budget), its report carrying the ``budget`` gate and, under
    ``--check``, the ``contract`` — as on one device."""
    rc, res, err = dryruns["budget"].result(timeout=300)
    assert rc == F.EXIT_BUDGET
    assert "BUDGET EXCEEDED" in err
    b = res["budget"]
    assert b["over_budget"] and b["measured_peak_bytes"] == \
        res["gspmd"]["peak_bytes"] == res["memory"]["peak_bytes_est"]
    assert res["contract"]["checks_run"] == ["JX004", "HLO003"]


def test_production_check_refuses_what_one_rank_cannot_feed(dryruns):
    """``--check`` on the production mesh runs the census's JX004 and
    HLO003 against ``estimate(mesh=, fsdp_params=True)`` (clean here) and
    refuses by name the rules that read one process's op trace: exit 1,
    never 0 with rules unchecked."""
    rc, res, err = dryruns["check"].result(timeout=300)
    assert rc == F.EXIT_ERROR
    c = res["contract"]
    assert c["findings"] == [] and set(c["context"]["refused"]) == {
        "JX001", "JX002", "JX003", "HLO001"}
    for rule in c["context"]["refused"]:
        assert f"CONTRACT: [{rule}] not checked on this mesh" in err
    assert res["oracle"]["modeled_bytes"] > 0 and res["budget"] is None


@pytest.mark.parametrize("case", ["stray", "no-scatter", "peak", "clean"])
def test_check_gspmd_rank_findings(case):
    """JX004's GSPMD form and HLO003 over one rank's census and peak:
    a collective over a group of no mesh axis, a step without a
    reduce-scatter over 16 batch ranks and a peak far over the model's
    band are findings (exit 3); the clean census is none."""
    mesh = {"data": 16, "model": 16}
    census = {"by_kind_and_axis": {"all_gather": {"data": 4, "model": 2},
                                   "reduce_scatter": {"data": 2},
                                   "all_reduce": {"data+model": 1}}}
    peak = 1 << 20
    if case == "stray":
        census["by_kind_and_axis"]["all_reduce"]["other"] = 1
    elif case == "no-scatter":
        del census["by_kind_and_axis"]["reduce_scatter"]
    elif case == "peak":
        peak = 1 << 40
    rep = analysis.check_gspmd_rank(census, mesh, peak_bytes=peak,
                                    modeled_bytes=1 << 20)
    want = {"stray": ["JX004"], "no-scatter": ["JX004"], "peak": ["HLO003"],
            "clean": []}[case]
    assert [f.rule for f in rep.findings] == want
    assert rep.exit_code() == (F.EXIT_CONTRACT if want else F.EXIT_OK)
