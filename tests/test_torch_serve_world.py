"""The serve launcher on a world of ranks: ``launch.serve.main`` on every
rank of a gloo ``LocalWorld`` of two CPU ranks (``tests/torch_gspmd_cases
.serve_world``, no JAX), held against the reference's data-parallel
serve plan and against the launcher on one process.

The reference's launcher builds a data mesh over all its devices and
hands it to ``plan_serve(mesh=)`` (its own launcher stops under jax 0.9
in ``with_sharding_constraint``, so the plan is compared directly, on a
2-device host mesh). Greedy tokens are compared one by one.
"""
import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")

import torch_gspmd_cases as cases  # noqa: E402
from conftest import host_mesh  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.engine import serving as jserving  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402

REQUESTS = 12
ARGV = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
        "--requests", str(REQUESTS), "--rate", "400", "--max-len", "64",
        "--prompt-lens", "5,9,17", "--new-tokens", "3,7"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launcher on the two ranks, once for the module."""
    with LocalWorld(2, store_dir=str(tmp_path_factory.mktemp("serve")),
                    timeout_s=120) as w:
        yield w.run(cases.serve_world, ARGV)


@functools.lru_cache(maxsize=None)
def _one_process():
    out = serve.main(ARGV)
    return {r.rid: list(r.tokens) for r in out["requests"]}, out


def test_world_plan_equals_the_references_data_parallel_plan(runs):
    """Every rank holds the plan the reference's ``plan_serve(mesh=)``
    admits on a 2-device data mesh at the launcher's arguments, field by
    field: the budget per device, ``local_slots`` a worker."""
    want = dataclasses.asdict(jserving.plan_serve(
        jconfigs.get_reduced("qwen2-1.5b"), budget_bytes=int(0.5 * 2**30),
        max_len=64, mesh=host_mesh(2), cache_bytes=4))
    for r in runs:
        assert r["plan"] == want
    assert want["data_parallel"] == 2
    assert want["max_decode_slots"] == 2 * want["local_slots"]


def test_every_request_finishes_once_across_the_ranks(runs):
    """Rank r serves the requests whose id is r modulo 2; each finishes
    on its rank and on no other, and the gathered report — the same on
    both ranks — counts every request once."""
    seen = [rid for r in runs[0]["ranks"] for rid in r["finished"]]
    assert sorted(seen) == list(range(REQUESTS))
    for rank, r in enumerate(runs):
        assert r["states"] == [r["finished"]]
        assert sorted(r["tokens"]) == list(range(rank, REQUESTS, 2))
        assert r["report"] == runs[0]["report"]
        assert r["ranks"] == runs[0]["ranks"]
    rep = runs[0]["report"]
    assert rep["requests"] == {"admitted": REQUESTS, "finished": REQUESTS}
    assert rep["engines"] == 2
    assert rep["slots"]["planned"] == runs[0]["plan"]["max_decode_slots"]


def test_world_tokens_equal_one_process(runs):
    """Each request's greedy tokens on its rank equal the one-process
    launcher's at the same arguments (a world of one is the launcher as
    it was: its engine holds every slot of the plan)."""
    tokens, one = _one_process()
    assert one["plan"].data_parallel == 1
    assert one["engine"].pool.max_slots == one["plan"].max_decode_slots
    for r in runs:
        for rid, toks in r["tokens"].items():
            assert toks == tokens[rid], rid


def test_world_report_pools_the_ranks_samples(runs):
    """The report over the ranks sums decode tokens and tokens/s over
    them and takes the ITL and TTFT percentiles over every rank's
    samples: its decode tokens equal the one-process run's, which decodes
    the same requests."""
    _, one = _one_process()
    rep = runs[0]["report"]
    assert rep["decode"]["tokens"] == one["report"]["decode"]["tokens"]
    assert rep["prefill"]["prompt_tokens"] == \
        one["report"]["prefill"]["prompt_tokens"]
    assert rep["decode"]["tokens_per_s"] > 0
    itl = rep["decode"]["itl_s"]
    assert itl["max"] >= itl["p50"] > 0
    assert rep["ttft_s"]["max"] >= rep["ttft_s"]["p50"] > 0
