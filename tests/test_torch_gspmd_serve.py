"""Prefill and decode on the GSPMD mesh, and the serve suite on a mesh —
held against the reference.

  * **Placement.** Every family's decode cache at ``decode_32k`` and
    ``long_500k`` sizes (the whole configs, as meta tensors and
    ``jax.eval_shape``: nothing allocated): the port's ``cache_specs``
    equal the reference's, leaf for leaf, on the 16 × 16 and 2 × 16 × 16
    production meshes.
  * **Four gloo ranks at 2 × 2.** Reduced qwen2-1.5b (a ring split over
    ``model`` on its slots), gemma2-9b (a sliding-window ring split on
    its head dim, a global ring on its slots, soft-caps), mamba2-780m
    (the SSD state and conv tail split on their widths),
    recurrentgemma-2b (the RG-LRU scan and conv on their channels,
    beside its local-attention rings) and moonshot-v1-16b-a3b (the MoE
    dispatch, each rank filling its experts' block): a prefill of
    4 × 16 tokens into a cache of 32, then 17 decode steps, past the
    global ring's wrap (position 32 overwrites slot 0; the 16-slot
    window wraps at the first step); and seamless-m4t-medium on the
    mesh: its teacher-forced forward, its encoder's cross keys and
    values, and its decode with them split on their 64 frames. The ranks run
    ``tests/torch_gspmd_serve_cases.py`` (no JAX); the reference's
    ``prefill`` / ``decode_step`` run on one device here, on the same
    numpy parameters and tokens.
  * **The dry run on a fake world.** Reduced ``prefill_32k`` and
    ``decode_32k`` as one rank of the production meshes: 256 / 512
    ranks, FLOPs, a census with collectives, ``--budget`` (exit 2) and
    ``--check`` (exit 1, naming what it cannot check).
  * **The serve suite on a ``2:1`` mesh:** its plan and context against
    the reference's ``plan_serve(mesh=)``.

Tolerance: fp32 everywhere. The port's split softmax over the ring's
slots and its sums over the mesh run in other orders than one device's,
so logits and cache entries agree to ``ATOL`` = 2e-5 (logits of order
1–10); ring positions agree exactly.
"""
import concurrent.futures
import functools
import multiprocessing

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_gspmd_serve_cases as cases  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.engine import serving as jserving  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.analysis import serve_checks  # noqa: E402
from repro_torch.launch import sharding, steps  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402

ATOL = 2e-5
DIMS = (2, 2)
PROMPT, MAX_LEN, DECODE = 16, 32, 17
ARCHS = ("qwen2-1.5b", "gemma2-9b", "mamba2-780m", "recurrentgemma-2b",
         "moonshot-v1-16b-a3b")
ENCDEC, FRAMES, ENCDEC_DECODE = "seamless-m4t-medium", 64, 4
PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _inputs(arch):
    jcfg = jconfigs.get_reduced(arch)
    params = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size,
                        (4, PROMPT + DECODE)).astype(np.int32)
    return jcfg, params, toks


def _reference(jcfg, params, toks):
    """The reference's prefill and decode steps on one device."""
    jp = jax.tree.map(jnp.asarray, params)
    last, cache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks[:, :PROMPT]),
                                       max_len=MAX_LEN, dtype=jnp.float32)
    step = jax.jit(lambda p, t, c, pos: jtransformer.decode_step(
        p, jcfg, t, c, pos, dtype=jnp.float32))
    out = []
    for j in range(DECODE):
        pos = jnp.full((toks.shape[0],), PROMPT + j, jnp.int32)
        lg, cache = step(jp, jnp.asarray(toks[:, PROMPT + j:PROMPT + j + 1]),
                         cache, pos)
        out.append(np.asarray(lg))
    return np.asarray(last), out, jax.tree.map(np.asarray, cache)


def _encdec_inputs():
    jcfg = jconfigs.get_reduced(ENCDEC)
    params = jax.tree.map(np.asarray, jencdec.init_params(
        jcfg, jax.random.PRNGKey(4)))
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((4, FRAMES, jcfg.d_model), np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (4, ENCDEC_DECODE)).astype(
        np.int32)
    return params, frames, toks


def _encdec_reference(params, frames, toks):
    """The reference's enc-dec on one device: the teacher-forced
    forward's logits, the cross keys and values, each decode step's
    logits and the self-attention rings after the last."""
    jcfg = jconfigs.get_reduced(ENCDEC)
    jp = jax.tree.map(jnp.asarray, params)
    fwd, _ = jencdec.forward(jp, jcfg, jnp.asarray(frames), jnp.asarray(toks),
                             dtype=jnp.float32, remat=False)
    cache = jencdec.init_decode_cache(jp, jcfg, jnp.asarray(frames), MAX_LEN,
                                      jnp.float32)
    cross = jax.tree.map(np.asarray, cache["cross"])
    step = jax.jit(lambda p, t, c, pos: jencdec.decode_step(
        p, jcfg, t, c, pos, dtype=jnp.float32))
    out = []
    for j in range(toks.shape[1]):
        pos = jnp.full((toks.shape[0],), j, jnp.int32)
        lg, cache = step(jp, jnp.asarray(toks[:, j:j + 1]), cache, pos)
        out.append(np.asarray(lg))
    return (np.asarray(fwd), cross), out, jax.tree.map(np.asarray,
                                                       cache["self"])


@pytest.fixture(scope="module")
def fake_world():
    """The production dry runs (:func:`cases.production_serve_dryruns`),
    started at the module's first test in one spawned process, so they
    run while the gloo world works."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        yield pool.submit(cases.production_serve_dryruns)


@pytest.fixture(scope="module")
def served(tmp_path_factory, fake_world):
    """Each arch's ranks' results beside the reference's, run here while
    the ranks work, and the census's: ``{key: (ranks' results,
    reference) or the exception its world call raised}``. One world
    serves them all; a call that fails closes it and the next starts a
    new one, so a failure fails only the tests that read its key
    (:func:`_result`)."""
    store = tmp_path_factory.mktemp("serve")

    def start():
        return LocalWorld(4, store_dir=str(store), timeout_s=300)

    def lm(arch):
        jcfg, params, toks = _inputs(arch)
        return (cases.prefill_decode,
                (DIMS, arch, params, toks[:, :PROMPT], toks[:, PROMPT:],
                 MAX_LEN), lambda: _reference(jcfg, params, toks))

    def encdec():
        params, frames, toks = _encdec_inputs()
        return (cases.encdec_decode,
                (DIMS, ENCDEC, params, frames, toks, MAX_LEN),
                lambda: _encdec_reference(params, frames, toks))

    calls = [(arch, functools.partial(lm, arch)) for arch in ARCHS] + [
        (ENCDEC, encdec),
        ("census", lambda: (cases.census_by_ranks, (DIMS,), None))]
    return cases.serve_each(start, calls)


def _result(served, key):
    """``served[key]``; the error of its world call, raised again."""
    got = served[key]
    if isinstance(got, BaseException):
        raise got
    return got


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_prefill_and_decode_match_one_device(served, arch):
    """Every rank's gathered logits and cache equal the reference's one
    device's through the ring's wrap."""
    ranks, (last, logits, cache) = _result(served, arch)
    for r in ranks:
        assert _err(r["prefill"], last) < ATOL, arch
        for j, (got, want) in enumerate(zip(r["decode"], logits)):
            assert _err(got, want) < ATOL, (arch, j)
        for c, jc in zip(r["cache"], cache):
            assert sorted(c) == sorted(jc)
            for k in c:
                if k == "pos":
                    np.testing.assert_array_equal(c[k], jc[k])
                else:
                    assert _err(c[k], jc[k]) < ATOL, (arch, k)


def test_gspmd_encdec_decode_matches_one_device(served):
    """seamless-m4t-medium on the mesh: the teacher-forced forward (the
    encoder's heads split over ``model``, the cross attention on DTensor
    keys) and the encoder's cross keys and values; then the decode with
    those keys and values split over ``model`` on their frames (64 > 4
    heads, 32 wide) and its self-attention rings on their slots: every
    rank's logits, cross cache and gathered rings equal the reference's
    one device's."""
    ranks, ((fwd, cross), logits, rings) = _result(served, ENCDEC)
    for r in ranks:
        assert _err(r["forward"], fwd) < ATOL
        for k in ("k", "v"):
            assert _err(r["cross"][k], cross[k]) < ATOL, k
        assert r["layout"]["k"][1] == (2, 2, FRAMES // 2, 4, 32)
        for j, (got, want) in enumerate(zip(r["decode"], logits)):
            assert _err(got, want) < ATOL, j
        for k in ("k", "v"):
            assert _err(r["self"][k], rings[k]) < ATOL, k
        np.testing.assert_array_equal(r["self"]["pos"], rings["pos"])


def test_census_tells_an_axis_by_its_ranks(served):
    """A collective over a group named otherwise but holding the ranks of
    a rank's ``model`` line (DTensor's caches may hand back an equal,
    earlier ``DeviceMesh``) is counted on ``model``; one over ranks of
    no axis line on "other"."""
    for r, by in enumerate(_result(served, "census")[0]):
        want = {"model": 1, "other": 1} if r in (0, 3) else {"model": 1}
        assert by == {"all_reduce": want}, r


def test_ring_and_state_are_split_on_the_2x2_world(served):
    """The layouts the cases cover (each rank's blocks): qwen2's ring
    split over ``data`` on its batch and over ``model`` on its 32 slots,
    gemma2's 16-slot window ring on its head dim (32 > 16) and its global
    ring on its slots, mamba2's SSD state on its head dim; a decode step
    reduces over ``model`` (the split softmax)."""
    lay = {a: _result(served, a)[0][0]["layout"]
           for a in ("qwen2-1.5b", "gemma2-9b", "mamba2-780m")}
    split = "(Shard(dim=1), Shard(dim={}))"
    assert lay["qwen2-1.5b"][0]["k"] == (split.format(2), (2, 2, 16, 2, 32))
    assert lay["qwen2-1.5b"][0]["pos"] == (split.format(2), (2, 2, 16))
    assert lay["gemma2-9b"][0]["k"] == (split.format(4), (1, 2, 16, 2, 16))
    assert lay["gemma2-9b"][0]["pos"] == (split.format(2), (1, 2, 8))
    assert lay["gemma2-9b"][1]["k"] == (split.format(2), (1, 2, 16, 2, 32))
    assert lay["mamba2-780m"][0]["state"] == (split.format(3),
                                              (2, 2, 8, 16, 16))
    for a in ("qwen2-1.5b", "gemma2-9b"):
        assert _result(served, a)[0][0]["census"]["by_kind_and_axis"][
            "all_reduce"].get("model", 0) > 0, a


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_cache_specs_equal_the_reference(shape, multi_pod):
    """Every family's whole cache tree (meta tensors; the reference's
    under ``jax.eval_shape``) has the reference's shapes and dtypes, and
    ``cache_specs`` gives each leaf the reference's spec on the
    production mesh."""
    dims = PRODUCTION[multi_pod]
    for arch in configs.ARCHS:
        if not configs.supports_shape(arch, shape):
            continue
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        got = steps.abstract_cache(cfg, configs.SHAPES[shape])
        want = jsteps.abstract_cache(jcfg, JSHAPES[shape])
        leaves, jleaves = tree.leaves(got), jax.tree.leaves(want)
        assert [tuple(x.shape) for x in leaves] == [
            tuple(x.shape) for x in jleaves], arch
        assert [str(x.dtype).split(".")[-1] for x in leaves] == [
            str(x.dtype) for x in jleaves], arch
        specs = sharding.spec_leaves(sharding.cache_specs(got, dims))
        jspecs = jax.tree.leaves(
            jsharding.cache_specs(want, FakeMesh(dims)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert [tuple(s) for s in specs] == [tuple(s) for s in jspecs], arch


def test_production_dry_run_of_serving_steps(fake_world):
    """Reduced serving steps as one rank of the production meshes: 256 /
    512 ranks, FLOPs, a census with collectives, the cache's blocks; a
    decode step's collectives move less than one block of one layer's
    ring (the ring is never gathered); ``--check`` names what it cannot
    check and exits 1, ``--budget`` exits 2."""
    res = fake_world.result(timeout=600)
    code, rep, err = res["check"]
    assert code == F.EXIT_ERROR and rep["num_devices"] == 256
    assert rep["kind"] == "decode" and rep["raw_cost_analysis"]["flops"] > 0
    assert rep["gspmd"]["collectives"]["calls"] > 0
    assert rep["contract"]["findings"] == []
    assert "not checked on this mesh" in err and "[SRV002]" in err
    assert set(rep["contract"]["checks_run"]) == {"JX004", "SRV001"}
    multi = res["multi"]
    g = multi["gspmd"]
    assert multi["num_devices"] == 512 and multi["axes"] == [
        "pod", "data", "model"]
    cfg = configs.get_reduced("qwen2-1.5b")
    # one layer's key block: 128 / 32 rows, 32768 / 16 slots, bf16
    block = 4 * 2048 * cfg.num_kv_heads * cfg.head_dim * 2
    assert g["local_cache_bytes"] == cfg.num_layers * (2 * block + 4 * 2048
                                                       * 4)
    assert 0 < sum(g["collectives"]["bytes_by_kind"].values()) < block
    assert max(g["collectives"]["largest_by_kind"].values()) < block
    code, rep, err = res["budget"]
    assert code == F.EXIT_BUDGET and "BUDGET EXCEEDED" in err
    assert rep["kind"] == "prefill" and rep["num_devices"] == 256
    assert rep["gspmd"]["logits_local_shape"] == [2, cfg.vocab_size // 16]


def test_serve_suite_on_a_mesh_plans_as_the_reference():
    """``analysis --serve --mesh 2:1``: the data-parallel serve plan
    (slots, ``local_slots``, budget) and the report's context are the
    reference's ``plan_serve(mesh=)``'s for a 2 × 1 mesh, and one rank's
    decode step is clean."""
    rep = serve_checks.run_serve_suite("qwen2-1.5b", mesh="2:1",
                                       device="cpu")
    jplan = jserving.plan_serve(
        jconfigs.get_reduced("qwen2-1.5b"),
        budget_bytes=serve_checks.ANALYSIS_BUDGET,
        max_len=serve_checks.ANALYSIS_MAX_LEN,
        max_slots=serve_checks.ANALYSIS_SLOTS,
        prefill_micro=serve_checks.ANALYSIS_PREFILL,
        mesh=FakeMesh({"data": 2, "model": 1}))
    built = serve_checks.build_decode("qwen2-1.5b", mesh=(2, 1))
    plan = built["plan"]
    for key in ("max_decode_slots", "local_slots", "data_parallel",
                "budget_bytes", "prefill_micro", "max_len"):
        assert getattr(plan, key) == getattr(jplan, key), key
    assert built["engine"].pool.cache[0]["k"].shape[1] == jplan.local_slots
    assert rep.findings == []
    ctx = {k: v for k, v in rep.context.items()
           if k not in ("peak_bytes", "peak_source")}
    assert ctx == {"target": "qwen2-1.5b", "mode": "serve-decode",
                   "mesh": f"dp={jplan.data_parallel}",
                   "slots": jplan.local_slots, "max_len": jplan.max_len,
                   "donate": True}
