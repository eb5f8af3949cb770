"""The port's GSPMD path — parameters, gradients and optimizer state split
by the reference's ``param_specs`` (tensor-parallel over ``model``, FSDP
over ``data``), activations steered by the model's shard hints, the
production meshes — held against the reference's own GSPMD step.

The reference side runs on a 2 × 2 ``jax.sharding.Mesh`` with Auto axes
built here from the forced host devices (never ``jax.make_mesh``, whose
axes are Explicit under jax 0.9 and refuse the embedding gather), the
step placed as its dry run's ``_compile`` places it: in and out
shardings as ``_in_specs`` / ``_out_specs`` make them (:func:`_placed`),
under ``with mesh:`` so the hints act. The port side runs on a gloo ``LocalWorld`` of CPU ranks
(one world of 4 and one of 2, each started once for the module), whose
ranks run ``tests/torch_gspmd_cases.py`` (no JAX). Same numpy parameters
and batches; the reference's compiles are cached for the module.

Tolerance: fp32 everywhere; the port's sums over the mesh (DTensor's
partial sums, the vocab-sharded log-sum-exp) run in other orders than
XLA's, so losses, parameters and momentum agree to ``ATOL`` = 1e-5. The
tiny-MLP golden trajectory keeps the suite's 2e-6.
"""
import concurrent.futures
import dataclasses
import functools
import multiprocessing
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_gspmd_cases as cases  # noqa: E402
from conftest import GOLDEN_LOSSES, tiny_params  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.shapes import InputShape  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.launch import dryrun, sharding, train  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.world import LocalWorld  # noqa: E402

ATOL = 1e-5  # fp32; sums over the mesh in other orders than XLA's
GOLDEN_ATOL = 2e-6
SEQ, BATCH, N_MICRO = 16, 8, 2
DIMS = {"data": 2, "model": 2}
ARCHS = ("qwen2-1.5b", "moonshot-v1-16b-a3b")
ODD_VOCAB = 511  # divides no model axis: the table splits on d_model
# a capacity factor at which MoE drops tokens: the queues must span the
# batch's data blocks
DROP = "capacity0.5"


@pytest.fixture(scope="module", autouse=True)
def fake_worlds():
    """The fake-world cases, started at the module's first test in one
    spawned process (each starts and leaves its own process group
    there), so they run while the gloo worlds work: the production dry
    run, then rank 37's layout on the 256- and 512-rank meshes."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        yield {"dryrun": pool.submit(cases.production_dryrun),
               **{mp: pool.submit(cases.production_layout,
                                  512 if mp else 256, 37, mp, "qwen2-1.5b")
                  for mp in (False, True)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(n)``: the module's gloo world of ``n`` CPU ranks."""
    started = {}

    def get(n: int) -> LocalWorld:
        if n not in started:
            started[n] = LocalWorld(
                n, store_dir=str(tmp_path_factory.mktemp(f"gspmd{n}")),
                timeout_s=300)
        return started[n]

    yield get
    for w in started.values():
        w.close()


def _jmesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))


def _batches(vocab: int):
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
             "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
            for _ in range(2)]


def _placed(bundle, mesh):
    """The in and out specs of a train bundle as the reference's dry run
    places it (``repro.launch.dryrun._in_specs`` / ``_out_specs``:
    params and optimizer state by ``param_specs``, the split batch by
    ``batch_specs`` on its sample dim, the metrics replicated), written
    out here: importing that module sets ``XLA_FLAGS`` to 512 host
    devices for the whole test process."""
    P = jax.sharding.PartitionSpec
    params, opt_state, batch = bundle.arg_shapes
    ins = (jsharding.param_specs(params, mesh),
           jsharding.param_specs(opt_state, mesh),
           jsharding.batch_specs(batch, mesh, batch_dim=1))
    out = jax.eval_shape(bundle.fn, *bundle.arg_shapes)
    outs = (jsharding.param_specs(out[0], mesh),
            jsharding.param_specs(out[1], mesh),
            jax.tree.map(lambda _: P(), out[2]))
    return ins, outs


def _overrides(variant) -> dict:
    """The config fields a case's variant changes: a vocabulary (an int)
    or MoE's capacity factor (``DROP``)."""
    if variant is None:
        return {}
    if variant == DROP:
        return {"capacity_factor": 0.5}
    return {"vocab_size": variant}


def _jcfg(arch: str, vocab=None):
    return dataclasses.replace(jconfigs.get_reduced(arch),
                               **_overrides(vocab))


@functools.lru_cache(maxsize=None)
def _init(arch: str, vocab=None):
    """The reference's seed-0 parameters of reduced ``arch`` (numpy), its
    vocabulary ``vocab`` when given."""
    return jax.tree.map(np.asarray, jtransformer.init_params(
        _jcfg(arch, vocab), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, vocab=None):
    """The reference's GSPMD step on the Auto-axis 2 × 2 mesh: two steps
    from seed-0 parameters. Returns numpy results and, per leaf, the
    index of every device's block."""
    mesh = _jmesh()
    jcfg = _jcfg(arch, vocab)
    bundle = jsteps.build_step(jcfg, InputShape("gspmd_test", "train", SEQ,
                                                BATCH),
                               num_microbatches=N_MICRO, dtype=jnp.float32)
    init = _init(arch, vocab)
    params = jax.tree.map(jnp.asarray, init)
    ins, outs = _placed(bundle, mesh)
    with mesh:
        step = jax.jit(bundle.fn,
                       in_shardings=tuple(jsharding.named(s, mesh)
                                          for s in ins),
                       out_shardings=jsharding.named(outs, mesh))
        p = jax.device_put(params, jsharding.named(ins[0], mesh))
        s = jax.device_put(bundle.optimizer.init(params),
                           jsharding.named(ins[1], mesh))
        losses = []
        for b in _batches(jcfg.vocab_size):
            p, s, m = step(p, s, bundle.plan.split(b))
            losses.append(float(m["loss"]))
    devices = list(mesh.devices.flat)
    index = [[leaf.sharding.devices_indices_map(leaf.shape)[d]
              for d in devices] for leaf in jax.tree.leaves(p)]
    return {"init": init, "losses": losses,
            "params": jax.tree.map(np.asarray, p),
            "mom": jax.tree.map(np.asarray, s["mom"]), "index": index}


_PORT = {}


def _port(world, arch: str, inner: str, vocab=None):
    """The port's two steps on the 4-rank world; the reference's step
    compiles here while the ranks run."""
    key = (arch, inner, vocab)
    if key not in _PORT:
        w = world(4)
        w.submit(cases.lm_train, (2, 2), arch, inner, _init(arch, vocab),
                 _batches(_jcfg(arch, vocab).vocab_size),
                 SEQ, BATCH, N_MICRO, None, _overrides(vocab), vocab == DROP)
        _reference(arch, vocab)
        _PORT[key] = w.collect("lm_train")
    return _PORT[key]


def _close(a, b, what):
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=ATOL,
                                   rtol=0, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("arch,inner,vocab", [
    ("qwen2-1.5b", "flat", None), ("qwen2-1.5b", "compiled", None),
    ("qwen2-1.5b", "fused", None), ("qwen2-1.5b", "flat", ODD_VOCAB),
    ("moonshot-v1-16b-a3b", "flat", None),
    ("moonshot-v1-16b-a3b", "flat", DROP)])
def test_gspmd_step_matches_the_reference_gspmd_step(world, arch, inner,
                                                     vocab):
    """Two steps of the port's 2 × 2 GSPMD step (through
    ``build_train_step(mesh=gspmd_mesh)``) against the reference's jitted
    GSPMD step: losses, parameters and momentum, gathered on every rank.
    moonshot exercises the MoE hints (expert-parallel, no sequence
    sharding); a vocabulary that does not divide ``model`` puts the
    table's ``model`` split on d_model, the tokens replicated over it.
    At capacity factor 0.5 (``DROP``) MoE drops tokens, and each rank
    routes its own data block: see :func:`_check_block_routing`."""
    ref = _reference(arch, vocab)
    outs = _port(world, arch, inner, vocab)
    if vocab == DROP:
        _check_block_routing(arch, outs)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], ref["losses"], atol=ATOL,
                                   rtol=0, err_msg=f"rank {r} losses")
        _close(out["params"], ref["params"], f"rank {r} params")
        _close(out["mom"], ref["mom"], f"rank {r} momentum")
        assert out["census"]["calls"] > 0
        assert set(out["census"]["by_kind_and_axis"]) <= {
            "all_gather", "reduce_scatter", "all_reduce", "all_to_all"}


def _reference_queues(cfg, tokens, router_w):
    """The reference's dispatch plan of ``tokens`` (T, D) — its lines in
    ``repro.models.moe._moe_block`` from the router to the buffer row of
    each (token, choice) — as (keep, idx, C)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = tokens.shape[0]
    probs = jax.nn.softmax(jnn.dense({"w": jnp.asarray(router_w)},
                                     jnp.asarray(tokens), jnp.float32), -1)
    _, topi = jax.lax.top_k(probs, k)
    C = min(max(1, int(np.ceil(T * k / E * cfg.capacity_factor))), T)
    flat_e = topi.reshape(-1)
    in_e = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(in_e, axis=0) * in_e - 1, axis=-1)
    keep = pos < C
    return np.asarray(keep), np.asarray(jnp.where(keep, flat_e * C + pos,
                                                  E * C)), C


def _check_block_routing(arch, outs):
    """The first MoE call of the drop case on every rank: ``route`` saw
    the rank's data block alone (T / 2 tokens, the same on both model
    ranks of a data rank); the blocks' plans, side by side, are the
    reference's plan of the whole micro-batch, which drops tokens; and
    the second block's plan alone would differ from it (so a missing
    prefix of the earlier block's counts could not pass)."""
    cfg = _jcfg(arch, DROP)
    T = BATCH // N_MICRO * SEQ
    by_data = {}
    for r, out in enumerate(outs):
        rec = out["route"]
        assert rec["token_counts"] == {T // 2}, (r, rec["token_counts"])
        assert rec["blocked"], r
        by_data.setdefault(out["coords"]["data"], rec)
        np.testing.assert_array_equal(rec["idx"],
                                      by_data[out["coords"]["data"]]["idx"])
    tokens = np.concatenate([by_data[d]["tokens"] for d in (0, 1)])
    router = by_data[0]["router"]
    keep, idx, C = _reference_queues(cfg, tokens, router)
    assert not keep.all(), "capacity 0.5 must drop tokens"
    assert by_data[0]["C"] == by_data[1]["C"] == C
    np.testing.assert_array_equal(
        np.concatenate([by_data[d]["idx"] for d in (0, 1)]), idx)
    np.testing.assert_array_equal(
        np.concatenate([by_data[d]["keep"] for d in (0, 1)]), keep)
    alone = _reference_queues(cfg, by_data[1]["tokens"], router)
    assert not np.array_equal(alone[1], idx[len(idx) // 2:])


@pytest.mark.parametrize("arch", ARCHS)
def test_local_blocks_are_the_reference_layout(world, arch):
    """Each rank's parameter blocks are the reference's layout: the block
    index of every leaf on device r is the port's ``local_slices`` at rank
    r's (data, model) coordinates, and the block is bitwise the gathered
    array sliced there — momentum in its parameter's layout. The bytes
    held are the spec arithmetic, Σ numel / shard_factor × 4."""
    ref = _reference(arch)
    outs = _port(world, arch, "flat")
    specs = sharding.spec_leaves(sharding.param_specs(ref["init"], DIMS))
    shapes = [x.shape for x in tree.leaves(ref["init"])]
    want_bytes = sum(int(np.prod(s)) // sharding.shard_factor(sp, DIMS) * 4
                     for s, sp in zip(shapes, specs))
    for r, out in enumerate(outs):
        assert out["coords"] == {"data": r // 2, "model": r % 2}
        assert out["local_param_bytes"] == want_bytes
        full_p, full_m = tree.leaves(out["params"]), tree.leaves(out["mom"])
        for i, (shape, spec) in enumerate(zip(shapes, specs)):
            idx = sharding.local_slices(shape, spec, DIMS, out["coords"])
            assert _norm(idx, shape) == _norm(ref["index"][i][r], shape), i
            assert np.array_equal(tree.leaves(out["local_params"])[i],
                                  full_p[i][idx])
            assert np.array_equal(tree.leaves(out["local_mom"])[i],
                                  full_m[i][idx])


def _norm(index, shape):
    return tuple(range(*s.indices(n)) for s, n in zip(index, shape))


@pytest.mark.parametrize("dims,n", [((1, 2), 2), ((2, 1), 2), ((2, 2), 4)])
def test_golden_trajectory_on_gspmd_meshes(world, dims, n):
    """conftest's GOLDEN_LOSSES (the tiny MLP, mini-batch 10 → 3 × 4 with
    padding, exact normalization, SGD-m) on GSPMD meshes: the layout and
    the global valid count change no numerics."""
    p = jax.tree.map(np.asarray, tiny_params())
    for r, losses in enumerate(world(n).run(cases.golden, dims, "flat", p,
                                            5)):
        np.testing.assert_allclose(losses, GOLDEN_LOSSES, atol=GOLDEN_ATOL,
                                   rtol=0, err_msg=f"rank {r}")


def _ref_spec(fn, x, seq_shard=None):
    """The spec the reference's hint ``fn`` gives ``x`` on the 2 × 2
    mesh (its output sharding under ``with mesh:``)."""
    mesh = _jmesh()
    jnn.set_seq_shard(seq_shard)
    try:
        with mesh:  # x enters batch-sharded, as the port's does
            x = jax.device_put(x, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data")))
            out = jax.jit(lambda y: fn(y))(x)  # a new trace per case
    finally:
        jnn.set_seq_shard(None)
    spec = tuple(out.sharding.spec) + (None,) * (x.ndim - len(
        out.sharding.spec))
    return str(tuple(sharding.placements(sharding.filter_spec(spec, DIMS),
                                         DIMS)))


@pytest.mark.parametrize("mode", ["on", "off", "moe"])
def test_sequence_hints_match_the_reference(world, mode, monkeypatch):
    """``seq_sharded`` / ``seq_gathered`` give the reference's layout:
    sequence over ``model`` when on (the default), nothing when off
    (``REPRO_SEQ_SHARD=0``), and nothing under MoE (``forward`` sets
    ``set_seq_shard(False)``)."""
    seq = {"on": None, "off": False, "moe": False}[mode]
    if mode == "off":
        monkeypatch.setenv("REPRO_SEQ_SHARD", "0")
    x = jnp.zeros((4, 16, 8), jnp.float32)
    want_s = _ref_spec(jnn.seq_sharded, x, seq)
    want_g = _ref_spec(lambda y: jnn.seq_gathered(jnn.seq_sharded(y)), x,
                       seq)
    got = world(4).run(cases.hint_placements, (2, 2),
                       None if mode == "on" else False, mode == "moe", 16)
    for r, g in enumerate(got):
        assert g["seq_sharded"] == want_s, (r, g)
        assert g["seq_gathered"] == want_g, (r, g)
    if mode == "on":
        assert "Shard(dim=1)" in want_s


def test_attention_hints_head_sharded_or_context_parallel(world):
    """The reference's attention layout (``attention.attn_block``): with
    the head count dividing ``model`` the heads are sharded (q on H, k/v
    on K when K divides too); otherwise the query ROWS are
    (context-parallel) and k/v replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    g = world(4).run(cases.hint_placements, (2, 2), None, False, 16)[0]
    assert g["q42"] == str((Shard(0), Shard(2)))
    assert g["k42"] == str((Shard(0), Shard(2)))
    assert g["out_spec42"] == repr((("pod", "data"), None, "model", None))
    assert g["q31"] == str((Shard(0), Shard(1)))
    assert g["k31"] == str((Shard(0), Replicate()))
    assert g["out_spec31"] == repr((("pod", "data"), "model", None, None))


def test_vocab_sharded_cross_entropy_matches_the_reference(world):
    """``losses.cross_entropy`` of logits split (batch over ``data``,
    vocab over ``model``) against the reference's on the whole array:
    the loss, and the gradient with respect to the logits."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (4, 6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (4, 6)).astype(np.int32)
    w = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want, gwant = jax.value_and_grad(
        lambda lg: jlosses.cross_entropy(lg, labels, sample_weight=w))(
            jnp.asarray(logits))
    for r, (loss, grad) in enumerate(world(4).run(
            cases.vocab_ce, (2, 2), logits, labels, w)):
        np.testing.assert_allclose(loss, float(want), atol=1e-6, rtol=0)
        np.testing.assert_allclose(grad, np.asarray(gwant), atol=1e-7,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the production meshes on a fake world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_world(fake_worlds, multi_pod):
    """``make_production_mesh`` on a fake world of 256 (512 with the pod
    axis): the reference's axes, rank 37's coordinates, and each leaf's
    local shape under ``param_specs(fsdp_over_pod=multi_pod)`` — the
    reference's spec divided out."""
    dims, coords, local = fake_worlds[multi_pod].result(timeout=300)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert dims == want and list(dims) == list(want)
    assert coords == ({"pod": 0, "data": 2, "model": 5} if multi_pod
                      else {"data": 2, "model": 5})
    jm = types.SimpleNamespace(shape=want, axis_names=tuple(want))
    shapes = jax.tree.map(np.asarray, jtransformer.init_params(
        jconfigs.get_reduced("qwen2-1.5b"), jax.random.PRNGKey(0)))
    specs = jax.tree.leaves(
        jsharding.param_specs(shapes, jm, fsdp_over_pod=multi_pod),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for x, spec, got in zip(jax.tree.leaves(shapes), specs, local):
        exp = list(x.shape)
        for i, e in enumerate(tuple(spec)):
            for ax in (e if isinstance(e, tuple) else (e,) if e else ()):
                exp[i] //= want[ax]
        assert tuple(exp) == tuple(got)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_another_world_size(multi_pod):
    """At any other world size the production mesh names the size it
    needs — the constructor, the launcher (exit 2) and the dry run."""
    need = "512" if multi_pod else "256"
    with pytest.raises(ValueError, match=f"exactly {need} ranks"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod)
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--mesh", "production", "--steps", "1"]
    with pytest.raises(SystemExit) as e:
        train.main(argv + (["--multi-pod"] if multi_pod else []))
    assert e.value.code == 2


def test_production_dry_run_reports_the_spec_arithmetic(fake_worlds):
    """The dry run of reduced qwen2-1.5b train_4k on the production mesh
    (a fake world of 256 in the dry-run process, fake tensors): one rank's
    parameter bytes equal ``param_shard_ratio``'s arithmetic (Σ numel /
    shard_factor × 4), and the collectives of its step are counted by
    kind and axis. (The 512-rank mesh's blocks are the fake-world test's
    local shapes.)"""
    res = fake_worlds["dryrun"].result(timeout=300)
    cfg = configs.get_reduced("qwen2-1.5b")
    g = res["gspmd"]
    assert g["world"] == 256 and g["mesh"] == {"data": 16, "model": 16}
    shapes = memory_model.param_shapes(cfg)
    total = sum(x.numel() for x in tree.leaves(shapes))
    ratio = memory_model.param_shard_ratio(cfg, g["mesh"])
    assert g["local_param_bytes"] == round(total * 4 * ratio)
    specs = sharding.spec_leaves(sharding.param_specs(shapes, g["mesh"]))
    assert g["local_param_bytes"] == sum(
        x.numel() // sharding.shard_factor(s, g["mesh"]) * 4
        for x, s in zip(tree.leaves(shapes), specs))
    assert g["collectives"]["calls"] > 0
    assert "data" in g["collectives"]["by_kind_and_axis"]["all_gather"]
    assert res["memory"]["peak_bytes_est"] > 0
    assert res["raw_cost_analysis"]["flops"] > 0


def test_production_dry_run_refuses_serving_shapes():
    """Prefill and decode on a production mesh are no longer refused: a
    decode step runs as rank 0 of the 256-rank world, its cache placed by
    ``cache_specs`` (``tests/test_torch_gspmd_serve.py`` holds the
    rest)."""
    res = dryrun.run_dryrun("qwen2-1.5b", "decode_32k", reduced=True,
                            mesh_spec="production", device="cpu",
                            probe=False, verbose=False)
    g = res["gspmd"]
    assert res["kind"] == "decode" and res["num_devices"] == 256
    assert g["local_cache_bytes"] > 0 and g["collectives"]["calls"] > 0


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def test_checkpoints_cross_between_packages(world, tmp_path):
    """A checkpoint the 2 × 2 GSPMD step saves (every rank gathers, rank
    0 writes the reference format) restores in the reference; one the
    reference saves restores on the 2 × 2 mesh, each rank holding its
    blocks of it."""
    p = jax.tree.map(np.asarray, tiny_params())
    out = str(tmp_path / "port")
    saved = world(4).run(cases.save_after_steps, (2, 2), p, out, 2)[0]
    template = {"params": jax.tree.map(jnp.zeros_like, tiny_params()),
                "opt_state": {"mom": jax.tree.map(jnp.zeros_like,
                                                  tiny_params()),
                              "step": jnp.zeros((), jnp.int32)}}
    got = jckpt.restore(out, template, 2)
    _close(got["params"], saved["params"], "reference restore params")
    _close(got["opt_state"]["mom"], saved["mom"], "reference restore mom")
    assert int(got["opt_state"]["step"]) == 2

    back = str(tmp_path / "reference")
    jckpt.save(back, 5, got)
    for r, blocks in enumerate(world(4).run(cases.restore_blocks, (2, 2), p,
                                            back)):
        specs = sharding.spec_leaves(sharding.param_specs(p, DIMS))
        c = {"data": r // 2, "model": r % 2}
        for x, spec, b in zip(tree.leaves(saved["params"]), specs,
                              tree.leaves(blocks["params"])):
            idx = sharding.local_slices(x.shape, spec, DIMS, c)
            assert np.array_equal(np.asarray(x)[idx], b)
        assert blocks["step"] == 2


def test_rank_module_imports_no_jax(world):
    """The ranks that ran the GSPMD cases loaded no JAX."""
    from torch_mesh_cases import leaked_modules
    assert world(4).run(leaked_modules) == [[]] * 4


def test_supervise_on_a_gspmd_mesh_is_refused():
    """``--supervise`` on a GSPMD mesh is ported: the executor takes
    ``guard=True`` (``tests/test_torch_gspmd_guard.py`` runs it), and what
    is still refused is the reference's refusal (``streaming``) and, on
    the launcher, a world of the wrong size for the production mesh,
    named as without ``--supervise`` (exit 2)."""
    from repro_torch import engine
    m = mesh_lib.Mesh({"data": 2, "model": 2}, mode="gspmd",
                      device_mesh=object())
    ex = engine.GspmdExecutor(None, None, engine.plan_mbs(4), mesh=m,
                              guard=True)
    assert ex.guard
    with pytest.raises(ValueError, match="streaming"):
        engine.GspmdExecutor(None, None, engine.plan_mbs(4), mesh=m,
                             inner="streaming", guard=True)
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                    "--mesh", "production", "--steps", "1", "--supervise"])
    assert e.value.code == 2
