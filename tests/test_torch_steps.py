"""The port's step builders (``repro_torch.launch.steps``: ``StepBundle``,
``abstract_*``, ``build_*_step``; ``configs/shapes.py``) against the JAX
package's.

For every architecture × assigned shape the bundles' abstract arguments
— meta tensors in the port, ``ShapeDtypeStruct`` in the reference — have
the same leaf paths, shapes and dtypes; every train shape plans the same
analytic geometry at the reference's default budget (one v5e, passed
explicitly); at 2 layers the bundles' train, prefill and decode steps
give the reference's jitted bundle ``fn`` outputs, fp32, on the same
weights (``weights.from_reference``) and numpy inputs, within
``DTYPE_ATOL`` (conftest) plus rtol 1e-5 (XLA and torch order the matmul
sums differently, as in the other conformance tests) — the VLM within
``tests/test_torch_vlm.py``'s atol 1e-5, its 1280-wide patch projection
rounding further apart; what the port does not have (a model axis, FSDP)
is refused by name.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, tree, weights  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402

V5E = jmemory_model.V5E_HBM_BYTES
F32_ATOL = DTYPE_ATOL[jnp.dtype(jnp.float32)]
F32_RTOL = 1e-5
CELLS = [(a, s) for a in jconfigs.ARCHS for s in jconfigs.SHAPES]


def _layout(t, path=()):
    """(path, shape, dtype name) of every leaf: dicts by sorted key,
    tuples and lists by index — either package's tree."""
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _layout(t[k], path + (k,))]
    if isinstance(t, (tuple, list)):
        return [x for i, v in enumerate(t)
                for x in _layout(v, path + (str(i),))]
    if t is None:
        return []
    name = (str(t.dtype).replace("torch.", "") if isinstance(t, torch.Tensor)
            else jnp.dtype(t.dtype).name)
    return [("/".join(path), tuple(t.shape), name)]


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.InputShape is InputShape


@pytest.mark.parametrize("arch,shape", CELLS)
def test_bundle_arg_trees_equal_the_reference(arch, shape):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = steps.build_step(cfg, configs.SHAPES[shape], budget_bytes=V5E,
                           device="cpu")
    want = jsteps.build_step(jcfg, jconfigs.SHAPES[shape])
    assert got.kind == want.kind
    assert got.donate_argnums == want.donate_argnums
    assert len(got.arg_shapes) == len(want.arg_shapes)
    for i, (g, w) in enumerate(zip(got.arg_shapes, want.arg_shapes)):
        assert _layout(g) == _layout(w), f"argument {i}"
    for leaf in tree.leaves(got.arg_shapes):
        assert leaf.device.type == "meta"  # shapes only: nothing allocated
    if got.kind == "train":
        assert got.executor == want.executor == "compiled"
        assert got.plan.describe() == want.plan.describe()


@pytest.mark.parametrize("policy", [None, "auto"])
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_train_plans_equal_the_reference(arch, policy):
    """The analytic plan of every train shape (the memory model sizes the
    micro-batch) at the reference's default budget, for ``compiled`` and
    ``flat`` (no step-❺ transient)."""
    for name, shape in jconfigs.SHAPES.items():
        if shape.kind != "train":
            continue
        for executor in ("compiled", "flat"):
            got = steps.build_train_step(
                configs.get(arch), configs.SHAPES[name],
                remat_policy=policy, executor=executor, budget_bytes=V5E,
                device="cpu").plan
            want = jsteps.build_train_step(
                jconfigs.get(arch), shape, remat_policy=policy,
                executor=executor).plan
            for f in ("micro_batch_size", "num_micro_batches", "pad",
                      "remat_policy", "auto_policy", "normalization"):
                assert getattr(got, f) == getattr(want, f), (name, executor,
                                                             f)


# ---------------------------------------------------------------------------
# the bundles' steps at 2 layers, fp32, on the reference's weights
# ---------------------------------------------------------------------------

MODELS = ["qwen2-1.5b", "gemma2-9b", "mamba2-780m", "seamless-m4t-medium",
          "qwen2-vl-72b"]
# a VLM sample carries 256 patches, so its text follows them
SEQ = {"qwen2-vl-72b": 272}
ATOL = {"qwen2-vl-72b": 1e-5}


def _cfgs(arch):
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    assert cfg.num_layers == jcfg.num_layers == 2
    return cfg, jcfg


def _ref_params(jcfg):
    init = jencdec.init_params if jcfg.is_encdec else jtransformer.init_params
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))


def _close(got, want, what, atol=F32_ATOL):
    g = [np.asarray(x.detach().float()) for x in tree.leaves(got)]
    w = [np.asarray(jnp.asarray(x, jnp.float32))
         for x in jax.tree.leaves(want)]
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=F32_RTOL,
                                   err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("arch", MODELS)
def test_train_bundle_matches_the_reference(arch):
    cfg, jcfg = _cfgs(arch)
    seq = SEQ.get(arch, 16)
    shape = InputShape("train_tiny", "train", seq, 4)
    got = steps.build_train_step(cfg, shape, num_microbatches=2,
                                 dtype=torch.float32, remat_policy="none",
                                 budget_bytes=V5E, device="cpu")
    want = jsteps.build_train_step(jcfg, shape, num_microbatches=2,
                                   dtype=jnp.float32, remat_policy="none")
    batch = steps.family_batch(cfg, seq, 4, seed=1)
    split = steps.device_split(got.plan, batch, "cpu")
    jsplit = {k: jnp.asarray(v.numpy()) for k, v in split.items()}
    assert _layout(split) == _layout(got.arg_shapes[2])
    rp = _ref_params(jcfg)
    jp = jax.tree.map(jnp.asarray, rp)
    jnew, jstate, jm = jax.jit(want.fn)(jp, want.optimizer.init(jp), jsplit)
    tp = weights.from_reference(rp, "cpu")
    new, state, m = got.fn(tp, got.optimizer.init(tp), split)
    atol = ATOL.get(arch, F32_ATOL)
    _close(m["loss"], jm["loss"], f"{arch} loss", atol)
    _close(new, jnew, f"{arch} params", atol)
    _close(state, jstate, f"{arch} optimizer state", atol)


def _inputs(cfg, seq, b, seed):
    """The serving inputs of the prefill bundle, as numpy."""
    batch = steps.family_batch(cfg, seq, b, seed=seed)
    if cfg.is_encdec:
        return [batch["frames"], batch["tgt_tokens"]]
    out = [batch["tokens"]]
    if cfg.is_vlm:
        out += [batch["vision_embeds"], batch["mrope_positions"]]
    return out


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_and_decode_bundles_match_the_reference(arch):
    cfg, jcfg = _cfgs(arch)
    seq, b = SEQ.get(arch, 16), 2
    pre = InputShape("prefill_tiny", "prefill", seq, b)
    dec = InputShape("decode_tiny", "decode", seq + 8, b)
    rp = _ref_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, rp), weights.from_reference(rp, "cpu")
    args = _inputs(cfg, seq, b, seed=2)
    got = steps.build_step(cfg, pre, dtype=torch.float32)
    want = jsteps.build_step(jcfg, pre, dtype=jnp.float32)
    out = got.fn(tp, *[torch.from_numpy(a) for a in args])
    jout = jax.jit(want.fn)(jp, *[jnp.asarray(a) for a in args])
    atol = ATOL.get(arch, F32_ATOL)
    _close(out, jout, f"{arch} prefill", atol)
    # decode one token after a cache of seq + 8 slots (an enc-dec cache
    # attends over (seq + 8) / 4 encoder frames, as the shape sizes it)
    if cfg.is_encdec:
        frames = steps.family_batch(cfg, dec.seq_len // 4, b,
                                    seed=3)["frames"]
        cache = encdec.init_decode_cache(tp, cfg, torch.from_numpy(frames),
                                         dec.seq_len, torch.float32)
        jcache = jencdec.init_decode_cache(jp, jcfg, jnp.asarray(frames),
                                           dec.seq_len, jnp.float32)
    else:
        short = InputShape("prefill_cache", "prefill", dec.seq_len, b)
        pad = [np.concatenate([a, np.zeros((b, 8), a.dtype)], 1)
               if a.ndim == 2 else a for a in args[:1]]
        _, cache = steps.build_step(cfg, short, dtype=torch.float32).fn(
            tp, torch.from_numpy(pad[0]))
        _, jcache = jax.jit(jsteps.build_step(jcfg, short,
                                              dtype=jnp.float32).fn)(
            jp, jnp.asarray(pad[0]))
    dgot = steps.build_step(cfg, dec, dtype=torch.float32)
    dwant = jsteps.build_step(jcfg, dec, dtype=jnp.float32)
    assert _layout(cache) == _layout(dgot.arg_shapes[2])
    assert _layout(jcache) == _layout(dwant.arg_shapes[2])
    tok = np.full((b, 1), 7, np.int32)
    pos = np.full((b,), dec.seq_len - 1, np.int32)
    logits, cache = dgot.fn(tp, torch.from_numpy(tok), cache,
                            torch.from_numpy(pos))
    jlogits, jcache = jax.jit(dwant.fn)(jp, jnp.asarray(tok), jcache,
                                        jnp.asarray(pos))
    _close(logits, jlogits, f"{arch} decode logits", atol)
    _close(cache, jcache, f"{arch} decode cache", atol)


# ---------------------------------------------------------------------------
# what is not ported is refused by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"data": 1, "model": 2},
    {"data": 2, "model": 2},
    {"data": 2, "model": 2, "fsdp": True}],
    ids=["model-axis", "data-and-model", "fsdp"])
def test_pipelined_and_fsdp_steps_are_refused(kw, tmp_path):
    """Once refused (pipeline parallelism unported), now built as the
    reference builds them: a mesh with a model axis routes through
    ``PipelinedExecutor`` with the reference's plan (``pipeline=True``),
    the staged loss and one rank's abstract block; and the bundle's step
    runs — on a gloo world of 2 ranks for the 2-stage mesh (one step
    against the single-device executor's)."""
    from conftest import pipeline_mesh
    kw = dict(kw)
    fsdp = kw.pop("fsdp", False)
    shape = configs.SHAPES["train_4k"]
    got = steps.build_train_step(
        configs.get_reduced("qwen2-1.5b"), shape, num_microbatches=8,
        mesh=mesh_lib.make_host_mesh(**kw), fsdp=fsdp, budget_bytes=V5E,
        device="cpu")
    want = jsteps.build_train_step(
        jconfigs.get_reduced("qwen2-1.5b"), shape, num_microbatches=8,
        mesh=pipeline_mesh(kw["data"], kw["model"]), fsdp=fsdp)
    for f in ("micro_batch_size", "num_micro_batches", "data_parallel",
              "local_micro", "remat_policy", "pipeline_stages"):
        assert getattr(got.plan, f) == getattr(want.plan, f), f
    assert got.executor == want.executor == "pipelined"
    ex = got.fn.__self__
    assert isinstance(ex, engine.PipelinedExecutor) and ex.fsdp == fsdp
    assert got.arg_shapes[2]["tokens"].shape == (
        8, got.plan.local_micro, shape.seq_len)
    with pytest.raises(ValueError, match="does not divide the block stack"):
        steps.build_train_step(  # 4 stages of reduced qwen2's 2 layers
            configs.get_reduced("qwen2-1.5b"), shape, num_microbatches=8,
            mesh=mesh_lib.make_host_mesh(data=2, model=4), budget_bytes=V5E,
            device="cpu")
    if kw == {"data": 1, "model": 2}:
        import torch_pipeline_cases as cases
        from repro_torch.launch.world import LocalWorld
        with LocalWorld(2, store_dir=str(tmp_path), timeout_s=120) as w:
            losses = w.run(cases.bundle_step, "qwen2-1.5b", 16, 4)
        assert losses[0] == losses[1]
        np.testing.assert_allclose(losses[0][0], losses[0][1], rtol=0,
                                   atol=2e-6)


def test_data_parallel_mesh_wraps_the_executor():
    """A mesh with only a data axis: the reference's plan geometry, the
    executor wrapped in ``ShardedExecutor`` (params replicated), and the
    abstract batch one rank's block."""
    from conftest import host_mesh
    shape = configs.SHAPES["train_4k"]
    got = steps.build_train_step(configs.get_reduced("qwen2-1.5b"), shape,
                                 num_microbatches=8, executor="flat",
                                 mesh=mesh_lib.make_host_mesh(data=2),
                                 budget_bytes=V5E, device="cpu")
    want = jsteps.build_train_step(jconfigs.get_reduced("qwen2-1.5b"),
                                   shape, num_microbatches=8,
                                   executor="flat", mesh=host_mesh(2))
    for f in ("micro_batch_size", "num_micro_batches", "data_parallel",
              "local_micro", "remat_policy"):
        assert getattr(got.plan, f) == getattr(want.plan, f), f
    assert isinstance(got.fn.__self__, engine.ShardedExecutor)
    assert got.arg_shapes[2]["tokens"].shape == (8, 16, shape.seq_len)


def test_default_budget_is_the_card():
    with pytest.raises(ValueError, match="pass budget_bytes"):
        steps.build_train_step(configs.get("qwen2-1.5b"),
                               configs.SHAPES["train_4k"],
                               num_microbatches=None, device="cpu")


def test_abstract_params_allocate_nothing_for_the_largest_model():
    cfg = configs.get("grok-1-314b")
    params = steps.abstract_params(cfg)
    leaves = tree.leaves(params)
    assert all(x.device.type == "meta" for x in leaves)
    assert _layout(params) == _layout(jsteps.abstract_params(
        jconfigs.get("grok-1-314b")))
    assert sum(x.numel() for x in leaves) > 3e11
    state = steps.abstract_opt_state(steps.make_optimizer(cfg), params)
    assert _layout(state["mom"]) == _layout(params)
    assert state["step"].dtype == torch.int32
