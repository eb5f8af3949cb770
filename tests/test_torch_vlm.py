"""The VLM backbone (qwen2-vl-72b) in the port against the JAX package:
``apply_mrope`` (and its equal-streams twin of plain RoPE), attention
under M-RoPE, the ``vision_proj`` prefix, the forward with patch
embeddings and M-RoPE streams, loss gradients leaf by leaf, one MBS step
of each of the four executors with the streams split before the plan's
split, prefill and decode, ``plan_serve``, the planner's numbers, a
checkpoint round trip, the text-only launcher and the refusals of a
mis-split streams leaf — on the same numpy inputs and the reference's
parameters (``weights.from_reference``).

Tolerance: fp32, atol 1e-5 / rtol 1e-5 (XLA and torch sum the products in
other orders), gradients and the updated state 1e-4 as in
``test_torch_families.py``; prefill and decode against the forward 1e-4
(``tests/test_decode_consistency.py``'s bound). Shapes, plans and byte
counts are integers and must be equal.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_executor  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.core import memory_model as jmm  # noqa: E402
from repro.engine import serving as jserving  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.engine import serving  # noqa: E402
from repro_torch.engine.sharded import batch_partition_specs  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import attention, nn, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_ATOL = 1e-4
DECODE_ATOL = 1e-4
ARCH = "qwen2-vl-72b"
EXECUTORS = ("compiled", "streaming", "fused", "flat")
B, S, N_VIS = 4, 16, 4  # N_VIS patches on a 2 x 2 grid, then text


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_reduced(ARCH)
    p = _np(jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, configs.get_reduced(ARCH), p


def _batch(seed, vision=True, sample_weight=None):
    """Tokens and labels; with ``vision`` N_VIS patch embeddings and
    their (3, B, S) streams, which differ over the image."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if vision:
        b["vision_embeds"] = _rand(seed + 100, (B, N_VIS, 1280))
        b["mrope_positions"] = steps.mrope_positions(B, S, N_VIS)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    """Three streams that differ, qwen2-vl's uneven sections; rotated in
    fp32 and cast back."""
    x = jnp.asarray(_rand(0, (2, 6, 3, 32)), dtype)
    pos = np.random.default_rng(1).integers(0, 50, (3, 2, 6)).astype(
        np.int32)
    want = jnn.apply_mrope(x, jnp.asarray(pos), 1e6, (4, 6, 6))
    got = nn.apply_mrope(weights.from_reference({"x": np.asarray(x)},
                                                "cpu")["x"], _t(pos), 1e6,
                         (4, 6, 6))
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32), f"mrope [{dtype}]",
           atol=ATOL if dtype == "float32" else 1e-2)


def test_mrope_equals_rope_when_positions_equal():
    """``tests/test_layers.py``'s twin: identical t/h/w streams give plain
    RoPE, and both equal the reference's."""
    x = _rand(2, (2, 6, 2, 24))
    pos = np.broadcast_to(np.arange(6)[None], (2, 6)).astype(np.int32)
    mpos = np.broadcast_to(pos[None], (3, 2, 6))
    a = nn.apply_rope(_t(x), _t(pos), 1e4)
    b = nn.apply_mrope(_t(x), _t(mpos), 1e4, (4, 4, 4))
    _close(a, b.numpy(), "mrope == rope")
    _close(b, jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4),
           "mrope == reference rope")
    with pytest.raises(ValueError, match="head_dim/2"):
        nn.apply_mrope(_t(x), _t(mpos), 1e4, (4, 4, 3))


@pytest.mark.parametrize("streams", ["given", "none"])
def test_attn_block_mrope_matches_reference(streams):
    """M-RoPE applies only with both ``mrope_sections`` and the streams;
    without the streams the block is plain RoPE, as in the reference."""
    kw = dict(name="a", family="vlm", num_layers=1, d_model=32,
              num_heads=4, num_kv_heads=2, head_dim=8, d_ff=48,
              vocab_size=64, qkv_bias=True, mrope_sections=(1, 1, 2),
              is_vlm=True)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = _np(jattention.attn_init(jax.random.PRNGKey(3), jcfg))
    x = _rand(4, (2, 9, 32))
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32)
    mpos = (np.random.default_rng(5).integers(0, 9, (3, 2, 9)).astype(
        np.int32) if streams == "given" else None)
    want, (jk, _) = jattention.attn_block(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
        jnp.asarray(pos), compute_dtype=jnp.float32,
        mrope_positions=None if mpos is None else jnp.asarray(mpos))
    got, (k, _) = attention.attn_block(
        weights.from_reference(p, "cpu"), cfg, _t(x), _t(pos),
        compute_dtype=torch.float32,
        mrope_positions=None if mpos is None else _t(mpos))
    _close(got, want, f"attention [{streams}]")
    _close(k, jk, f"rotated keys [{streams}]")


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(model):
    """The reference's tree with ``vision_proj`` (1280 → d_model) and the
    untied head; ``weights`` carries it across and back exactly."""
    _, cfg, p = model
    got = transformer.init_params(cfg, seed=0, device="cpu")
    assert tuple(got["vision_proj"]["w"].shape) == (1280, cfg.d_model)
    assert "unembed" in got and set(got) == set(p)
    assert [tuple(t.shape) for t in tree.leaves(got)] == \
        [x.shape for x in jax.tree.leaves(p)]
    back = weights.to_reference(weights.from_reference(p, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    assert transformer.VISION_EMBED_DIM == jtransformer.VISION_EMBED_DIM
    assert steps.N_VISION_TOKENS == jsteps.N_VISION_TOKENS


@pytest.mark.parametrize("inputs", ["vision", "text"])
@pytest.mark.parametrize("policy", ["none", "dots", "full"])
def test_forward_matches_reference(model, inputs, policy):
    """Patch embeddings over the first N_VIS positions and M-RoPE over
    streams that differ; or text only (plain RoPE)."""
    jcfg, cfg, p = model
    b = _batch(0, vision=inputs == "vision")
    kw = {k: b[k] for k in ("vision_embeds", "mrope_positions") if k in b}
    want, _ = jax.jit(lambda q, t, kw_: jtransformer.forward(
        q, jcfg, t, dtype=jnp.float32, remat_policy=policy, **kw_))(
        p, jnp.asarray(b["tokens"]),
        {k: jnp.asarray(v) for k, v in kw.items()})
    got, aux = transformer.forward(
        weights.from_reference(p, "cpu"), cfg, _t(b["tokens"]),
        dtype=torch.float32, remat_policy=policy,
        **{k: _t(v) for k, v in kw.items()})
    assert tuple(got.shape) == (B, S, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want, f"logits [{inputs}, {policy}]")


def test_vision_and_streams_change_the_logits(model):
    """The patches replace the prefix's token embeddings, and M-RoPE over
    streams that differ is not plain RoPE; equal streams are."""
    _, cfg, p = model
    tp = weights.from_reference(p, "cpu")
    b = _batch(1)
    toks, vis = _t(b["tokens"]), _t(b["vision_embeds"])
    fwd = lambda **kw: transformer.forward(tp, cfg, toks,  # noqa: E731
                                           dtype=torch.float32, **kw)[0]
    text = fwd()
    plain = fwd(vision_embeds=vis)
    mrope = fwd(vision_embeds=vis, mrope_positions=_t(b["mrope_positions"]))
    equal = fwd(vision_embeds=vis, mrope_positions=torch.arange(S).expand(
        3, B, S))
    assert not torch.allclose(text, plain, atol=1e-3)
    assert not torch.allclose(plain, mrope, atol=1e-3)
    _close(equal, plain.numpy(), "equal streams == plain RoPE")


@pytest.mark.parametrize("inputs", ["vision", "text"])
def test_loss_and_grads_match_reference(model, inputs):
    """``make_loss_fn`` passes the patches and streams through; text-only
    leaves ``vision_proj`` a zero gradient in both packages."""
    jcfg, cfg, p = model
    b = _batch(2, vision=inputs == "vision",
               sample_weight=[1.0, 0.5, 1.0, 0.0])
    jloss = jsteps.make_loss_fn(jcfg, dtype=jnp.float32, remat_policy="dots")
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda q, jb: jloss(q, jb, exact_denom=3.0), has_aux=True))(
        p, {k: jnp.asarray(v) for k, v in b.items()})
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="dots")
    leaves, td = tree.flatten(weights.from_reference(p, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, _ = loss_fn(tree.unflatten(td, leaves),
                      {k: _t(v) for k, v in b.items()}, exact_denom=3.0)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    _close(loss.item(), want, f"loss [{inputs}]")
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, jg, f"grads [{inputs}]", atol=GRAD_ATOL, rtol=GRAD_ATOL)
    vis = jax.tree.leaves(jgrads["vision_proj"])[0]
    assert (np.abs(np.asarray(vis)).max() > 0) == (inputs == "vision")


@pytest.fixture(scope="module", params=["vision", "text"])
def reference_step(request, model):
    """One mini-batch of 4 in 2 micro-batches of 2 through the
    reference's ``compiled`` executor, the streams split as its
    ``abstract_train_batch`` lays them out (N_Smu, 3, N_mu, S)."""
    jcfg, cfg, p = model
    jplan = jengine.plan_mbs(B, micro_batch_size=2, remat_policy="none")
    jopt = joptim.sgd(0.05, 0.9, 5e-4)
    jex = make_executor("compiled", jsteps.make_loss_fn(
        jcfg, dtype=jnp.float32, remat_policy="none"), jopt, jplan,
        donate=False)
    batch = _batch(3, vision=request.param == "vision")
    split = jplan.device_split({k: v for k, v in batch.items()
                                if k != "mrope_positions"})
    if "mrope_positions" in batch:
        split["mrope_positions"] = jnp.asarray(
            batch["mrope_positions"].reshape(3, 2, 2, S).transpose(1, 0, 2,
                                                                   3))
    jp = jax.tree.map(jnp.asarray, p)
    jnew, jstate, jm = jex.step_split(jp, jopt.init(jp), split)
    return batch, _np(jnew), _np(jstate), float(jm["loss"])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_mbs_step_matches_reference(model, reference_step, executor):
    """Each of the port's four executors hands the loss one micro-batch's
    (3, N_mu, S) streams (``steps.device_split``); loss, params and
    momentum against the reference's step. Text-only, ``vision_proj``
    moves by weight decay alone in both."""
    jcfg, cfg, p = model
    batch, jnew, jstate, jloss = reference_step
    plan = engine.plan_mbs(B, micro_batch_size=2, remat_policy="none",
                           device="cpu")
    opt = optim.sgd(0.05, 0.9, 5e-4)
    seen = []
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="none")

    def spy(params, mb, exact_denom=None):
        seen.append(tuple(mb["mrope_positions"].shape)
                    if "mrope_positions" in mb else None)
        return loss_fn(params, mb, exact_denom=exact_denom)

    ex = engine.get_executor(executor)(spy, opt, plan)
    tp = weights.from_reference(p, "cpu")
    new, state, m = ex.step_split(tp, opt.init(tp),
                                  steps.device_split(plan, batch, "cpu"))
    vision = "mrope_positions" in batch
    assert seen == [(3, 2, S) if vision else None] * 2
    assert math.isfinite(float(m["loss"]))
    _close(float(m["loss"]), jloss, f"{executor} loss")
    for what, got, want in (("params", new, jnew), ("state", state, jstate)):
        gl, wl = tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            _close(g, w, f"{executor} {what}", atol=GRAD_ATOL,
                   rtol=GRAD_ATOL)
    if not vision:
        w0 = p["vision_proj"]["w"]
        _close(new["vision_proj"]["w"], w0 - 0.05 * 5e-4 * w0,
               "text-only vision_proj: weight decay alone")


def test_mis_split_streams_are_refused(model):
    """The plan's split cuts every leaf on axis 0, so the streams are
    split apart: a whole-batch leaf reaching the model, a ragged plan
    (which would pad them) and the data-parallel block (whose sample dim
    the streams' axis could shadow) are refused by name."""
    _, cfg, p = model
    tp = weights.from_reference(p, "cpu")
    b = _batch(4)
    with pytest.raises(ValueError, match="mrope_positions"):
        transformer.forward(tp, cfg, _t(b["tokens"][:2]),
                            mrope_positions=_t(b["mrope_positions"]),
                            dtype=torch.float32)
    ragged = engine.plan_mbs(B, micro_batch_size=3, device="cpu")
    with pytest.raises(ValueError, match="mrope_positions"):
        steps.device_split(ragged, b, "cpu")
    plan = engine.plan_mbs(B, micro_batch_size=2, device="cpu")
    split = steps.device_split(plan, b, "cpu")
    with pytest.raises(ValueError, match="mrope_positions"):
        batch_partition_specs(split, 2, ("data",))


def test_prefill_and_decode_match_forward_and_reference(model):
    """Prefill with the patches and streams against the reference's, then
    text-only decode (plain RoPE, as the reference's ``decode_step``)
    against the full text-only forward."""
    jcfg, cfg, p = model
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    b = _batch(5)
    last, _ = transformer.prefill(
        tp, cfg, _t(b["tokens"]), 24, dtype=torch.float32,
        vision_embeds=_t(b["vision_embeds"]),
        mrope_positions=_t(b["mrope_positions"]))
    jlast, _ = jtransformer.prefill(
        jp, jcfg, jnp.asarray(b["tokens"]), max_len=24, dtype=jnp.float32,
        vision_embeds=jnp.asarray(b["vision_embeds"]),
        mrope_positions=jnp.asarray(b["mrope_positions"]))
    _close(last, jlast, "prefill with vision")
    toks = _t(b["tokens"])
    full, _ = transformer.forward(tp, cfg, toks, dtype=torch.float32)
    _, cache = transformer.prefill(tp, cfg, toks[:, :10], 24,
                                   dtype=torch.float32)
    for t in range(10, S):
        lg, cache = transformer.decode_step(
            tp, cfg, toks[:, t:t + 1], cache,
            torch.full((B,), t, dtype=torch.int32), dtype=torch.float32)
        _close(lg[:, 0], full[:, t].detach(), f"decode [{t}]",
               atol=DECODE_ATOL, rtol=0)


def test_served_text_only_as_the_reference_plans(model):
    """``plan_serve`` equals the reference's field for field (the reduced
    and the full config); the engine serves requests text-only and
    finishes them all."""
    jcfg, cfg, p = model
    for c, jc in ((cfg, jcfg), (configs.get(ARCH), jconfigs.get(ARCH))):
        for budget in (1 << 28, 1 << 40):
            kw = dict(budget_bytes=budget, max_len=64)
            got = want = ValueError
            try:
                got = dataclasses.asdict(serving.plan_serve(c, **kw))
            except ValueError:
                pass
            try:
                want = dataclasses.asdict(jserving.plan_serve(jc, **kw))
            except ValueError:
                pass
            assert got == want, (c.name, budget)
    plan = serving.plan_serve(cfg, budget_bytes=1 << 28, max_len=32)
    eng = serving.ServingEngine(weights.from_reference(p, "cpu"), cfg, plan,
                                dtype=torch.float32,
                                cache_dtype=torch.float32)
    reqs = list(serving.synthetic_traffic(5, rate_rps=500.0,
                                          prompt_lens=(4, 9),
                                          new_tokens=(3, 5),
                                          vocab_size=cfg.vocab_size, seed=0))
    rep = eng.run(reqs, warmup_prompt_lens=[r.prompt_len for r in reqs])
    assert rep["requests"]["finished"] == 5
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)


# ---------------------------------------------------------------------------
# config, planner, checkpoint, launcher
# ---------------------------------------------------------------------------

def test_configs_equal_reference_and_assignment():
    """``test_arch_smoke.py``'s full-config row, and both configs field
    for field."""
    assert dataclasses.asdict(configs.get(ARCH)) == \
        dataclasses.asdict(jconfigs.get(ARCH))
    assert dataclasses.asdict(configs.get_reduced(ARCH)) == \
        dataclasses.asdict(jconfigs.get_reduced(ARCH))
    c = configs.get(ARCH)
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
            c.vocab_size) == (80, 8192, 64, 8, 29568, 152064)
    assert c.is_vlm and c.mrope_sections == (16, 24, 24) and \
        sum(c.mrope_sections) * 2 == c.head_dim and not c.tie_embeddings


@pytest.mark.parametrize("layers", [None, 1])
def test_param_shapes_and_estimate_equal_reference(layers):
    """``param_shapes`` against the reference's ``abstract_params``, and
    ``estimate`` term by term, for the full config and its 1-layer cut."""
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    got = memory_model.param_shapes(cfg)
    want = jsteps.abstract_params(jcfg)
    assert [tuple(x.shape) for x in tree.leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    for policy in ("none", "dots", "period", "full"):
        kw = dict(opt_slots=1, act_bytes=2, fused_update=True)
        e = memory_model.estimate(cfg, 1024, remat_policy=policy, **kw)
        je = jmm.estimate(jcfg, 1024, remat_policy=policy, **kw)
        assert dataclasses.asdict(e) == dataclasses.asdict(je), policy


@pytest.mark.parametrize("budget_gib", [1, 60, 72])
@pytest.mark.parametrize("policy", [None, "auto", "full"])
def test_plan_mbs_equals_reference(budget_gib, policy):
    """The 1-layer cut at seq 1024, as the card runs it."""
    cfg = dataclasses.replace(configs.get(ARCH), num_layers=1)
    jcfg = dataclasses.replace(jconfigs.get(ARCH), num_layers=1)
    fields = [f.name for f in dataclasses.fields(engine.MBSPlan)]
    kw = dict(seq_len=1024, budget_bytes=int(budget_gib * 2 ** 30),
              remat_policy=policy)
    out = []
    for pkg, c, o in ((engine, cfg, optim), (jengine, jcfg, joptim)):
        extra = {"device": "cpu"} if pkg is engine else {}
        try:
            out.append(pkg.plan_mbs(8, model_cfg=c, **kw, **extra,
                                    **o.memory_model_kw(o.sgd(0.05, 0.9),
                                                        fused=True)))
        except ValueError as e:
            out.append(type(e))
    got, want = out
    if isinstance(want, type):
        assert got is want
        return
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if f == "accum_dtype":
            g, w = str(g).replace("torch.", ""), jnp.dtype(w).name
        assert g == w, f
    assert got.describe() == want.describe()


def test_family_batch_matches_abstract_train_batch(model):
    """The probe's batch (``family_batch`` split by ``device_split``) has
    the leaves, shapes and dtypes of the reference's
    ``abstract_train_batch``: 256 patch embeddings in the activation
    dtype and the streams as (N_Smu, 3, N_mu, S)."""
    jcfg, cfg, _ = model
    plan = engine.plan_mbs(6, micro_batch_size=2, device="cpu")
    jplan = jengine.plan_mbs(6, micro_batch_size=2)
    got = steps.device_split(plan, steps.family_batch(cfg, 512, 6), "cpu",
                             torch.bfloat16)
    want = jsteps.abstract_train_batch(jcfg, 512, jplan)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == \
            jnp.dtype(v.dtype).name, k
    pos = got["mrope_positions"][0, :, 0]  # (3, S): the image differs
    assert not torch.equal(pos[0], pos[1]) and torch.equal(
        pos[:, 256:], pos[:1, 256:].expand(3, -1))


def test_checkpoint_round_trip_across_packages(tmp_path, model):
    """Params (``vision_proj`` and the untied head included) and momentum
    saved by the port restore exactly in the port and in the reference."""
    _, cfg, p = model
    tp = weights.from_reference(p, "cpu")
    state = {"params": tp, "opt_state": {
        "mom": tree.map(lambda x: x * 0.5 - 1.0, tp),
        "step": torch.tensor(2, dtype=torch.int32)}}
    ckpt_lib.save(str(tmp_path), 2, state)
    fresh = transformer.init_params(cfg, seed=1, device="cpu")
    got = ckpt_lib.restore(str(tmp_path), {"params": fresh, "opt_state": {
        "mom": tree.map(torch.zeros_like, fresh),
        "step": torch.tensor(0, dtype=torch.int32)}}, 2)
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert torch.equal(a, b)
    jstate = jax.tree.map(jnp.asarray, weights.to_reference(state))
    back = jckpt.restore(str(tmp_path), jstate, 2)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launcher_trains_text_only():
    """``--arch qwen2-vl-72b`` trains as the reference's launcher feeds
    it: ``LMDataset`` tokens, no patches, plain RoPE; every loss finite
    and ``vision_proj`` moved by weight decay alone."""
    out = train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                      "--executor", "flat", "--device", "cpu",
                      "--log-every", "1", "--lr", "0.05"])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    cfg = out["config"]
    w0 = transformer.init_params(cfg, seed=0, device="cpu")["vision_proj"][
        "w"]
    w = out["params"]["vision_proj"]["w"]
    assert not torch.equal(w, w0)
    ratio = (w / w0)[w0.abs() > 1e-3]
    assert float(ratio.max() - ratio.min()) < 1e-5  # a uniform shrink
