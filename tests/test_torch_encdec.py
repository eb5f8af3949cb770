"""The encoder-decoder family (seamless-m4t-medium) in the port against
the JAX package: ``layernorm``, the non-gated ``gelu`` FFN and MoE
expert, ``cross_attn_block``, the encoder, the teacher-forced forward,
loss gradients leaf by leaf, one MBS step of each of the four
executors, ``decode_step`` against ``forward`` and against the
reference's, the planner's numbers, a checkpoint round trip and the
serving and launcher refusals — on the same numpy inputs and the
reference's parameters (``weights.from_reference``).

Tolerance: fp32, atol 1e-5 / rtol 1e-5 (XLA and torch sum the products in
other orders), gradients and the updated state 1e-4 as in
``test_torch_families.py``; decode against the full forward 1e-4, the
reference's own bound (``tests/test_decode_consistency.py``). Shapes,
plans and byte counts are integers and must be equal.
"""
import dataclasses
import json
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
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.engine import serving  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import attention, encdec, moe, nn, transformer  # noqa: E402,E501
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL = RTOL = 1e-5
GRAD_ATOL = 1e-4
DECODE_ATOL = 1e-4
ARCH = "seamless-m4t-medium"
EXECUTORS = ("compiled", "streaming", "fused", "flat")
B, S_ENC = 4, 16  # S_ENC // steps.AUDIO_TGT_FRACTION target tokens


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


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_reduced(ARCH)
    p = _np(jencdec.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, configs.get_reduced(ARCH), p


def _batch(cfg, seed, sample_weight=None):
    b = steps.family_batch(cfg, S_ENC, B, seed=seed)
    if sample_weight is not None:
        b["sample_weight"] = np.asarray(sample_weight, np.float32)
    return b


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """Scale, then bias (no ``1 +``), in fp32, cast back."""
    x = _rand(0, (2, 5, 24), 3.0) + 1.5
    p = {"scale": _rand(1, (24,)), "bias": _rand(2, (24,))}
    jx = jnp.asarray(x, dtype)
    want = jnn.layernorm(jax.tree.map(jnp.asarray, p), jx)
    got = nn.layernorm(weights.from_reference(p, "cpu"),
                       weights.from_reference({"x": np.asarray(jx)},
                                              "cpu")["x"])
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32), f"layernorm [{dtype}]",
           atol=ATOL if dtype == "float32" else 1e-2)
    init = nn.layernorm_init(24)
    assert torch.equal(init["scale"], torch.ones(24))
    assert torch.equal(init["bias"], torch.zeros(24))


def test_gelu_ffn_matches_reference():
    """The non-gated FFN with ``jax.nn.gelu``'s tanh approximation: its
    tree has no ``w_gate``."""
    p = _np(jnn.ffn_init(jax.random.PRNGKey(3), 16, 40, "gelu"))
    assert "w_gate" not in p and set(
        nn.ffn_init(torch.Generator().manual_seed(0), 16, 40, "gelu")) == \
        {"w_up", "w_down"}
    x = _rand(4, (3, 7, 16))
    want = jnn.ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "gelu")
    got = nn.ffn(weights.from_reference(p, "cpu"), _t(x), "gelu")
    _close(got, want, "gelu ffn")
    with pytest.raises(ValueError):
        nn.ffn(weights.from_reference(p, "cpu"), _t(x), "relu")


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_gelu_moe_matches_reference(capacity_factor):
    """The ``gelu`` expert (no ``w_gate``) inside the whole MoE block, at
    a capacity that drops no token and one that drops some."""
    kw = dict(name="moe-gelu", family="moe", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
              vocab_size=64, num_experts=4, experts_per_token=2,
              moe_d_ff=24, ffn_kind="gelu", capacity_factor=capacity_factor)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = _np(jmoe.moe_init(jax.random.PRNGKey(5), jcfg))
    assert "w_gate" not in p
    x = _rand(6, (2, 9, 32))
    want, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(x), compute_dtype=jnp.float32)
    got, aux = moe.moe_block(weights.from_reference(p, "cpu"), cfg, _t(x),
                             compute_dtype=torch.float32)
    _close(got, want, "moe out")
    _close(aux, jaux, "moe aux")
    e = _rand(7, (4, 5, 32))
    _close(moe._expert_ffn(weights.from_reference(p, "cpu"), _t(e), "gelu"),
           jmoe._expert_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(e),
                            "gelu", 4), "gelu experts")


@pytest.mark.parametrize("cached", [False, True])
def test_cross_attn_block_matches_reference(cached):
    """Queries of the decoder over the encoder's frames: projected here
    (``kv_src``) or precomputed (``kv_cache``), some frames masked out by
    ``src_valid``; no RoPE, no causal mask, GQA."""
    kw = dict(name="x", family="audio", num_layers=1, d_model=32,
              num_heads=4, num_kv_heads=2, head_dim=8, d_ff=48,
              vocab_size=64, qkv_bias=True, encoder_layers=1)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = _np(jattention.attn_init(jax.random.PRNGKey(8), jcfg))
    p["wq"]["b"] = _rand(9, p["wq"]["b"].shape)
    x, src = _rand(10, (2, 5, 32)), _rand(11, (2, 7, 32))
    valid = np.ones((2, 7), bool)
    valid[1, 4:] = False
    jp, tp = jax.tree.map(jnp.asarray, p), weights.from_reference(p, "cpu")
    want, (jk, jv) = jattention.cross_attn_block(
        jp, jcfg, jnp.asarray(x), kv_src=jnp.asarray(src),
        src_valid=jnp.asarray(valid), compute_dtype=jnp.float32)
    if cached:
        kv = jattention.cross_attn_block(jp, jcfg, jnp.asarray(x),
                                         kv_src=jnp.asarray(src))[1]
        got, (k, v) = attention.cross_attn_block(
            tp, cfg, _t(x), kv_cache=tuple(_t(np.asarray(a)) for a in kv),
            src_valid=_t(valid), compute_dtype=torch.float32)
    else:
        got, (k, v) = attention.cross_attn_block(
            tp, cfg, _t(x), kv_src=_t(src), src_valid=_t(valid),
            compute_dtype=torch.float32)
    assert tuple(k.shape) == (2, 7, 2, 8)
    _close(got, want, f"cross attention [cached={cached}]")
    _close(k, jk, "k")
    _close(v, jv, "v")


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def test_param_tree_matches_reference(model):
    """Keys, nesting, the (L,) stacking and every shape; ``weights``
    carries the tree across and back exactly (no 4-D ``w`` leaf, so
    nothing is transposed)."""
    jcfg, cfg, p = model
    got = encdec.init_params(cfg, seed=0, device="cpu")
    assert set(got) == set(p) == {"embed", "enc_layers", "enc_norm",
                                  "dec_layers", "final_norm"}
    gl = tree.leaves(got)
    want = jax.tree.leaves(p)
    assert [tuple(t.shape) for t in gl] == [x.shape for x in want]
    assert p["enc_layers"]["attn"]["wq"]["w"].shape[0] == cfg.encoder_layers
    assert p["dec_layers"]["cross_attn"]["wq"]["w"].shape[0] == \
        cfg.num_layers
    back = weights.to_reference(weights.from_reference(p, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["none", "full"])
def test_encode_matches_reference(model, policy):
    jcfg, cfg, p = model
    frames = _rand(12, (2, S_ENC, cfg.d_model))
    want = jax.jit(lambda q, f: jencdec.encode(
        q, jcfg, f, dtype=jnp.float32, remat_policy=policy))(
        p, jnp.asarray(frames))
    got = encdec.encode(weights.from_reference(p, "cpu"), cfg, _t(frames),
                        dtype=torch.float32, remat_policy=policy)
    assert tuple(got.shape) == (2, S_ENC, cfg.d_model)
    _close(got, want, f"encode [{policy}]")


@pytest.mark.parametrize("policy", ["none", "dots", "period", "full"])
def test_forward_matches_reference(model, policy):
    jcfg, cfg, p = model
    b = _batch(cfg, 0)
    want, jaux = jax.jit(lambda q, f, t: jencdec.forward(
        q, jcfg, f, t, dtype=jnp.float32, remat_policy=policy))(
        p, jnp.asarray(b["frames"]), jnp.asarray(b["tgt_tokens"]))
    got, aux = encdec.forward(weights.from_reference(p, "cpu"), cfg,
                              _t(b["frames"]), _t(b["tgt_tokens"]),
                              dtype=torch.float32, remat_policy=policy)
    assert tuple(got.shape) == (B, S_ENC // 4, cfg.vocab_size)
    assert got.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    _close(got, want, f"logits [{policy}]")


@pytest.mark.parametrize("exact_denom", [None, 3.0])
def test_loss_and_grads_match_reference(model, exact_denom):
    """``make_loss_fn``'s enc-dec branch (``frames``, ``tgt_tokens``)
    with a half-weight sample, gradients leaf by leaf against
    ``jax.grad``."""
    jcfg, cfg, p = model
    b = _batch(cfg, 1, sample_weight=[1.0, 0.5, 1.0, 0.0])
    jloss = jsteps.make_loss_fn(jcfg, dtype=jnp.float32, remat_policy="dots")
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda q, jb: jloss(q, jb, exact_denom=exact_denom),
        has_aux=True))(p, {k: jnp.asarray(v) for k, v in b.items()})
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="dots")
    leaves, td = tree.flatten(weights.from_reference(p, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, m = loss_fn(tree.unflatten(td, leaves),
                      {k: _t(v) for k, v in b.items()},
                      exact_denom=exact_denom)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), want, f"loss [{exact_denom}]")
    assert float(m["aux_loss"]) == 0.0
    jl = jax.tree.leaves(jgrads)
    assert len(grads) == len(jl)
    for g, jg in zip(grads, jl):
        _close(g, jg, f"grads [{exact_denom}]", atol=GRAD_ATOL,
               rtol=GRAD_ATOL)


@pytest.fixture(scope="module")
def reference_step(model):
    """One mini-batch of 4 in 2 micro-batches of 2 through the
    reference's ``compiled`` executor: (batch, params, state, metrics)."""
    jcfg, cfg, p = model
    jplan = jengine.plan_mbs(B, micro_batch_size=2, remat_policy="none")
    jopt = joptim.sgd(0.05, 0.9, 5e-4)
    jex = make_executor("compiled", jsteps.make_loss_fn(
        jcfg, dtype=jnp.float32, remat_policy="none"), jopt, jplan,
        donate=False)
    batch = _batch(cfg, 3)
    jp = jax.tree.map(jnp.asarray, p)
    jnew, jstate, jm = jex.step_split(jp, jopt.init(jp),
                                      jplan.device_split(batch))
    return batch, _np(jnew), _np(jstate), float(jm["loss"])


@pytest.mark.parametrize("executor", EXECUTORS)
def test_mbs_step_matches_reference(model, reference_step, executor):
    """``test_arch_smoke.py``'s MBS step for this family: each of the
    port's four executors (K1, K2 on their plain versions here) against
    the reference's step — loss, params and momentum."""
    jcfg, cfg, p = model
    batch, jnew, jstate, jloss = reference_step
    plan = engine.plan_mbs(B, micro_batch_size=2, remat_policy="none",
                           device="cpu")
    opt = optim.sgd(0.05, 0.9, 5e-4)
    ex = engine.get_executor(executor)(steps.make_loss_fn(
        cfg, dtype=torch.float32, remat_policy="none"), opt, plan)
    tp = weights.from_reference(p, "cpu")
    new, state, m = ex.step_split(tp, opt.init(tp),
                                  steps.device_split(plan, batch, "cpu"))
    assert math.isfinite(float(m["loss"]))
    _close(float(m["loss"]), jloss, f"{executor} loss")
    for what, got, want in (("params", new, jnew), ("state", state, jstate)):
        gl, wl = tree.leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            _close(g, w, f"{executor} {what}", atol=GRAD_ATOL,
                   rtol=GRAD_ATOL)


def test_decode_matches_forward_and_reference():
    """``tests/test_decode_consistency.py``'s enc-dec case: the encoder
    once, the cross K/V projected once, then 8 teacher-forced tokens
    through the self-attention ring — each step's logits against the
    full forward's (1e-4) and against the reference's ``decode_step``."""
    kw = dict(name="ed", family="audio", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
              vocab_size=128, ffn_kind="gelu", encoder_layers=2)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = _np(jencdec.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = weights.from_reference(p, "cpu")
    frames = _rand(2, (2, 12, 64))
    toks = np.random.default_rng(1).integers(0, 128, (2, 9)).astype(
        np.int32)
    full, _ = encdec.forward(tp, cfg, _t(frames), _t(toks),
                             dtype=torch.float32, remat=False)
    cache = encdec.init_decode_cache(tp, cfg, _t(frames), 16, torch.float32)
    assert tuple(cache["self"]["k"].shape) == (2, 2, 16, 4, 16)
    assert tuple(cache["cross"]["k"].shape) == (2, 2, 12, 4, 16)
    jcache = jencdec.init_decode_cache(p, jcfg, jnp.asarray(frames), 16,
                                       jnp.float32)
    for name in ("k", "v"):
        _close(cache["cross"][name], jcache["cross"][name], f"cross {name}")
    jstep = jax.jit(lambda q, t, c, ps: jencdec.decode_step(
        q, jcfg, t, c, ps, dtype=jnp.float32))
    for t in range(8):
        pos = np.full((2,), t, np.int32)
        lg, out = encdec.decode_step(tp, cfg, _t(toks[:, t:t + 1]), cache,
                                     _t(pos), dtype=torch.float32)
        assert out is cache  # the rings are written in place
        jlg, jcache = jstep(p, jnp.asarray(toks[:, t:t + 1]), jcache,
                            jnp.asarray(pos))
        assert tuple(lg.shape) == (2, 1, 128)
        _close(lg[:, 0], full[:, t].detach(), f"decode vs forward [{t}]",
               atol=DECODE_ATOL, rtol=0)
        _close(lg, jlg, f"decode vs reference [{t}]")
    _close(cache["self"]["k"], jcache["self"]["k"], "self ring k")
    np.testing.assert_array_equal(cache["self"]["pos"].numpy(),
                                  np.asarray(jcache["self"]["pos"]))


# ---------------------------------------------------------------------------
# config, planner, checkpoint, refusals
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
            c.vocab_size) == (12, 1024, 16, 16, 4096, 256206)
    assert c.is_encdec and c.encoder_layers == 12 and c.ffn_kind == "gelu"


@pytest.mark.parametrize("reduced", [True, False])
def test_param_shapes_and_estimate_equal_reference(reduced):
    """``param_shapes`` (a fake-tensor ``encdec.init_params``) against
    the reference's ``abstract_params`` (``jax.eval_shape``), and ``estimate`` term by term,
    for every remat policy."""
    cfg = configs.get_reduced(ARCH) if reduced else configs.get(ARCH)
    jcfg = jconfigs.get_reduced(ARCH) if reduced else jconfigs.get(ARCH)
    got = memory_model.param_shapes(cfg)
    want = jsteps.abstract_params(jcfg)
    assert [tuple(x.shape) for x in tree.leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
    for policy in ("none", "dots", "period", "full"):
        for kw in (dict(opt_slots=1, act_bytes=2, fused_update=True),
                   dict(opt_slots=2, act_bytes=4)):
            e = memory_model.estimate(cfg, 4096, remat_policy=policy, **kw)
            je = jmm.estimate(jcfg, 4096, remat_policy=policy, **kw)
            assert dataclasses.asdict(e) == dataclasses.asdict(je), policy
            assert e.total(3) == je.total(3)


@pytest.mark.parametrize("budget_gib", [0.0625, 1, 16, 60])
@pytest.mark.parametrize("policy", [None, "auto", "dots"])
def test_plan_mbs_equals_reference(budget_gib, policy):
    fields = [f.name for f in dataclasses.fields(engine.MBSPlan)]
    for mini in (8, 30):
        kw = dict(model_cfg=configs.get(ARCH), seq_len=4096,
                  budget_bytes=int(budget_gib * 2 ** 30),
                  remat_policy=policy,
                  **optim.memory_model_kw(optim.sgd(0.05, 0.9), fused=True))
        jkw = dict(kw, model_cfg=jconfigs.get(ARCH),
                   **joptim.memory_model_kw(joptim.sgd(0.05, 0.9),
                                            fused=True))
        got = want = None
        try:
            got = engine.plan_mbs(mini, device="cpu", **kw)
        except ValueError as e:
            got = type(e)
        try:
            want = jengine.plan_mbs(mini, **jkw)
        except ValueError as e:
            want = type(e)
        if isinstance(want, type):
            assert got is want
            continue
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if f == "accum_dtype":
                g, w = str(g).replace("torch.", ""), jnp.dtype(w).name
            assert g == w, (f, mini, budget_gib, policy)
        assert got.describe() == want.describe()


def test_family_batch_matches_abstract_train_batch(model):
    """The probe's batch (``family_batch`` split by ``device_split``) has
    the leaves, shapes and dtypes of the reference's
    ``abstract_train_batch``: frames in the activation dtype, target
    tokens and labels of seq / AUDIO_TGT_FRACTION."""
    jcfg, cfg, _ = model
    plan = engine.plan_mbs(6, micro_batch_size=2, device="cpu")
    jplan = jengine.plan_mbs(6, micro_batch_size=2)
    got = steps.device_split(plan, steps.family_batch(cfg, 32, 6), "cpu",
                             torch.bfloat16)
    want = jsteps.abstract_train_batch(jcfg, 32, jplan)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).replace("torch.", "") == \
            jnp.dtype(v.dtype).name, k
    assert steps.AUDIO_TGT_FRACTION == jsteps.AUDIO_TGT_FRACTION


def test_checkpoint_round_trip_across_packages(tmp_path, model):
    """The port saves params and momentum; the port and the reference
    restore them exactly, and the reference's file of the same tree has
    the same keys and CRCs."""
    _, cfg, p = model
    tp = weights.from_reference(p, "cpu")
    state = {"params": tp, "opt_state": {
        "mom": tree.map(lambda x: x * 0.5 + 1.0, tp),
        "step": torch.tensor(3, dtype=torch.int32)}}
    ckpt_lib.save(str(tmp_path / "port"), 3, state)
    fresh = encdec.init_params(cfg, seed=1, device="cpu")
    template = {"params": fresh, "opt_state": {
        "mom": tree.map(torch.zeros_like, fresh),
        "step": torch.tensor(0, dtype=torch.int32)}}
    got = ckpt_lib.restore(str(tmp_path / "port"), template, 3)
    for a, b in zip(tree.leaves(got), tree.leaves(state)):
        assert torch.equal(a, b)
    jstate = jax.tree.map(jnp.asarray, weights.to_reference(state))
    assert jstate["opt_state"]["step"].shape == ()  # a 0-d leaf stays 0-d
    back = jckpt.restore(str(tmp_path / "port"), jstate, 3)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.save(str(tmp_path / "ref"), 3, jstate)
    man = [json.loads((tmp_path / d / "ckpt_00000003.json").read_text())
           for d in ("port", "ref")]
    assert man[0]["keys"] == man[1]["keys"] and man[0]["crc"] == man[1]["crc"]


def test_serving_and_the_decoder_stack_refuse_encdec():
    """The serving engine refuses enc-dec with the reference's message,
    before anything is allocated; the decoder-only stack names
    ``models.encdec``."""
    cfg, jcfg = configs.get_reduced(ARCH), jconfigs.get_reduced(ARCH)
    with pytest.raises(ValueError) as want:
        jserving.check_servable(jcfg)
    for call in (lambda: serving.check_servable(cfg),
                 lambda: serving.plan_serve(cfg, budget_bytes=1 << 28,
                                            max_len=24)):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)
    for call in (lambda: transformer.init_params(cfg, device="cpu"),
                 lambda: transformer.init_cache(cfg, 2, 8, device="cpu"),
                 lambda: transformer.forward(
                     {}, cfg, torch.zeros((1, 4), dtype=torch.long))):
        with pytest.raises(ValueError, match="models.encdec"):
            call()


def test_launcher_refuses_encdec_before_allocating(capsys):
    """The reference's launcher feeds ``LMDataset`` tokens to a loss
    that reads ``mb["frames"]``; the port's refuses the arch up front,
    with that reason."""
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", ARCH, "--reduced", "--steps", "1",
                    "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "encoder-decoder" in err and "frames" in err and \
        "family_batch" in err
