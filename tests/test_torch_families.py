"""The ssm (Mamba2 SSD), hybrid (RG-LRU + local attention) and MoE
families in the port against the JAX package: the blocks on the same
numpy inputs and parameters (``weights.from_reference``), the MoE
routing equal index for index before any value is compared, the five
reduced archs' logits, aux loss, loss and gradients (exact normalization
included), one MBS step through ``compiled`` and ``flat``, and the five
configs field for field.

Tolerance: fp32, atol 1e-5 / rtol 1e-5 where both packages run the same
products (XLA and torch sum in other orders). The SSD's inter-chunk
carry is a loop here and an associative scan there, and the RG-LRU's
log-depth scan combines its rounds in another order, so their blocks are
held at atol 1e-4 (``tests/test_layers.py``'s own tolerance for these
scans against a sequential recurrence); routing and keep masks are
integers and must be equal.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import recurrent as jrecurrent  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.data import LMDataset  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe, recurrent, ssm, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL = RTOL = 1e-5
SCAN_ATOL = 1e-4
ARCHS = ["mamba2-780m", "recurrentgemma-2b", "moonshot-v1-16b-a3b",
         "mixtral-8x22b", "grok-1-314b"]
B, S = 2, 20  # S: not a multiple of the reduced ssm chunk (8), > window 16


def _close(got, want, what, atol=ATOL, rtol=RTOL):
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


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B_, S_, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B_, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B_, S_, H)))).astype(
        np.float32)
    A = -np.exp(rng.standard_normal((H,)) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((B_, S_, N)).astype(np.float32)
    Cm = rng.standard_normal((B_, S_, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S_,chunk", [(32, 8), (33, 8), (16, 16), (40, 13)])
def test_ssd_chunked_matches_reference_and_is_chunk_invariant(S_, chunk):
    """``tests/test_layers.py``'s chunk-size cases: the port against the
    reference at the same chunk, and against itself in one chunk; with an
    initial state too."""
    args = _ssd_inputs(3, 2, S_, 3, 8, 4)
    s0 = _rand(5, (2, 3, 8, 4))
    for init in (None, s0):
        y, f = ssm.ssd_chunked(*map(_t, args), chunk,
                               None if init is None else _t(init))
        jy, jf = jax.jit(jssm.ssd_chunked, static_argnums=5)(
            *map(jnp.asarray, args), chunk,
            None if init is None else jnp.asarray(init))
        _close(y, jy, "y", atol=SCAN_ATOL)
        _close(f, jf, "final", atol=SCAN_ATOL)
        y1, f1 = ssm.ssd_chunked(*map(_t, args), S_,
                                 None if init is None else _t(init))
        _close(y, y1, "chunk invariance y", atol=SCAN_ATOL)
        _close(f, f1, "chunk invariance final", atol=SCAN_ATOL)


def test_ssd_matches_sequential_recurrence():
    """h_t = exp(dt·A) h_{t-1} + dt·B x_t, y_t = C_t·h_t, step by step in
    numpy (``tests/test_layers.py``'s reference)."""
    x, dt, A, Bm, Cm = _ssd_inputs(4, 1, 12, 2, 4, 3)
    A = -np.ones((2,), np.float32)
    y, final = ssm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), 4)
    h = np.zeros((1, 2, 4, 3))
    for t in range(12):
        dec = np.exp(dt[:, t] * A)
        xdt = x[:, t] * dt[:, t][..., None]
        h = h * dec[..., None, None] + np.einsum("bn,bhp->bhpn", Bm[:, t],
                                                 xdt)
        _close(y[:, t], np.einsum("bn,bhpn->bhp", Cm[:, t], h), f"y[{t}]",
               atol=SCAN_ATOL)
    _close(final, h, "final", atol=SCAN_ATOL)


def _block_cfgs(**kw):
    base = dict(name="blk", family="t", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=1, head_dim=8, d_ff=48,
                vocab_size=64)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_block_matches_reference(dtype):
    """The whole block (projection, causal conv, SSD, gate, norm) with
    its decode cache entry, from a zero and from a given state; then its
    one-token decode step against the reference's."""
    jcfg, cfg = _block_cfgs(ssm_state=8, ssm_head_dim=16, ssm_chunk=8)
    p = _np(jssm.ssm_init(jax.random.PRNGKey(0), jcfg))
    p["A_log"] = _rand(1, p["A_log"].shape) * 0.3
    p["dt_bias"] = _rand(2, p["dt_bias"].shape) * 0.3
    tp = weights.from_reference(p, "cpu")
    x = _rand(3, (2, 13, 32))
    s0 = _rand(4, (2, cfg.ssm_num_heads, 16, 8))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    # bf16: jitted XLA keeps the elementwise chain in fp32 between the
    # roundings the port makes after every op — a few bf16 ulps
    atol = SCAN_ATOL if dtype == "float32" else 5e-2
    for init in (None, s0):
        out, c = ssm.ssm_block(tp, cfg, _t(x), compute_dtype=tdt,
                               init_state=None if init is None else _t(init),
                               return_cache=True)
        jout, jc = jax.jit(lambda q, x, s: jssm.ssm_block(
            q, jcfg, x, compute_dtype=jdt, init_state=s, return_cache=True))(
            p, jnp.asarray(x), init)
        assert out.dtype == tdt
        _close(out.float(), jnp.asarray(jout, jnp.float32), "out", atol)
        _close(c["state"], jc["state"], "state", atol)
        _close(c["conv"].float(), jnp.asarray(jc["conv"], jnp.float32),
               "conv", atol)
    xt = _rand(5, (2, 1, 32))
    o, nc = ssm.ssm_decode_step(tp, cfg, _t(xt), c, compute_dtype=tdt)
    jo, jnc = jax.jit(lambda q, x, c: jssm.ssm_decode_step(
        q, jcfg, x, c, compute_dtype=jdt))(p, jnp.asarray(xt), jc)
    _close(o.float(), jnp.asarray(jo, jnp.float32), "decode out", atol)
    for k in ("state", "conv"):
        _close(nc[k].float(), jnp.asarray(jnc[k], jnp.float32), k, atol)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S_", [1, 2, 7, 16, 37])
def test_linear_scan_matches_sequential(S_):
    """The log-depth scan against the step-by-step recurrence, at lengths
    that are and are not powers of two."""
    a = np.random.default_rng(0).uniform(0.5, 1.0, (2, S_, 5)).astype(
        np.float32)
    b = _rand(1, (2, S_, 5))
    h = np.zeros((2, 5), np.float32)
    want = []
    for t in range(S_):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(recurrent.linear_scan(_t(a), _t(b)), np.stack(want, 1), "scan",
           atol=1e-5)


def test_rg_lru_block_matches_reference_and_sequential_decode():
    """``tests/test_layers.py``'s case in both packages: the block against
    the reference's, and against the port's own one-token decode fed the
    sequence a token at a time; from a given state too."""
    jcfg, cfg = _block_cfgs(d_model=16, d_ff=32, lru_width=16)
    p = _np(jrecurrent.recurrent_init(jax.random.PRNGKey(0), jcfg))
    tp = weights.from_reference(p, "cpu")
    x = _rand(1, (2, 10, 16))
    h0 = _rand(2, (2, 16))
    for init in (None, h0):
        out, c = recurrent.recurrent_block(
            tp, cfg, _t(x), init_state=None if init is None else _t(init),
            return_cache=True)
        jout, jc = jax.jit(lambda q, x, s: jrecurrent.recurrent_block(
            q, jcfg, x, init_state=s, return_cache=True))(
            p, jnp.asarray(x), init)
        _close(out, jout, "out", SCAN_ATOL)
        _close(c["h"], jc["h"], "h", SCAN_ATOL)
        _close(c["conv"], jc["conv"], "conv", SCAN_ATOL)
    cache = recurrent.init_recurrent_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(10):
        o, cache = recurrent.recurrent_decode_step(tp, cfg,
                                                   _t(x[:, t:t + 1]), cache)
        outs.append(o)
    full, h_full = recurrent.recurrent_block(tp, cfg, _t(x))
    _close(torch.cat(outs, 1), full, "decode vs scan", SCAN_ATOL)
    _close(cache["h"], h_full, "final h", SCAN_ATOL)


# ---------------------------------------------------------------------------
# MoE: tests/test_moe.py's five cases in both packages
# ---------------------------------------------------------------------------

def _moe_cfgs(E=4, k=2, cap=10.0, **kw):
    return _block_cfgs(num_layers=1, d_model=32, num_heads=4, num_kv_heads=4,
                       head_dim=8, d_ff=0, num_experts=E,
                       experts_per_token=k, moe_d_ff=48, capacity_factor=cap,
                       **kw)


def _jax_route(p, cfg, xt):
    """The reference's routing (``repro.models.moe._moe_block``, its
    router, top-k and capacity-bounded positions), step for step."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = xt.shape[0]
    C = min(max(1, int(math.ceil(T * k / E * cfg.capacity_factor))), T)
    topi, keep, idx = jax.jit(lambda q, x: _jax_dispatch(q, cfg, x, C))(
        p, jnp.asarray(xt))
    return np.asarray(topi), np.asarray(keep), np.asarray(idx), C


def _jax_dispatch(p, cfg, xt, C):
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = jax.nn.softmax(jnn.dense(p["router"], xt, jnp.float32), axis=-1)
    topv, topi = jax.lax.top_k(probs, k)
    flat_e = topi.reshape(-1)
    in_e = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(in_e, axis=0) * in_e - 1, axis=-1)
    keep = pos < C
    return topi, keep, jnp.where(keep, flat_e * C + pos, E * C)


def _moe_case(case):
    """(cfgs, reference params, x) of one of test_moe.py's cases."""
    shape = (2, 8, 32)
    if case == "shape_and_finite":
        cfgs = _moe_cfgs()
    elif case == "uniform_router":
        cfgs, shape = _moe_cfgs(E=4, k=1), (1, 16, 32)
    elif case == "capacity_drops":
        cfgs, shape = _moe_cfgs(E=4, k=1, cap=1e-6), (1, 32, 32)
    elif case == "grad_flows":
        cfgs, shape = _moe_cfgs(), (1, 8, 32)
    else:  # shared_expert
        cfgs, shape = _moe_cfgs(num_shared_experts=1, shared_d_ff=48,
                                cap=1e-6), (1, 16, 32)
    p = _np(jmoe.moe_init(jax.random.PRNGKey(0), cfgs[0]))
    if case == "uniform_router":  # ties: lax.top_k's lower index first
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    return cfgs, p, np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                 shape))


MOE_CASES = ["shape_and_finite", "uniform_router", "capacity_drops",
             "grad_flows", "shared_expert"]


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_block_matches_reference(case):
    """Routing, keep mask and buffer rows equal; then output, aux loss
    and (every case) the gradient of sum(out²) + 0.01·aux for every
    leaf; then the case's own invariant."""
    (jcfg, cfg), p, x = _moe_case(case)
    tp = weights.from_reference(p, "cpu")
    xt = x.reshape(-1, 32)
    topi, _, keep, idx, C, aux = moe.route(tp, cfg, _t(xt))
    jtopi, jkeep, jidx, jC = _jax_route(p, jcfg, xt)
    assert C == jC
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(idx.numpy(), jidx)

    leaves, td = tree.flatten(tp)
    leaves = [v.requires_grad_() for v in leaves]
    out, aux = moe.moe_block(tree.unflatten(td, leaves), cfg, _t(x))
    def jloss(q):
        jout, jaux = jmoe.moe_block(q, jcfg, jnp.asarray(x))
        return jnp.sum(jout ** 2) + 0.01 * jaux, (jout, jaux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(p)
    _close(out.detach(), jout, "out")
    _close(aux.detach(), jaux, "aux")
    grads = torch.autograd.grad((out ** 2).sum() + 0.01 * aux, leaves)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, jg, "grad", atol=1e-4, rtol=1e-4)

    out = out.detach()
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    if case == "uniform_router":
        assert abs(float(aux) - 1.0) < 1e-5
    elif case == "capacity_drops":
        assert int((out[0].abs() > 1e-9).any(-1).sum()) <= 4
    elif case == "grad_flows":
        named = dict(zip(["router", "w_down", "w_gate", "w_up"], grads))
        for name, g in named.items():
            assert float(g.abs().max()) > 0, name
    elif case == "shared_expert":
        assert float(out.abs().mean()) > 1e-4


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    v, i = moe.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the five reduced archs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.get_reduced(request.param)
    p = _np(jtransformer.init_params(jcfg, jax.random.PRNGKey(0)))
    return request.param, jcfg, configs.get_reduced(request.param), p


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "sample_weight": np.array([1.0, 0.5], np.float32)}


def test_configs_equal_reference():
    for a in ARCHS:
        assert dataclasses.asdict(configs.get(a)) == \
            dataclasses.asdict(jconfigs.get(a))
        assert dataclasses.asdict(configs.get_reduced(a)) == \
            dataclasses.asdict(jconfigs.get_reduced(a))


def test_full_configs_match_assignment():
    """``tests/test_arch_smoke.py``'s table for the five configs."""
    spec = {
        "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "mamba2-780m": (48, 1536, 0, 0, 0, 50280),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
    }
    for a, (L, d, H, K, ff, V) in spec.items():
        c = configs.get(a)
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
                c.vocab_size) == (L, d, H, K, V), a
        assert c.d_ff == ff or c.moe_d_ff == ff, a
    assert (configs.get("grok-1-314b").num_experts,
            configs.get("grok-1-314b").experts_per_token) == (8, 2)
    assert configs.get("mixtral-8x22b").num_experts == 8
    assert not configs.get("mixtral-8x22b").tie_embeddings
    m = configs.get("moonshot-v1-16b-a3b")
    assert (m.num_experts, m.experts_per_token, m.num_shared_experts) == \
        (64, 6, 2)
    r = configs.get("recurrentgemma-2b")
    assert r.num_periods == 2 and r.layer_pattern.count("recurrent") == 9


def test_param_tree_matches_reference(arch):
    """init_params builds the reference's tree leaf for leaf in shape,
    the untied head, the 13-slot hybrid period and the stacked experts
    included; ``weights`` carries them across and back exactly."""
    name, _, cfg, p = arch
    got = tree.leaves(transformer.init_params(cfg, seed=0, device="cpu"))
    want = jax.tree.leaves(p)
    assert [tuple(t.shape) for t in got] == [x.shape for x in want]
    assert ("unembed" in p) == (not cfg.tie_embeddings)
    back = weights.to_reference(weights.from_reference(p, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["none", "full"])
def test_logits_and_aux_match_reference(arch, policy):
    name, jcfg, cfg, p = arch
    toks = _batch(0, cfg.vocab_size)["tokens"]
    want, jaux = jax.jit(lambda q, t: jtransformer.forward(
        q, jcfg, t, dtype=jnp.float32, remat_policy=policy))(
        p, jnp.asarray(toks))
    got, aux = transformer.forward(weights.from_reference(p, "cpu"), cfg,
                                   _t(toks), dtype=torch.float32,
                                   remat_policy=policy)
    _close(got.detach(), want, f"{name} logits [{policy}]")
    _close(aux.detach(), jaux, f"{name} aux [{policy}]")
    assert (float(aux) > 0) == cfg.is_moe


def test_loss_and_grads_match_reference(arch):
    """Exact normalization (``exact_denom`` 3, a half-weight sample), and
    for MoE paper normalization too: the router term is added, scaled in
    exact mode by the micro-batch's valid share."""
    name, jcfg, cfg, p = arch
    b = _batch(1, cfg.vocab_size)
    jloss = jsteps.make_loss_fn(jcfg, dtype=jnp.float32, remat_policy="dots")
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="dots")
    for exact_denom in ((None, 3.0) if cfg.is_moe else (3.0,)):
        (want, jm), jgrads = jax.jit(jax.value_and_grad(
            lambda q, jb: jloss(q, jb, exact_denom=exact_denom),
            has_aux=True))(p, {k: jnp.asarray(v) for k, v in b.items()})
        leaves, td = tree.flatten(weights.from_reference(p, "cpu"))
        leaves = [x.requires_grad_() for x in leaves]
        loss, m = loss_fn(tree.unflatten(td, leaves),
                          {k: _t(v) for k, v in b.items()},
                          exact_denom=exact_denom)
        grads = torch.autograd.grad(loss, leaves)
        _close(loss.item(), want, f"{name} loss [{exact_denom}]")
        _close(float(m["aux_loss"]), float(jm["aux_loss"]), f"{name} aux")
        for g, jg in zip(grads, jax.tree.leaves(jgrads)):
            _close(g, jg, f"{name} grads [{exact_denom}]", atol=1e-4,
                   rtol=1e-4)


def test_mbs_step_compiled_and_flat_match_reference(arch):
    """One mini-batch of 6 in micro-batches of 4 (ragged, exact
    normalization) through the port's ``compiled`` and ``flat`` (K1, K2
    on their plain versions here) and the reference's ``flat``: params
    and momentum equal, loss finite and equal."""
    name, jcfg, cfg, p = arch
    jplan = jengine.plan_mbs(6, micro_batch_size=4, remat_policy="none")
    plan = engine.plan_mbs(6, micro_batch_size=4, remat_policy="none",
                           device="cpu")
    jopt = joptim.sgd(0.05, 0.9, 5e-4)
    jex = make_executor("flat", jsteps.make_loss_fn(
        jcfg, dtype=jnp.float32, remat_policy="none"), jopt, jplan,
        donate=False)
    batch = LMDataset(cfg.vocab_size, 16, seed=3).batch(6, 0)
    jp = jax.tree.map(jnp.asarray, p)
    jnew, jstate, jm = jex.step_split(jp, jopt.init(jp),
                                      jplan.device_split(batch))
    for ex in ("compiled", "flat"):
        topt = optim.sgd(0.05, 0.9, 5e-4)
        tex = engine.get_executor(ex)(steps.make_loss_fn(
            cfg, dtype=torch.float32, remat_policy="none"), topt, plan)
        tp = weights.from_reference(p, "cpu")
        new, state, m = tex.step_split(tp, topt.init(tp),
                                       plan.device_split(batch, "cpu"))
        assert math.isfinite(float(m["loss"]))
        _close(float(m["loss"]), float(jm["loss"]), f"{name} {ex} loss")
        for what, got, want in (("params", new, jnew),
                                ("state", state, jstate)):
            gl, wl = tree.leaves(got), jax.tree.leaves(want)
            assert len(gl) == len(wl)
            for g, w in zip(gl, wl):
                _close(g.detach().float(), w, f"{name} {ex} {what}")


def test_moe_decode_routes_the_pool_as_the_reference():
    """MoE capacity is per call: a decode step over the pool routes all
    of its rows together, garbage slots included, as the reference's
    does. At a capacity that drops tokens the two still agree."""
    kw = dict(name="moe-tight", family="moe", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
              vocab_size=64, num_experts=4, experts_per_token=2,
              moe_d_ff=16, capacity_factor=0.5)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    p = _np(jtransformer.init_params(jcfg, jax.random.PRNGKey(2)))
    tp = weights.from_reference(p, "cpu")
    toks = np.random.default_rng(0).integers(0, 64, (6, 5)).astype(np.int32)
    last, cache = transformer.prefill(tp, cfg, _t(toks), 8,
                                      dtype=torch.float32)
    jlast, jcache = jax.jit(lambda q, t: jtransformer.prefill(
        q, jcfg, t, max_len=8, dtype=jnp.float32))(p, jnp.asarray(toks))
    _close(last, jlast, "prefill", 1e-4)
    nxt = toks[:, :1]
    pos = np.full((6,), 5, np.int32)
    lg, _ = transformer.decode_step(tp, cfg, _t(nxt), cache, _t(pos),
                                    dtype=torch.float32)
    jlg, _ = jax.jit(lambda q, t, c, ps: jtransformer.decode_step(
        q, jcfg, t, c, ps, dtype=jnp.float32))(
        p, jnp.asarray(nxt), jcache, jnp.asarray(pos))
    _close(lg, jlg, "decode", 1e-4)


def test_ssd_gradient_is_finite_where_the_masked_exp_overflows():
    """A 256-step chunk (mamba2-780m's) with A = -1: above the diagonal
    cum_i - cum_j reaches ~180 and exp overflows. The reference's
    ``where(mask, exp(seg), 0)`` keeps the forward finite but its
    gradient is NaN (0 · inf); the port masks before the exp: the same
    forward, and a finite gradient equal to the reference's wherever that
    one is finite (a 16-step chunk of the same inputs)."""
    x, dt, A, Bm, Cm = _ssd_inputs(6, 1, 256, 2, 4, 3)
    dt = np.full_like(dt, 0.7)
    A = -np.ones((2,), np.float32)
    args = [_t(a).requires_grad_() for a in (x, dt, A, Bm, Cm)]
    y, _ = ssm.ssd_chunked(*args, 256)
    grads = torch.autograd.grad((y ** 2).sum(), args)

    def jloss(chunk):
        return lambda *a: jnp.sum(jssm.ssd_chunked(*a, chunk)[0] ** 2)

    jargs = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy, _ = jssm.ssd_chunked(*jargs, 256)
    _close(y.detach(), jy, "forward", atol=SCAN_ATOL)
    jgrads = jax.jit(jax.grad(jloss(256), argnums=(0, 1, 2, 3, 4)))(*jargs)
    assert not np.isfinite(np.asarray(jgrads[1])).all()  # the reference
    want = jax.jit(jax.grad(jloss(16), argnums=(0, 1, 2, 3, 4)))(*jargs)
    for g, w in zip(grads, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, "grad", atol=1e-3, rtol=1e-4)
