"""Gemma's dense features in the port against the JAX package, on the
training path and through the serve launcher: reduced gemma2-9b (local /
global windows, attention and final soft-caps, post-norms, the embedding
scale, GeGLU) and gemma3-12b (QK-norm, dual RoPE theta, 5:1 local:global)
give the reference's logits, loss and gradients on its parameters, and
one ``flat`` step gives its params and momentum.

Tolerance: atol 1e-5 / rtol 1e-5 in fp32, as ``test_torch_model.py``
(XLA and torch order the matmul sums differently).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_executor  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.engine import serving as jserving  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, optim, tree, weights  # noqa: E402
from repro_torch.data import LMDataset  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import nn, transformer  # noqa: E402

ATOL = RTOL = 1e-5
B, S = 2, 24  # longer than the reduced configs' window of 16
ARCHS = ["gemma2-9b", "gemma3-12b"]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jconfigs.get_reduced(request.param)
    p = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return request.param, jcfg, configs.get_reduced(request.param), p


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "sample_weight": np.array([1.0, 0.5], np.float32)}


def test_configs_equal_reference():
    for name in ARCHS:
        for get in ("get", "get_reduced"):
            assert dataclasses.asdict(getattr(configs, get)(name)) == \
                dataclasses.asdict(getattr(jconfigs, get)(name))


@pytest.mark.parametrize("policy", ["none", "period"])
def test_logits_match_reference(arch, policy):
    name, jcfg, cfg, p = arch
    toks = _batch()["tokens"]
    want, _ = jtransformer.forward(jax.tree.map(jnp.asarray, p), jcfg,
                                   jnp.asarray(toks), dtype=jnp.float32,
                                   remat_policy=policy)
    got, _ = transformer.forward(weights.from_reference(p, "cpu"), cfg,
                                 torch.from_numpy(toks), dtype=torch.float32,
                                 remat_policy=policy)
    _close(got.detach().numpy(), want, f"{name} logits [{policy}]")


def test_param_tree_matches_reference(arch):
    """init_params builds the reference's tree: post-norms and the GeGLU
    gate included, leaf for leaf in shape."""
    name, _, cfg, p = arch
    got = tree.leaves(transformer.init_params(cfg, seed=0, device="cpu"))
    want = jax.tree.leaves(p)
    assert [tuple(t.shape) for t in got] == [x.shape for x in want]
    assert "post_norm" in p["blocks"][0] and "w_gate" in p["blocks"][0]["ffn"]


def test_loss_and_grads_match_reference(arch):
    name, jcfg, cfg, p = arch
    b = _batch(1)
    jloss = jsteps.make_loss_fn(jcfg, dtype=jnp.float32, remat_policy="dots")
    (want, _), jgrads = jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, p))
    loss_fn = steps.make_loss_fn(cfg, dtype=torch.float32,
                                 remat_policy="dots")
    leaves, td = tree.flatten(weights.from_reference(p, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, _ = loss_fn(tree.unflatten(td, leaves),
                      {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.item(), want, f"{name} loss")
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _close(g.numpy(), jg, f"{name} grads")


def test_flat_step_matches_reference(arch):
    """One mini-batch of 6 in micro-batches of 4 (ragged: exact
    normalization) through both packages' ``flat`` executors."""
    name, jcfg, cfg, p = arch
    jplan = jengine.plan_mbs(6, micro_batch_size=4, remat_policy="none")
    plan = engine.plan_mbs(6, micro_batch_size=4, remat_policy="none",
                           device="cpu")
    jopt, topt = joptim.sgd(0.05, 0.9, 5e-4), optim.sgd(0.05, 0.9, 5e-4)
    jex = make_executor("flat", jsteps.make_loss_fn(
        jcfg, dtype=jnp.float32, remat_policy="none"), jopt, jplan,
        donate=False)
    tex = engine.get_executor("flat")(steps.make_loss_fn(
        cfg, dtype=torch.float32, remat_policy="none"), topt, plan)
    batch = LMDataset(512, 16, seed=3).batch(6, 0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = weights.from_reference(p, "cpu")
    jnew, jstate, jm = jex.step_split(jp, jopt.init(jp),
                                      jplan.device_split(batch))
    new, state, m = tex.step_split(tp, topt.init(tp),
                                   plan.device_split(batch, "cpu"))
    for what, got, want in (("params", new, jnew), ("state", state, jstate)):
        gl = tree.leaves(got)
        wl = jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            _close(g.detach().float().numpy(), w, f"{name} flat {what}")
    _close(float(m["loss"]), float(jm["loss"]), f"{name} flat loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_and_geglu_match_reference(dtype):
    """The embedding scale is sqrt(d) rounded to the compute dtype before
    it multiplies (59.75 for d 3584 in bf16), and GeGLU's GELU is the tanh
    approximation — in bf16 too, within one bf16 ulp."""
    rng = np.random.default_rng(7)
    d = 3584
    table = rng.normal(size=(11, d)).astype(np.float32)
    toks = np.array([[3, 0, 10]], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnn.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jd,
                     scale=True)
    got = nn.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks),
                   td, scale=True)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    fp = {k: {"w": rng.normal(size=s).astype(np.float32) * 0.1}
          for k, s in (("w_up", (16, 32)), ("w_gate", (16, 32)),
                       ("w_down", (32, 16)))}
    x = rng.normal(size=(3, 16)).astype(np.float32)
    want = jnn.ffn(jax.tree.map(jnp.asarray, fp), jnp.asarray(x), "geglu",
                   compute_dtype=jd)
    got = nn.ffn(weights.from_reference(fp, "cpu"), torch.from_numpy(x),
                 "geglu", compute_dtype=td)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


SERVE = dict(arch="gemma2-9b", budget=0.25, max_len=64, requests=8, rate=200.0,
             prompt_lens=(8, 24, 40), new_tokens=(4, 9), seed=0)


def _argv(**kw):
    kw = dict(SERVE, **kw)
    return ["--arch", kw["arch"], "--reduced", "--budget", str(kw["budget"]),
            "--max-len", str(kw["max_len"]), "--requests",
            str(kw["requests"]), "--rate", str(kw["rate"]),
            "--prompt-lens", ",".join(map(str, kw["prompt_lens"])),
            "--new-tokens", ",".join(map(str, kw["new_tokens"])),
            "--seed", str(kw["seed"])]


def _reference_launcher_run():
    """What ``repro.launch.serve.main`` computes on one host device,
    without its mesh: under jax 0.9 that launcher stops in
    ``with_sharding_constraint``, which refuses its Explicit-axis mesh
    (the reference's dryrun failures, ROADMAP.md "Not port faults"). On
    one device the mesh changes nothing in the plan (the replicated
    params' shard ratio is 1) and the engine is the same."""
    jcfg = jconfigs.get_reduced(SERVE["arch"])
    plan = jserving.plan_serve(jcfg, budget_bytes=int(SERVE["budget"] * 2**30),
                               max_len=SERVE["max_len"], cache_bytes=4)
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    eng = jserving.ServingEngine(params, jcfg, plan, dtype=jnp.float32,
                                 seed=SERVE["seed"])
    reqs = list(jserving.synthetic_traffic(
        SERVE["requests"], rate_rps=SERVE["rate"],
        prompt_lens=SERVE["prompt_lens"], new_tokens=SERVE["new_tokens"],
        vocab_size=jcfg.vocab_size, seed=SERVE["seed"] + 1))
    eng.run(reqs, warmup_prompt_lens=SERVE["prompt_lens"])
    return plan, eng.finished_report(reqs)


def test_serve_launcher_reports_the_reference_plan_and_counts(capsys):
    """The port's serve launcher on the CPU (``--reduced --device cpu``)
    against the reference launcher's computation: the same plan line, and
    the same requests finished, prompt tokens prefilled and tokens
    decoded. Which micro-batches formed and how many decode steps ran
    depend on the wall clock, so they are not compared."""
    from repro_torch.launch import serve
    got = serve.main(_argv() + ["--device", "cpu"])
    printed = capsys.readouterr().out
    jplan, want = _reference_launcher_run()
    assert jplan.describe() in printed
    assert dataclasses.asdict(got["plan"]) == dataclasses.asdict(jplan)
    rep = got["report"]
    assert rep["requests"] == want["requests"] == {"admitted": 8,
                                                   "finished": 8}
    assert rep["prefill"]["prompt_tokens"] == \
        want["prefill"]["prompt_tokens"]
    assert rep["decode"]["tokens"] == want["decode"]["tokens"]
    assert rep["slots"]["planned"] == want["slots"]["planned"]
    assert got["engine"].pool.free_count == got["plan"].max_decode_slots
    assert all(len(r.tokens) == r.max_new_tokens for r in got["requests"])
