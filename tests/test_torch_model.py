"""Reduced qwen2 in the port against the JAX package: the same parameters
(loaded through ``repro_torch.weights``) and the same numpy tokens give
the same logits, loss and gradients under every remat policy.

Tolerance: atol 1e-5, rtol 1e-5 in fp32 — XLA and torch sum the matmuls
in different orders, so agreement is to rounding, not bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, tree, weights  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import remat, transformer  # noqa: E402

ATOL = RTOL = 1e-5
B, S = 2, 16


@pytest.fixture(scope="module")
def ref_params():
    cfg = jconfigs.get_reduced("qwen2-1.5b")
    return jax.tree.map(np.asarray, jtransformer.init_params(
        cfg, jax.random.PRNGKey(0)))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (B, S + 1)).astype(np.int32)
    w = np.array([1.0, 0.0], np.float32)  # one padded sample
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "sample_weight": w}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("policy", remat.POLICIES)
def test_logits_match_reference(ref_params, policy):
    cfg = configs.get_reduced("qwen2-1.5b")
    b = _batch()
    want, _ = jtransformer.forward(
        jax.tree.map(jnp.asarray, ref_params), jconfigs.get_reduced(
            "qwen2-1.5b"), jnp.asarray(b["tokens"]), dtype=jnp.float32,
        remat_policy=policy)
    got, aux = transformer.forward(
        weights.from_reference(ref_params, "cpu"), cfg,
        torch.from_numpy(b["tokens"]), dtype=torch.float32,
        remat_policy=policy)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _assert_close(got.detach().numpy(), want, f"logits [{policy}]")


@pytest.mark.parametrize("policy", remat.POLICIES)
@pytest.mark.parametrize("exact_denom", [None, 4.0])
def test_loss_and_grads_match_reference(ref_params, policy, exact_denom):
    b = _batch(1)
    jloss = jsteps.make_loss_fn(jconfigs.get_reduced("qwen2-1.5b"),
                                dtype=jnp.float32, remat_policy=policy)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jloss(p, jb, exact_denom=exact_denom), has_aux=True)(
        jax.tree.map(jnp.asarray, ref_params))

    loss_fn = steps.make_loss_fn(configs.get_reduced("qwen2-1.5b"),
                                 dtype=torch.float32, remat_policy=policy)
    leaves, td = tree.flatten(weights.from_reference(ref_params, "cpu"))
    leaves = [x.requires_grad_() for x in leaves]
    loss, metrics = loss_fn(tree.unflatten(td, leaves), _torch_batch(b),
                            exact_denom=exact_denom)
    grads = torch.autograd.grad(loss, leaves)
    _assert_close(loss.item(), want, f"loss [{policy}]")
    assert float(metrics["aux_loss"]) == 0.0
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        _assert_close(g.numpy(), jg, f"grads [{policy}]")


def test_weights_round_trip_is_exact(ref_params):
    back = weights.to_reference(weights.from_reference(ref_params, "cpu"))
    assert (jax.tree.structure(back) == jax.tree.structure(ref_params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bf16_leaves_round_trip():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = np.arange(6, dtype=np.float32).reshape(2, 3).astype(
        ml_dtypes.bfloat16)
    t = weights.from_reference({"w": x}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(weights.to_reference({"w": t})["w"], x)


def test_unported_families_name_their_roadmap_item():
    """No family is left unported: every arch of ``configs.ARCHS``
    resolves, full and reduced, to the reference's config; an unknown
    one still raises."""
    for arch in configs.ARCHS:
        for get, jget in ((configs.get, jconfigs.get),
                          (configs.get_reduced, jconfigs.get_reduced)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(jget(arch)), arch
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get("gpt-17")


def test_local_window_and_qk_norm_match_reference():
    """The attention features qwen2 does not use: sliding-window ``local``
    slots (with a window below the sequence) and QK-norm."""
    import dataclasses
    kw = dict(layer_pattern=("local", "global"), sliding_window=5,
              use_qk_norm=True)
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen2-1.5b"), **kw)
    cfg = dataclasses.replace(configs.get_reduced("qwen2-1.5b"), **kw)
    p = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(1)))
    toks = np.random.default_rng(2).integers(0, 512, (B, S)).astype(np.int32)
    want, _ = jtransformer.forward(jax.tree.map(jnp.asarray, p), jcfg,
                                   jnp.asarray(toks), dtype=jnp.float32,
                                   remat_policy="none")
    got, _ = transformer.forward(weights.from_reference(p, "cpu"), cfg,
                                 torch.from_numpy(toks), dtype=torch.float32,
                                 remat_policy="none")
    _assert_close(got.detach().numpy(), want, "logits [local + qk-norm]")


def test_chunked_attention_matches_reference():
    """Sequences longer than one query chunk, causal and windowed."""
    from repro.models import attention as jattn
    from repro_torch.models import attention
    rng = np.random.default_rng(3)
    Bq, Sq, H, K, hd = 1, 300, 4, 2, 8
    q, k, v = (rng.normal(size=(Bq, Sq, h, hd)).astype(np.float32)
               for h in (H, K, K))
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq))
    for window in (None, 40):
        want = jattn.chunked_attention(
            *(jnp.asarray(x) for x in (q, k, v)), q_pos=jnp.asarray(pos),
            k_pos=jnp.asarray(pos), window=window, q_chunk=128, align=32)
        got = attention.chunked_attention(
            *(torch.from_numpy(x) for x in (q, k, v)),
            q_pos=torch.from_numpy(pos.copy()),
            k_pos=torch.from_numpy(pos.copy()), window=window, q_chunk=128,
            align=32)
        _assert_close(got.numpy(), want, f"chunked attention [{window}]")


def test_oracles_match_reference():
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 4, 12, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 12, 8)).astype(np.float32)
            for _ in range(2))
    for kw in (dict(), dict(window=4), dict(softcap=5.0),
               dict(causal=False)):
        want = jref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw)
        got = ref.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw)
        _assert_close(got.numpy(), want, f"attention_ref {kw}")
    logits = rng.normal(size=(10, 33)).astype(np.float32)
    labels = rng.integers(0, 33, 10).astype(np.int32)
    _assert_close(ref.cross_entropy_ref(torch.from_numpy(logits),
                                        torch.from_numpy(labels)).numpy(),
                  jref.cross_entropy_ref(jnp.asarray(logits),
                                         jnp.asarray(labels)),
                  "cross_entropy_ref")


def test_accuracy_matches_reference():
    from repro.core import losses as jlosses
    from repro_torch.core import losses
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(4, 6, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (4, 6)).astype(np.int32)
    assert float(losses.accuracy(torch.from_numpy(logits),
                                 torch.from_numpy(labels))) == \
        float(jlosses.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("sample_weight", [None, [1.0, 0.5, 0.0]])
def test_token_weight_matches_reference(sample_weight):
    """Per-sample weighted token mean with its denominator clamped at 1;
    row 1's weights are all 0, so its per-sample loss is 0."""
    from repro.core import losses as jlosses
    from repro_torch.core import losses
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 5, 9)).astype(np.float32)
    labels = rng.integers(0, 9, (3, 5)).astype(np.int32)
    tw = rng.uniform(size=(3, 5)).astype(np.float32)
    tw[1] = 0.0
    tw[2, :2] = 0.0
    jkw = {"token_weight": jnp.asarray(tw)}
    tkw = {"token_weight": torch.from_numpy(tw)}
    if sample_weight is not None:
        sw = np.asarray(sample_weight, np.float32)
        jkw["sample_weight"] = jnp.asarray(sw)
        tkw["sample_weight"] = torch.from_numpy(sw)
    want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 **jkw)
    got = losses.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), **tkw)
    assert np.isfinite(float(got))
    _assert_close(float(got), want, f"token_weight [{sample_weight}]")
