"""Prefill and decode of the port against its own full forward and against
the JAX package (``tests/test_decode_consistency.py``'s decoder-only
cases: dense, MoE, ssm and hybrid): the ring cache with sliding windows,
the SSD and RG-LRU states with their conv tails, wraparound during
decode, ragged right-padded prefill and the windowed-global variant, on
the reference's parameters (``weights.from_reference``) and the same
numpy tokens.

Tolerance: 1e-4 absolute on fp32 logits, the reference test's own (XLA
and torch sum in different orders). The ring layouts are integer
gathers and must be equal exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL = 1e-4
F32 = torch.float32

CASES = {
    "dense-local-global": dict(
        layer_pattern=("local", "global"), num_layers=2, sliding_window=8,
        use_post_norm=True, attn_softcap=50.0, final_softcap=30.0),
    "dense-gemma3-pattern": dict(
        layer_pattern=("local",) * 5 + ("global",), num_layers=6,
        sliding_window=8, use_qk_norm=True, rope_theta_global=1e6),
    # ample capacity: capacity-bounded dropping depends on the batch's
    # shape, so prefill equals forward only when no token drops
    "moe": dict(layer_pattern=("global",), num_layers=2, num_experts=4,
                experts_per_token=2, moe_d_ff=96, d_ff=0,
                capacity_factor=8.0),
    "ssm": dict(layer_pattern=("ssm",), num_layers=2, ssm_state=16,
                ssm_head_dim=32, ssm_chunk=4, num_heads=0, num_kv_heads=0,
                head_dim=0, d_ff=0),
    "hybrid": dict(layer_pattern=("recurrent", "recurrent", "local"),
                   num_layers=3, sliding_window=8, lru_width=64),
}


def _cfgs(name, **extra):
    kw = dict(name=name, family="t", d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128, vocab_size=128)
    kw.update(CASES.get(name, {}), **extra)
    return JModelConfig(**kw), ModelConfig(**kw)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(seed)))


def _toks(seed, shape, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_decode_matches_forward_and_reference(name):
    """Prefill 18 tokens (not window-aligned), decode 3 more: the port's
    logits equal its own full forward's and the reference's prefill and
    decode, step for step."""
    jcfg, cfg = _cfgs(name)
    p = _params(jcfg)
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    toks = _toks(1, (2, 21))
    full, _ = transformer.forward(tp, cfg, _t(toks), dtype=F32, remat=False)
    full = full.detach()
    last, cache = transformer.prefill(tp, cfg, _t(toks[:, :18]), 32,
                                      dtype=F32)
    jlast, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks[:, :18]),
                                         max_len=32, dtype=jnp.float32)
    assert _err(last, full[:, 17]) < ATOL
    assert _err(last, jlast) < ATOL
    for t in range(18, 21):
        pos = np.full((2,), t, np.int32)
        lg, cache = transformer.decode_step(tp, cfg, _t(toks[:, t:t + 1]),
                                            cache, _t(pos), dtype=F32)
        jlg, jcache = jtransformer.decode_step(
            jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jcache,
            jnp.asarray(pos), dtype=jnp.float32)
        assert _err(lg[:, 0], full[:, t]) < ATOL, (name, t)
        assert _err(lg, jlg) < ATOL, (name, t)
    # the rings hold the same positions; keys, states and conv tails
    # agree within the tolerance
    for c, jc in zip(cache, jcache):
        assert sorted(c) == sorted(jc)
        for k in c:
            if k == "pos":
                np.testing.assert_array_equal(c[k].numpy(),
                                              np.asarray(jc[k]))
            else:
                assert c[k].dtype == torch.float32, k
                assert _err(c[k], jc[k]) < ATOL, (name, k)


@pytest.mark.parametrize("name", ["dense-local-global", "ssm", "hybrid"])
def test_ring_wraparound_matches_full_recompute(name):
    """Prompt shorter than the window, 20 decode steps: the local ring
    wraps during decode (the states carry on past it). Each step equals a
    fresh full forward over the prefix (which never uses the cache) and
    the reference's decode."""
    jcfg, cfg = _cfgs(name)
    p = _params(jcfg)
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    S, prompt = 26, 6
    toks = _toks(3, (2, S))
    _, cache = transformer.prefill(tp, cfg, _t(toks[:, :prompt]), S,
                                   dtype=F32)
    _, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks[:, :prompt]),
                                     max_len=S, dtype=jnp.float32)
    jdecode = jax.jit(lambda q, tok, c, ps: jtransformer.decode_step(
        q, jcfg, tok, c, ps, dtype=jnp.float32))
    for t in range(prompt, S):
        pos = np.full((2,), t, np.int32)
        lg, cache = transformer.decode_step(tp, cfg, _t(toks[:, t:t + 1]),
                                            cache, _t(pos), dtype=F32)
        jlg, jcache = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                              jnp.asarray(pos))
        ref, _ = transformer.forward(tp, cfg, _t(toks[:, :t + 1]), dtype=F32,
                                     remat=False)
        assert _err(lg[:, 0], ref.detach()[:, t]) < ATOL, (name, t)
        assert _err(lg, jlg) < ATOL, (name, t)


def test_ragged_prefill_matches_exact_per_row():
    """Right-padded ragged prefill equals per-row exact prefill — rows
    longer than the window included — and decodes identically after; the
    port's ragged logits also equal the reference's."""
    kw = dict(layer_pattern=("local", "global"), num_layers=2,
              sliding_window=4)
    jcfg, cfg = _cfgs("rag", **kw)
    assert transformer.supports_ragged_prefill(cfg)
    p = _params(jcfg)
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    lengths = np.array([3, 11, 7], np.int32)
    rows = [_toks(10 + i, (L,)) for i, L in enumerate(lengths)]
    padded = np.stack([np.pad(r, (0, 16 - len(r)), constant_values=99)
                       for r in rows])
    last_r, cache_r = transformer.prefill(tp, cfg, _t(padded), 32, dtype=F32,
                                          lengths=_t(lengths))
    jlast_r, jcache_r = jtransformer.prefill(
        jp, jcfg, jnp.asarray(padded), max_len=32, dtype=jnp.float32,
        lengths=jnp.asarray(lengths))
    assert _err(last_r, jlast_r) < ATOL
    nxt = _toks(20, (3, 1))
    lg_r, _ = transformer.decode_step(tp, cfg, _t(nxt), cache_r, _t(lengths),
                                      dtype=F32)
    jlg_r, _ = jtransformer.decode_step(jp, jcfg, jnp.asarray(nxt), jcache_r,
                                        jnp.asarray(lengths),
                                        dtype=jnp.float32)
    assert _err(lg_r, jlg_r) < ATOL
    for i, L in enumerate(lengths):
        last_e, cache_e = transformer.prefill(tp, cfg, _t(rows[i][None]), 32,
                                              dtype=F32)
        assert _err(last_r[i], last_e[0]) < ATOL, ("prefill", i)
        lg_e, _ = transformer.decode_step(tp, cfg, _t(nxt[i:i + 1]), cache_e,
                                          _t([L]), dtype=F32)
        assert _err(lg_r[i, 0], lg_e[0, 0]) < ATOL, ("decode", i)


def test_long_context_global_window_variant():
    """Global layers under a window cap equal full attention while the
    context fits the cap, and differ once it does not — in both
    packages, and the port's capped logits equal the reference's."""
    kw = dict(layer_pattern=("local", "global"), num_layers=2,
              sliding_window=4)
    jcfg, cfg = _cfgs("g", **kw)
    p = _params(jcfg)
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    toks = _toks(1, (1, 12))
    full, _ = transformer.forward(tp, cfg, _t(toks), dtype=F32, remat=False)
    for gw in (16, 4):
        capped, _ = transformer.forward(tp, cfg, _t(toks), dtype=F32,
                                        remat=False, global_window=gw)
        jcapped, _ = jtransformer.forward(jp, jcfg, jnp.asarray(toks),
                                          dtype=jnp.float32, remat=False,
                                          global_window=gw)
        assert _err(capped.detach(), jcapped) < ATOL
        diff = _err(full.detach(), capped.detach())
        assert (diff < 1e-5) if gw == 16 else (diff > 1e-4), (gw, diff)
    # and decode past the cap reads a ring of global_window slots
    last, cache = transformer.prefill(tp, cfg, _t(toks[:, :10]), 16,
                                      dtype=F32, global_window=4)
    jlast, jcache = jtransformer.prefill(jp, jcfg, jnp.asarray(toks[:, :10]),
                                         max_len=16, dtype=jnp.float32,
                                         global_window=4)
    assert cache[1]["k"].shape[2] == 4
    assert _err(last, jlast) < ATOL
    lg, _ = transformer.decode_step(tp, cfg, _t(toks[:, 10:11]), cache,
                                    _t([10]), dtype=F32, global_window=4)
    jlg, _ = jtransformer.decode_step(jp, jcfg, jnp.asarray(toks[:, 10:11]),
                                      jcache, jnp.asarray([10]),
                                      dtype=jnp.float32, global_window=4)
    assert _err(lg, jlg) < ATOL


@pytest.mark.parametrize("S,window,ragged", [
    (5, 8, False), (8, 8, False), (13, 8, False), (21, 8, False),
    (13, None, False), (16, 8, True), (16, 4, True), (7, 16, True)])
def test_ring_cache_layout_equals_reference(S, window, ragged):
    """``ring_cache_from_full``: the dense static permutation (short,
    exact and wrapped prompts) and the ragged per-row gather hold the same
    keys at the same slots as the reference's, bit for bit."""
    rng = np.random.default_rng(S)
    k, v = (rng.normal(size=(3, S, 2, 4)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, S)).copy()
    lengths = np.array([1, S // 2, S], np.int32) if ragged else None
    want = jattention.ring_cache_from_full(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), window, 24,
        lengths=None if lengths is None else jnp.asarray(lengths))
    got = attention.ring_cache_from_full(
        _t(k), _t(v), _t(pos), window, 24,
        lengths=None if lengths is None else _t(lengths))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_bf16_cache_attends_the_unrounded_token():
    """A bf16 cache under fp32 compute: like the reference, decode attends
    the current token's k/v in fp32 and stores them rounded, so the
    logits equal the reference's and the stored ring is the rounded one."""
    jcfg, cfg = _cfgs("dense-local-global")
    p = _params(jcfg)
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    toks = _toks(5, (2, 12))
    cache = transformer.init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    jcache = jtransformer.init_cache(jcfg, 2, 16, jnp.bfloat16)
    for t in range(12):
        pos = np.full((2,), t, np.int32)
        lg, cache = transformer.decode_step(tp, cfg, _t(toks[:, t:t + 1]),
                                            cache, _t(pos), dtype=F32)
        jlg, jcache = jtransformer.decode_step(
            jp, jcfg, jnp.asarray(toks[:, t:t + 1]), jcache,
            jnp.asarray(pos), dtype=jnp.float32)
        assert _err(lg, jlg) < ATOL, t
    for c, jc in zip(cache, jcache):
        assert c["k"].dtype == torch.bfloat16
        assert _err(c["k"].float(), jnp.asarray(jc["k"], jnp.float32)) \
            < 2e-2
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_writes_the_pool_in_place():
    """decode_step updates the cache tensors it is given (no second
    pool): the leaves after a step are the same storage as before."""
    _, cfg = _cfgs("dense-local-global")
    tp = transformer.init_params(cfg, seed=0, device="cpu")
    cache = transformer.init_cache(cfg, 2, 16, F32, device="cpu")
    ptrs = [leaf.data_ptr() for c in cache for leaf in c.values()]
    _, out = transformer.decode_step(tp, cfg, _t(_toks(0, (2, 1))), cache,
                                     _t([3, 5]), dtype=F32)
    assert [leaf.data_ptr() for c in out for leaf in c.values()] == ptrs
    slots = [c["pos"][0].tolist() for c in out]
    assert slots[0][0][3] == 3 and slots[0][1][5] == 5  # ring slot p % 8
