"""The port's serving engine against the JAX package's
(``tests/test_serving.py``): continuous batching gives the tokens of a
one-request-at-a-time decode and of the reference engine, the slot pool
admits, evicts and reuses, ``plan_serve`` and the memory model's serving
terms equal the reference's field by field, ``synthetic_traffic`` gives
the same requests; the ssm, hybrid and MoE families prefill exact-length
groups and serve as the reference does, the VLM serves text-only, and
enc-dec configs are refused with the reference's message.

Tolerance: fp32 logits within 1e-4 (``tests/test_decode_consistency.py``'s);
a token must equal the reference's wherever the reference's top-2 margin
exceeds twice that, which on these models is every token.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import memory_model as jmemory_model  # noqa: E402
from repro.engine import serving as jserving  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, weights  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.engine import serving  # noqa: E402
from repro_torch.engine.kv import KVPool, PoolExhausted  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

VOCAB = 101
ATOL = 1e-4
F32 = torch.float32


def _kw(pattern=("global", "local"), **kw):
    base = dict(name="serve-toy", family="t", num_layers=len(pattern),
                d_model=48, num_heads=4, num_kv_heads=2, head_dim=12,
                d_ff=96, vocab_size=VOCAB, layer_pattern=pattern,
                sliding_window=8)
    base.update(kw)
    return base


def _cfgs(pattern=("global", "local"), **kw):
    kw = _kw(pattern, **kw)
    return JModelConfig(**kw), ModelConfig(**kw)


def _cfg(pattern=("global", "local"), **kw):
    return ModelConfig(**_kw(pattern, **kw))


@pytest.fixture(scope="module")
def toy():
    """The toy config in both packages and the reference's parameters."""
    jcfg, cfg = _cfgs()
    p = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, p


def _traffic(pkg, n, seed, prompt_lens=(4, 7, 11), new_tokens=(3, 6),
             rate=500.0):
    return list(pkg.synthetic_traffic(n, rate_rps=rate,
                                      prompt_lens=prompt_lens,
                                      new_tokens=new_tokens,
                                      vocab_size=VOCAB, seed=seed))


def _run_engine(cfg, params, reqs, max_len, **plan_kw):
    plan = serving.plan_serve(cfg, budget_bytes=1 << 28, max_len=max_len,
                              **plan_kw)
    eng = serving.ServingEngine(params, cfg, plan, dtype=F32,
                                cache_dtype=F32)
    rep = eng.run(reqs, warmup_prompt_lens=[r.prompt_len for r in reqs])
    return plan, eng, rep


def _teacher_forced(params, cfg, req, max_len):
    """Logits (n, V) a one-request prefill + decode gives at each of the
    request's generated positions, fed the request's own tokens."""
    logits, cache = transformer.prefill(
        params, cfg, torch.from_numpy(req.prompt[None].copy()), max_len,
        dtype=F32)
    out = [logits[0]]
    for i, tok in enumerate(req.tokens[:-1]):
        lg, cache = transformer.decode_step(
            params, cfg, torch.tensor([[tok]]), cache,
            torch.tensor([req.prompt_len + i]), dtype=F32)
        out.append(lg[0, 0])
    return torch.stack(out).numpy()


def _jax_teacher_forced(jp, jcfg, req, max_len):
    logits, cache = jtransformer.prefill(
        jp, jcfg, jnp.asarray(req.prompt[None]), max_len=max_len,
        dtype=jnp.float32)
    out = [np.asarray(logits[0])]
    for i, tok in enumerate(req.tokens[:-1]):
        lg, cache = jtransformer.decode_step(
            jp, jcfg, jnp.array([[tok]], jnp.int32), cache,
            jnp.array([req.prompt_len + i], jnp.int32), dtype=jnp.float32)
        out.append(np.asarray(lg[0, 0]))
    return np.stack(out)


# ---------------------------------------------------------------------------
# continuous batching == one request at a time == the reference engine
# ---------------------------------------------------------------------------

def test_engine_matches_reference_engine(toy):
    """Pattern ("global", "local"): the port's engine and the reference's
    over the same requests. Each request's tokens, teacher-forced through
    both packages one request at a time, give logits within the
    tolerance; the port's tokens are the argmax of its own logits and
    equal the reference engine's wherever the reference's top-2 margin
    exceeds twice the tolerance (up to the first place where it does not,
    after which the two streams may part)."""
    jcfg, cfg, p = toy
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    reqs = _traffic(serving, 9, 2)
    jreqs = _traffic(jserving, 9, 2)
    plan, eng, rep = _run_engine(cfg, tp, reqs, 32)
    jplan = jserving.plan_serve(jcfg, budget_bytes=1 << 28, max_len=32)
    jeng = jserving.ServingEngine(jp, jcfg, jplan, dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    jrep = jeng.run(jreqs, warmup_prompt_lens=[r.prompt_len for r in jreqs])
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    assert plan.ragged_prefill
    assert rep["requests"] == jrep["requests"] == {"admitted": 9,
                                                   "finished": 9}
    assert rep["decode"]["tokens"] == jrep["decode"]["tokens"]
    compared = 0
    for r, jr in zip(reqs, jreqs):
        assert r.state == serving.FINISHED and len(r.tokens) == \
            r.max_new_tokens == jr.max_new_tokens
        got = _teacher_forced(tp, cfg, r, plan.max_len)
        want = _jax_teacher_forced(jp, jcfg, r, plan.max_len)
        assert float(np.max(np.abs(got - want))) < ATOL, r.rid
        assert r.tokens == [int(t) for t in got.argmax(-1)], r.rid
        top2 = np.sort(want, axis=-1)[:, -2:]
        for i, (a, b) in enumerate(zip(r.tokens, jr.tokens)):
            if top2[i, 1] - top2[i, 0] <= 2 * ATOL:
                break
            assert a == b, (r.rid, i)
            compared += 1
    assert compared == sum(len(r.tokens) for r in reqs)


def _reference_tokens(params, cfg, req, max_len):
    """One-request greedy decode straight through prefill / decode_step."""
    logits, cache = transformer.prefill(
        params, cfg, torch.from_numpy(req.prompt[None].copy()), max_len,
        dtype=F32)
    toks = [int(torch.argmax(logits[0]))]
    pos = req.prompt_len
    while len(toks) < req.max_new_tokens:
        lg, cache = transformer.decode_step(
            params, cfg, torch.tensor([[toks[-1]]]), cache,
            torch.tensor([pos]), dtype=F32)
        toks.append(int(torch.argmax(lg[0, 0])))
        pos += 1
    return toks


def test_engine_matches_one_request_at_a_time(toy):
    _, cfg, p = toy
    tp = weights.from_reference(p, "cpu")
    reqs = _traffic(serving, 9, 2)
    plan, _, rep = _run_engine(cfg, tp, reqs, 32)
    assert rep["requests"]["finished"] == len(reqs)
    for r in reqs:
        assert r.tokens == _reference_tokens(tp, cfg, r, plan.max_len), r.rid


def test_decode_token_accounting_excludes_prefill_token():
    """The token a prefill samples does not count as decode throughput:
    decode tokens == sum(max_new - 1), one batched step per new token."""
    cfg = _cfg()
    tp = transformer.init_params(cfg, seed=0, device="cpu")
    reqs = [serving.Request(rid=i, prompt=np.arange(1, 6, dtype=np.int32),
                            max_new_tokens=4) for i in range(3)]
    _, _, rep = _run_engine(cfg, tp, reqs, 24)
    assert all(len(r.tokens) == 4 for r in reqs)
    assert rep["decode"]["tokens"] == sum(4 - 1 for _ in reqs)
    assert rep["decode"]["steps"] == 3
    assert rep["prefill"]["batches"] == 1


def test_temperature_sampling_runs():
    cfg = _cfg()
    plan = serving.plan_serve(cfg, budget_bytes=1 << 28, max_len=24)
    tp = transformer.init_params(cfg, seed=0, device="cpu")
    eng = serving.ServingEngine(tp, cfg, plan, dtype=F32, cache_dtype=F32,
                                temperature=0.9)
    reqs = [serving.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                            max_new_tokens=6)]
    eng.run(reqs, warmup_prompt_lens=[8])
    assert len(reqs[0].tokens) == 6
    assert all(0 <= t < VOCAB for t in reqs[0].tokens)
    # one generator stream: the same seed samples the same tokens again
    eng2 = serving.ServingEngine(tp, cfg, plan, dtype=F32, cache_dtype=F32,
                                 temperature=0.9)
    again = [serving.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                             max_new_tokens=6)]
    eng2.run(again, warmup=False)
    eng3 = serving.ServingEngine(tp, cfg, plan, dtype=F32, cache_dtype=F32,
                                 temperature=0.9)
    third = [serving.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                             max_new_tokens=6)]
    eng3.run(third, warmup=False)
    assert again[0].tokens == third[0].tokens


def test_no_donate_matches_donate(toy):
    """``donate=False`` writes every update into a fresh pool; the tokens
    are the in-place engine's."""
    _, cfg, p = toy
    tp = weights.from_reference(p, "cpu")
    plan = serving.plan_serve(cfg, budget_bytes=1 << 28, max_len=32)
    out = {}
    for donate in (True, False):
        reqs = _traffic(serving, 5, 4)
        eng = serving.ServingEngine(tp, cfg, plan, dtype=F32,
                                    cache_dtype=F32, donate=donate)
        before = eng.pool.cache[0]["k"]
        eng.run(reqs, warmup=False)
        assert (eng.pool.cache[0]["k"] is before) == donate
        out[donate] = [r.tokens for r in reqs]
    assert out[True] == out[False]


# ---------------------------------------------------------------------------
# slot pool: admission bound, eviction, reuse
# ---------------------------------------------------------------------------

def test_kv_pool_alloc_free_reuse():
    pool = KVPool(_cfg(), 3, 16, dtype=F32, device="cpu")
    slots = [pool.alloc() for _ in range(3)]
    assert slots == [0, 1, 2] and pool.free_count == 0
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.free(slots[1])
    assert pool.alloc() == slots[1]  # evicted slot is immediately reusable
    pool.free(slots[1])
    with pytest.raises(ValueError):
        pool.free(slots[1])  # double evict
    with pytest.raises(ValueError):
        pool.free(99)  # out of range


@pytest.mark.parametrize("donate", [True, False])
def test_kv_pool_insert_copies_one_row(donate):
    """insert puts prefill row ``row`` into slot ``slot`` of every leaf
    (dim 1), converted to the pool's dtype; the in-place pool keeps its
    storage, the undonated one is replaced and the old pool untouched."""
    cfg = _cfg()
    pool = KVPool(cfg, 4, 16, dtype=torch.bfloat16, device="cpu",
                  donate=donate)
    tp = transformer.init_params(cfg, seed=0, device="cpu")
    _, pre = transformer.prefill(tp, cfg, torch.arange(30).reshape(3, 10) % 7,
                                 16, dtype=F32)
    old = pool.cache
    ptr = old[0]["k"].data_ptr()
    pool.insert(pre, 2, 1)
    for c, p, o in zip(pool.cache, pre, old):
        for name in ("k", "v", "pos"):
            assert torch.equal(c[name][:, 1], p[name][:, 2].to(c[name].dtype))
            assert not c[name][:, 0].any() if name != "pos" else \
                bool((c[name][:, 0] == -1).all())
        if not donate:
            assert not o["k"].any()
    assert (pool.cache[0]["k"].data_ptr() == ptr) == donate


def test_evicted_slots_reused_without_contamination(toy):
    """More requests than slots: every request finishes through slot
    reuse, and a reused slot's tokens equal the one-request decode (the
    previous occupant's row is fully overwritten)."""
    _, cfg, p = toy
    tp = weights.from_reference(p, "cpu")
    reqs = _traffic(serving, 10, 7, prompt_lens=(4, 6), new_tokens=(2, 5),
                    rate=10_000.0)
    plan, eng, rep = _run_engine(cfg, tp, reqs, 24, max_slots=2,
                                 prefill_micro=2)
    assert plan.max_decode_slots == 2
    assert rep["requests"]["finished"] == 10
    assert rep["slots"]["max_concurrent"] <= 2
    assert eng.pool.free_count == 2
    for r in reqs:
        assert r.tokens == _reference_tokens(tp, cfg, r, plan.max_len)


# ---------------------------------------------------------------------------
# plan_serve and the memory model's serving terms against the reference
# ---------------------------------------------------------------------------

def _plan_both(jcfg, cfg, **kw):
    """(port plan or its error type, reference plan or its error type)."""
    out = []
    for pkg, c in ((serving, cfg), (jserving, jcfg)):
        try:
            out.append(dataclasses.asdict(pkg.plan_serve(c, **kw)))
        except ValueError:
            out.append(ValueError)
    return out


def test_plan_serve_equals_reference_sweep():
    """A seeded sweep over dense patterns, widths, contexts, budgets and
    pinned slots / micro-batches: the port's plan equals the reference's
    field by field, or both refuse; an admitted plan's modeled peak is
    within its budget."""
    rng = np.random.default_rng(0)
    admitted = 0
    for _ in range(60):
        pat = [("global",), ("global", "local"), ("local", "local",
                                                  "global")][rng.integers(3)]
        kw = dict(d_model=int(rng.choice([24, 48])),
                  num_kv_heads=int(rng.choice([1, 2])),
                  head_dim=int(rng.choice([6, 12])))
        jcfg, cfg = _cfgs(pat, **kw)
        plan_kw = dict(max_len=int(rng.choice([16, 64, 256])),
                       budget_bytes=int(rng.choice([1 << 22, 1 << 26,
                                                    1 << 30])),
                       cache_bytes=int(rng.choice([2, 4])))
        if rng.random() < 0.3:
            plan_kw["max_slots"] = int(rng.choice([1, 4, 64]))
        if rng.random() < 0.3:
            plan_kw["prefill_micro"] = int(rng.choice([1, 2, 16]))
        if rng.random() < 0.2:
            plan_kw["global_window"] = 32
        got, want = _plan_both(jcfg, cfg, **plan_kw)
        assert got == want, plan_kw
        if got is not ValueError:
            admitted += 1
            plan = serving.ServePlan(**got)
            assert plan.modeled_peak_bytes() <= plan_kw["budget_bytes"]
            assert 1 <= plan.prefill_micro <= plan.max_decode_slots
            assert plan.describe() == jserving.ServePlan(**want).describe()
    assert admitted >= 20


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "gemma3-12b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_plan_serve_equals_reference_for_configs(arch, reduced):
    get = "get_reduced" if reduced else "get"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    budget, max_len = ((1 << 28, 128) if reduced else (10 << 30, 2048))
    if arch != "qwen2-1.5b" and not reduced:
        budget, max_len = 64 << 30, 8192
    got, want = _plan_both(jcfg, cfg, budget_bytes=budget, max_len=max_len)
    assert got == want and got is not ValueError
    if not reduced and arch == "qwen2-1.5b":
        assert (got["max_decode_slots"], got["prefill_micro"]) == (51, 8)
        assert got["kv_slot_bytes"] == 58_949_632
        assert got["prefill_bytes_per_sample"] == 182_240_768
    if not reduced and arch == "gemma2-9b":
        assert (got["max_decode_slots"], got["prefill_micro"]) == (8, 4)
        assert got["kv_slot_bytes"] == 2_114_961_408


# the state and MoE families' serving cells: (budget GiB, max_len, depth)
# and the plan the reference's arithmetic gives — slots, prefill micro,
# kv_slot_bytes, prefill bytes a sample, modeled peak
FAMILY_CELLS = {
    "mamba2-780m": ((10, 2048, None),
                    (84, 8, 76_455_936, 139_571_616, 10_725_633_280)),
    "recurrentgemma-2b": ((24, 4096, None),
                          (256, 4, 17_303_552, 2_513_938_432,
                           25_281_685_504)),
    "moonshot-v1-16b-a3b": ((32, 2048, 4),
                            (256, 8, 67_141_632, 214_335_488,
                             29_718_093_824)),
}


@pytest.mark.parametrize("arch", list(FAMILY_CELLS))
@pytest.mark.parametrize("reduced", [True, False])
def test_plan_serve_equals_reference_for_family_configs(arch, reduced):
    """The ssm, hybrid and MoE configs: reduced at a small budget, and at
    full width at the serving cells' budgets (moonshot cut to 4 layers),
    where the plan is pinned integer for integer."""
    (budget_gb, max_len, layers), pinned = FAMILY_CELLS[arch]
    if reduced:
        cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
        budget, max_len = 1 << 28, 128
    else:
        cfg, jcfg = configs.get(arch), jconfigs.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            jcfg = dataclasses.replace(jcfg, num_layers=layers)
        budget = budget_gb << 30
    got, want = _plan_both(jcfg, cfg, budget_bytes=budget, max_len=max_len)
    assert got == want and got is not ValueError
    assert not got["ragged_prefill"]
    if not reduced:
        plan = serving.ServePlan(**got)
        assert (plan.max_decode_slots, plan.prefill_micro,
                plan.kv_slot_bytes, plan.prefill_bytes_per_sample,
                plan.modeled_peak_bytes()) == pinned


_ESTIMATE_CASES = {
    "global-local": dict(pattern=("global", "local")),
    "ssm": dict(pattern=("ssm", "global"), ssm_state=16, ssm_head_dim=24),
    "recurrent": dict(pattern=("recurrent", "local"), lru_width=48),
    "moe": dict(pattern=("global",), num_experts=4, experts_per_token=2,
                moe_d_ff=64, d_ff=0, capacity_factor=8.0),
}


@pytest.mark.parametrize("case", list(_ESTIMATE_CASES))
@pytest.mark.parametrize("cache_bytes", [2, 4])
def test_serve_estimate_equals_reference(case, cache_bytes):
    """Every serving term, the ssm / recurrent / MoE ones included, is the
    reference's integer for integer."""
    kw = dict(_ESTIMATE_CASES[case])
    jcfg, cfg = _cfgs(kw.pop("pattern"), **kw)
    for max_len, gw in ((16, None), (64, None), (256, 32)):
        args = dict(cache_bytes=cache_bytes, global_window=gw)
        want = jmemory_model.serve_estimate(jcfg, max_len, prefill_len=48,
                                            **args)
        got = memory_model.serve_estimate(cfg, max_len, prefill_len=48,
                                          **args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.affine_coeffs(3) == want.affine_coeffs(3)
        assert memory_model.kv_bytes_per_token(cfg, cache_bytes) == \
            jmemory_model.kv_bytes_per_token(jcfg, cache_bytes)
        assert memory_model.slot_state_bytes(cfg, cache_bytes) == \
            jmemory_model.slot_state_bytes(jcfg, cache_bytes)
        assert memory_model.kv_slot_bytes(cfg, max_len, cache_bytes, gw) == \
            jmemory_model.kv_slot_bytes(jcfg, max_len, cache_bytes, gw)
    assert memory_model.CACHE_POS_BYTES == jmemory_model.CACHE_POS_BYTES


def test_plan_serve_monotone_in_budget():
    cfg = configs.get_reduced("qwen2-1.5b")
    est = memory_model.serve_estimate(cfg, 64, prefill_len=64)
    budgets = [est.total(s, 8) for s in (1, 4, 16, 64)]
    slots = [serving.plan_serve(cfg, budget_bytes=b, max_len=64,
                                prefill_micro=8).max_decode_slots
             for b in budgets]
    assert slots == sorted(slots), slots
    assert slots[-1] >= 64


def test_plan_serve_pinned_overrun_raises():
    cfg = configs.get_reduced("qwen2-1.5b")
    est = memory_model.serve_estimate(cfg, 64, prefill_len=64)
    with pytest.raises(ValueError, match="fits at most"):
        serving.plan_serve(cfg, budget_bytes=est.total(2, 1), max_len=64,
                           max_slots=64, prefill_micro=1)


def test_kv_slot_bytes_honors_windows():
    cfg = _cfg(("global", "local"), sliding_window=8)
    per_entry = 2 * cfg.num_kv_heads * cfg.head_dim * 2 \
        + memory_model.CACHE_POS_BYTES
    assert memory_model.kv_slot_bytes(cfg, 64) \
        - memory_model.kv_slot_bytes(cfg, 8) == (64 - 8) * per_entry
    # and the pool's real allocation is the model's slot accounting
    pool = KVPool(cfg, 4, 64, dtype=torch.bfloat16, device="cpu")
    assert pool.bytes() == 4 * memory_model.kv_slot_bytes(cfg, 64)
    pool = KVPool(cfg, 3, 64, dtype=F32, device="cpu", global_window=16)
    assert pool.bytes() == 3 * memory_model.kv_slot_bytes(cfg, 64, 4, 16)


def test_serve_estimate_affine_in_slots():
    est = memory_model.serve_estimate(configs.get_reduced("qwen2-1.5b"), 64)
    fixed, per_slot = est.affine_coeffs(prefill_micro=2)
    for s in (0, 1, 7):
        assert est.total(s, 2) == fixed + per_slot * s


def test_synthetic_traffic_equals_reference():
    kw = dict(rate_rps=32.0, prompt_lens=(128, 512, 1024),
              new_tokens=(64, 256), vocab_size=151_936, seed=1)
    got = list(serving.synthetic_traffic(96, **kw))
    want = list(jserving.synthetic_traffic(96, **kw))
    assert len(got) == len(want) == 96
    for a, b in zip(got, want):
        assert (a.rid, a.max_new_tokens, a.arrival_s) == \
            (b.rid, b.max_new_tokens, b.arrival_s)
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ---------------------------------------------------------------------------
# family guards
# ---------------------------------------------------------------------------

_FAMILIES = {
    "ssm": dict(pattern=("ssm",), ssm_state=16, ssm_head_dim=24,
                num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0),
    "recurrent": dict(pattern=("recurrent", "recurrent", "local"),
                      lru_width=48),
    "moe": dict(pattern=("global",), num_experts=4, experts_per_token=2,
                moe_d_ff=64, d_ff=0, capacity_factor=8.0),
    "encdec": dict(pattern=("global",), encoder_layers=2, ffn_kind="gelu"),
}


@pytest.mark.parametrize("case", list(_FAMILIES))
def test_unported_families_name_item_10(case):
    """The reference serves ssm / recurrent / MoE stacks in exact-length
    prefill groups and refuses enc-dec. The port plans the three families
    as the reference does (plan field for field, not ragged), its pool
    holds exactly slots × ``kv_slot_bytes``, and its engine gives the
    reference engine's tokens; enc-dec is refused before anything is
    allocated — in check_servable and plan_serve with the reference's
    message, and in init_cache, prefill and the pool naming
    ``models.encdec``, the stack that builds it."""
    kw = dict(_FAMILIES[case])
    jcfg, cfg = _cfgs(kw.pop("pattern"), **kw)
    if case == "encdec":
        with pytest.raises(ValueError, match="encoder-decoder") as want:
            jserving.check_servable(jcfg)
        for call in (lambda: serving.check_servable(cfg),
                     lambda: serving.plan_serve(cfg, budget_bytes=1 << 28,
                                                max_len=24)):
            with pytest.raises(ValueError) as got:
                call()
            assert str(got.value) == str(want.value)
        for call in (lambda: transformer.init_cache(cfg, 2, 24, F32,
                                                    device="cpu"),
                     lambda: transformer.prefill(
                         {}, cfg, torch.zeros((2, 8), dtype=torch.long), 24),
                     lambda: KVPool(cfg, 2, 24, device="cpu")):
            with pytest.raises(ValueError, match="models.encdec"):
                call()
        return
    got, want = _plan_both(jcfg, cfg, budget_bytes=1 << 28, max_len=24)
    assert got == want and got is not ValueError
    assert not got["ragged_prefill"] and not \
        transformer.supports_ragged_prefill(cfg)
    pool = KVPool(cfg, 3, 24, dtype=torch.bfloat16, device="cpu")
    assert pool.bytes() == 3 * memory_model.kv_slot_bytes(cfg, 24)
    p = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tp, jp = weights.from_reference(p, "cpu"), jax.tree.map(jnp.asarray, p)
    reqs, jreqs = _traffic(serving, 6, 5), _traffic(jserving, 6, 5)
    plan, eng, rep = _run_engine(cfg, tp, reqs, 24)
    jplan = jserving.plan_serve(jcfg, budget_bytes=1 << 28, max_len=24)
    jeng = jserving.ServingEngine(jp, jcfg, jplan, dtype=jnp.float32,
                                  cache_dtype=jnp.float32)
    jeng.run(jreqs, warmup_prompt_lens=[r.prompt_len for r in jreqs])
    assert rep["requests"]["finished"] == 6 and eng.pool.free_count == \
        plan.max_decode_slots
    for r, jr in zip(reqs, jreqs):
        want = _jax_teacher_forced(jp, jcfg, r, plan.max_len)
        got = _teacher_forced(tp, cfg, r, plan.max_len)
        assert float(np.max(np.abs(got - want))) < ATOL, (case, r.rid)
        top2 = np.sort(want, axis=-1)[:, -2:]
        for i, (a, b) in enumerate(zip(r.tokens, jr.tokens)):
            if top2[i, 1] - top2[i, 0] <= 2 * ATOL:
                break
            assert a == b, (case, r.rid, i)


def test_moe_and_state_families_group_exact_length():
    """``tests/test_serving.py``'s case: the plan groups exact lengths and
    the model refuses a ragged ``lengths=`` prefill."""
    moe = _cfg(("global",), num_experts=4, experts_per_token=2, moe_d_ff=64,
               d_ff=0, capacity_factor=8.0)
    for cfg in (moe, _cfg(("ssm",), ssm_state=16, ssm_head_dim=24,
                          num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)):
        plan = serving.plan_serve(cfg, budget_bytes=1 << 28, max_len=24)
        assert not plan.ragged_prefill
        assert "exact-length" in plan.describe()
        params = transformer.init_params(cfg, seed=0, device="cpu")
        with pytest.raises(ValueError, match="ragged"):
            transformer.prefill(params, cfg,
                                torch.zeros((2, 8), dtype=torch.long), 24,
                                dtype=F32, lengths=torch.tensor([5, 8]))


@pytest.mark.parametrize("pattern", [("ssm", "global"),
                                     ("recurrent", "recurrent", "local")])
def test_mixed_patterns_match_one_request_at_a_time(pattern):
    """``tests/test_serving.py``'s mixed patterns: exact-length groups
    (one length per prefill micro-batch, whatever the queue holds) and
    continuous batching give each request the tokens of its own greedy
    decode."""
    kw = (dict(ssm_state=16, ssm_head_dim=32, conv_width=4)
          if "ssm" in pattern else dict(lru_width=48))
    cfg = _cfg(pattern, **kw)
    tp = transformer.init_params(cfg, seed=0, device="cpu")
    reqs = _traffic(serving, 9, 2)
    plan, eng, rep = _run_engine(cfg, tp, reqs, 32)
    assert not plan.ragged_prefill
    assert rep["requests"]["finished"] == len(reqs)
    assert rep["prefill"]["batches"] >= len({r.prompt_len for r in reqs})
    for r in reqs:
        assert r.state == serving.FINISHED
        assert r.tokens == _reference_tokens(tp, cfg, r, plan.max_len), \
            (pattern, r.rid)


def test_plan_serve_on_a_mesh_names_item_11():
    """``plan_serve(mesh=...)`` plans data-parallel workers, and the engine
    of one worker (one rank of the serve launcher's world,
    ``tests/test_torch_serve_world.py``) holds its ``local_slots``, not
    the plan's slots over all workers; its report plans those."""
    cfg = configs.get_reduced("qwen2-1.5b")
    plan = serving.plan_serve(cfg, budget_bytes=1 << 30, max_len=32,
                              mesh={"data": 2, "model": 1})
    assert plan.data_parallel == 2
    assert plan.max_decode_slots == 2 * plan.local_slots
    params = transformer.init_params(cfg, seed=0, device="cpu")
    eng = serving.ServingEngine(params, cfg, plan, dtype=F32)
    assert eng.pool.max_slots == plan.local_slots
    assert eng.report()["slots"]["planned"] == plan.local_slots


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b", "mamba2-780m",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("data", [2, 4, 8])
def test_plan_serve_on_a_mesh_equals_reference(arch, data):
    """Data-parallel serving plans (per-device budget, params replicated
    or FSDP-discounted, ``local_slots`` per worker, pinned slots split
    over the workers), field for field, refusals alike; and
    ``serve_estimate(mesh=...)`` integer for integer."""
    from conftest import host_mesh
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    tm, jm = {"data": data, "model": 1}, host_mesh(data)
    for fsdp in (False, True):
        for max_len in (64, 256):
            got = memory_model.serve_estimate(cfg, max_len, mesh=tm,
                                              fsdp_params=fsdp)
            want = jmemory_model.serve_estimate(jcfg, max_len, mesh=jm,
                                                fsdp_params=fsdp)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for budget in (1 << 22, 1 << 26, 1 << 30):
            for pins in ({}, {"max_slots": 5}, {"prefill_micro": 2},
                         {"max_slots": 64, "prefill_micro": 16}):
                kw = dict(budget_bytes=budget, max_len=64,
                          fsdp_params=fsdp, **pins)
                out = []
                for pkg, c, m in ((serving, cfg, tm), (jserving, jcfg, jm)):
                    try:
                        out.append(dataclasses.asdict(
                            pkg.plan_serve(c, mesh=m, **kw)))
                    except ValueError as e:
                        out.append(str(e))
                assert out[0] == out[1], (fsdp, budget, pins)
                if isinstance(out[0], dict):
                    plan = serving.ServePlan(**out[0])
                    assert plan.data_parallel == data
                    assert plan.describe() == \
                        jserving.ServePlan(**out[1]).describe()


def test_all_archs_plan_or_fail_cleanly():
    """Every --arch either plans and decodes one step through a pool of
    its plan's geometry (the VLM text-only), or is refused with the
    reference's error — the enc-dec one — never a shape error."""
    served = []
    for arch in configs.ARCHS:
        cfg = configs.get_reduced(arch)
        try:
            plan = serving.plan_serve(cfg, budget_bytes=1 << 30, max_len=32,
                                      max_slots=2, prefill_micro=1)
        except ValueError as e:
            with pytest.raises(ValueError) as want:
                jserving.plan_serve(jconfigs.get_reduced(arch),
                                    budget_bytes=1 << 30, max_len=32,
                                    max_slots=2, prefill_micro=1)
            assert cfg.is_encdec and str(e) == str(want.value), (arch, e)
            continue
        params = transformer.init_params(cfg, seed=0, device="cpu")
        pool = KVPool(cfg, plan.max_decode_slots, plan.max_len, dtype=F32,
                      device="cpu")
        lg, _ = transformer.decode_step(
            params, cfg, torch.zeros((2, 1), dtype=torch.long), pool.cache,
            torch.zeros((2,), dtype=torch.int32), dtype=F32)
        assert lg.shape == (2, 1, cfg.vocab_size)
        served.append(arch)
    assert served == ["gemma2-9b", "grok-1-314b", "recurrentgemma-2b",
                      "gemma3-12b", "qwen2-1.5b", "mixtral-8x22b",
                      "mamba2-780m", "qwen2-vl-72b", "moonshot-v1-16b-a3b"]
