"""The port's autotuner (``repro_torch.engine.autotune``) against the JAX
package's: ``tests/test_autotune.py``'s cases wherever they run without a
card — the tuning cache, its corrupt-file fallback, the affine fit, the
corrected admission search, the key layout, the OOM bound, the block
resolver — and conformance: a cache file the reference writes makes the
port's ``plan_mbs(calibrate="auto")`` equal the reference's field for
field.

The memory oracle measures the caching allocator's peak and the block
tuner times kernels with CUDA events, so ``calibrate="force"`` and the
timed sweep run on the card only: those cases carry the ``gpu`` marker
and skip here; on the CPU the oracle must raise, never model.

Plans are pure arithmetic and must be equal; tuned blocks must give the
default block's bits (atol 0).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro import engine as jengine  # noqa: E402
from repro.engine import autotune as jautotune  # noqa: E402
from repro_torch import configs, engine, kernels, optim, tree  # noqa: E402
from repro_torch.core import memory_model  # noqa: E402
from repro_torch.engine import autotune  # noqa: E402
from test_torch_pipeline import _params  # noqa: E402
from test_torch_streaming import t_loss_fn  # noqa: E402

SEQ = 64
MINI = 32
# tight: analytically even micro-batch 1 overflows the fixed-cost pad
BUDGET = 64 * 1024 ** 2
PLAN_KW = dict(seq_len=SEQ, budget_bytes=BUDGET, remat_policy="period",
               act_bytes=4)
ARCH = "qwen2-1.5b"


@pytest.fixture(autouse=True)
def _reset_active_cache():
    yield
    autotune.set_cache_path(None)
    jautotune.set_cache_path(None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the oracle reads the caching "
                    "allocator's peak; the tuner times CUDA kernels)")
    return torch.device("cuda")


def _cfg():
    return configs.get_reduced(ARCH)


def _plan(**kw):
    return engine.plan_mbs(MINI, model_cfg=_cfg(), device="cpu",
                           **{**PLAN_KW, **kw})


# ---------------------------------------------------------------------------
# cache round trip / fallback
# ---------------------------------------------------------------------------

def test_cache_entry_roundtrip(tmp_path):
    p = str(tmp_path / "t.json")
    c = autotune.TuningCache(p)
    c.put_memory("k", 1.25, -512.0, [(1, 100, 80)])
    c.put_block("b", 4096, {"4096": 10.0})
    c2 = autotune.TuningCache(p)
    assert c2.memory_correction("k") == (1.25, -512.0)
    assert c2.tuned_block("b") == 4096
    assert c2.data["memory"]["k"]["probes"] == [[1, 100, 80]]


def test_cache_files_are_read_by_both_packages(tmp_path):
    """One schema: a file either package writes, the other reads."""
    p = str(tmp_path / "t.json")
    autotune.TuningCache(p).put_memory("port", 1.5, 7.0, [(2, 10, 22)])
    jc = jautotune.TuningCache(p)
    assert jc.memory_correction("port") == (1.5, 7.0)
    jc.put_block("ref", 2048, {"2048": 1.0})
    assert autotune.TuningCache(p).tuned_block("ref") == 2048
    assert autotune.TuningCache(p).memory_correction("port") == (1.5, 7.0)


@pytest.mark.parametrize("garbage", [
    "{not json at all",
    json.dumps({"version": 999, "memory": {"k": {"a": 1, "b": 2}}}),
    json.dumps({"version": 1, "memory": {"k": "not-a-dict"},
                "blocks": {"b": {"block": "nan"}}}),
    json.dumps({"version": 1, "memory": {"k": {"a": -3.0, "b": 0.0}},
                "blocks": {"b": {"block": -5}}}),
])
def test_corrupted_cache_falls_back_without_raising(tmp_path, garbage):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        f.write(garbage)
    c = autotune.TuningCache(p)
    assert c.memory_correction("k") is None
    assert c.tuned_block("b") is None
    # the planner falls back to the analytic plan, silently
    analytic = _plan()
    degraded = _plan(calibrate="auto", tuning_cache=p)
    assert degraded == analytic and not degraded.calibrated
    # the resolver keeps the default block, and a launch still works
    autotune.set_cache_path(p)
    assert kernels.resolve_block("grad_accum", torch.float32, 100,
                                 interpret=True) == 1024
    out = kernels.grad_accum(torch.zeros(100), torch.ones(100), 0.5)
    assert float(out[0]) == 0.5


def test_calibrate_mode_validated():
    with pytest.raises(ValueError, match="calibrate"):
        engine.plan_mbs(8, calibrate="yes", device="cpu")


def test_oracle_refuses_the_cpu():
    """No allocator peak on the CPU: the oracle raises, never models."""
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.measured_step_bytes(_cfg(), SEQ, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        _plan(calibrate="force")
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.tune_block_sizes(1000, device="cpu")


# ---------------------------------------------------------------------------
# the affine fit and the corrected search
# ---------------------------------------------------------------------------

def test_affine_fit_degeneracies():
    # one probe pins only the offset
    assert autotune._fit_affine([(100.0, 80.0)]) == (1.0, -20.0)
    # two probes pin the line exactly
    a, b = autotune._fit_affine([(100.0, 80.0), (200.0, 130.0)])
    assert a == pytest.approx(0.5) and b == pytest.approx(30.0)
    # a negative slope falls back to offset-only
    a, b = autotune._fit_affine([(100.0, 200.0), (200.0, 100.0)])
    assert a == 1.0
    assert autotune._fit_affine([]) == (1.0, 0.0)
    for pts in ([(100.0, 80.0)], [(1.0, 3.0), (2.0, 5.5), (4.0, 9.0)],
                [(100.0, 200.0), (200.0, 100.0)]):
        assert autotune._fit_affine(pts) == jautotune._fit_affine(pts)


def test_affine_coeffs_reproduce_the_estimate():
    est = memory_model.estimate(_cfg(), SEQ, remat_policy="period",
                                act_bytes=4)
    fixed, per_sample = est.affine_coeffs()
    for m in (0, 1, 7, 64):
        assert fixed + per_sample * m == est.total(m)


def test_corrected_micro_search_matches_direct_scan():
    est = memory_model.estimate(_cfg(), SEQ, remat_policy="period",
                                act_bytes=4)
    corr = (0.5, -10 * 1024 ** 2)
    got = autotune.corrected_micro_search(_cfg(), SEQ, 64, BUDGET, corr,
                                          remat_policy="period", act_bytes=4)
    want = max(m for m in range(1, 65)
               if corr[0] * est.total(m) + corr[1] <= BUDGET)
    assert got == want
    assert autotune.corrected_micro_search(
        _cfg(), SEQ, 64, 1, corr, remat_policy="period", act_bytes=4) is None


# ---------------------------------------------------------------------------
# keys: layout, mesh entries, backend
# ---------------------------------------------------------------------------

def test_key_layout_distinguishes_axes():
    cfg = _cfg()
    keys = {
        autotune.memory_key(cfg, 64, "period", None, "sgd", "compiled", "cpu"),
        autotune.memory_key(cfg, 128, "period", None, "sgd", "compiled", "cpu"),
        autotune.memory_key(cfg, 64, "full", None, "sgd", "compiled", "cpu"),
        autotune.memory_key(cfg, 64, "period", None, "adam", "compiled", "cpu"),
        autotune.memory_key(cfg, 64, "period", None, "sgd", "flat", "cpu"),
        autotune.memory_key(cfg, 64, "period", None, "sgd", "compiled", "tpu"),
        autotune.memory_key(cfg, 64, "period", None, "sgd", "compiled", "gpu"),
    }
    assert len(keys) == 7
    full = dataclasses.replace(configs.get(ARCH), name=cfg.name)
    assert (autotune.memory_key(full, 64, "period", None, "sgd", "compiled")
            != autotune.memory_key(cfg, 64, "period", None, "sgd",
                                   "compiled"))


def test_keys_equal_the_reference():
    cfg, jcfg = _cfg(), jconfigs.get_reduced(ARCH)
    for args in ((64, "period", None, "sgd", "compiled", "cpu"),
                 (128, "dots", None, "adam", "flat", "gpu")):
        assert autotune.memory_key(cfg, *args) == jautotune.memory_key(
            jcfg, *args)
    assert autotune.mesh_tag({"data": 2, "model": 1}) == "data2xmodel1"
    for n in (1, 2, 3, 1000, 1 << 20, (1 << 20) + 1):
        assert autotune.size_bucket(n) == jautotune.size_bucket(n)
    assert autotune.block_key("grad_accum", torch.float32, 5000,
                              interpret=True, backend="cpu") == \
        jautotune.block_key("grad_accum", np.float32, 5000, interpret=True,
                            backend="cpu") == "grad_accum|float32|p13|cpu+interp"
    assert autotune.block_key("fused_update", torch.bfloat16, 5000,
                              interpret=False, backend="gpu") == \
        "fused_update|bfloat16|p13|gpu"


def test_mesh_keyed_entry_does_not_leak(tmp_path):
    """A correction keyed by a mesh never serves a single-device plan, and
    the mesh plan with the same cache does see it (the reference's case
    whole, now that ``plan_mbs(mesh=)`` is ported)."""
    cfg = _cfg()
    p = str(tmp_path / "t.json")
    cache = autotune.get_cache(p)
    mesh = {"data": 2, "model": 1}
    cache.put_memory(autotune.memory_key(cfg, SEQ, "period", mesh, "sgd",
                                         "compiled", "cpu"), 0.5, 0.0)
    assert not _plan(calibrate="auto", tuning_cache=p).calibrated
    assert _plan(calibrate="auto", tuning_cache=p, mesh=mesh).calibrated
    cache.put_memory(autotune.memory_key(cfg, SEQ, "period", None, "sgd",
                                         "compiled", "cpu"), 0.5, 0.0)
    assert _plan(calibrate="auto", tuning_cache=p).calibrated


def test_calibrated_mesh_plan_equals_reference(tmp_path):
    """One cache file the reference writes under a data-parallel mesh's
    key gives both planners the same calibrated per-device plan."""
    from conftest import host_mesh
    p = str(tmp_path / "ref.json")
    jcfg = jconfigs.get_reduced(ARCH)
    jautotune.TuningCache(p).put_memory(
        jautotune.memory_key(jcfg, SEQ, "period", host_mesh(2), "sgd",
                             "compiled"),
        0.5, -10 * 1024 ** 2, [(1, 100, 90), (2, 200, 170)])
    kw = dict(PLAN_KW, budget_bytes=72 * 1024 ** 2, calibrate="auto",
              tuning_cache=p)
    want = jengine.plan_mbs(MINI, model_cfg=jcfg, mesh=host_mesh(2), **kw)
    got = engine.plan_mbs(MINI, model_cfg=_cfg(), device="cpu",
                          mesh={"data": 2, "model": 1}, **kw)
    assert want.calibrated and got.calibrated
    for f in ("micro_batch_size", "num_micro_batches", "pad",
              "data_parallel", "local_micro", "remat_policy", "correction"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.describe() == want.describe()


def test_a_tpu_or_gpu_entry_never_serves_the_cpu(tmp_path):
    cfg = _cfg()
    p = str(tmp_path / "t.json")
    cache = autotune.get_cache(p)
    for backend in ("tpu", "gpu"):
        cache.put_memory(autotune.memory_key(cfg, SEQ, "period", None, "sgd",
                                             "compiled", backend), 0.5, 0.0)
    assert not _plan(calibrate="auto", tuning_cache=p).calibrated


# ---------------------------------------------------------------------------
# conformance: the reference's cache file, both planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget_mib", [28, 72, 130])
@pytest.mark.parametrize("corr", [(0.5, -10 * 1024 ** 2),
                                  (1.7, 3 * 1024 ** 2)])
def test_calibrated_plan_equals_reference(tmp_path, budget_mib, corr):
    """The budgets put the corrected frontier inside the mini-batch (19 and
    14 samples, neither a power of two), at the whole mini-batch, and
    where nothing fits corrected so the analytic plan (1 or 4) stands."""
    p = str(tmp_path / "ref.json")
    jcfg = jconfigs.get_reduced(ARCH)
    jautotune.TuningCache(p).put_memory(
        jautotune.memory_key(jcfg, SEQ, "period", None, "sgd", "compiled"),
        *corr, [(1, 100, 90), (2, 200, 170)])
    kw = dict(PLAN_KW, budget_bytes=budget_mib * 1024 ** 2,
              calibrate="auto", tuning_cache=p)
    want = jengine.plan_mbs(MINI, model_cfg=jcfg, **kw)
    got = engine.plan_mbs(MINI, model_cfg=_cfg(), device="cpu", **kw)
    for f in ("mini_batch_size", "micro_batch_size", "num_micro_batches",
              "pad", "normalization", "auto_micro", "auto_normalization",
              "remat_policy", "auto_policy", "calibrated", "correction"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.describe() == want.describe()
    analytic = engine.plan_mbs(MINI, model_cfg=_cfg(), device="cpu",
                               **dict(kw, calibrate="off"))
    if got.calibrated:
        assert "calibrated memory model" in got.describe()
        assert got.correction == corr
    else:  # the corrected search admitted nothing: the analytic plan stands
        assert dataclasses.replace(got, calibrated=False) == analytic


def test_pinned_micro_ignores_calibration(tmp_path):
    p = str(tmp_path / "t.json")
    autotune.get_cache(p).put_memory(autotune.memory_key(
        _cfg(), SEQ, "period", None, "sgd", "compiled", "cpu"), 0.5, 0.0)
    plan = _plan(calibrate="auto", tuning_cache=p, micro_batch_size=4)
    assert plan.micro_batch_size == 4 and not plan.calibrated


# ---------------------------------------------------------------------------
# calibrate="force" against a fake memory oracle: a probe the card cannot
# hold, and a peak that changes regime between the probes
# ---------------------------------------------------------------------------

GB = 10 ** 9
BUDGET_60 = 60 * 1024 ** 3


def _fake_oracle(monkeypatch, fn):
    """Make ``fn(micro, policy)`` the probe's measured bytes (or raise)."""
    calls = []

    def oracle(cfg, seq, micro, *, remat_policy="period", **kw):
        calls.append((remat_policy, micro))
        return fn(micro, remat_policy)
    monkeypatch.setattr(autotune, "measured_step_bytes", oracle)
    return calls


def _force(tmp_path, mini=16, cal="force", **kw):
    return engine.plan_mbs(
        mini, model_cfg=configs.get(ARCH), seq_len=1024,
        budget_bytes=BUDGET_60, device="cpu", calibrate=cal,
        tuning_cache=str(tmp_path / "t.json"), act_bytes=2,
        **{"remat_policy": "auto", **kw})


def test_probe_oom_climbs_the_lattice(tmp_path, monkeypatch):
    """A probe that does not fit rules its policy out: ``none`` and
    ``dots`` OOM, the planner climbs to ``period`` itself, records the
    OOM'd policies in their tuning entries, and ``auto`` plans the same
    from the cache alone."""
    def fn(micro, policy):
        if policy in ("none", "dots"):
            raise torch.OutOfMemoryError(f"injected at micro {micro}")
        return int(20 * GB + 2 * GB * micro)
    calls = _fake_oracle(monkeypatch, fn)
    assert engine.plan_mbs(16, model_cfg=configs.get(ARCH), seq_len=1024,
                           budget_bytes=BUDGET_60, device="cpu",
                           remat_policy="auto", act_bytes=2
                           ).remat_policy == "none"  # the analytic choice
    plan = _force(tmp_path)
    assert plan.remat_policy == "period" and plan.auto_policy
    assert plan.calibrated and plan.micro_batch_size == 16
    assert [c for c in calls if c[0] != "period"] == [("none", 1),
                                                      ("dots", 1)]
    cache = autotune.get_cache(str(tmp_path / "t.json"))
    for pol in ("none", "dots"):
        oom = cache.memory_oom(autotune.memory_key(
            configs.get(ARCH), 1024, pol, None, "sgd", "compiled", "cpu"))
        assert oom == {"micro": 1, "error": "injected at micro 1"}
    n = len(calls)
    assert _force(tmp_path, cal="auto") == plan
    assert len(calls) == n  # "auto" probes nothing


@pytest.mark.parametrize("full_from", [17, 6])
def test_climb_keeps_the_reference_joint_rule(tmp_path, monkeypatch,
                                             full_from):
    """After a probe OOM rules the analytic policy out, the planner walks
    the rungs left by the reference's joint rule
    (``memory_model.suggest_remat_policy_and_micro``): the first whose
    micro-batch reaches the whole mini-batch, else the one admitting the
    largest, ties to the cheaper — held against the reference's own
    function over the micro-batches the calibrated planner admits for
    each policy pinned. ``none`` runs out of memory; ``dots`` measures
    over the budget from micro 3, ``period`` from 7 and ``full`` from
    ``full_from`` (17: it reaches the mini-batch of 16; 6: no policy
    does, and ``period`` admits the most)."""
    over = {"dots": 3, "period": 7, "full": full_from}

    def fn(micro, policy):
        if policy == "none":
            raise torch.OutOfMemoryError("injected")
        return int(BUDGET_60 + GB if micro >= over[policy]
                   else 20 * GB + GB // 100 * micro)
    _fake_oracle(monkeypatch, fn)
    admitted = {}
    for pol in ("dots", "period", "full"):
        admitted[pol] = _force(tmp_path, remat_policy=pol).micro_batch_size
    with pytest.raises(ValueError, match="remat policy 'none'"):
        _force(tmp_path, remat_policy="none")
    admitted["none"] = None
    from repro.core import memory_model as jmemory_model
    monkeypatch.setattr(
        jmemory_model, "suggest_micro_batch_size",
        lambda cfg, seq, mini, *, remat_policy, **kw: admitted[remat_policy])
    want = jmemory_model.suggest_remat_policy_and_micro(
        jconfigs.get(ARCH), 1024, 16)
    plan = _force(tmp_path)
    assert plan.auto_policy and plan.calibrated
    assert (plan.remat_policy, plan.micro_batch_size) == want
    assert want == (("full", 16) if full_from == 17 else ("period", 6))


def test_probe_oom_of_a_pinned_policy_is_the_planners_error(tmp_path,
                                                            monkeypatch):
    """A pinned policy (or the lattice's last rung) is ruled out only by
    an out-of-memory smallest probe — the planner's ``ValueError``, not
    the allocator's; a larger probe's OOM caps admission below it."""
    def fn(micro, policy):
        if policy == "none" or micro >= 2:
            raise torch.OutOfMemoryError("injected")
        return int(40 * GB)
    _fake_oracle(monkeypatch, fn)
    with pytest.raises(ValueError, match="remat policy 'none'"):
        _force(tmp_path, remat_policy="none")
    plan = _force(tmp_path, remat_policy="full")
    assert plan.remat_policy == "full" and plan.calibrated
    assert plan.micro_batch_size == 1


def test_back_off_probe_keeps_the_plan_in_budget(tmp_path, monkeypatch):
    """The two regimes of qwen2-vl-72b's probes on the card (1 layer,
    ``flat``): micro 1 and 2 peak at the set-up (54.11 / 54.14 GB), micro
    4 at the step (58.68 GB), whose line is steeper. The line through the
    three admits micro 7 (the reference's plan, 66 GiB real); the planner
    probes 7, finds it over the budget, refits and steps down until a
    measured probe fits."""
    def oracle_bytes(micro):
        setup = 54.11 * GB + 0.03 * GB * (micro - 1)
        step = 58.68 * GB + 4.094 * GB * (micro - 4)
        return int(max(setup, step))
    calls = _fake_oracle(monkeypatch, lambda m, p: oracle_bytes(m))
    cfg = configs.get(ARCH)
    est = memory_model.estimate(cfg, 1024, act_bytes=2,
                                remat_policy="period")
    first = [(est.total(m), oracle_bytes(m)) for m in (1, 2, 4)]
    reference = autotune.corrected_micro_search(
        cfg, 1024, 8, BUDGET_60, autotune._fit_affine(first),
        remat_policy="period", act_bytes=2)
    assert oracle_bytes(reference) > BUDGET_60  # the fault repaired here
    plan = _force(tmp_path, mini=8, remat_policy="period")
    assert plan.calibrated
    assert oracle_bytes(plan.micro_batch_size) <= BUDGET_60
    assert 2 < plan.micro_batch_size < reference
    probed = [m for _, m in calls]
    assert probed[:3] == [1, 2, 4] and reference in probed
    assert plan.micro_batch_size in probed
    # the cache caps "auto" below the size measured over the budget
    assert _force(tmp_path, mini=8, remat_policy="period",
                  cal="auto") == plan


# ---------------------------------------------------------------------------
# negative bounds from an observed OOM
# ---------------------------------------------------------------------------

def test_record_oom_bound_shrinks_admission(tmp_path):
    cfg = _cfg()
    p = str(tmp_path / "t.json")
    kw = dict(remat_policy="period", act_bytes=4)
    budget = 1024 ** 3
    admitted = autotune.corrected_micro_search(cfg, SEQ, MINI, budget,
                                               (1.0, 0.0), **kw)
    a, b = autotune.record_oom_bound(cfg, SEQ, admitted, budget,
                                     cache_path=p, device="cpu", **kw)
    assert a == 1.0 and b > 0
    after = autotune.corrected_micro_search(cfg, SEQ, MINI, budget, (a, b),
                                            **kw)
    assert after < admitted
    # a correction that already rejects the micro-batch is left as it is
    again = autotune.record_oom_bound(cfg, SEQ, admitted, budget,
                                      cache_path=p, device="cpu", **kw)
    assert again == (a, b)
    # the reference records the same bound
    jp = str(tmp_path / "j.json")
    jgot = jautotune.record_oom_bound(jconfigs.get_reduced(ARCH), SEQ,
                                      admitted, budget, cache_path=jp, **kw)
    assert jgot == (a, b)


# ---------------------------------------------------------------------------
# the block resolver
# ---------------------------------------------------------------------------

def _tuned_cache(tmp_path, block: int, mode: str = "cpu+interp"):
    """A cache mapping every fp32 size bucket of both tunable kernels to
    ``block``."""
    p = str(tmp_path / f"tuned-{block}.json")
    cache = autotune.get_cache(p)
    for kind in ("grad_accum", "fused_update"):
        for exp in range(1, 32):
            cache.data["blocks"]["|".join(
                [kind, "float32", f"p{exp}", mode])] = {
                "block": block, "timings_us": {}}
    cache.save()
    return p


@pytest.mark.parametrize("block", [256, 8192, 37, 0])
def test_resolver_serves_powers_of_two_only(tmp_path, block):
    """A tuned power of two is served (clamped to the buffer's
    power-of-two ceiling); 0 (the reference's whole buffer) and 37 are no
    launch geometry on the card, so the default block stays."""
    autotune.set_cache_path(_tuned_cache(tmp_path, block))
    for n in (100, 5000, 3_000_000):
        default = kernels._launch.launch_config(n)[0]
        got = kernels.resolve_block("grad_accum", torch.float32, n,
                                    interpret=True)
        pow2 = block > 0 and not block & (block - 1)
        want = min(block, 1 << (n - 1).bit_length()) if pow2 else default
        assert got == want
        # the card's key ("gpu") has no entry in this cache
        assert kernels.resolve_block("grad_accum", torch.float32, n,
                                     interpret=False) == default


def test_bucket_blocks_helper(tmp_path):
    spec = engine.FlatSpec.for_tree(_params())
    autotune.set_cache_path(None)
    default = tuple(kernels._launch.launch_config(n)[0]
                    for n in spec.bucket_sizes)
    assert spec.bucket_blocks("grad_accum", interpret=True) == default
    autotune.set_cache_path(_tuned_cache(tmp_path, 64))
    assert spec.bucket_blocks("grad_accum", interpret=True) == \
        tuple(min(64, 1 << (n - 1).bit_length()) for n in spec.bucket_sizes)


EXECUTOR_GRID = sorted(engine.EXECUTORS)


@pytest.mark.parametrize("executor", EXECUTOR_GRID)
def test_executor_bit_equal_under_tuning(executor, tmp_path):
    """Tuned blocks active and a plan flagged as calibrated: the step is
    bit-equal — tuning changes speed and admission only."""
    from conftest import ToyDataset
    opt = optim.sgd(0.1, momentum=0.9, weight_decay=1e-4)
    plan = engine.plan_mbs(10, num_microbatches=3, device="cpu")
    split = plan.device_split(ToyDataset().batch(10, 0), "cpu")

    def run(p):
        ex = engine.get_executor(executor)(t_loss_fn, opt, p)
        params, state = _params(), opt.init(_params())
        if executor == "flat":
            params, state = ex.prepare(params, state)
        return ex.step_split(params, state, split)

    autotune.set_cache_path(None)
    base_p, base_s, base_m = run(plan)
    autotune.set_cache_path(_tuned_cache(tmp_path, 256))
    cal_plan = dataclasses.replace(plan, calibrated=True,
                                   correction=(1.0, 0.0))
    tuned_p, tuned_s, tuned_m = run(cal_plan)
    for a, b in zip(tree.leaves((tuned_p, tuned_s)),
                    tree.leaves((base_p, base_s))):
        assert torch.equal(a, b)
    assert float(tuned_m["loss"]) == float(base_m["loss"])


# ---------------------------------------------------------------------------
# on the card: the oracle, calibrated admission, the timed sweep
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_calibrated_admission_holds_on_the_card(card, tmp_path):
    """``force`` probes the real step; the admitted micro-batch's measured
    peak stays within the budget."""
    cfg = _cfg()
    budget = 256 * 1024 ** 2
    plan = engine.plan_mbs(MINI, model_cfg=cfg, device=card,
                           calibrate="force",
                           tuning_cache=str(tmp_path / "t.json"),
                           **dict(PLAN_KW, budget_bytes=budget))
    assert plan.calibrated and plan.correction is not None
    measured = autotune.measured_step_bytes(
        cfg, SEQ, plan.micro_batch_size, remat_policy=plan.remat_policy,
        device=card)
    assert measured <= budget


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["grad_accum", "fused_update"])
def test_tuned_blocks_bit_identical_on_the_card(card, tmp_path, kind):
    n = 3_000_017
    rec = autotune.tune_block_sizes(n, kind=kind, iters=2, device=card,
                                    cache_path=str(tmp_path / "t.json"))
    assert rec["block"] in autotune.CANDIDATE_BLOCKS
    assert set(rec["timings_us"]) == {str(b) for b in
                                      autotune.CANDIDATE_BLOCKS}
    base = autotune.sweep_operands(kind, n, device=card)
    autotune.run_with_block(kind, base, None)
    for block in autotune.CANDIDATE_BLOCKS:
        ops = autotune.sweep_operands(kind, n, device=card)
        autotune.run_with_block(kind, ops, block)
        assert all(torch.equal(a, b) for a, b in zip(ops, base)), block
