"""The port's kernels K5 (fused cross-entropy) and K6 (flash attention),
through their wrappers on CPU tensors (the plain PyTorch versions) and
through the differentiable API, against the JAX package's Pallas kernels
run in interpret mode on the same numpy inputs — case for case as
``tests/test_kernels.py`` holds the Pallas kernels against their oracles.
Also the launch-geometry hooks and the wrappers' contracts.

Tolerances are the reference tests' own: attention 2e-5 in fp32 and 2e-2
in bf16 (sums taken in another order, bf16 output rounding), the per-token
NLL 1e-4 in both dtypes (both packages sum in fp32), its gradient 1e-6.
The kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import kernels as jkernels  # noqa: E402
from repro.kernels import cross_entropy_kernels as jce  # noqa: E402
from repro.kernels import flash_attention_kernels as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _cuda, _launch  # noqa: E402

fa = kernels.flash_attention_kernels
ce = kernels.cross_entropy_kernels
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _no_resolver():
    """Every test starts with no resolver in the port; both packages'
    resolvers (``engine.autotune`` installs one at import in each) are
    put back as they were, so a later test file in the same process sees
    the port's tuner again."""
    jax_resolver = jkernels.grad_accum_kernels._BLOCK_RESOLVER
    port_resolver = kernels._launch._BLOCK_RESOLVER
    kernels.set_block_resolver(None)
    yield
    kernels.set_block_resolver(port_resolver)
    jkernels.set_block_resolver(jax_resolver)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round fp32 → bf16 to nearest even)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _err(t: torch.Tensor, j) -> float:
    return float(np.max(np.abs(t.detach().float().numpy()
                               - np.asarray(jnp.asarray(j, jnp.float32)))))


def _qkv(seed, B, H, Hkv, S, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(B, h, S, hd)).astype(np.float32)
            for h in (H, Hkv, Hkv)]
    pairs = [_pair(a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# ---------------------------------------------------------------------------
# K6 flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,hd,H,Hkv", [(128, 64, 4, 4), (256, 64, 4, 2),
                                        (256, 32, 8, 1), (384, 64, 2, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_pallas(S, hd, H, Hkv, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(S + hd + H, 2, H, Hkv, S, hd, dtype)
    want = jfa.flash_attention(jq, jk, jv, block_q=128, block_k=128,
                               interpret=True)
    before = kernels.launch_counts()
    got = fa.flash_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert _err(got, want) < tol
    assert kernels.launch_counts() == before  # the plain path never counts


@pytest.mark.parametrize("window,softcap", [(None, None), (64, None),
                                            (None, 30.0), (96, 50.0)])
def test_flash_attention_window_softcap_matches_pallas(window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 1, 4, 2, 256, 64)
    want = jfa.flash_attention(jq, jk, jv, window=window, softcap=softcap,
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv, window=window, softcap=softcap)
    assert _err(got, want) < 2e-5


def test_flash_attention_unaligned_seq_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 1, 2, 2, 200, 64)
    want = jfa.flash_attention(jq, jk, jv, block_q=128, block_k=128,
                               interpret=True)
    got = fa.flash_attention(tq, tk, tv)
    assert got.shape == tq.shape
    assert _err(got, want) < 2e-5


def test_flash_attention_vjp_matches_pallas():
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 1, 2, 2, 128, 32)
    w = np.random.default_rng(30).normal(size=tq.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c: (jops.flash_attention(a, b, c, True, 32,
                                                           None)
                                     * jnp.asarray(w)).sum(),
                    argnums=(0, 1, 2))(jq, jk, jv)
    ins = [x.requires_grad_() for x in (tq, tk, tv)]
    before = kernels.launch_counts()
    out = kernels.ops.flash_attention(*ins, True, 32, None)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)
    for g, j, x in zip(got, want, ins):
        assert g.shape == x.shape
        assert _err(g, j) < 2e-5
    assert kernels.launch_counts() == before


def test_flash_attention_api_is_the_ops_function():
    (_, _, _), (tq, tk, tv) = _qkv(4, 1, 2, 1, 64, 32)
    a = kernels.flash_attention(tq, tk, tv, True, 16, 20.0)
    b = kernels.ref.attention_ref(tq, tk, tv, window=16, softcap=20.0)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K5 fused cross-entropy
# ---------------------------------------------------------------------------

def _logits(seed, T, V, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(T, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    jx, tx = _pair(x, dtype)
    return jx, tx, jnp.asarray(labels), torch.from_numpy(labels)


@pytest.mark.parametrize("T,V", [(64, 500), (100, 1000), (256, 2048),
                                 (37, 777)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy_matches_pallas(T, V, dtype):
    jx, tx, jl, tl = _logits(T + V, T, V, dtype)
    want = jce.cross_entropy(jx, jl, scale=0.25, block_t=64, block_v=256,
                             interpret=True)
    before = kernels.launch_counts()
    got = ce.cross_entropy(tx, tl, scale=0.25, block_t=64, block_v=256)
    assert got.shape == (T,) and got.dtype == torch.float32
    assert _err(got, want) < 1e-4
    assert kernels.launch_counts() == before


def test_cross_entropy_vjp_matches_pallas():
    jx, tx, jl, tl = _logits(5, 16, 64)
    w = np.random.default_rng(50).normal(size=16).astype(np.float32)
    want = jax.grad(lambda x: (jops.fused_cross_entropy(x, jl, 0.5)
                               * jnp.asarray(w)).sum())(jx)
    tx.requires_grad_()
    out = kernels.cross_entropy(tx, tl, 0.5)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)
    assert got.dtype == tx.dtype
    assert _err(got, want) < 1e-6


def test_cross_entropy_backward_bf16_and_out_of_range_label():
    """Forward and backward through the API: a label outside [0, V) gives
    ``lse · scale`` forward, as the Pallas kernel does, and has no one-hot
    row backward, as ``jax.nn.one_hot`` gives; bf16 logits get a bf16
    gradient."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    labels = np.array([3, 31, 0, 40, -1], np.int32)
    jx, tx = _pair(x, "bfloat16")
    jl = jnp.asarray(labels)
    want_out = jops.fused_cross_entropy(jx, jl, 0.25)
    want = jax.grad(lambda a: jops.fused_cross_entropy(a, jl, 0.25).sum())(jx)
    tx.requires_grad_()
    out = kernels.cross_entropy(tx, torch.from_numpy(labels), 0.25)
    assert _err(out, want_out) < 1e-4
    (got,) = torch.autograd.grad(out.sum(), tx)
    assert got.dtype == torch.bfloat16
    assert _err(got, want) < 2e-2
    for row in (3, 4):
        assert float(got[row].float().sum()) == pytest.approx(0.25, abs=1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy_out_of_range_labels_match_pallas(dtype):
    """Labels below 0 and at or past V hit no column: their rows give
    ``lse · scale`` on the plain path, as in the Pallas kernel (run at its
    default blocks, which pad no vocab column here)."""
    jx, tx, _, tl = _logits(18, 6, 777, dtype)
    labels = np.array([-1, 777, 5000, -300, 0, 776], np.int32)
    want = jce.cross_entropy(jx, jnp.asarray(labels), scale=0.25,
                             interpret=True)
    got = ce.cross_entropy(tx, torch.from_numpy(labels), scale=0.25)
    assert _err(got, want) < 1e-4
    lse = torch.logsumexp(tx.float(), dim=-1) * 0.25
    assert torch.allclose(got[:4], lse[:4], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# launch-geometry hooks
# ---------------------------------------------------------------------------

TUNED = {"cross_entropy_t": 8, "cross_entropy_v": 512, "flash_q": 64,
         "flash_k": 64, "grad_accum": 256, "fused_update": 512}


def test_resolver_changes_blocks_not_values():
    jx, tx, jl, tl = _logits(7, 37, 777)
    (_, _, _), (tq, tk, tv) = _qkv(8, 1, 2, 1, 96, 32)
    acc, g = torch.zeros(3000), torch.ones(3000)
    default = (ce.launch_blocks(tx), fa.launch_blocks(96, tq.dtype),
               _launch.stream_geometry("grad_accum", acc.dtype, 3000),
               _launch.stream_geometry("fused_update", acc.dtype, 3000))
    assert default == ((ce.DEFAULT_BLOCK_T, ce.DEFAULT_BLOCK_V), (64, 64),
                       (1024, 4), (1024, 4))
    outs = [(ce.cross_entropy(tx, tl), fa.flash_attention(tq, tk, tv),
             kernels.grad_accum(acc.clone(), g, 0.5))]
    calls = []

    def resolver(kind, dtype, n, interpret):
        calls.append((kind, dtype, n, interpret))
        return TUNED[kind]

    kernels.set_block_resolver(resolver)
    tuned = (ce.launch_blocks(tx), fa.launch_blocks(96, tq.dtype),
             _launch.stream_geometry("grad_accum", acc.dtype, 3000),
             _launch.stream_geometry("fused_update", acc.dtype, 3000))
    # K6 has one tile, so its resolver can only confirm it
    assert tuned == ((8, 512), (64, 64), (256, 4), (512, 4))
    assert ("flash_q", "float32", 96, False) in calls
    assert ("flash_k", "float32", 96, False) in calls
    outs.append((ce.cross_entropy(tx, tl), fa.flash_attention(tq, tk, tv),
                 kernels.grad_accum(acc.clone(), g, 0.5)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # the plain CPU path asks as the reference's interpret mode does
    assert ("cross_entropy_t", "float32", 37, True) in calls


def test_resolver_keys_are_the_references():
    """The port asks the resolver with the reference's keys, so a tuner
    keeps the reference's cache schema (its values are the card's own)."""
    jx, tx, jl, tl = _logits(9, 37, 777, "bfloat16")
    seen = {"jax": [], "torch": []}

    def recorder(who):
        def resolver(kind, dtype, n, interpret):
            seen[who].append((kind, dtype, n, interpret))
            return None
        return resolver

    jkernels.set_block_resolver(recorder("jax"))
    kernels.set_block_resolver(recorder("torch"))
    jce.cross_entropy(jx, jl, interpret=True)
    ce.cross_entropy(tx, tl)
    assert seen["torch"] == seen["jax"] == [
        ("cross_entropy_t", "bfloat16", 37, True),
        ("cross_entropy_v", "bfloat16", 777, True)]


def test_lookup_clamps_and_resolve_falls_back():
    assert kernels.lookup_tuned_block("flash_q", torch.float32, 256) is None
    for n in (1000, 1 << 21):
        assert kernels.resolve_block("grad_accum", torch.float32, n) == \
            _launch.launch_config(n)[0]
    kernels.set_block_resolver(lambda *a: 4096)
    assert kernels.lookup_tuned_block("flash_q", torch.float32, 256) == 256
    assert kernels.lookup_tuned_block("flash_q", torch.float32, 1) == 1
    # a Triton block masks its ragged edge: n rounds up to a power of two
    assert kernels.lookup_tuned_block("flash_q", torch.float32, 1000) == 1024
    assert kernels.resolve_block("grad_accum", torch.float32, 1 << 21) == 4096
    kernels.set_block_resolver(lambda *a: None)
    assert kernels.lookup_tuned_block("flash_q", torch.float32, 256) is None
    assert kernels.resolve_block("grad_accum", torch.float32, 10) == 1024


@pytest.mark.parametrize("bad", [96, 3, -4])
def test_non_power_of_two_block_is_refused(bad):
    _, tx, _, tl = _logits(10, 8, 100)
    kernels.set_block_resolver(lambda *a: bad)
    with pytest.raises(ValueError, match="not a power of two"):
        kernels.resolve_block("grad_accum", torch.float32, 1 << 20)
    with pytest.raises(ValueError, match="not a power of two"):
        ce.cross_entropy(tx, tl)
    kernels.set_block_resolver(None)
    with pytest.raises(ValueError, match="not a power of two"):
        ce.cross_entropy(tx, tl, block_v=bad)


def test_flash_tile_without_instance_is_refused():
    (_, _, _), (tq, tk, tv) = _qkv(11, 1, 2, 2, 64, 32)
    with pytest.raises(ValueError, match="no kernel instance for block_q"):
        fa.flash_attention(tq, tk, tv, block_q=128)
    with pytest.raises(ValueError, match="no kernel instance for block_k"):
        fa.flash_attention(tq, tk, tv, block_k=32)
    with pytest.raises(ValueError, match="not a power of two"):
        fa.flash_attention(tq, tk, tv, block_k=48)
    # a resolver's tile is refused the same way, never rounded
    kernels.set_block_resolver(lambda *a: 32)
    with pytest.raises(ValueError, match="no kernel instance for block_q"):
        fa.launch_blocks(256, torch.float32)


@pytest.mark.parametrize("S", [1, 20, 64])
def test_resolver_tile_spanning_short_seq_takes_the_covering_tile(S):
    """The resolver's block is clamped to S, as in the reference; a tile
    that spans S is then the one 64-row instance, which masks the rest."""
    kernels.set_block_resolver(lambda *a: 64)
    assert kernels.lookup_tuned_block("flash_q", torch.float32, S) <= 64
    assert fa.launch_blocks(S, torch.float32) == (64, 64)
    (jq, jk, jv), (tq, tk, tv) = _qkv(19 + S, 1, 2, 1, S, 32)
    want = jfa.flash_attention(jq, jk, jv, interpret=True)
    assert _err(fa.flash_attention(tq, tk, tv), want) < 2e-5


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_non_causal_unaligned_seq_is_refused_as_in_the_reference():
    (jq, jk, jv), (tq, tk, tv) = _qkv(12, 1, 2, 2, 200, 64)
    with pytest.raises(AssertionError, match="causal"):
        jfa.flash_attention(jq, jk, jv, causal=False, block_q=128,
                            block_k=128, interpret=True)
    with pytest.raises(ValueError, match="only causal attention"):
        fa.flash_attention(tq, tk, tv, causal=False)
    # aligned, non-causal attention is taken and matches the reference
    (jq, jk, jv), (tq, tk, tv) = _qkv(13, 1, 2, 1, 128, 32)
    want = jfa.flash_attention(jq, jk, jv, causal=False, interpret=True)
    assert _err(fa.flash_attention(tq, tk, tv, causal=False), want) < 2e-5


def test_unsupported_operands_are_refused():
    (_, _, _), (tq, tk, tv) = _qkv(14, 1, 2, 2, 16, 48)
    with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
        fa.flash_attention(tq, tk, tv)
    (_, _, _), (tq, tk, tv) = _qkv(15, 1, 3, 2, 16, 32)
    with pytest.raises(ValueError, match="not a multiple of Hkv"):
        fa.flash_attention(tq, tk, tv)
    (_, _, _), (tq, tk, tv) = _qkv(16, 1, 2, 2, 16, 32)
    with pytest.raises(TypeError, match="share one dtype"):
        fa.flash_attention(tq, tk.half(), tv)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(tq.transpose(2, 3).contiguous().transpose(2, 3),
                           tk, tv)
    with pytest.raises(ValueError, match=r"\(B, Hkv, S, hd\)"):
        fa.flash_attention(tq, tk[:, :, :8], tv)
    with pytest.raises(ValueError, match=r"logits \(T, V\)"):
        ce.cross_entropy(torch.zeros(4, 5), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="labels must be int32 or int64"):
        ce.cross_entropy(torch.zeros(4, 5), torch.zeros(4))
    with pytest.raises(TypeError, match="unsupported dtype"):
        ce.cross_entropy(torch.zeros(4, 5, dtype=torch.float16),
                         torch.zeros(4, dtype=torch.int32))


def test_cuda_path_raises_instead_of_falling_back(monkeypatch):
    """Without a GPU, Triton or nvcc the launch raises; the plain version
    is reachable only through a CPU tensor, and nothing counts."""
    before = kernels.launch_counts()
    meta = torch.empty(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="device meta"):
        ce.cross_entropy(torch.empty(4, 8, device="meta"),
                         torch.empty(4, dtype=torch.int32, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(ImportError):
            ce._kernel()
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.load.__wrapped__("flash_attention")
    assert kernels.launch_counts() == before


def test_cuda_library_is_named_by_its_sources_and_flags(monkeypatch):
    path = _cuda._library_path("flash_attention")
    assert path.startswith(_cuda.BUILD_DIR)
    assert path.endswith(".so") and len(path.rsplit("-", 1)[1]) == 19
    monkeypatch.setattr(_cuda, "NVCC_FLAGS", _cuda.NVCC_FLAGS + ("-G",))
    assert _cuda._library_path("flash_attention") != path
    assert "sm_90a" in " ".join(_cuda.NVCC_FLAGS)
    assert "--use_fast_math" not in _cuda.NVCC_FLAGS


def test_launch_counters_cover_every_kernel():
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts()) == {
        "grad_accum", "fused_sgd_mom", "fused_sgd", "fused_adam",
        "cross_entropy", "flash_attention"}
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_scale_is_a_python_float_like_the_reference():
    jx, tx, jl, tl = _logits(17, 32, 128)
    n_s = 4
    got = kernels.cross_entropy(tx, tl, 1.0 / n_s)
    want = jce.cross_entropy(jx, jl, scale=1.0 / n_s, interpret=True)
    assert _err(got, want) < 1e-6
    assert math.isclose(float(got.sum()), float(want.sum()), rel_tol=1e-6)
