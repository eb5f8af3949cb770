"""The arithmetic of K6's bf16 kernel (``flash_fwd_wgmma`` in
``repro_torch/kernels/csrc/flash_attention.cu``), emulated in plain
PyTorch on the CPU and held against the JAX package's Pallas kernel (in
interpret mode) and against the port's plain version, on bf16 inputs made
with numpy from a seed. Also the per-dtype, per-head-dim tile table
through the resolver hooks, the per-kernel launch counters and the
16-byte alignment check of the bf16 path.

The emulation follows the kernel: 128-row q-tiles and its k-tiles (128,
or 64 at hd 256), the live k-tiles only, an fp32 QKᵀ over bf16 inputs
(products exact, sums fp32), masked scores at -inf, p as
``exp2((s − m) · log2 e)`` (the kernel folds log2 e into an exp2f), and PV
as two bf16 terms of P, ``P_hi = bf16(P)`` and ``P_lo = bf16(P − P_hi)``, into one
fp32 accumulator. Its fp32 output must stay within 2e-5 of both
references (the tolerance ``chip_smoke.py`` holds the kernel to before
the bf16 rounding); one bf16 rounding of P, as SDPA does, does not.
The kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention_kernels as jfa  # noqa: E402
from repro_torch import kernels  # noqa: E402

fa = kernels.flash_attention_kernels
ATOL = 2e-5  # fp32, before the bf16 rounding
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _no_resolver():
    kernels.set_block_resolver(None)
    yield
    kernels.set_block_resolver(None)


def _bf16_qkv(seed, B, H, Hkv, S, hd):
    """bf16 q, k, v for the port, and the same values in fp32 for JAX."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.normal(size=(B, h, S, hd)).astype(np.float32))
          .to(torch.bfloat16) for h in (H, Hkv, Hkv)]
    return ts, [jnp.asarray(t.float().numpy()) for t in ts]


def emulate_wgmma(q, k, v, *, causal=True, window=None, softcap=None,
                  split=True):
    """The bf16 kernel's arithmetic, tile by tile; returns the fp32 output
    before its rounding to bf16. ``split=False`` rounds P once to bf16."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    bq, bk = fa.tile(torch.bfloat16, hd)
    nk = -(-S // bk)
    pad = nk * bk - S  # TMA zero-fills a tile past S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.empty(B, H, S, hd)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))[:, None]
        kt_hi = min(nk, (q0 + bq - 1) // bk + 1) if causal else nk
        kt_lo = max(0, q0 - window + 1) // bk if window is not None else 0
        for b in range(B):
            for h in range(H):
                qt = q[b, h, q0:q0 + bq].float()
                m = torch.full((len(rows),), -1e30)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), hd)
                for kt in range(kt_lo, kt_hi):
                    cols = torch.arange(kt * bk, (kt + 1) * bk)[None, :]
                    kb = kf[b, h // G, kt * bk:(kt + 1) * bk]
                    vb = vf[b, h // G, kt * bk:(kt + 1) * bk]
                    s = (qt @ kb.T) * scale
                    if softcap is not None:
                        s = torch.tanh(s / softcap) * softcap
                    keep = cols < S
                    if causal:
                        keep = keep & (cols <= rows)
                    if window is not None:
                        keep = keep & (cols > rows - window)
                    s = torch.where(keep, s, torch.tensor(-math.inf))
                    m_cur = torch.maximum(m, s.max(dim=-1).values)
                    alpha = torch.exp(m - m_cur)
                    p = torch.exp2((s - m_cur[:, None]) * LOG2E)
                    l = l * alpha + p.sum(dim=-1)
                    hi = p.bfloat16().float()
                    acc = acc * alpha[:, None] + hi @ vb
                    if split:
                        acc = acc + (p - hi).bfloat16().float() @ vb
                    m = m_cur
                out[b, h, q0:q0 + bq] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def _bf16_check(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke's bf16 check: one ulp plus ATOL."""
    a, b = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.clamp(torch.ldexp(torch.ones_like(a), exp - 8),
                      min=2.0 ** -133)
    return bool(torch.all((a - b).abs() <= ulp + ATOL))


def _opts(kw):
    return {o: kw[o] for o in ("causal", "window", "softcap") if o in kw}


# (B, H, Hkv, S, hd, options): every head dim, GQA, causal, window with
# softcap, non-causal, unaligned S
CASES = [
    (1, 4, 1, 256, 32, {}),
    (1, 2, 1, 128, 32, {"causal": False}),
    (1, 4, 2, 256, 64, {}),
    (1, 4, 2, 256, 64, {"window": 96, "softcap": 50.0}),
    (1, 2, 2, 200, 64, {}),
    (1, 6, 2, 256, 128, {}),
    (1, 2, 1, 200, 128, {"softcap": 30.0}),
    (1, 2, 1, 256, 256, {}),
    (1, 2, 1, 333, 256, {"window": 64, "softcap": 50.0}),
]


@pytest.mark.parametrize("B,H,Hkv,S,hd,kw", CASES)
def test_wgmma_arithmetic_matches_pallas_and_plain(B, H, Hkv, S, hd, kw):
    (tq, tk, tv), (jq, jk, jv) = _bf16_qkv(S + hd + H, B, H, Hkv, S, hd)
    got = emulate_wgmma(tq, tk, tv, **_opts(kw))
    plain = kernels.ref.attention_ref(tq.float(), tk.float(), tv.float(),
                                      **_opts(kw))
    pallas = jfa.flash_attention(jq, jk, jv, interpret=True, **_opts(kw))
    pallas = torch.from_numpy(np.array(pallas))
    assert pallas.dtype == torch.float32
    assert float((got - plain).abs().max()) < ATOL
    assert float((got - pallas).abs().max()) < ATOL
    # and, rounded as the kernel rounds, chip_smoke's bf16 check holds
    want = kernels.ref.attention_ref(tq, tk, tv, **_opts(kw))
    assert _bf16_check(got.bfloat16(), want)


@pytest.mark.parametrize("hd,kw", [(128, {}), (256, {"window": 128,
                                                     "softcap": 50.0})])
def test_one_bf16_rounding_of_p_breaks_the_check(hd, kw):
    """Why P enters PV as two bf16 terms: rounded once (as SDPA and
    flex_attention do) it misses the plain version far beyond 2e-5, and
    the bf16 outputs then miss by more than one ulp."""
    (tq, tk, tv), _ = _bf16_qkv(21 + hd, 1, 2, 1, 256, hd)
    plain = kernels.ref.attention_ref(tq.float(), tk.float(), tv.float(),
                                      **kw)
    split = emulate_wgmma(tq, tk, tv, **kw)
    once = emulate_wgmma(tq, tk, tv, split=False, **kw)
    assert float((split - plain).abs().max()) < ATOL
    assert float((once - plain).abs().max()) > 10 * ATOL
    want = kernels.ref.attention_ref(tq, tk, tv, **kw)
    assert _bf16_check(split.bfloat16(), want)
    assert not _bf16_check(once.bfloat16(), want)


# ---------------------------------------------------------------------------
# the tile table, through the resolver hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_tile_table_by_dtype_and_head_dim(hd):
    assert fa.launch_blocks(512, torch.bfloat16, hd=hd) == \
        (128, 64 if hd == 256 else 128)
    assert fa.launch_blocks(512, torch.float32, hd=hd) == (64, 64)
    assert fa.tile(torch.float32) == (64, 64)
    with pytest.raises(ValueError, match="depends on the head dim"):
        fa.tile(torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel instance"):
        fa.tile(torch.bfloat16, 96)


def test_resolver_confirms_or_is_refused_per_head_dim():
    calls = []

    def resolver(tiles):
        def fn(kind, dtype, n, interpret):
            calls.append((kind, dtype, n, interpret))
            return tiles[kind]
        return fn

    kernels.set_block_resolver(resolver({"flash_q": 128, "flash_k": 64}))
    assert fa.launch_blocks(1024, torch.bfloat16, hd=256) == (128, 64)
    assert ("flash_q", "bfloat16", 1024, False) in calls
    assert ("flash_k", "bfloat16", 1024, False) in calls
    with pytest.raises(ValueError, match="no kernel instance for block_k"):
        fa.launch_blocks(1024, torch.bfloat16, hd=128)
    kernels.set_block_resolver(resolver({"flash_q": 64, "flash_k": 128}))
    with pytest.raises(ValueError, match="no kernel instance for block_q"):
        fa.launch_blocks(1024, torch.bfloat16, hd=128)
    # a resolver tile that spans a short S takes the instance's tile
    kernels.set_block_resolver(resolver({"flash_q": 64, "flash_k": 64}))
    assert fa.launch_blocks(20, torch.bfloat16, hd=64) == (128, 128)
    # arguments are refused the same way, never rounded
    kernels.set_block_resolver(None)
    with pytest.raises(ValueError, match="no kernel instance for block_k"):
        fa.launch_blocks(1024, torch.bfloat16, block_k=128, hd=256)
    with pytest.raises(ValueError, match="not a power of two"):
        fa.launch_blocks(1024, torch.bfloat16, block_q=96, hd=64)


def test_resolver_changes_no_bf16_value():
    (tq, tk, tv), _ = _bf16_qkv(30, 1, 4, 2, 200, 128)
    before = kernels.launch_counts()
    a = fa.flash_attention(tq, tk, tv)
    kernels.set_block_resolver(lambda kind, *_: 128)
    b = fa.flash_attention(tq, tk, tv)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no kernel instance for block_k"):
        fa.flash_attention(*_bf16_qkv(31, 1, 2, 1, 256, 256)[0])
    assert kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# launch counters by kernel, alignment
# ---------------------------------------------------------------------------

def test_variant_counters_cover_both_kernels():
    kernels.reset_launch_counts()
    assert kernels.variant_launch_counts() == {"wgmma_bf16": 0,
                                               "simt_fp32": 0}
    assert fa.VARIANTS == {torch.bfloat16: "wgmma_bf16",
                           torch.float32: "simt_fp32"}
    for dt in (torch.bfloat16, torch.float32):  # the plain path never counts
        x = torch.zeros(1, 2, 16, 64, dtype=dt)
        fa.flash_attention(x, x, x)
    assert kernels.variant_launch_counts() == {"wgmma_bf16": 0,
                                               "simt_fp32": 0}


def test_bf16_operands_must_be_16_byte_aligned():
    base = torch.zeros(2 * 16 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:2 * 16 * 64].view(1, 2, 16, 64)
    shifted = base[1:1 + 2 * 16 * 64].view(1, 2, 16, 64)  # 2 bytes off
    assert aligned.is_contiguous() and shifted.is_contiguous()
    assert aligned.data_ptr() % 16 == 0
    fa.check_aligned(aligned, aligned)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_aligned(aligned, shifted)
    for off in (4, 8):  # 8 and 16 bytes off: only 16 passes
        x = base[off:off + 2 * 16 * 64].view(1, 2, 16, 64)
        if off == 8:
            fa.check_aligned(x)
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fa.check_aligned(x)
    # the plain CPU path reads through no TMA and takes any address
    out = fa.flash_attention(shifted, shifted, shifted)
    assert torch.equal(out, kernels.ref.attention_ref(shifted, shifted,
                                                      shifted))
