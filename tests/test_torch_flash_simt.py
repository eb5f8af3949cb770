"""The arithmetic of K6's fp32 kernel (``flash_fwd_simt`` in
``repro_torch/kernels/csrc/flash_attention.cu``), emulated in plain
PyTorch on the CPU and held against the JAX package's Pallas kernel (in
interpret mode) and against the port's plain version, on fp32 inputs made
with numpy from a seed; and the kernel's grid order, live-tile range and
masked-tile predicate, mirrored here, against the Pallas kernel's
``live`` predicate and the masks themselves.

The emulation follows the kernel: its blocks in grid order (the q-tiles
with the most live k-tiles first, the q-heads of one KV head side by
side), 64 × 64 tiles, the live k-tiles only, K and V zero-filled past S,
QKᵀ at hd 256 as the sum of its two halves of d (the kernel's two
half-warps), scale and cap on every tile but the causal, window and
S-edge masks only on the tiles that straddle them (masked scores at
-inf), alpha as ``exp(m − m_new)``, p as ``exp2((s − m) · log2 e)`` (the
kernel folds log2 e into an exp2f), l kept per thread over its four
columns (``sx + 16 j``) and summed over the 16 threads of a row at the
end, and ``out = acc / max(l, 1e-30)``. Its output must stay within 2e-5
of both references, the tolerance ``chip_smoke.py`` holds the kernel to
on the card.
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
ATOL = 2e-5
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
THREADS_A_ROW = 16  # sx: a row's score columns are sx + 16 j, j < 4


def d_parts(hd):
    """The parts the kernel splits d into for QKᵀ (two half-warps at hd
    256, where a thread's O leaves registers for only half of d's
    scores)."""
    return 2 if hd == 256 else 1


@pytest.fixture(autouse=True)
def _no_resolver():
    kernels.set_block_resolver(None)
    yield
    kernels.set_block_resolver(None)


def _qkv(seed, B, H, Hkv, S, hd):
    """fp32 q, k, v for the port, and the same values for JAX."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.normal(size=(B, h, S, hd)).astype(np.float32))
          for h in (H, Hkv, Hkv)]
    return ts, [jnp.asarray(t.numpy()) for t in ts]


def grid(B, H, Hkv, S, tile):
    """The kernel's blocks in launch order: (b, h, q0) of each."""
    G, nq = H // Hkv, -(-S // tile)
    out = []
    for idx in range(nq * B * H):
        g = idx % G
        idx //= G
        hk = idx % Hkv
        idx //= Hkv
        out.append((idx % B, hk * G + g, (nq - 1 - idx // B) * tile))
    return out


def live_range(q0, S, tile, causal, window):
    """The kernel's live k-tiles of the q-tile at q0: [kt_lo, kt_hi)."""
    nk = -(-S // tile)
    kt_hi = min(nk, (q0 + tile - 1) // tile + 1) if causal else nk
    kt_lo = 0
    if window is not None and q0 - window + 1 > 0:
        kt_lo = (q0 - window + 1) // tile
    return kt_lo, kt_hi


def straddles(q0, k0, S, tile, causal, window):
    """The kernel's predicate: the tile at (q0, k0) needs its masks."""
    return ((causal and k0 + tile - 1 > q0)
            or (window is not None and k0 <= q0 + tile - 1 - window)
            or k0 + tile > S)


def keep_mask(rows, cols, S, causal, window):
    keep = torch.broadcast_to(cols < S, (rows.shape[0], cols.shape[1]))
    if causal:
        keep = keep & (cols <= rows)
    if window is not None:
        keep = keep & (cols > rows - window)
    return keep


def emulate_simt(q, k, v, *, causal=True, window=None, softcap=None):
    """The fp32 kernel's arithmetic, block by block in grid order."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    bq, bk = fa.tile(torch.float32)
    assert bq == bk
    tile = bq
    nk = -(-S // tile)
    pad = nk * tile - S  # cp.async zero-fills rows past S
    kf = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qf = torch.nn.functional.pad(q, (0, 0, 0, -(-S // tile) * tile - S))
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    out = torch.full((B, H, S, hd), float("nan"))
    for b, h, q0 in grid(B, H, k.shape[1], S, tile):
        rows = torch.arange(q0, q0 + tile)[:, None]
        qt = qf[b, h, q0:q0 + tile]
        m = torch.full((tile,), -1e30)
        l_part = torch.zeros(tile, THREADS_A_ROW)  # each thread's share
        acc = torch.zeros(tile, hd)
        kt_lo, kt_hi = live_range(q0, S, tile, causal, window)
        for kt in range(kt_lo, kt_hi):
            k0 = kt * tile
            cols = torch.arange(k0, k0 + tile)[None, :]
            kt = kf[b, h // G, k0:k0 + tile]
            part = hd // d_parts(hd)
            s = sum(qt[:, d:d + part] @ kt[:, d:d + part].T
                    for d in range(0, hd, part)) * scale
            if softcap is not None:
                s = torch.tanh(s / softcap) * softcap
            keep = keep_mask(rows, cols, S, causal, window)
            if straddles(q0, k0, S, tile, causal, window):
                s = torch.where(keep, s, torch.tensor(-math.inf))
            else:  # the predicate never skips a mask that bites
                assert bool(keep[rows[:, 0] < S].all())
            m_cur = torch.maximum(m, s.max(dim=-1).values)
            alpha = torch.exp(m - m_cur)
            p = torch.exp2((s - m_cur[:, None]) * LOG2E)
            # thread sx sums its columns sx, sx + 16, sx + 32, sx + 48
            share = p.reshape(tile, -1, THREADS_A_ROW)
            part = torch.zeros(tile, THREADS_A_ROW)
            for j in range(share.shape[1]):
                part = part + share[:, j]
            l_part = l_part * alpha[:, None] + part
            acc = acc * alpha[:, None] + p @ vf[b, h // G, k0:k0 + tile]
            m = m_cur
        # the row's 16 shares summed by xor-shuffles 1, 2, 4, 8
        while l_part.shape[-1] > 1:
            l_part = l_part[:, 0::2] + l_part[:, 1::2]
        o = acc / torch.clamp(l_part[:, 0], min=1e-30)[:, None]
        n = min(tile, S - q0)  # rows past S are not stored
        out[b, h, q0:q0 + n] = o[:n]
    return out


def _opts(kw):
    return {o: kw[o] for o in ("causal", "window", "softcap") if o in kw}


# (B, H, Hkv, S, hd, options): every head dim, GQA (the gemma layers' G = 2
# and qwen2's 6), causal, window with softcap, non-causal, S one below, one
# above and below the tile
CASES = [
    (1, 4, 1, 128, 32, {}),
    (1, 2, 1, 128, 32, {"causal": False}),
    (2, 2, 1, 192, 64, {}),
    (1, 4, 2, 256, 64, {"window": 96, "softcap": 50.0}),
    (1, 2, 2, 63, 64, {}),
    (1, 6, 1, 200, 128, {}),
    (1, 2, 1, 65, 128, {"softcap": 30.0}),
    (1, 4, 2, 256, 256, {"window": 64, "softcap": 50.0}),
    (1, 2, 1, 20, 256, {}),
    (1, 2, 1, 333, 256, {"window": 100}),
]


@pytest.mark.parametrize("B,H,Hkv,S,hd,kw", CASES)
def test_simt_arithmetic_matches_pallas_and_plain(B, H, Hkv, S, hd, kw):
    (tq, tk, tv), (jq, jk, jv) = _qkv(S + hd + H, B, H, Hkv, S, hd)
    got = emulate_simt(tq, tk, tv, **_opts(kw))
    assert torch.isfinite(got).all()  # every row stored exactly once
    plain = kernels.ref.attention_ref(tq, tk, tv, **_opts(kw))
    pallas = jfa.flash_attention(jq, jk, jv, interpret=True, **_opts(kw))
    pallas = torch.from_numpy(np.array(pallas))
    assert pallas.dtype == torch.float32
    assert float((got - plain).abs().max()) < ATOL
    assert float((got - pallas).abs().max()) < ATOL
    # and the port's wrapper, on the CPU, is the plain version
    assert torch.equal(fa.flash_attention(tq, tk, tv, **_opts(kw)), plain)


@pytest.mark.parametrize("B,H,Hkv,S", [(1, 16, 8, 4096), (4, 12, 2, 1024),
                                       (2, 4, 4, 333)])
def test_grid_covers_every_block_once_heaviest_first(B, H, Hkv, S):
    tile = fa.tile(torch.float32)[0]
    blocks = grid(B, H, Hkv, S, tile)
    nq = -(-S // tile)
    assert sorted(blocks) == sorted((b, h, t * tile) for b in range(B)
                                    for h in range(H) for t in range(nq))
    q0s = [q0 for _, _, q0 in blocks]
    assert q0s == sorted(q0s, reverse=True)  # the causal tail starts first
    G = H // Hkv
    for i in range(0, len(blocks), G):  # a KV head's q-heads side by side
        group = blocks[i:i + G]
        assert len({(b, h // G, q0) for b, h, q0 in group}) == 1


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (True, 100),
                                           (True, 1024), (False, 96)])
def test_live_range_is_the_pallas_live_predicate(causal, window):
    """The kernel's [kt_lo, kt_hi) is exactly the k-tiles whose Pallas
    ``live`` predicate holds at 64 × 64 tiles (``_flash_kernel``)."""
    tile = fa.tile(torch.float32)[0]
    for S in (1, 63, 64, 65, 200, 1500):
        nq = nk = -(-S // tile)
        for iq in range(nq):
            q0 = iq * tile
            live = []
            for ik in range(nk):
                ok = True
                if causal:
                    ok = ik * tile <= q0 + tile - 1
                if window is not None:
                    ok = ok and ik * tile + tile - 1 > q0 - window
                live.append(ok)
            lo, hi = live_range(q0, S, tile, causal, window)
            assert live == [lo <= ik < hi for ik in range(nk)]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (True, 100),
                                           (False, 96)])
def test_masked_tile_predicate_is_exact(causal, window):
    """A live tile takes the masks exactly where one of them drops a
    (row < S) pair of it: never a bitten tile unmasked, and a tile inside
    the diagonal, the window and S runs the mask-free loop."""
    tile = fa.tile(torch.float32)[0]
    for S in (63, 64, 65, 300):
        for q0 in range(0, S, tile):
            rows = torch.arange(q0, q0 + tile)[:, None]
            lo, hi = live_range(q0, S, tile, causal, window)
            for kt in range(lo, hi):
                k0 = kt * tile
                cols = torch.arange(k0, k0 + tile)[None, :]
                keep = keep_mask(rows, cols, S, causal, window)
                bites = not bool(keep.all())
                assert straddles(q0, k0, S, tile, causal, window) == bites


def test_one_fp32_tile_at_every_head_dim():
    tiles = {fa.tile(torch.float32, hd) for hd in fa.HEAD_DIMS}
    assert tiles == {fa.tile(torch.float32)} == {(64, 64)}


def test_unaligned_fp32_operands_are_copied_to_16_bytes():
    """The fp32 kernel moves its operands in 16-byte chunks: the wrapper
    hands it an aligned copy of an operand that starts elsewhere, with
    the same values, and an aligned operand itself."""
    base = torch.arange(2 * 16 * 64 + 4, dtype=torch.float32)
    aligned = base[:2 * 16 * 64].view(1, 2, 16, 64)
    assert aligned.data_ptr() % 16 == 0
    assert fa.aligned16(aligned) is aligned
    for off in (1, 2, 3):  # 4, 8 and 12 bytes past 16
        x = base[off:off + 2 * 16 * 64].view(1, 2, 16, 64)
        y = fa.aligned16(x)
        assert y.data_ptr() % 16 == 0 and y.is_contiguous()
        assert torch.equal(x, y)
    # the plain CPU path takes any address
    x = base[1:1 + 2 * 16 * 64].view(1, 2, 16, 64)
    assert torch.equal(fa.flash_attention(x, x, x),
                       kernels.ref.attention_ref(x, x, x))
