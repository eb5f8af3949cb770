"""Kernel K1 over a list of (accumulator, gradient) pairs: the flat
executor's step ❹ adds each gradient leaf, where autograd left it, into
its slice of the flat accumulator, with no concatenated copy.

On the CPU the wrapper takes the plain version pair by pair; the JAX
package's ``accumulate_flat`` (which concatenates, then runs the Pallas
kernel in interpret mode) is the reference, on the same numpy trees, at
``DTYPE_ATOL`` in fp32 (2e-6), the tolerance of ``test_torch_kernels.py``'s
K1 checks. The launch grouping and the chunk table the CUDA kernel
searches are pure Python and arithmetic, checked here; the kernel itself
is held bit for bit against the plain version on the card by
``chip_smoke.py``.
"""
import bisect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.engine import exec_core as jexec_core  # noqa: E402
from repro.engine import flat as jflat  # noqa: E402
from repro.kernels import grad_accum_kernels as jga  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs, engine, kernels, optim, tree  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.data import LMDataset  # noqa: E402
from repro_torch.engine import exec_core, flat  # noqa: E402
from repro_torch.kernels import _launch  # noqa: E402
from repro_torch.launch import steps  # noqa: E402

ga = kernels.grad_accum_kernels
ARCH = "qwen2-1.5b"
ATOL = DTYPE_ATOL[jnp.dtype("float32")]


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray, jtransformer.init_params(
        jconfigs.get_reduced(ARCH), jax.random.PRNGKey(0)))


def _grad_trees(ref_params, seed, n):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), ref_params) for _ in range(n)]


@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
def test_accumulate_flat_matches_reference(ref_params, gdt):
    """Three micro-batches of gradients (fp32 or bf16 leaves) into the flat
    fp32 accumulator, against the JAX package's accumulate_flat."""
    jspec = jflat.FlatSpec.for_tree(jax.tree.map(jnp.asarray, ref_params))
    spec = flat.FlatSpec.for_tree(weights.from_reference(ref_params, "cpu"))
    jacc = jspec.zeros(jnp.float32)
    acc = spec.zeros(torch.float32, "cpu")
    for g in _grad_trees(ref_params, 11, 3):
        jg = jax.tree.map(lambda x: jnp.asarray(x).astype(gdt), g)
        tg = tree.map(lambda x: x.to(getattr(torch, gdt)),
                      weights.from_reference(g, "cpu"))
        jacc = jexec_core.accumulate_flat(jacc, jspec, jg, scale=1.0 / 3.0,
                                          interpret=True)
        out = exec_core.accumulate_flat(acc, spec, tg, scale=1.0 / 3.0)
        assert out is acc  # in place on the accumulator
    assert len(acc) == len(jacc)
    for a, j in zip(acc, jacc):
        err = float(np.max(np.abs(a.numpy() - np.asarray(j))))
        assert err <= ATOL, f"accumulate_flat ({gdt} grads): {err:.3e}"


def test_accumulate_flat_makes_no_gradient_copy(ref_params, monkeypatch):
    """Step ❹ of the flat path never calls FlatSpec.flatten, and no leaf
    of the model's gradient needs a contiguous copy."""
    cfg = configs.get_reduced(ARCH)
    plan = engine.plan_mbs(6, micro_batch_size=2, remat_policy="none",
                           device="cpu")
    ex = engine.get_executor("flat")(
        steps.make_loss_fn(cfg, dtype=torch.float32, remat_policy="none"),
        optim.sgd(0.05, 0.9, 5e-4), plan)
    params, state = ex.prepare(weights.from_reference(ref_params, "cpu"),
                               optim.sgd(0.05, 0.9, 5e-4).init(
                                   weights.from_reference(ref_params, "cpu")))
    split = plan.device_split(LMDataset(512, 16, seed=3).batch(6, 0), "cpu")
    want, _ = ex.gradients(params, split)

    def refuse(*a, **k):
        raise AssertionError("FlatSpec.flatten called on the flat path")
    monkeypatch.setattr(flat.FlatSpec, "flatten", refuse)
    copied = ga.COPIED_BYTES["grad_accum"]
    grads, _ = ex.gradients(params, split)
    new, _, _ = ex.step_split(params, state, split)
    assert ga.COPIED_BYTES["grad_accum"] == copied
    for a, b in zip(tree.leaves(grads), tree.leaves(want)):
        assert torch.equal(a, b)
    assert all(torch.isfinite(x).all() for x in tree.leaves(new))


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
@pytest.mark.parametrize("gdt", ["float32", "bfloat16"])
def test_grad_accum_many_on_odd_views(adt, gdt):
    """Accumulators are views at odd offsets into one buffer, gradients
    views at odd offsets too: each pair equals the plain version, the
    buffer's gaps stay as they were, and in fp32 each pair is within K1's
    tolerance of the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(5)
    offs, sizes = [1, 1003, 5100, 9000], [1000, 4097, 0, 7]
    buf = torch.from_numpy(rng.normal(size=9010).astype(np.float32)).to(
        getattr(torch, adt))
    gbuf = torch.from_numpy(rng.normal(size=9010).astype(np.float32)).to(
        getattr(torch, gdt))
    accs = [buf[o:o + n] for o, n in zip(offs, sizes)]
    grads = [gbuf[o + 2:o + 2 + n] for o, n in zip(offs, sizes)]
    before, want = buf.clone(), buf.clone()
    s = torch.full((1,), 0.125)
    for o, n, g in zip(offs, sizes, grads):
        want[o:o + n] = kernels.ref.grad_accum_ref(want[o:o + n], g, s)
    counts = kernels.launch_counts()
    out = kernels.grad_accum_many(accs, grads, s)
    assert all(a is b for a, b in zip(out, accs))
    assert torch.equal(buf, want)
    assert kernels.launch_counts() == counts  # the plain path never counts
    if adt == "float32":
        for a, o, n, g in zip(accs, offs, sizes, grads):
            if not n:
                continue
            j = jga.grad_accum(jnp.asarray(before[o:o + n].numpy()),
                               jnp.asarray(g.float().numpy()).astype(gdt),
                               0.125, interpret=True)
            assert float(np.max(np.abs(a.numpy() - np.asarray(j)))) <= ATOL


def _chunks(sizes, block):
    """The CUDA kernel's table: the prefix of each entry's chunk count, and
    for each chunk (one block) the entry a binary search finds."""
    start = [0]
    for n in sizes:
        start.append(start[-1] + -(-n // block))
    return [(bisect.bisect_right(start, c, hi=len(sizes)) - 1, c)
            for c in range(start[-1])], start


def test_launch_groups_cover_every_element_once():
    """More pairs than a launch takes, in mixed dtypes and with empty
    leaves: groups of one dtype pair and at most MAX_ENTRIES, every
    non-empty pair in one group, in order; inside each launch the chunk
    table gives every element to exactly one block."""
    rng = np.random.default_rng(9)
    n_pairs = 2 * ga.MAX_ENTRIES + 45
    sizes = [int(x) if i % 17 else 0
             for i, x in enumerate(rng.integers(1, 5000, n_pairs))]
    gdts = [torch.bfloat16 if i % 3 == 0 else torch.float32
            for i in range(n_pairs)]
    pairs = [(torch.empty(n), torch.empty(n, dtype=dt))
             for n, dt in zip(sizes, gdts)]
    groups = ga.launch_groups(pairs)
    flat_idx = [i for g in groups for i in g]
    assert sorted(flat_idx) == [i for i, n in enumerate(sizes) if n]
    assert len(groups) > 2  # more than one launch per dtype pair
    for g in groups:
        assert 0 < len(g) <= ga.MAX_ENTRIES
        assert g == sorted(g)
        assert len({(pairs[i][0].dtype, pairs[i][1].dtype) for i in g}) == 1
        gsizes = [sizes[i] for i in g]
        for block in (_launch.stream_geometry("grad_accum", torch.float32,
                                              sum(gsizes))[0], 1, 4096):
            hits = [np.zeros(n, np.int32) for n in gsizes]
            chunks, start = _chunks(gsizes, block)
            for e, c in chunks:
                base = (c - start[e]) * block
                assert 0 <= base < gsizes[e]  # a chunk never spans entries
                hits[e][base:base + block] += 1
            assert all((h == 1).all() for h in hits)


def test_grad_accum_many_refuses_what_it_cannot_take():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="unequal numel"):
        kernels.grad_accum_many([a], [torch.zeros(7)], 1.0)
    with pytest.raises(ValueError, match="accumulators for"):
        kernels.grad_accum_many([a, a], [torch.zeros(8)], 1.0)
    with pytest.raises(ValueError, match="different devices"):
        kernels.grad_accum_many([a], [torch.zeros(8, device="meta")], 1.0)
    with pytest.raises(ValueError, match="device meta"):
        meta = torch.zeros(8, device="meta")
        kernels.grad_accum_many([meta], [meta], 1.0)
    for dt in (torch.float16, torch.int32, torch.float64):
        with pytest.raises(TypeError, match="unsupported dtype"):
            kernels.grad_accum_many([a], [torch.zeros(8, dtype=dt)], 1.0)
        with pytest.raises(TypeError, match="unsupported dtype"):
            kernels.grad_accum_many([torch.zeros(8, dtype=dt)], [a], 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.grad_accum_many([torch.zeros(16)[::2]], [a], 1.0)
    assert torch.all(a == 0)


def test_strided_gradient_is_copied_alone_and_counted():
    acc = torch.zeros(2, 3)
    g = torch.arange(6.0).view(3, 2).t()  # (2, 3), not contiguous
    copied = ga.COPIED_BYTES["grad_accum"]
    kernels.grad_accum_many([acc], [g], 0.5)
    assert torch.equal(acc.view(-1), g.reshape(-1) * 0.5)
    assert ga.COPIED_BYTES["grad_accum"] == copied + 6 * 4


def test_cuda_launch_raises_without_a_card_or_nvcc():
    """On a machine without nvcc the launch raises; nothing is added and
    nothing counts (no fallback to the plain version)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    acc, g = torch.zeros(8), torch.ones(8)
    before = kernels.launch_counts()
    with pytest.raises((RuntimeError, OSError)):
        ga._launch([acc], [g], torch.ones(1))
    assert torch.all(acc == 0)
    assert kernels.launch_counts() == before
