"""The port's kernels K1–K4, through their wrappers on CPU tensors (the
plain PyTorch versions), against the JAX package's Pallas kernels run in
interpret mode on the same numpy inputs.

Tolerances are the suite's ``DTYPE_ATOL`` (2e-6 in fp32, 2e-2 in bf16):
the two frameworks round bf16 at slightly different places (XLA may keep
excess precision inside a fusion). The kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import DTYPE_ATOL  # noqa: E402
from repro.kernels import fused_update as jfu  # noqa: E402
from repro.kernels import grad_accum_kernels as jga  # noqa: E402
from repro_torch import kernels  # noqa: E402

SIZES = [1, 1000, 4097]
DTYPES = ["float32", "bfloat16"]


def _tol(dtype: str) -> float:
    return DTYPE_ATOL[jnp.dtype(dtype)]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (both round fp32 → bf16 to nearest even)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x.copy()).to(getattr(torch, dtype)))


def _close(t: torch.Tensor, j, dtype: str, what: str):
    got = t.float().numpy()
    want = np.asarray(jnp.asarray(j, jnp.float32))
    err = float(np.max(np.abs(got - want)))
    assert err <= _tol(dtype), f"{what}: max err {err:.3e} > {_tol(dtype)}"


def _normal(rng, n):
    return rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gdt", DTYPES)
def test_grad_accum_matches_pallas(n, gdt):
    rng = np.random.default_rng(n)
    acc, g = _normal(rng, n), _normal(rng, n)
    scale = 1.0 / 3.0
    ja, ta = _pair(acc, "float32")
    jg, tg = _pair(g, gdt)
    want = jga.grad_accum(ja, jg, scale, interpret=True)
    before = kernels.launch_counts()
    out = kernels.grad_accum(ta, tg, scale)
    assert out is ta  # in place on the accumulator
    _close(ta, want, "float32", "K1")
    assert kernels.launch_counts() == before  # the plain path never counts


def test_grad_accum_buckets_and_tree():
    rng = np.random.default_rng(7)
    accs = [_normal(rng, 33), _normal(rng, 5)]
    grads = [_normal(rng, 33), _normal(rng, 5)]
    scale = torch.tensor(0.125)
    tb = [torch.from_numpy(a.copy()) for a in accs]
    kernels.grad_accum_buckets(tb, [torch.from_numpy(g) for g in grads],
                               scale)
    tree_acc = {"a": torch.from_numpy(accs[0].copy()).view(3, 11),
                "b": torch.from_numpy(accs[1].copy())}
    kernels.grad_accum_tree(tree_acc, {"a": torch.from_numpy(grads[0]).view(3, 11),
                                       "b": torch.from_numpy(grads[1])}, scale)
    for t, a, g, leaf in zip(tb, accs, grads, (tree_acc["a"], tree_acc["b"])):
        want = jga.grad_accum(jnp.asarray(a), jnp.asarray(g), 0.125,
                              interpret=True)
        _close(t, want, "float32", "K1 bucket")
        _close(leaf.reshape(-1), want, "float32", "K1 tree")


SGD_CASES = [  # (nesterov, weight_decay, clip_scale)
    (False, 5e-4, 1.0),
    (True, 1e-2, 0.5),
    (False, 0.0, 0.3),
]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SGD_CASES)
def test_fused_sgd_momentum_matches_pallas(n, dtype, case):
    nesterov, wd, clip = case
    rng = np.random.default_rng(n + 11)
    p, g, m = _normal(rng, n), _normal(rng, n), _normal(rng, n)
    jp, tp = _pair(p, dtype)
    jm, tm = _pair(m, dtype)
    jg, tg = _pair(g, "float32")
    want_p, want_m = jfu.fused_sgd(jp, jg, jm, 0.05, clip, momentum=0.9,
                                   weight_decay=wd, nesterov=nesterov,
                                   interpret=True)
    kernels.fused_sgd(tp, tg, tm, torch.tensor(0.05), torch.tensor(clip),
                      momentum=0.9, weight_decay=wd, nesterov=nesterov)
    _close(tp, want_p, dtype, "K2 params")
    _close(tm, want_m, dtype, "K2 momentum")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_fused_sgd_plain_matches_pallas(n, dtype, wd):
    rng = np.random.default_rng(n + 23)
    p, g = _normal(rng, n), _normal(rng, n)
    jp, tp = _pair(p, dtype)
    jg, tg = _pair(g, "float32")
    want = jfu.fused_sgd(jp, jg, None, 0.1, 0.7, weight_decay=wd,
                         interpret=True)
    out = kernels.fused_sgd(tp, tg, None, 0.1, 0.7, weight_decay=wd)
    assert out is tp
    _close(tp, want, dtype, "K3 params")


ADAM_CASES = [  # (weight_decay, decoupled, clip_scale)
    (0.0, False, 1.0),
    (1e-2, False, 0.7),
    (1e-2, True, 0.7),
]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ADAM_CASES)
def test_fused_adam_matches_pallas(n, dtype, case):
    wd, decoupled, clip = case
    rng = np.random.default_rng(n + 37)
    p, g, m = _normal(rng, n), _normal(rng, n), _normal(rng, n)
    v = np.abs(_normal(rng, n))
    step = 3
    bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
    jp, tp = _pair(p, dtype)
    jm, tm = _pair(m, dtype)
    jv, tv = _pair(v, dtype)
    jg, tg = _pair(g, "float32")
    want = jfu.fused_adam(jp, jg, jm, jv, 1e-3, bc1, bc2, clip,
                          weight_decay=wd, decoupled=decoupled,
                          interpret=True)
    kernels.fused_adam(tp, tg, tm, tv, 1e-3, bc1, bc2, clip,
                       weight_decay=wd, decoupled=decoupled)
    for t, j, what in zip((tp, tm, tv), want, ("params", "m", "v")):
        _close(t, j, dtype, f"K4 {what}")


def test_cuda_path_raises_instead_of_falling_back():
    """Without a GPU or without Triton the kernel launch raises; the plain
    version is reachable only through a CPU tensor, and nothing counts."""
    ga = kernels.grad_accum_kernels
    acc, g = torch.zeros(8), torch.ones(8)
    before = kernels.launch_counts()
    with pytest.raises((ImportError, RuntimeError, ValueError)):
        ga._launch(acc, g, torch.ones(1))
    assert torch.all(acc == 0)
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="device meta"):
        kernels.grad_accum(meta, meta, 1.0)
    with pytest.raises(ValueError, match="device meta"):
        kernels.fused_sgd(meta, meta, meta, 0.1, momentum=0.9)
    assert kernels.launch_counts() == before


def test_wrappers_check_their_operands():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="1-D of one length"):
        kernels.grad_accum(a, torch.zeros(7), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.grad_accum(torch.zeros(16)[::2], torch.zeros(8), 1.0)
    with pytest.raises(TypeError, match="fp32"):
        kernels.fused_sgd(a, torch.zeros(8, dtype=torch.bfloat16), None, 0.1)
    with pytest.raises(TypeError, match="unsupported dtype"):
        kernels.grad_accum(torch.zeros(8, dtype=torch.int32), a, 1.0)
