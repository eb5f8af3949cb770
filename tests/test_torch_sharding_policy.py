"""``tests/test_sharding_policy.py`` case for case in the port: the
divisibility-aware sharding policy as arithmetic (``repro_torch.launch.
sharding``). Each case builds the same leaves in both packages — meta
tensors here, ``ShapeDtypeStruct`` there, on a mesh given as axis sizes
(the port's mesh is a mapping; the reference's test uses a fake mesh of
the same sizes) — and checks the port's spec against the literal the
reference's test expects and against the reference's own spec.
"""
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch import sharding as jsharding  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402

DM = {"data": 16, "model": 16}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _meta(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _sds(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _trees(build):
    """``build(leaf)`` with the port's leaf and the reference's."""
    return build(_meta), build(_sds)


def _specs(fn, jfn, build, mesh, path, **kw):
    """The port's spec at ``path`` beside the reference's, as tuples."""
    t, jt = _trees(build)
    got = fn(t, mesh, **kw)
    want = jfn(jt, FakeMesh(mesh), **kw)
    for k in path:
        got, want = got[k], want[k]
    assert tuple(got) == tuple(want)
    return got


def _param(build, path, mesh=DM, **kw):
    return _specs(sharding.param_specs, jsharding.param_specs, build, mesh,
                  path, **kw)


def test_param_specs_tp_and_fsdp():
    def build(leaf):
        return {"ffn": {"w_up": leaf((3584, 14336))},
                "norm": {"scale": leaf((3584,))}}
    assert _param(build, ["ffn", "w_up"]) == P("data", "model")
    assert _param(build, ["norm", "scale"]) == P(None)  # 1-D: replicated


def test_param_specs_skips_stacked_dim():
    # the leading period dim (64) is never sharded, though it divides
    assert _param(lambda leaf: {"blocks": ({"w": leaf((64, 128, 256))},)},
                  ["blocks", 0, "w"]) == P(None, "data", "model")


def test_param_specs_nondivisible_replicated():
    assert _param(lambda leaf: {"w": leaf((10, 7))}, ["w"]) == P(None, None)


def test_embed_table_vocab_sharded():
    assert _param(lambda leaf: {"embed": {"table": leaf((256000, 3584))}},
                  ["embed", "table"]) == P("model", "data")
    # a vocab the model axis does not divide: the generic rule
    assert _param(lambda leaf: {"embed": {"table": leaf((256206, 1024))}},
                  ["embed", "table"]) == P(None, "model")


def test_fsdp_over_pod():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert _param(lambda leaf: {"w": leaf((8, 6144, 2048))}, ["w"], mesh,
                  fsdp_over_pod=True) == P(None, ("pod", "data"), "model")


def _batch(build, path, mesh=DM, batch_dim=1):
    return _specs(sharding.batch_specs, jsharding.batch_specs, build, mesh,
                  path, batch_dim=batch_dim)


def test_batch_specs():
    def build(leaf):
        return {"tokens": leaf((8, 32, 4096)), "small": leaf((8, 3))}
    assert _batch(build, ["tokens"]) == P(None, "data", None)
    assert _batch(build, ["small"]) == P(None, None)  # 3 % 16 != 0


def _cache(build, path, mesh=DM):
    return _specs(sharding.cache_specs, jsharding.cache_specs, build, mesh,
                  path, stacked=True)


def test_cache_specs_prefers_largest_dim():
    # the window dim (32768) on model, the batch (128) on data
    assert _cache(lambda leaf: {"k": leaf((21, 128, 32768, 8, 256))},
                  ["k"]) == P(None, "data", "model", None, None)


def test_param_specs_partially_divisible_leaf():
    """Only the divisible dim shards: the model axis takes the LAST
    divisible dim, and nothing is left for FSDP."""
    assert _param(lambda leaf: {"w": leaf((3584, 7))}, ["w"]) == \
        P("model", None)


def test_param_specs_1d_leaves_replicated_even_when_divisible():
    def build(leaf):
        return {"bias": leaf((4096,)), "scalar": leaf(())}
    assert _param(build, ["bias"]) == P(None)
    assert _param(build, ["scalar"]) == P()


def test_param_specs_stacked_2d_leaf_fully_replicated():
    """Under a stacked root a 2-D leaf is a per-layer vector: replicated."""
    assert _param(lambda leaf: {"blocks": ({"scale": leaf((24, 4096))},)},
                  ["blocks", 0, "scale"]) == P(None, None)


def test_param_specs_stacked_skip_applies_to_every_stacked_root():
    for root in ("blocks", "enc_layers", "dec_layers"):
        assert _param(lambda leaf: {root: ({"w": leaf((16, 256, 512))},)},
                      [root, 0, "w"]) == P(None, "data", "model"), root


def test_embed_table_nondivisible_fsdp_dim():
    """A divisible vocab shards on model; a d_model the data axis does not
    divide leaves the FSDP dim replicated."""
    assert _param(lambda leaf: {"embed": {"table": leaf((256000, 1000))}},
                  ["embed", "table"]) == P("model", None)


def test_batch_specs_with_pod_axis_and_nondivisible():
    mesh = {"pod": 2, "data": 8, "model": 1}

    def build(leaf):
        return {"tokens": leaf((4, 16, 128)), "ragged": leaf((4, 10, 128))}
    # 16 % (2*8) == 0: sharded over the (pod, data) product
    assert _batch(build, ["tokens"], mesh) == P(None, ("pod", "data"), None)
    assert _batch(build, ["ragged"], mesh) == P(None, None, None)


def test_cache_specs_nondivisible_fully_replicated():
    assert _cache(lambda leaf: {"state": leaf((21, 10, 7, 3))},
                  ["state"]) == P(None, None, None, None)


def test_fsdp_disabled_leaves_data_axis_unused():
    assert _param(lambda leaf: {"w": leaf((3584, 14336))}, ["w"],
                  fsdp=False) == P(None, "model")
