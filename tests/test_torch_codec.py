"""Port int8 kernel path and codecs (repro_torch.kernels, repro_torch.core.codec)
against the JAX package's.

Inputs come from a numpy seed. The JAX side runs as its own tests run it:
the Pallas kernel in interpret mode and ``repro/kernels/ref.py``.

The int8 plain version must be BIT-EQUAL to the JAX reference: both divide
x by an fp32 scale (IEEE), round half to even, clip and multiply in fp32,
and bf16 results round to nearest even on both sides. Wire sizes are
numpy arithmetic on the same cost tables and must be exactly equal.

The CUDA kernel itself is held against its plain version in
``test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import RESNET56
from repro.core import codec as jcodec
from repro.core import timemodel as jtime
from repro.kernels import ref as jref
from repro.kernels.quantize import int8_roundtrip as j_int8_pallas
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import codec as tcodec
from repro_torch.core import timemodel as ttime
from repro_torch.kernels import quantize
from repro_torch.kernels.ref import int8_roundtrip_ref

torch.set_num_threads(2)
SHAPES = [(64,), (77, 130), (4, 8, 33)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(shape, dtype, seed=0, zeros=False):
    """The same values as a JAX array and a torch CPU tensor."""
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(seed).normal(0, 2.0, shape).astype(np.float32)
    if zeros:
        x[...] = 0.0
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _bits(a):
    """Raw bits of a JAX array or torch tensor, for bit-equality."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_int8_plain_bit_equals_jax_ref_and_pallas(shape, dtype, zeros):
    """One tensor = one row: the port's per-row plain version equals the
    JAX per-tensor reference and its Pallas kernel (interpret mode)."""
    jx, tx = _pair(shape, dtype, zeros=zeros)
    got = int8_roundtrip_ref(tx.reshape(1, -1)).reshape(shape)
    np.testing.assert_array_equal(_bits(got), _bits(jref.int8_roundtrip_ref(jx)))
    np.testing.assert_array_equal(_bits(got), _bits(j_int8_pallas(jx, interpret=True)))
    if zeros:
        assert not got.float().any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_rows_bit_equal_jax_vmap(dtype):
    """One scale per row == ``jax.vmap`` of the per-tensor reference; the
    rows differ in scale by orders of magnitude, and one row is zero."""
    jx, tx = _pair((6, 515), dtype, seed=1)
    scales = np.array([1e-3, 1.0, 1e3, 0.0, 7.0, 1e-30], np.float32)[:, None]
    jx = (jx.astype(jnp.float32) * scales).astype(jx.dtype)
    tx = (tx.float() * torch.from_numpy(scales)).to(tx.dtype)
    want = jax.vmap(jref.int8_roundtrip_ref)(jx)
    np.testing.assert_array_equal(_bits(int8_roundtrip_ref(tx)), _bits(want))
    # the wrapper takes the plain version for a CPU tensor, without counting
    before = quantize.LAUNCHES
    np.testing.assert_array_equal(_bits(quantize.int8_roundtrip_rows(tx)), _bits(want))
    assert quantize.LAUNCHES == before


@pytest.mark.parametrize("name", ["identity", "bf16", "int8"])
def test_codec_wires_match_jax(name):
    """z uplink (one row per client), download (one row per leaf) and the
    delta-coded upload over a client-stacked tree."""
    rng = np.random.default_rng(2)
    ref = {"w": rng.normal(size=(3, 5)).astype(np.float32),
           "blocks": [{"b": rng.normal(size=(7,)).astype(np.float32)}]}
    trained = {"w": rng.normal(size=(4, 3, 5)).astype(np.float32),
               "blocks": [{"b": rng.normal(size=(4, 7)).astype(np.float32)}]}
    z = rng.normal(size=(4, 2, 3, 3, 6)).astype(np.float32)
    jc, tc = jcodec.make_codec(name), tcodec.make_codec(name)
    j = lambda t: jax.tree.map(jnp.asarray, t)
    t = lambda tree: from_numpy_tree(tree, "cpu")

    np.testing.assert_array_equal(
        tc.rt(torch.from_numpy(z)).numpy(), np.asarray(jax.vmap(jc.tree_rt)(jnp.asarray(z))))
    jax.tree.map(np.testing.assert_array_equal,
                 to_numpy_tree(tc.tree_down_rt(t(ref))),
                 jax.tree.map(np.asarray, jc.tree_down_rt(j(ref))))
    jax.tree.map(np.testing.assert_array_equal,
                 to_numpy_tree(tcodec.uplink_rt(tc, t(trained), t(ref))),
                 jax.tree.map(np.asarray, jcodec.uplink_rt(jc, j(trained), j(ref))))


@pytest.mark.parametrize("name", ["identity", "bf16", "int8"])
def test_wire_sizes_exact(name):
    jw = jcodec.wire_sizes(jtime.resnet_tier_costs(RESNET56, 32), name)
    tw = tcodec.wire_sizes(ttime.resnet_tier_costs(RESNET56, 32), name)
    for f in ("z_bytes", "down_bytes", "up_bytes", "param_bytes"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f))
    assert (tw.full_down, tw.full_up) == (jw.full_down, jw.full_up)
    tiers, nb = np.array([0, 3, 6, 6]), np.array([1, 4, 2, 9])
    np.testing.assert_array_equal(tw.uplink_bytes(tiers, nb), jw.uplink_bytes(tiers, nb))
    np.testing.assert_array_equal(tw.comm_bytes(tiers, nb), jw.comm_bytes(tiers, nb))


def test_make_codec_specs():
    assert tcodec.make_codec(None).is_identity
    assert tcodec.make_codec("identity").is_identity
    assert isinstance(tcodec.make_codec("int8"), tcodec.Int8Codec)
    assert isinstance(tcodec.make_codec("bf16"), tcodec.Bf16Codec)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tcodec.make_codec("topk0.05")
    with pytest.raises(ValueError):
        tcodec.make_codec("gzip")
