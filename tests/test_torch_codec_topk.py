"""The port's top-k codec and error-feedback helpers against the JAX
package's (``repro/core/codec.py:154-251``).

Inputs come from a numpy seed and are tie-free: normal draws, whose |x|
are distinct with probability one, so ``torch.topk`` and ``jax.lax.top_k``
keep the same entries. One case has many exact zeros, where only zeros can
tie at the k-th magnitude, and a zero kept or dropped is the same zero.

Tolerance: none. ``rt``, ``tree_rt_ef`` and ``uplink_rt_ef`` must be
BIT-EQUAL: top-k copies the kept values, and the error-feedback sums are
the same fp32 adds in the same order on both sides. The port's loop plane
uploads a client through ``uplink_rt`` / ``uplink_rt_ef`` over a client
axis of 1; that must be bit-equal to the JAX package's single-client
``uplink_rt_one``. ``nbytes`` and ``wire_sizes`` are numpy on the same
counts and must be exactly equal.

The loop plane's int8 upload is held bit-equal to the JAX package's
per-tensor int8 (``uplink_rt_one``) on a conv leaf whose first axis is 3:
it fails if the upload quantizes per first-axis slice (three scales)
instead of per tensor (one). ``tests/test_torch_planes.py`` holds the loop
plane of the trainer itself to the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import RESNET56
from repro.core import codec as jcodec
from repro.core import timemodel as jtime
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import codec as tcodec
from repro_torch.core import timemodel as ttime

torch.set_num_threads(2)
FRACS = [0.05, 0.3, 1.0]


def _x(shape, seed=0, zero_frac=0.0):
    x = np.random.default_rng(seed).normal(0, 2.0, shape).astype(np.float32)
    if zero_frac:
        x[np.random.default_rng(seed + 1).random(shape) < zero_frac] = 0.0
    return x


def _eq(got, want):
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)),
                 to_numpy_tree(got), jax.tree.map(np.asarray, want))


def _one(tree):
    """A numpy tree with a client axis of 1 (one loop-plane chunk)."""
    return jax.tree.map(lambda a: a[None], tree)


def _trees(seed, n_clients=None):
    """A parameter-like tree (conv HWIO, dense, bias) with or without a
    leading client axis."""
    lead = () if n_clients is None else (n_clients,)
    rng = np.random.default_rng(seed)
    return {"conv": rng.normal(size=lead + (3, 3, 4, 8)).astype(np.float32),
            "blocks": [{"w": rng.normal(size=lead + (8, 10)).astype(np.float32),
                        "b": rng.normal(size=lead + (10,)).astype(np.float32)}]}


@pytest.mark.parametrize("zero_frac", [0.0, 0.9])
@pytest.mark.parametrize("frac", FRACS)
def test_topk_rt_bit_equals_jax(frac, zero_frac):
    """One tensor as one row, and a stack of rows (the client axis) against
    ``jax.vmap`` of the per-tensor ``rt``."""
    jc, tc = jcodec.make_codec(f"topk{frac}"), tcodec.make_codec(f"topk{frac}")
    one = _x((7, 9, 5), seed=3, zero_frac=zero_frac)
    got = tc.rt(torch.from_numpy(one)[None])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc.rt(jnp.asarray(one))))
    rows = _x((6, 4, 33), seed=4, zero_frac=zero_frac)
    rows[2] *= 1e3                              # rows of very different scale
    rows[3] = 0.0                               # and an all-zero row
    got = tc.rt(torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.vmap(jc.rt)(jnp.asarray(rows))))
    k = max(1, int(np.ceil(frac * 4 * 33)))
    kept = (got.reshape(6, -1) != 0).sum(1).numpy()
    assert (kept <= k).all() and kept[3] == 0
    if not zero_frac:
        assert kept[0] == k


@pytest.mark.parametrize("frac", FRACS)
def test_topk_ef_helpers_bit_equal_jax(frac):
    """``tree_rt_ef`` on one client and ``uplink_rt_ef`` over a stack of 4,
    with nonzero residuals; ``uplink_rt`` / ``uplink_rt_ef`` over a stack of
    1 (the loop plane) against the JAX package's ``uplink_rt_one``."""
    jc, tc = jcodec.make_codec(f"topk{frac}"), tcodec.make_codec(f"topk{frac}")
    j = lambda t: jax.tree.map(jnp.asarray, t)
    t = lambda tree: from_numpy_tree(tree, "cpu")
    x, e = _trees(5), jax.tree.map(lambda a: 0.1 * a, _trees(6))
    got = tc.tree_rt_ef(t(jax.tree.map(lambda a: a[None], x)),
                        t(jax.tree.map(lambda a: a[None], e)))
    want = jc.tree_rt_ef(j(x), j(e))
    _eq(jax.tree.map(lambda a: a[0], got[0]), want[0])
    _eq(jax.tree.map(lambda a: a[0], got[1]), want[1])

    ref, trained, ef = _trees(7), _trees(8, 4), jax.tree.map(lambda a: 0.1 * a, _trees(9, 4))
    got = tcodec.uplink_rt_ef(tc, t(trained), t(ref), t(ef))
    want = jcodec.uplink_rt_ef(jc, j(trained), j(ref), j(ef))
    _eq(got[0], want[0])
    _eq(got[1], want[1])

    one = jax.tree.map(lambda a: a[1], trained)
    e1 = jax.tree.map(lambda a: a[1], ef)
    first = lambda tree: jax.tree.map(lambda a: a[0], tree)
    got = tcodec.uplink_rt(tc, t(_one(one)), t(ref))
    want = jcodec.uplink_rt_one(jc, j(one), j(ref))
    _eq(first(got), want[0])
    assert want[1] is None
    got = tcodec.uplink_rt_ef(tc, t(_one(one)), t(ref), t(_one(e1)))
    want = jcodec.uplink_rt_one(jc, j(one), j(ref), j(e1))
    _eq(first(got[0]), want[0])
    _eq(first(got[1]), want[1])


def test_topk_download_is_dense_and_ef_sums_back():
    """The download wire is the identity, and what is sent plus the new
    residual is exactly the input plus the old residual."""
    tc = tcodec.make_codec("topk0.05")
    x = torch.from_numpy(_x((3, 50), seed=10))
    e = torch.from_numpy(_x((3, 50), seed=11))
    assert torch.equal(tc.tree_down_rt({"w": x[0]})["w"], x[0])
    d, e2 = tc.rt_ef(x, e)
    assert torch.equal(d + e2, x + e)
    assert ((d != 0).sum(1) == 3).all()


def test_make_codec_topk_specs():
    for spec, frac in (("topk0.05", 0.05), ("topk:0.05", 0.05), ("TOPK1", 1.0)):
        c = tcodec.make_codec(spec)
        assert isinstance(c, tcodec.TopKCodec) and c.stateful and c.frac == frac
        assert c.name == jcodec.make_codec(spec.lower()).name
    for bad in ("topk", "topk0", "topk1.5", "topkx"):
        with pytest.raises(ValueError):
            tcodec.make_codec(bad)
    assert not tcodec.make_codec("int8").stateful


@pytest.mark.parametrize("frac", [0.05, 0.37, 1.0])
def test_topk_wire_sizes_exact(frac):
    name = f"topk{frac}"
    n = np.array([1, 7, 19, 1000, 853_018])
    np.testing.assert_array_equal(tcodec.make_codec(name).nbytes(n),
                                  jcodec.make_codec(name).nbytes(n))
    np.testing.assert_array_equal(tcodec.make_codec(name).down_nbytes(n),
                                  jcodec.make_codec(name).down_nbytes(n))
    jw = jcodec.wire_sizes(jtime.resnet_tier_costs(RESNET56, 32), name)
    tw = tcodec.wire_sizes(ttime.resnet_tier_costs(RESNET56, 32), name)
    for f in ("z_bytes", "down_bytes", "up_bytes", "param_bytes"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f))
    assert (tw.full_down, tw.full_up) == (jw.full_down, jw.full_up)


def test_loop_plane_int8_upload_is_per_tensor():
    """A conv leaf (3, 3, 16, 16) whose first-axis slices differ in scale
    by 100x: the upload of a client axis of 1 equals the JAX package's
    per-tensor int8 (``uplink_rt_one``) bit for bit, and differs from
    quantizing each first-axis slice."""
    jc, tc = jcodec.make_codec("int8"), tcodec.make_codec("int8")
    ref = {"conv": _x((3, 3, 16, 16), seed=12)}
    trained = {"conv": ref["conv"] + _x((3, 3, 16, 16), seed=13)
               * np.array([1.0, 0.01, 0.1], np.float32)[:, None, None, None]}
    got = tcodec.uplink_rt(tc, from_numpy_tree(_one(trained), "cpu"),
                           from_numpy_tree(ref, "cpu"))
    got = {"conv": got["conv"][0]}
    want, _ = jcodec.uplink_rt_one(jc, jax.tree.map(jnp.asarray, trained),
                                   jax.tree.map(jnp.asarray, ref))
    _eq(got, want)
    delta = torch.from_numpy(trained["conv"] - ref["conv"])
    per_slice = torch.from_numpy(ref["conv"]) + tc.rt(delta)
    assert not torch.equal(got["conv"], per_slice)
