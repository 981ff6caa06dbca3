"""Port ResNet (repro_torch.models.resnet) against the JAX package's.

Both sides start from the JAX package's initialization, copied leaf by leaf
through ``repro_torch.bridge``; images come from a numpy seed. C = 1 runs
one model; C = 3 stacks three models on the port's client axis and runs
the JAX functions under ``jax.vmap``.

Tolerance: rtol = 1e-5 and atol = 1e-5 times the reference's largest
magnitude (at least 1). Both sides compute fp32 im2col GEMMs and GroupNorm
reductions, summed in a different order by XLA and by PyTorch; that error
is a few ulps of the activations' scale, which grows through the residual
stack (|z| reaches ~16 at the last module of RESNET_BENCH, where the
largest difference seen is 1.5e-5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.resnet_cifar import RESNET_BENCH, RESNET_MICRO
from repro.core import splitting as jsplit
from repro.models import resnet as JR
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import splitting as tsplit
from repro_torch.models import resnet as TR

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-5
CFGS = {"micro": RESNET_MICRO, "bench": RESNET_BENCH}


def _port(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), "cpu")


def _stacked_params(cfg, C):
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(C)])
    return jax.jit(jax.vmap(lambda k: JR.init(k, cfg)))(keys)


def _images(cfg, C, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (C, n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_refs(name):
    """Three stacked JAX models, their per-tier aux heads, images, and every
    output the tests compare, from ONE jit(vmap(...)) program per config
    (compiling XLA programs dominates this file's time). A C = 1 port run
    is held against client 0's row."""
    cfg = CFGS[name]
    params = _stacked_params(cfg, 3)
    tiers = list(range(1, cfg.n_modules))
    aux = {m: jax.vmap(lambda k, m=m: JR.aux_init(k, cfg, m))(
        jnp.stack([jax.random.PRNGKey(10 * m + i) for i in range(3)])) for m in tiers}
    images = _images(cfg, 3)

    def outputs(p, a, im):
        out = {"logits": JR.forward(p, cfg, im)}
        for m in tiers:
            c, s = jsplit.split_params(p, JR.n_blocks_in_modules(cfg, m), jsplit.RESNET)
            z = JR.client_forward(c, cfg, im)
            out[f"tier{m}"] = (z, JR.aux_apply(a[m], z), JR.server_forward(s, cfg, z, m))
        return out

    outs = jax.jit(jax.vmap(outputs))(params, aux, jnp.asarray(images))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, aux), images,
            jax.tree.map(np.asarray, outs))


def _rows(tree, C):
    return jax.tree.map(lambda a: a[:C], tree)


def _close(torch_out, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(torch_out.detach().numpy(), want, rtol=RTOL, atol=ATOL * scale)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_matches_jax(name, C):
    params, _, images, outs = _jax_refs(name)
    got = TR.forward(_port(_rows(params, C)), CFGS[name], torch.from_numpy(images[:C]))
    _close(got, outs["logits"][:C])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_split_forwards_match_jax_at_every_tier(name, C):
    """client_forward, aux_apply and server_forward at every tier; the
    server half starts from the JAX package's z on both sides."""
    cfg = CFGS[name]
    params, aux, images, outs = _jax_refs(name)
    tp = _port(_rows(params, C))
    for m in range(1, cfg.n_modules):
        nb = JR.n_blocks_in_modules(cfg, m)
        assert nb == TR.n_blocks_in_modules(cfg, m)
        assert JR.aux_channels(cfg, m) == TR.aux_channels(cfg, m)
        tc, ts = tsplit.split_params(tp, nb, tsplit.RESNET)
        jz, jlogits_aux, jlogits_srv = _rows(outs[f"tier{m}"], C)
        tz = TR.client_forward(tc, cfg, torch.from_numpy(images[:C]))
        _close(tz, jz)
        _close(TR.aux_apply(_port(_rows(aux[m], C)), tz), jlogits_aux)
        _close(TR.server_forward(ts, cfg, torch.from_numpy(jz.copy()), m), jlogits_srv)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_merge_split_roundtrip_every_boundary(name):
    cfg = CFGS[name]
    tp = _port(_rows(_jax_refs(name)[0], 1))
    for nb in range(len(tp["blocks"]) + 1):
        near, far = tsplit.split_params(tp, nb, tsplit.RESNET)
        assert len(near["blocks"]) == nb and "stem" in near and "fc" in far
        merged = tsplit.merge_params(near, far, tsplit.RESNET)
        jax.tree.map(np.testing.assert_array_equal,
                     to_numpy_tree(merged), to_numpy_tree(tp))


def test_init_shapes_match_jax():
    cfg = RESNET_BENCH
    jshapes = jax.tree.map(lambda a: a.shape[1:], _jax_refs("bench")[0])
    tshapes = jax.tree.map(lambda a: a.shape,
                           to_numpy_tree(TR.init(torch.Generator().manual_seed(0), cfg)))
    assert jshapes == tshapes


def test_stride2_conv_pads_like_xla():
    """SAME padding of a stride-2 3x3 conv on an even input is (0, 1): the
    port matches XLA's conv, and symmetric (1, 1) padding does not."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(1, 3, 3, 4, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x[0]), jnp.asarray(w[0]), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = TR.conv(torch.from_numpy(x), torch.from_numpy(w), stride=2)[0]
    _close(got, np.asarray(want))
    symmetric = torch.nn.functional.conv2d(
        torch.from_numpy(x[0]).permute(0, 3, 1, 2),
        torch.from_numpy(w[0]).permute(3, 2, 0, 1), stride=2, padding=1,
    ).permute(0, 2, 3, 1)
    assert symmetric.shape == got.shape
    assert not np.allclose(symmetric.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
