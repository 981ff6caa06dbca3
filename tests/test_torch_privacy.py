"""The port's distance correlation and patch shuffling (repro_torch.privacy,
and the plain versions of kernel K2 in repro_torch.kernels.ref) against the
JAX package's (repro.privacy, repro.kernels.dcor in interpret mode).

Inputs come from a numpy seed and go to both sides. Tolerances, with their
reasons (u = 2**-24, the fp32 unit roundoff, gamma_F = F u / (1 - F u)):

  * distances: any order of summing F products carries an error of at most
    gamma_F times the sum of their magnitudes, so two implementations'
    squared distances differ by at most 8 gamma_F (sq_i + sq_j), plus the
    rounding of the last sqrt and the clamp floor. This holds on the
    diagonal too, where the exact d2 is 0 and each side's D_ii is the square
    root of its own rounding noise: an absolute bound of
    sqrt(4 gamma_F max sq) on each side.
  * with small-integer inputs every product and sum is exact in fp32 (the
    Gram of such rows stays below 2**24): the distances agree to the last
    sqrt, the diagonal is exactly the clamp floor on every side, and values
    and gradients agree to rtol 1e-5.
  * with normal inputs, dcor and its gradient also see the diagonal noise:
    D_ii moves a centered entry by ~1e-3 of its ~5 (F = 48), so dcor values
    agree to atol 2e-4 and gradients to 2e-3 of their largest magnitude.
    Autodiff through the JAX function also carries the rounding of the
    diagonal's cancelling terms (+4 H_ii x_i - 4 H_ii x_i, H_ii = g / 2 D_ii
    with D_ii that noise), which the port's explicit backward drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import privacy as jpriv
from repro.kernels import dcor as jkdcor
from repro_torch import privacy as tpriv
from repro_torch.configs.resnet_cifar import RESNET_MICRO
from repro_torch.fed.adapter import ResNetAdapter
from repro_torch.kernels import dcor as tkdcor
from repro_torch.kernels.ref import D_MIN, pairwise_dist_bwd_ref, pairwise_dist_ref
from repro_torch.tree import tree_map

torch.set_num_threads(2)
U = 2.0 ** -24


def _gamma(n):
    return n * U / (1 - n * U)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-4, 5, shape).astype(np.float32)


def _assert_dists_close(got, want, x):
    """|got^2 - want^2| <= 8 gamma_F (sq_i + sq_j) + sqrt rounding + floor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sq = (np.asarray(x, np.float64) ** 2).sum(-1)
    tol = 8 * _gamma(x.shape[-1]) * (sq[:, :, None] + sq[:, None, :])
    tol += 4 * U * np.maximum(got, want) ** 2 + 1e-12
    assert (np.abs(got ** 2 - want ** 2) <= tol).all()
    # the diagonal: each side within sqrt(4 gamma_F max sq) of 0
    diag_bound = np.sqrt(max(4 * _gamma(x.shape[-1]) * sq.max() * (1 + 1e-6), 1e-12))
    for d in (got, want):
        assert (np.diagonal(d, axis1=1, axis2=2) <= diag_bound).all()


_jdist = jax.jit(jax.vmap(jpriv._pairwise_dist))


@pytest.mark.parametrize("shape", [(2, 8, 48), (3, 17, 101), (1, 1, 5), (2, 33, 64)])
def test_pairwise_dist_matches_jax(shape):
    x = _normal(shape, 0)
    want = np.asarray(_jdist(jnp.asarray(x)))
    want_pallas = np.stack([np.asarray(jkdcor.pairwise_dist(jnp.asarray(xc), interpret=True))
                            for xc in x])
    ref = pairwise_dist_ref(torch.from_numpy(x)).numpy()
    wrapped = tkdcor.pairwise_dist(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(wrapped, ref)   # the CPU path is the plain version
    _assert_dists_close(ref, want, x)
    _assert_dists_close(ref, want_pallas, x)
    np.testing.assert_array_equal(ref, np.swapaxes(ref, 1, 2))


def test_pairwise_dist_exact_on_small_integers():
    x = _ints((2, 8, 48), 1)
    ref = pairwise_dist_ref(torch.from_numpy(x)).numpy()
    want = np.asarray(_jdist(jnp.asarray(x)))
    np.testing.assert_allclose(ref, want, rtol=2 * U, atol=0)
    assert (np.diagonal(ref, axis1=1, axis2=2) == D_MIN).all()


def _gram_diag_dist(x):
    """Distances with sq taken from the Gram's own diagonal, as the kernel
    takes them: d2_ii is exactly 0, so the clamp stops the diagonal's
    gradient and autodiff has no cancelling terms."""
    g = torch.bmm(x, x.transpose(1, 2))
    sq = torch.diagonal(g, dim1=1, dim2=2)
    return torch.sqrt(torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * g, 1e-12))


@pytest.mark.parametrize("shape", [(2, 8, 48), (3, 17, 101), (1, 1, 5)])
def test_pairwise_dist_bwd_ref_matches_autograd(shape):
    x = torch.from_numpy(_normal(shape, 2)).requires_grad_(True)
    g = torch.from_numpy(_normal(shape[:2] + shape[1:2], 3))
    d = _gram_diag_dist(x)
    (want,) = torch.autograd.grad((d * g).sum(), x)
    got = pairwise_dist_bwd_ref(x.detach(), d.detach(), g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_pairwise_dist_bwd_ref_matches_jax_grad():
    """Small-integer inputs: the Gram is exact on every side, d2_ii is
    exactly 0 in the JAX function too, and the clamp stops its gradient."""
    x = _ints((2, 8, 48), 4)
    x[1, 3] = x[1, 5]                    # two identical rows: D = D_MIN, no gradient
    g = _normal((2, 8, 8), 5)
    want = jax.grad(lambda a: jnp.sum(jnp.asarray(g) * jax.vmap(jpriv._pairwise_dist)(a)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    d = pairwise_dist_ref(xt)
    (auto,) = torch.autograd.grad((d * torch.from_numpy(g)).sum(), xt)
    got = pairwise_dist_bwd_ref(xt.detach(), d.detach(), torch.from_numpy(g))
    via_wrapper = torch.autograd.grad((tkdcor.pairwise_dist(xt) * torch.from_numpy(g)).sum(), xt)[0]
    scale = float(np.abs(np.asarray(want)).max())
    for t in (got, auto, via_wrapper):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6 * scale)


_jdcor = jax.jit(jax.vmap(jpriv.dcor))
_jdcor_grad = jax.jit(jax.vmap(jax.grad(jpriv.dcor, argnums=1)))


def _port_dcor_and_grad(x, z):
    zt = torch.from_numpy(z).requires_grad_(True)
    val = tpriv.dcor(torch.from_numpy(x), zt)
    (g,) = torch.autograd.grad(val.sum(), zt)
    return val.detach().numpy(), g.numpy()


@pytest.mark.parametrize("inputs,atol,grad_rtol", [
    ("ints", 1e-6, 1e-5), ("normal", 2e-4, 2e-3)])
def test_dcor_value_and_grad_match_jax(inputs, atol, grad_rtol):
    make = _ints if inputs == "ints" else _normal
    x = make((3, 8, 4, 4, 3), 6)                       # images, (C, B, H, W, ch)
    z = (x.reshape(3, 8, -1) @ make((48, 10), 7)).reshape(3, 8, 10)
    z = (z + make((3, 8, 10), 8)).astype(np.float32)   # correlated, not a copy
    got, g = _port_dcor_and_grad(x, z)
    want = np.asarray(_jdcor(jnp.asarray(x), jnp.asarray(z)))
    gwant = np.asarray(_jdcor_grad(jnp.asarray(x), jnp.asarray(z)))
    assert ((got > 0.1) & (got <= 1.0 + 1e-5)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(g, gwant, rtol=0, atol=grad_rtol * np.abs(gwant).max())


def test_dcor_exact_zero_for_degenerate_inputs():
    """``tests/test_substrates.py:196-206`` with a client axis: zero-variance
    inputs give exactly 0.0 and finite gradients."""
    z = torch.from_numpy(_normal((2, 32, 8), 9))
    const = torch.ones((2, 32, 8))
    assert (tpriv.dcor(const, z) == 0.0).all()
    assert (tpriv.dcor(z, const) == 0.0).all()
    for a in (const.clone(), z * 0.1 + 1.0):
        a.requires_grad_(True)
        (g,) = torch.autograd.grad(tpriv.dcor(a, z).sum(), a)
        assert torch.isfinite(g).all()
    zc = const.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(tpriv.dcor(z, zc).sum(), zc)
    assert torch.isfinite(g).all() and not g.any()
    # one degenerate client does not disturb the other's value
    mixed = torch.stack([const[0], z[1] * 2.0 + 1.0])
    assert tpriv.dcor(mixed, z)[0] == 0.0 and tpriv.dcor(mixed, z)[1] > 0.9


@pytest.mark.parametrize("shape,n", [((2, 3, 64, 4), 16), ((3, 2, 36, 2), 16),
                                     ((2, 4, 7, 3), 4)])
def test_patch_shuffle_given_jax_permutation_matches_jax(shape, n):
    z = _normal(shape, 10)
    keys = jax.random.split(jax.random.PRNGKey(3), shape[0])
    want = np.stack([np.asarray(jpriv.patch_shuffle(k, jnp.asarray(zc), n))
                     for k, zc in zip(keys, z)])
    p = tpriv._patch_count(shape[2], n)
    perm = np.stack([np.asarray(jax.random.permutation(k, p)) for k in keys])
    got = tpriv.patch_shuffle_perm(torch.from_numpy(z), torch.from_numpy(perm)).numpy()
    np.testing.assert_array_equal(got, want)


def test_patch_shuffle_draws_from_the_generator():
    z = torch.arange(2 * 3 * 32 * 2, dtype=torch.float32).reshape(2, 3, 32, 2)
    a = tpriv.patch_shuffle(torch.Generator().manual_seed(0), z, 8)
    b = tpriv.patch_shuffle(torch.Generator().manual_seed(0), z, 8)
    assert torch.equal(a, b) and not torch.equal(a, z)
    assert torch.equal(a.sort(dim=2).values, z.sort(dim=2).values)


def test_client_loss_shuffles_only_with_a_generator():
    """The DTFL step passes no generator (``repro/fed/dtfl.py:133``), so
    ``patch_shuffle=True`` leaves the uploaded z as it is; with one, the
    upload is shuffled and the loss is unchanged (it reads the un-shuffled z)."""
    ad = ResNetAdapter(RESNET_MICRO, dcor_alpha=0.5, patch_shuffle=True)
    gen = torch.Generator().manual_seed(0)
    cp, _ = ad.split(ad.init_global(gen), 1)
    ap = ad.aux_init(gen, 1)
    cp, ap = (tree_map(lambda t: t[None], tree) for tree in (cp, ap))
    s = RESNET_MICRO.image_size
    batch = {"images": torch.from_numpy(_normal((1, 4, s, s, 3), 11)),
             "labels": torch.tensor([[0, 1, 2, 3]])}
    with torch.no_grad():
        loss, z = ad.client_loss(cp, ap, batch)
        loss2, zs = ad.client_loss(cp, ap, batch, torch.Generator().manual_seed(1))
    assert torch.equal(loss, loss2)
    assert not torch.equal(z, zs)
    flat = lambda t: t.reshape(t.shape[0], t.shape[1], -1, t.shape[-1]).sort(dim=2).values
    assert torch.equal(flat(z), flat(zs))
