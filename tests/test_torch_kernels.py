"""The port's hand-written kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on the
machine with the card, where JAX is absent (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py

Tests marked ``cuda`` build and launch the CUDA kernels; they skip where
``torch.cuda.is_available()`` is false. The plain versions are held
against the JAX package in ``test_torch_codec.py`` (K1) and
``test_torch_privacy.py`` (K2).

K2 tolerances, with their reasons (u = 2**-24, gamma_n = n u / (1 - n u)):
  * forward, off the diagonal: rtol 1e-4, the JAX package's own tolerance
    for its distance kernel (``tests/test_kernels.py:86``). Both sides sum
    the same F products in another order; for these random inputs that
    error is about u sqrt(F) ~ 1.5e-5 of d2 at F = 65,536 (the worst case
    gamma_F, 4e-3, is not reached by sums of random-sign roundings).
  * forward, the diagonal: the exact d2_ii is 0. The kernel takes the norms
    from the Gram's own diagonal, so its d2_ii is exactly 0 and D_ii is
    exactly sqrt(1e-12); the plain version's D_ii is the square root of its
    rounding noise, at most sqrt(4 gamma_F max sq).
  * backward, on the same (x, D, gD): H is the same IEEE quotient on both
    sides; the row sums and the product with x are sums of B terms in
    another order, so the results differ by at most
    4 gamma_B * 2 (rowsum|S| |x_i| + |S| |x|).
"""
import pytest
import torch

from repro_torch import privacy
from repro_torch.kernels import dcor, quantize
from repro_torch.kernels.ref import (D_MIN, int8_roundtrip_ref, pairwise_dist_bwd_ref,
                                     pairwise_dist_ref)

U = 2.0 ** -24


def test_int8_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, device="meta"))


def test_pairwise_dist_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        dcor.pairwise_dist(torch.zeros(4, 3))
    with pytest.raises(TypeError):
        dcor.pairwise_dist(torch.zeros(2, 4, 3, dtype=torch.float64))
    with pytest.raises(TypeError):
        dcor.pairwise_dist(torch.zeros(2, 4, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        dcor.pairwise_dist(torch.zeros(2, 4, 3, device="meta"))
    with pytest.raises(ValueError):
        dcor.pairwise_dist(torch.zeros(2, 3, 4).transpose(1, 2))
    with pytest.raises(ValueError):
        dcor.pairwise_dist(torch.zeros(2, 4, 0))
    x = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):   # distances of another shape
        dcor.dist_backward(x, torch.ones(2, 3, 3), torch.ones(2, 3, 3))
    with pytest.raises(ValueError):   # a non-contiguous cotangent
        dcor.dist_backward(x, torch.ones(2, 4, 4), torch.ones(2, 4, 4).transpose(1, 2))


@pytest.mark.parametrize("C,B,F", [(5, 32, 65_536), (5, 32, 3_072), (3, 17, 1_001),
                                   (1, 1, 5), (2, 200, 64)])
def test_split_chunk_covers_f(C, B, F):
    chunk = dcor.split_chunk(C, B, F)
    assert chunk % dcor.CHUNK_ALIGN == 0 and chunk >= dcor.CHUNK_ALIGN
    splits = -(-F // chunk)
    assert (splits - 1) * chunk < F <= splits * chunk


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((10, 36_864), torch.float32), ((1, 177), torch.float32),
    ((3, 4099), torch.bfloat16), ((4, 1), torch.float32),
])
def test_int8_kernel_bit_equals_plain_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    x[0] = 0
    before = quantize.LAUNCHES
    got = quantize.int8_roundtrip_rows(x)
    torch.cuda.synchronize()
    assert quantize.LAUNCHES == before + 2  # the absmax pass and the quantize pass
    assert torch.equal(got, int8_roundtrip_ref(x))
    assert not got[0].any()


@pytest.mark.cuda
def test_int8_kernel_misaligned_rows_on_card(cuda_device):
    """Rows that start off a 16-byte boundary, input and output offset
    differently."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(4 * 1003 + 1, generator=g, device=cuda_device)[1:].view(4, 1003)
    assert torch.equal(quantize.int8_roundtrip_rows(x), int8_roundtrip_ref(x))


@pytest.mark.cuda
def test_int8_kernel_propagates_nan_and_inf_like_plain(cuda_device):
    x = torch.randn(3, 257, generator=torch.Generator(device=cuda_device).manual_seed(2),
                    device=cuda_device)
    x[0, 5] = float("nan")
    x[1, 7] = float("inf")
    assert torch.equal(quantize.int8_roundtrip_rows(x).isnan(), int8_roundtrip_ref(x).isnan())
    got, want = quantize.int8_roundtrip_rows(x), int8_roundtrip_ref(x)
    ok = ~want.isnan()
    assert torch.equal(got[ok], want[ok])


def _gamma(n):
    return n * U / (1 - n * U)


def _check_dist(got, want, x):
    """The forward tolerances of the module docstring."""
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    off = ~eye.expand_as(got)
    assert ((got - want).abs()[off] <= 1e-4 * want[off]).all()
    assert (got.diagonal(dim1=1, dim2=2) == D_MIN).all()
    sq = (x.double() ** 2).sum(-1).max()
    bound = max(float(4 * _gamma(x.shape[-1]) * sq * (1 + 1e-6)), 1e-12) ** 0.5
    assert (want.diagonal(dim1=1, dim2=2) <= bound).all()
    assert torch.equal(got, got.transpose(1, 2))


def _check_grad(got, want, x, dist, g):
    """The backward tolerance of the module docstring."""
    eye = torch.eye(x.shape[1], dtype=torch.bool, device=x.device)
    h = torch.where((dist > D_MIN) & ~eye, 0.5 * g / dist, torch.zeros_like(dist))
    s = (h + h.transpose(1, 2)).abs()
    scale = 2 * (s.sum(-1, keepdim=True) * x.abs() + torch.bmm(s, x.abs()))
    assert ((got - want).abs() <= 4 * _gamma(x.shape[1]) * scale + 1e-30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 32, 65_536), (5, 32, 16_384), (5, 32, 3_072),
                                   (3, 17, 1_001), (2, 1, 100), (2, 70, 4_100)])
def test_pairwise_dist_kernels_match_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device)
    before = dict(dcor.LAUNCHES)
    got = dcor.dist_forward(x)
    torch.cuda.synchronize()
    assert dcor.LAUNCHES["forward"] == before["forward"] + 2  # partial Grams, finish
    _check_dist(got, pairwise_dist_ref(x), x)

    gd = torch.randn(got.shape, generator=g, device=cuda_device)
    gx = dcor.dist_backward(x, got, gd)
    torch.cuda.synchronize()
    assert dcor.LAUNCHES["backward"] == before["backward"] + 1
    _check_grad(gx, pairwise_dist_bwd_ref(x, got, gd), x, got, gd)

    xr = x.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad((dcor.pairwise_dist(xr) * gd).sum(), xr)
    assert torch.equal(auto, gx)  # the autograd.Function runs the same kernels


@pytest.mark.cuda
def test_pairwise_dist_identical_rows_on_card(cuda_device):
    """Identical rows are exactly D_MIN apart on the kernel, route no
    gradient, and dcor over them is 0 with a finite gradient."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    row = torch.randn(1, 1, 3_072, generator=g, device=cuda_device)
    x = row.expand(2, 32, 3_072).contiguous()
    d = dcor.dist_forward(x)
    assert (d == D_MIN).all()
    gd = torch.randn(d.shape, generator=g, device=cuda_device)
    assert not dcor.dist_backward(x, d, gd).any()
    z = torch.randn(2, 32, 500, generator=g, device=cuda_device, requires_grad=True)
    for a, b in ((x, z), (z, x)):
        val = privacy.dcor(a, b)
        assert (val == 0.0).all()
        (gz,) = torch.autograd.grad(val.sum(), z)
        assert torch.isfinite(gz).all()


def _dcor_float64(x, z):
    """dcor in float64 with an exact diagonal (the norms from the Gram's own
    diagonal): the yardstick for the card's fp32 value and gradient."""
    def dist(t):
        gram = torch.bmm(t, t.transpose(1, 2))
        sq = gram.diagonal(dim1=1, dim2=2)
        return torch.sqrt(torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2 * gram, 1e-30))

    def center(d):
        return d - d.mean(1, keepdim=True) - d.mean(2, keepdim=True) + d.mean((1, 2), keepdim=True)

    a, b = center(dist(x)), center(dist(z))
    return torch.sqrt((a * b).mean((1, 2)) / torch.sqrt((a * a).mean((1, 2)) * (b * b).mean((1, 2))))


@pytest.mark.cuda
def test_dcor_on_card_matches_float64(cuda_device):
    """dcor and its gradient w.r.t. z on the card, against float64 on the
    CPU. With the diagonal exact, fp32 leaves ~4e-8 on the value and ~2e-6
    of the largest magnitude on the gradient (the kernel's form evaluated
    in fp32 on the CPU, same inputs); bounds 1e-6 and 1e-4. The plain
    version's noisy diagonal is off by ~5e-3 on the gradient here, which is
    why the card is not held to the CPU path."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 32, 3_072, generator=g)
    z = torch.relu(x[..., :1024] @ torch.randn(1024, 1024, generator=g) / 32)
    z64 = z.double().requires_grad_(True)
    want = _dcor_float64(x.double(), z64)
    (gwant,) = torch.autograd.grad(want.sum(), z64)
    zc = z.to(cuda_device).requires_grad_(True)
    got = privacy.dcor(x.to(cuda_device), zc)
    (gz,) = torch.autograd.grad(got.sum(), zc)
    assert (got.double().cpu() - want).abs().max() <= 1e-6
    assert (gz.double().cpu() - gwant).abs().max() <= 1e-4 * gwant.abs().max()
