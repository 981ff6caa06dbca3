"""The port's hand-written kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on the
machine with the card, where JAX is absent (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py

Tests marked ``cuda`` build and launch the CUDA kernel; they skip where
``torch.cuda.is_available()`` is false. The plain versions are held
against the JAX package in ``test_torch_codec.py``.
"""
import pytest
import torch

from repro_torch.kernels import quantize
from repro_torch.kernels.ref import int8_roundtrip_ref


def test_int8_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        quantize.int8_roundtrip_rows(torch.zeros(2, 3, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int8 kernel is CUDA C++ with no CPU mode")
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
