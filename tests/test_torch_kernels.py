"""The port's hand-written kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on the
machine with the card, where JAX is absent (``tests/conftest.py`` imports
JAX, hence ``--noconftest``):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py

Tests marked ``cuda`` build and launch the CUDA kernels; they skip where
``torch.cuda.is_available()`` is false. The plain versions are held
against the JAX package in ``test_torch_codec.py`` (K1),
``test_torch_privacy.py`` (K2), ``test_torch_attention_xent.py`` (K3,
K4) and ``test_torch_xlstm.py`` (K5).

K3 and K4 tolerances on the card, kernel against plain version on the same
inputs (both sum in fp32, in other orders):
  * K4 forward: fp32 atol = rtol = 2e-5, the JAX package's own tolerance
    for its flash kernel (``tests/test_kernels.py:27``); bf16 2e-2, the
    same test's, since the output is rounded to bf16 (2**-9 relative) and
    p's cast to bf16 may fall on either side of a rounding boundary.
  * K4 backward: fp32 rtol 1e-4, atol 1e-4 of the largest magnitude: each
    gradient is a sum over up to S = 512 keys (or G * S queries) of
    products of fp32 sums over hd, a few ulps of the largest term each;
    bf16 2e-2 as the forward.
  * K3 loss: atol 2e-4 (lse ~ log V ~ 11, summed over V in another order).
  * K3 gradient: fp32 rtol 1e-5, atol 1e-6 of the largest magnitude; bf16
    rtol 1e-2 (one bf16 rounding step, 2**-8, either way), atol 1e-6 of
    the largest magnitude.

K5 tolerances on the card, kernel against the plain chunk form (and
autograd through it) on the same fp32 inputs, absolute: both sum the same
products in other orders and with other chunk boundaries (the kernel's
chunk is 256, the plain form's the largest divisor of S up to 256), and the
kernel takes every product on the tensor cores in split TF32 (three TF32
products per fp32 one). At the path's shape (48, 512, 512), q ~ N(0, 1),
k ~ N(0, 1/dh), v ~ N(0, 1), forget gates log_sigmoid(N(3, 1)), input gates
sigmoid(N(0, 1)), the largest errors measured on the H100 (chip_smoke.py's
K5 phase) are h 3.3e-5 (|h| up to 13), dq 1.5e-4 (|dq| up to 31), dv 2.7e-5
(15), dk 2.3e-3, d log_f 1.4e-3 and d i 1.5e-3 (up to 420); the smaller
shapes less. Against float64 the kernel's errors are 0.9-1.8x the fp32
plain form's own. Tolerances: h 2e-4, dq 2e-3, dv 2e-4, dk, d log_f and d
i 2e-2, 6x or more the largest error measured and far below a fault's O(1).

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
import numpy as np
import pytest
import torch

from repro_torch import privacy
from repro_torch.kernels import dcor, quantize
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels.ref import (D_MIN, attention_bwd_ref, attention_ref,
                                     fused_xent_bwd_ref, fused_xent_ref, int8_roundtrip_ref,
                                     mlstm_chunk_ref, pairwise_dist_bwd_ref, pairwise_dist_ref)

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


def _tile_pairs(T):
    """The forward's tile pair (ti, tj) of each grid index p, decoded as
    ``pdist_fwd`` decodes it: ti <= tj, row-major over the upper triangle."""
    out = []
    for p in range(T * (T + 1) // 2):
        ti, q = 0, p
        while q >= T - ti:
            q -= T - ti
            ti += 1
        out.append((ti, ti + q))
    return out


@pytest.mark.parametrize("C,B,F", [(5, 32, 65_536), (5, 32, 3_072), (3, 17, 1_001),
                                   (1, 1, 5), (2, 200, 64), (4, 4, 491_520)])
def test_split_chunk_covers_f(C, B, F):
    """The forward's grid: splits that cover F exactly in whole ring
    stages, every tile pair ti <= tj once, and no more than a wave of the
    H100's 132 SMs."""
    plan = dcor.forward_plan(C, B, F, sms=132)
    assert plan.chunk % plan.kt == 0 and plan.chunk >= plan.kt
    assert plan.kt * plan.tile * (1 if B <= 32 else 2) == dcor.STAGE_FLOATS  # rows staged
    assert (plan.splits - 1) * plan.chunk < F <= plan.splits * plan.chunk
    assert (B <= 32) == (plan.pairs == 1) and (B > 32 or B <= plan.tile < max(2 * B, 5))
    T = -(-B // plan.tile)
    pairs = _tile_pairs(T) if B > 32 else [(0, 0)]
    assert len(pairs) == plan.pairs
    assert sorted(pairs) == [(i, j) for i in range(T) for j in range(i, T)]
    assert C * plan.blocks <= 132 * max(dcor.BLOCKS_PER_SM.values())  # one wave


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


K2_CARD_SHAPES = [(5, 32, 65_536), (5, 32, 16_384), (5, 32, 3_072), (4, 4, 491_520),
                  (3, 8, 10_000), (3, 17, 1_001), (2, 1, 100), (2, 70, 4_100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K2_CARD_SHAPES)
def test_pairwise_dist_kernels_match_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device)
    dcor.dist_forward(x)  # the first call on a device also zeroes its counters
    before = dict(dcor.LAUNCHES)
    got = dcor.dist_forward(x)
    torch.cuda.synchronize()
    assert dcor.LAUNCHES["forward"] == before["forward"] + 1  # one launch a forward
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
@pytest.mark.parametrize("shape", [(5, 32, 65_536), (4, 4, 491_520), (2, 70, 4_100)])
def test_pairwise_dist_reruns_bit_identical_on_card(cuda_device, shape):
    """No float atomics and every sum in a fixed order: the same bits on
    every run, and inside a CUDA graph, whose replays reuse the counters."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda_device)
    d = dcor.dist_forward(x)
    gd = torch.randn(d.shape, generator=g, device=cuda_device)
    gx = dcor.dist_backward(x, d, gd)
    for _ in range(3):
        assert torch.equal(dcor.dist_forward(x), d)
        assert torch.equal(dcor.dist_backward(x, d, gd), gx)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        d_graph = dcor.dist_forward(x)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(d_graph, d)


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


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take():
    q, kv = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):   # k and v of different shapes
        fa.flash_attention(q, kv, torch.zeros(2, 8, 1, 16))
    with pytest.raises(ValueError):   # H not a multiple of KV
        fa.flash_attention(torch.zeros(2, 8, 3, 16), kv, kv)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):   # mixed dtypes
        fa.flash_attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(ValueError):   # head_dim above 128
        fa.flash_attention(torch.zeros(1, 4, 2, 160), torch.zeros(1, 4, 2, 160),
                           torch.zeros(1, 4, 2, 160))
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv, kv, window=-1)


def test_fused_xent_wrapper_rejects_what_the_kernel_does_not_take():
    labels = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        fx.fused_xent(torch.zeros(2, 4, 5), labels)
    with pytest.raises(TypeError):
        fx.fused_xent(torch.zeros(4, 5, dtype=torch.float64), labels)
    with pytest.raises(TypeError):
        fx.fused_xent(torch.zeros(4, 5), labels.float())
    with pytest.raises(ValueError):
        fx.fused_xent(torch.zeros(4, 5, device="meta"), labels.to("meta"))
    with pytest.raises(ValueError):
        fx.fused_xent(torch.zeros(5, 4).t(), labels)
    with pytest.raises(ValueError):
        fx.fused_xent(torch.zeros(4, 0), labels)


def _xent_row_cut(V, itemsize, offset, lanes):
    """How many times each element of a row is read when its ``lanes``
    threads take it as ``csrc/fused_xent.cu`` cuts a row whose first
    element lies ``offset`` bytes past a 16-byte boundary: lane t takes
    head and tail elements t, t + lanes, ... (``split_row``: the head runs
    to the first boundary) and 16-byte vectors t, t + lanes, ... in
    between. Returns (reads a column, the byte offset of the first vector,
    or None without one)."""
    N = 16 // itemsize
    past = offset % 16 // itemsize
    head = min(V, (N - past) & (N - 1))
    nvec = (V - head) // N
    tail0 = head + nvec * N
    scalars = np.concatenate([np.arange(head), np.arange(tail0, V)])
    reads = np.zeros(V, dtype=np.int64)
    for t in range(lanes):
        np.add.at(reads, scalars[t::lanes], 1)
        vec = np.arange(t, nvec, lanes)
        np.add.at(reads, (head + vec[:, None] * N + np.arange(N)).ravel(), 1)
    return reads, (offset + head * itemsize if nvec else None)


# K3's shapes: the timed rows, the runs' launches, the card tests' cases
XENT_GEOMETRY_SHAPES = [
    (8_192, 49_152, 2), (8_192, 49_155, 2), (4_096, 102_400, 2), (2_048, 102_400, 2),
    (2_048, 64_000, 2), (2_048, 49_155, 2), (6_144, 49_155, 2), (2_048, 202_048, 2),
    (8_192, 50_304, 2), (6_144, 50_304, 2), (4_096, 64_000, 2), (4_096, 49_152, 2),
    (320, 10, 4), (32, 10, 4), (640, 10, 4), (1_000, 50_001, 2),
    (333, 4_096, 4), (7, 202_048, 2), (1, 1, 2), (1, 1, 4), (5, 10, 2), (64, 4_097, 2),
    (64, 4_103, 2), (64, 4_099, 4), (1, 49_155, 2),
]


@pytest.mark.parametrize("T,V,itemsize,base", [
    (T, V, size, base) for T, V, size in XENT_GEOMETRY_SHAPES
    for base in ((0, 2, 6, 14) if size == 2 else (0, 4, 12))])
def test_fused_xent_geometry_covers_rows_and_elements(T, V, itemsize, base):
    """``geometry``: every row in exactly one (block, slot), no block
    without a row; every element of every row read exactly once, the
    vectors starting on a 16-byte boundary, at each row's own offset
    (logits starting ``base`` bytes past a boundary: a view with a storage
    offset)."""
    shape = fx.geometry(T, V, itemsize, sms=132)
    assert shape.lanes & (shape.lanes - 1) == 0 and 1 <= shape.lanes <= fx.THREADS
    assert shape.rows * shape.lanes == fx.THREADS
    rows = np.arange(shape.blocks)[:, None] * shape.rows + np.arange(shape.rows)
    assert np.array_equal(np.sort(rows[rows < T]), np.arange(T))
    assert rows[-1, 0] < T                                  # the last block has a row
    for offset in sorted({(base + r * V * itemsize) % 16 for r in range(min(T, 16))}):
        reads, first = _xent_row_cut(V, itemsize, offset, shape.lanes)
        assert (reads == 1).all()
        assert first is None or first % 16 == 0


def test_fused_xent_geometry_splits_small_t_and_packs_small_v():
    """At T = 2,048 a row spans several warps (the MoE and one-client
    granite launches); at the path's T = 8,192 one warp; the ResNet's
    classifier (V = 10 fp32) packs rows into a warp."""
    for V in (102_400, 49_155, 64_000):
        assert fx.geometry(2_048, V, 2).lanes > 32
    assert fx.geometry(8_192, 49_152, 2).lanes == 32
    resnet = fx.geometry(320, 10, 4)
    assert resnet.lanes < 32 and resnet.rows > 8
    assert fx.geometry(7, 202_048, 2).lanes == fx.THREADS


def test_plain_attention_grads_equal_autograd():
    """The plain backward (FlashAttention-2's form from the saved lse) is
    the gradient of the plain forward: against autograd through a
    materialized fp64 softmax attention with grouped heads, causal and
    windowed, ragged S."""
    g = torch.Generator().manual_seed(0)
    for S, causal, window in ((37, True, 0), (37, True, 9), (20, False, 0), (20, False, 6)):
        q = torch.randn(2, S, 6, 16, generator=g, dtype=torch.float64)
        k = torch.randn(2, S, 2, 16, generator=g, dtype=torch.float64)
        v = torch.randn(2, S, 2, 16, generator=g, dtype=torch.float64)
        do = torch.randn(2, S, 6, 16, generator=g, dtype=torch.float64)
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        kr, vr = (t.repeat_interleave(3, dim=2) for t in (ka, va))
        s = torch.einsum("nqhd,nkhd->nhqk", qa, kr) / 4.0
        qpos, kpos = torch.arange(S)[:, None], torch.arange(S)[None, :]
        vis = torch.ones(S, S, dtype=torch.bool)
        if causal:
            vis &= qpos >= kpos
        if window:
            vis &= qpos - kpos < window
        p = torch.softmax(s.masked_fill(~vis, -torch.inf), dim=-1)
        o = torch.einsum("nhqk,nkhd->nqhd", p, vr)
        grads = torch.autograd.grad((o * do).sum(), (qa, ka, va))
        # the plain versions in fp32 on these inputs
        q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
        o32, lse = attention_ref(q32, k32, v32, causal=causal, window=window)
        assert torch.allclose(o32.double(), o, atol=1e-5)
        got = attention_bwd_ref(q32, k32, v32, o32, lse, do32, causal=causal, window=window)
        for a, b in zip(got, grads):
            assert torch.allclose(a.double(), b, atol=1e-4, rtol=1e-4)


def _close(got, want, rtol, atol):
    """torch.allclose in fp32: atol is absolute, not scaled by the data."""
    return torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,S,H,KV,hd,causal,window", [
    (16, 512, 15, 5, 64, True, 0),      # the path's shape
    (4, 512, 15, 5, 64, True, 128),     # sliding window
    (3, 200, 6, 2, 64, True, 0),        # ragged S
    (3, 200, 4, 4, 64, True, 0),        # G = 1
    (2, 130, 4, 2, 64, False, 0),       # full attention
    (2, 96, 4, 2, 64, False, 40),       # window without causality
    (8, 32, 4, 2, 32, True, 0),         # the reduced model's hd
    (2, 150, 4, 1, 128, True, 0),       # hd 128
    (2, 70, 3, 3, 40, True, 0),         # hd not a power of two
    (2, 90, 4, 2, 20, True, 0),         # hd not a multiple of 8: staged element by element
])
def test_flash_attention_kernels_match_plain_on_card(cuda_device, N, S, H, KV, hd, causal,
                                                     window, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(N, S, H, hd, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(N, S, KV, hd, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(N, S, KV, hd, generator=g, device=cuda_device).to(dtype)
    do = torch.randn(N, S, H, hd, generator=g, device=cuda_device).to(dtype)
    before = dict(fa.LAUNCHES)
    o, lse = fa.attn_forward(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["forward"] == before["forward"] + 1
    o_want, lse_want = attention_ref(q, k, v, causal=causal, window=window)
    # (rtol, atol): fp32 as tests/test_kernels.py:27; bf16 holds a measured
    # error of 3.9e-3 (forward) and 1.6e-2 (backward: one bf16 step of a
    # gradient of magnitude 2-4) with room
    fwd_tol, bwd_tol = (((2e-5, 2e-5), (1e-4, 1e-4)) if dtype == torch.float32
                        else ((2e-2, 1e-2), (2e-2, 1e-2)))
    assert _close(o, o_want, *fwd_tol)
    assert torch.allclose(lse, lse_want, atol=1e-5, rtol=1e-5)

    grads = fa.attn_backward(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["backward"] == before["backward"] + 2   # dQ, then dK/dV
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    for name, a, b in zip("qkv", grads, want):
        assert _close(a, b, *bwd_tol), (name, float((a.float() - b.float()).abs().max()))
    again = fa.attn_backward(q, k, v, o, lse, do, causal=causal, window=window)
    for a, b in zip(grads, again):
        assert torch.equal(a, b)   # no atomics: the same bits every run

    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    auto = torch.autograd.grad((fa.flash_attention(qa, ka, va, causal=causal, window=window)
                                * do).sum(), (qa, ka, va))
    assert all(torch.equal(a, b) for a, b in zip(auto, grads))


def _xent_labels(kind, logits, g):
    """Labels for K3's card tests: random; at column 0 and V - 1 in turn;
    or each row's last element before its first 16-byte boundary (the
    peeled head; column 0 where the row starts on one)."""
    T, V = logits.shape
    if kind == "random":
        return torch.randint(0, V, (T,), generator=g, device=logits.device)
    rows = torch.arange(T, device=logits.device)
    if kind == "ends":
        return rows % 2 * (V - 1)
    size = logits.element_size()
    n = 16 // size
    past = (logits.data_ptr() + rows * V * size) % 16 // size
    head = torch.clamp((n - past) % n, max=V)
    return torch.clamp(head - 1, min=0)


BF16, FP32 = torch.bfloat16, torch.float32
# (T, V, dtype, storage offset in elements, labels)
XENT_CARD_CASES = [
    (8_192, 49_152, BF16, 0, "random"),       # the path's heads
    (320, 10, FP32, 0, "random"),             # the ResNet's classifier
    (1_000, 50_001, BF16, 0, "random"),       # ragged: rows off 16-byte alignment
    (333, 4_096, FP32, 0, "random"),
    (7, 202_048, BF16, 0, "random"),          # the largest vocab: a block a row
    (2_048, 49_155, BF16, 0, "head"),         # rows split over warps
    *[(64, 4_096 + r, BF16, 0, "head") for r in range(1, 8)],   # each row offset mod 16
    *[(64, 4_096 + r, FP32, 0, "head") for r in range(1, 4)],
    (64, 4_099, BF16, 3, "head"),             # a view with a storage offset
    (64, 4_099, FP32, 1, "ends"),
    (64, 4_096, BF16, 5, "ends"),
    (9, 1, BF16, 0, "ends"),
    (9, 1, FP32, 1, "ends"),
    (200, 10, BF16, 1, "ends"),
    (1, 49_155, BF16, 0, "ends"),
    (1, 10, FP32, 0, "random"),
    (7, 202_048, BF16, 0, "ends"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,V,dtype,offset,labels", XENT_CARD_CASES)
def test_fused_xent_kernels_match_plain_on_card(cuda_device, T, V, dtype, offset, labels):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    flat = (3 * torch.randn(T * V + offset, generator=g, device=cuda_device)).to(dtype)
    logits = flat[offset:].view(T, V)
    labels = _xent_labels(labels, logits, g)
    before = dict(fx.LAUNCHES)
    loss, lse = fx.xent_forward(logits, labels)
    torch.cuda.synchronize()
    assert fx.LAUNCHES["forward"] == before["forward"] + 1
    loss_want, lse_want = fused_xent_ref(logits, labels)
    assert (loss - loss_want).abs().max() <= 2e-4
    assert (lse - lse_want).abs().max() <= 2e-4

    gt = torch.randn(T, generator=g, device=cuda_device)
    grad = fx.xent_backward(logits, labels, lse, gt)
    torch.cuda.synchronize()
    assert fx.LAUNCHES["backward"] == before["backward"] + 1
    want = fused_xent_bwd_ref(logits, labels, lse, gt)
    assert grad.dtype == dtype
    assert _close(grad, want, 1e-5 if dtype == torch.float32 else 1e-2, 1e-6)

    # through autograd, on the same memory (the row's cut, and with it the
    # forward's order of summation, follows the offset from 16 bytes)
    la = logits.detach().requires_grad_(True)
    (auto,) = torch.autograd.grad((fx.fused_xent(la, labels) * gt).sum(), la)
    assert torch.equal(auto, grad)
    # a fixed order of summation: the same bits run to run
    again, lse_again = fx.xent_forward(logits, labels)
    assert torch.equal(again, loss) and torch.equal(lse_again, lse)
    assert torch.equal(fx.xent_backward(logits, labels, lse, gt), grad)


@pytest.mark.cuda
def test_fused_xent_backward_refuses_dlogits_at_another_offset_on_card(cuda_device):
    """The backward cuts logits and dlogits rows alike, so the library
    refuses a dlogits whose offset mod 16 differs from the logits'."""
    logits = torch.zeros(4, 64, device=cuda_device)
    out = torch.empty(4 * 64 + 1, device=cuda_device)[1:]
    labels = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    lse, gt = torch.zeros(4, device=cuda_device), torch.ones(4, device=cuda_device)
    shape = fx.geometry(4, 64, 4)
    err = fx.load_library().fused_xent_backward(
        logits.data_ptr(), labels.data_ptr(), 4, lse.data_ptr(), gt.data_ptr(), out.data_ptr(),
        4, 64, 0, shape.lanes, shape.blocks, torch.cuda.current_stream().cuda_stream)
    assert err != 0


def _mlstm_inputs(BH, S, dh, g, device):
    """The path's input distributions (the K5 tolerances above)."""
    q = torch.randn(BH, S, dh, generator=g, device=device)
    k = torch.randn(BH, S, dh, generator=g, device=device) / dh ** 0.5
    v = torch.randn(BH, S, dh, generator=g, device=device)
    lf = torch.nn.functional.logsigmoid(torch.randn(BH, S, generator=g, device=device) + 3)
    ig = torch.sigmoid(torch.randn(BH, S, generator=g, device=device))
    return q, k, v, lf, ig


MLSTM_TOL = {"h": 2e-4, "dq": 2e-3, "dk": 2e-2, "dv": 2e-4, "dlf": 2e-2, "dig": 2e-2}


def test_mlstm_chunk_wrapper_rejects_what_the_kernel_does_not_take():
    q, gate = torch.zeros(2, 8, 16), torch.zeros(2, 8)
    with pytest.raises(ValueError):   # k of another shape
        mk.mlstm_chunk(q, torch.zeros(2, 8, 8), q, gate, gate)
    with pytest.raises(ValueError):   # gates not (BH, S)
        mk.mlstm_chunk(q, q, q, torch.zeros(2, 9), gate)
    with pytest.raises(TypeError):
        mk.mlstm_chunk(q.double(), q.double(), q.double(), gate.double(), gate.double())
    with pytest.raises(ValueError):
        mk.mlstm_chunk(*(t.to("meta") for t in (q, q, q, gate, gate)))
    with pytest.raises(ValueError):
        mk.mlstm_chunk(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, gate, gate)
    big = torch.zeros(1, 4, 640)
    with pytest.raises(ValueError):   # dh above 512
        mk.mlstm_chunk(big, big, big, torch.zeros(1, 4), torch.zeros(1, 4))
    with pytest.raises(ValueError):   # the kernel-only entry points take no CPU tensor
        mk.mlstm_forward(q, q, q, gate, gate)


def test_mlstm_chunk_on_the_cpu_is_the_plain_form():
    g = torch.Generator().manual_seed(0)
    ins = [t.requires_grad_(True) for t in _mlstm_inputs(2, 40, 8, g, "cpu")]
    before = dict(mk.LAUNCHES)
    got = mk.mlstm_chunk(*ins)
    assert torch.equal(got, mlstm_chunk_ref(*ins))
    torch.autograd.grad(got.sum(), ins)
    assert mk.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,dh", [
    (48, 512, 512),     # the path: 3 clients x 4 sequences x 4 heads, two chunks
    (24, 320, 64),      # the reduced model's head dim, a ragged second chunk
    (3, 96, 32), (3, 200, 128), (2, 300, 256),    # ragged S, every state tile size
    (2, 130, 37),       # dh not a multiple of 4: 4-byte copies
])
def test_mlstm_chunk_kernels_match_plain_on_card(cuda_device, BH, S, dh):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ins = _mlstm_inputs(BH, S, dh, g, cuda_device)
    gout = torch.randn(BH, S, dh, generator=g, device=cuda_device)
    before = dict(mk.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    h = mk.mlstm_chunk(*leaves)
    got = torch.autograd.grad(h, leaves, gout)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == {"forward": before["forward"] + 4,
                           "backward": before["backward"] + 7}
    ref_leaves = [t.clone().requires_grad_(True) for t in ins]
    want_h = mlstm_chunk_ref(*ref_leaves)
    want = torch.autograd.grad(want_h, ref_leaves, gout)
    assert (h - want_h).abs().max() <= MLSTM_TOL["h"]
    for name, a, b in zip(("dq", "dk", "dv", "dlf", "dig"), got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= MLSTM_TOL[name], name
    # the backward's sums have a fixed order: the same bits every run
    hh, saved = mk.mlstm_forward(*ins)
    again = mk.mlstm_backward(*ins, hh, saved, gout)
    assert torch.equal(hh, h.detach())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,dh", [(48, 512, 512), (2, 300, 256)])
def test_mlstm_chunk_kernels_near_float64_on_card(cuda_device, BH, S, dh):
    """Each K5 output against the plain chunk form in float64: the kernel's
    max |error| is at most 4x the fp32 plain form's own (split TF32 keeps
    fp32 accuracy; one TF32 product would not)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ins = _mlstm_inputs(BH, S, dh, g, cuda_device)
    gout = torch.randn(BH, S, dh, generator=g, device=cuda_device)
    outs = {}
    for name, dtype, fn in (("kernel", torch.float32, mk.mlstm_chunk),
                            ("plain", torch.float32, mlstm_chunk_ref),
                            ("exact", torch.float64, mlstm_chunk_ref)):
        leaves = [t.to(dtype).requires_grad_(True) for t in ins]
        h = fn(*leaves)
        outs[name] = (h.detach(), *torch.autograd.grad(h, leaves, gout.to(dtype)))
    for i, name in enumerate(("h", "dq", "dk", "dv", "dlf", "dig")):
        exact = outs["exact"][i]
        kernel_err = (outs["kernel"][i].double() - exact).abs().max()
        plain_err = (outs["plain"][i].double() - exact).abs().max()
        assert kernel_err <= 4 * plain_err, (name, float(kernel_err), float(plain_err))

