"""The summation order of K2's forward kernel (``csrc/pairwise_dist.cu``) on the CPU.

The kernel cannot run here, so its arithmetic is emulated in torch fp32 on
the grid that ``kernels/dcor.py::forward_plan`` gives it:

  * F is cut into splits of ``chunk`` columns, each split into ring stages
    of ``kt`` columns; lane l of warp q of a task owns the float2 columns
    l + 32 (q + Q m) of every stage and sums its products with fmaf in
    column order (emulated by one rounding of the float64 sum);
  * the lanes are summed by a butterfly over the lane bits 4..0, the Q
    warps of a task in warp order, then the splits in split order;
  * D_ij = sqrt(max(G_ii + G_jj - 2 G_ij, 1e-12)) from that Gram.

At the dcor path's shapes and at the transformer shape (4, 4, 491,520) the
emulated D must be within the forward's tolerance of float64 (rtol 1e-4 off
the diagonal; ``tests/test_torch_kernels.py``), its Gram within the
deterministic bound of its summation depth, and D exactly symmetric with
a diagonal of exactly sqrt(1e-12), because every entry is summed in the
same order. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dcor
from repro_torch.kernels.ref import D2_MIN, D_MIN

torch.set_num_threads(2)
U = 2.0 ** -24


def _emulate_gram(x: torch.Tensor, plan: dcor.ForwardPlan) -> tuple[torch.Tensor, int]:
    """The kernel's Gram of x (C, B, F) fp32 in its summation order, and the
    depth of each entry's sum."""
    C, B, F = x.shape
    Q, kt, S = plan.warps_per_task, plan.kt, plan.splits
    nst, steps = plan.chunk // kt, kt // 2 // (Q * 32)
    pad = torch.zeros(C, B, S * plan.chunk, dtype=torch.float32)
    pad[..., :F] = x
    # a stage's column 2 (l + 32 (q + Q m)) + c, as (m, q, l, c)
    lanes = pad.reshape(C, B, S, nst, steps, Q, 32, 2).permute(0, 1, 2, 5, 6, 3, 4, 7)
    seq = lanes.reshape(C, B, S, Q, 32, nst * steps * 2).double()
    acc = torch.zeros(C, B, B, S, Q, 32, dtype=torch.float32)
    for k in range(seq.shape[-1]):   # fmaf in each lane's column order
        prod = seq[:, :, None, ..., k] * seq[:, None, :, ..., k]
        acc = (acc.double() + prod).float()
    for o in (16, 8, 4, 2, 1):       # the butterfly: pairs differing in bit 4, then 3, ...
        acc = acc[..., :o] + acc[..., o:2 * o]
    acc = acc[..., 0]
    g = acc[..., 0]
    for q in range(1, Q):            # the task's warps in order
        g = g + acc[..., q]
    gram = torch.zeros(C, B, B, dtype=torch.float32)
    for s in range(S):               # the splits in order
        gram = gram + g[..., s]
    return gram, seq.shape[-1] + 5 + (Q - 1) + S


def _dist(gram: torch.Tensor) -> torch.Tensor:
    sq = gram.diagonal(dim1=1, dim2=2)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
    return torch.sqrt(torch.clamp_min(d2, D2_MIN))


@pytest.mark.parametrize("shape", [(5, 32, 65_536), (5, 32, 3_072), (4, 4, 491_520),
                                   (3, 17, 1_001), (3, 8, 10_000)])
def test_emulated_order_near_float64(shape):
    C, B, F = shape
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape, dtype=np.float32))
    plan = dcor.forward_plan(C, B, F, sms=132)
    gram, depth = _emulate_gram(x, plan)

    x64 = x.double()
    exact = torch.bmm(x64, x64.transpose(1, 2))
    gamma = depth * U / (1 - depth * U)
    assert ((gram.double() - exact).abs()
            <= gamma * torch.bmm(x64.abs(), x64.abs().transpose(1, 2))).all()

    d = _dist(gram)
    want = torch.sqrt(torch.clamp_min(torch.diagonal(exact, dim1=1, dim2=2)[:, :, None]
                                      + torch.diagonal(exact, dim1=1, dim2=2)[:, None, :]
                                      - 2 * exact, D2_MIN))
    off = ~torch.eye(B, dtype=torch.bool).expand(C, B, B)
    assert ((d.double() - want).abs()[off] <= 1e-4 * want[off]).all()
    assert torch.equal(gram, gram.transpose(1, 2))
    assert torch.equal(d, d.transpose(1, 2))
    assert (d.diagonal(dim1=1, dim2=2) == D_MIN).all()


def test_emulated_identical_rows_are_d_min_apart():
    row = np.random.default_rng(1).standard_normal((1, 1, 3_072), dtype=np.float32)
    x = torch.from_numpy(np.broadcast_to(row, (2, 32, 3_072)).copy())
    gram, _ = _emulate_gram(x, dcor.forward_plan(2, 32, 3_072, sms=132))
    assert (_dist(gram) == D_MIN).all()


def _tri(base, r):
    return [(base + u, base + v) for v in range(r) for u in range(v + 1)]


def _block(a, b):
    return [(a + u, b + v) for u in range(8) for v in range(8)]


# the warp tasks of the source's task_of: B = 32 six 8 x 8 blocks above the
# diagonal and the triangles of row groups (0, 3) and (1, 2); B = 16 one
# block and both triangles; B = 8 and 4 one triangle
TASKS = {
    32: [_block(8 * a, 8 * b) for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))]
        + [_tri(0, 8) + _tri(24, 8), _tri(8, 8) + _tri(16, 8)],
    16: [_block(0, 8), _tri(0, 8) + _tri(8, 8)],
    8: [_tri(0, 8)],
    4: [_tri(0, 4)],
}


@pytest.mark.parametrize("tile", [4, 8, 16, 32])
def test_tasks_cover_the_upper_triangle_once(tile):
    entries = [e for task in TASKS[tile] for e in task]
    assert sorted(entries) == [(i, j) for i in range(tile) for j in range(i, tile)]
    plan = dcor.forward_plan(1, tile, 1_000)
    assert plan.entries == len(entries)
    assert plan.warps_per_task * len(TASKS[tile]) == dcor.WARPS
