"""The algebra and the arithmetic of K5's kernels (``csrc/mlstm_chunk.cu``) on the CPU.

The kernels cannot run here, so two things they rest on are checked apart:

  * the decomposition. A float64 emulation of the kernels' passes, on their
    chunks of 256 with a ragged last one, must agree with the plain chunk
    form ``kernels/ref.py::mlstm_chunk_ref`` and with autograd through it to
    1e-10 of each output's largest magnitude: n is C's extra column (the
    state update fed v with a column of ones), dn is dC's (the reverse walk
    fed g / den with a column r), den comes from q.n plus A's row sums, and
    the gate gradients from per-tile row and column sums of H.
  * the split. Every product runs on the tensor cores in split TF32; the
    emulation of that arithmetic (``kernels/ref.py::split_tf32_matmul``,
    rounding as ``cvt.rna.tf32.f32`` does: ``tf32_rna``) stays within 4x the
    error of an fp32 FMA product against float64 at the kernels' contraction
    lengths, where one TF32 product does not.
Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import mlstm_chunk_ref, split_tf32_matmul, tf32_rna

torch.set_num_threads(2)
P = 256     # the kernels' chunk (csrc/mlstm_chunk.cu kP)


def _inputs(BH, S, dh, seed=0):
    """q, k, v, log_f, i_gate and an output gradient g, float64."""
    rng = np.random.default_rng(seed)
    q, k, v = (0.5 * rng.standard_normal((BH, S, dh)) for _ in range(3))
    lf = -np.log1p(np.exp(-(rng.standard_normal((BH, S)) + 2.0)))
    ig = 1.0 / (1.0 + np.exp(-rng.standard_normal((BH, S))))
    g = rng.standard_normal((BH, S, dh))
    return [torch.from_numpy(a) for a in (q, k, v, lf, ig, g)]


def _emulate(q, k, v, lf, ig, g):
    """K5's forward and backward passes in float64: (h, (dq, dk, dv, d log_f, d i))."""
    BH, S, dh = q.shape
    spans = [(c0, min(P, S - c0)) for c0 in range(0, S, P)]
    nch = len(spans)
    vh = torch.cat([v, torch.ones(BH, S, 1, dtype=q.dtype)], -1)   # v and its column of ones
    # prep: cum, alpha = exp(cum), u = exp(cum_P - cum) i, beta = exp(cum_P), per chunk
    cum = torch.cat([torch.cumsum(lf[:, c0:c0 + L], -1) for c0, L in spans], -1)
    alpha = torch.exp(cum)
    last = [cum[:, c0 + L - 1] for c0, L in spans]
    u = torch.cat([torch.exp(last[c][:, None] - cum[:, c0:c0 + L]) * ig[:, c0:c0 + L]
                   for c, (c0, L) in enumerate(spans)], -1)
    beta = [torch.exp(x) for x in last]

    def decay(c0, L):
        """exp(cum_t - cum_s) and D = that * i_s, taken only where s <= t."""
        cc = cum[:, c0:c0 + L]
        tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
        e = torch.where(tri, torch.exp(torch.where(tri, cc[:, :, None] - cc[:, None, :], 0.0)),
                        0.0)
        return tri, e, e * ig[:, None, c0:c0 + L]

    # state: C with n as its extra column, at every chunk's start
    ch = [torch.zeros(BH, dh, dh + 1, dtype=q.dtype)]
    for c, (c0, L) in enumerate(spans[:-1]):
        sl = slice(c0, c0 + L)
        ch.append(beta[c][:, None, None] * ch[-1]
                  + torch.einsum("bs,bsd,bse->bde", u[:, sl], k[:, sl], vh[:, sl]))
    # out: [num | nq] = A [v | 1] + alpha q [C | n]; den = max(|nq|, 1)
    outs = []
    for c, (c0, L) in enumerate(spans):
        sl = slice(c0, c0 + L)
        _, _, D = decay(c0, L)
        A = torch.einsum("btd,bsd->bts", q[:, sl], k[:, sl]) * D
        outs.append(torch.einsum("bts,bse->bte", A, vh[:, sl])
                    + alpha[:, sl, None] * torch.einsum("btd,bde->bte", q[:, sl], ch[c]))
    numh = torch.cat(outs, 1)
    nq = numh[..., dh]
    den = torch.clamp_min(nq.abs(), 1.0)
    h = numh[..., :dh] / den[..., None]

    # bprep: g / den and r = d loss / d nq (the max's tie split in half)
    ax = nq.abs()
    slope = torch.where(ax > 1, 1.0, torch.where(ax == 1, 0.5, 0.0))
    r = torch.sign(nq) * slope * (-(g * h).sum(-1) / den)
    gh = torch.cat([g / den[..., None], r[..., None]], -1)    # g / den and its column r
    # bstate: dC with dn as its extra column, at every chunk's end but the last
    dce = [None] * nch
    acc = torch.zeros(BH, dh, dh + 1, dtype=q.dtype)
    for c in range(nch - 1, 0, -1):
        c0, L = spans[c]
        sl = slice(c0, c0 + L)
        if c < nch - 1:
            acc = beta[c][:, None, None] * acc
        acc = acc + torch.einsum("bt,btd,bte->bde", alpha[:, sl], q[:, sl], gh[:, sl])
        dce[c - 1] = acc
    grads = {n: [] for n in ("dq", "dk", "dv", "dlf", "dig")}
    for c, (c0, L) in enumerate(spans):
        sl = slice(c0, c0 + L)
        tri, e, D = decay(c0, L)
        sc = torch.einsum("btd,bsd->bts", q[:, sl], k[:, sl])
        dA = torch.where(tri, torch.einsum("bte,bse->bts", gh[:, sl], vh[:, sl]), 0.0)
        A, dS, H = sc * D, dA * D, dA * sc * e
        cg = torch.einsum("bde,bte->btd", ch[c], gh[:, sl])       # [C | n] [g/den ; r]
        dal = (q[:, sl] * cg).sum(-1)
        dq = alpha[:, sl, None] * cg + torch.einsum("bts,bsd->btd", dS, k[:, sl])
        dk = torch.einsum("bts,btd->bsd", dS, q[:, sl])
        dv = torch.einsum("bts,bte->bse", A, gh[:, sl, :dh])
        du = torch.zeros(BH, L, dtype=q.dtype)
        dbeta = torch.zeros(BH, dtype=q.dtype)
        if c < nch - 1:     # the state update feeds the next chunk
            cv = torch.einsum("bde,bse->bsd", dce[c], vh[:, sl])  # [dC | dn] [v ; 1]
            du = (k[:, sl] * cv).sum(-1)
            dk = dk + u[:, sl, None] * cv
            dv = dv + u[:, sl, None] * torch.einsum("bsd,bde->bse", k[:, sl], dce[c][..., :dh])
            dbeta = (dce[c] * ch[c]).sum((-2, -1))
        # gates: row sums of H i_s and column sums of H, then d log_f
        igc, w = ig[:, sl], torch.exp(last[c][:, None] - cum[:, sl])
        rowh, colh = (H * igc[:, None, :]).sum(-1), H.sum(-2)
        gw = du * igc * w
        dcum = rowh - igc * colh + alpha[:, sl] * dal - gw
        dcum[:, -1] += gw.sum(-1) + dbeta * beta[c]
        grads["dq"].append(dq)
        grads["dk"].append(dk)
        grads["dv"].append(dv)
        grads["dlf"].append(torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1]))
        grads["dig"].append(colh + du * w)
    return h, tuple(torch.cat(x, 1) for x in grads.values())


@pytest.mark.parametrize("S", [300, 600])   # 256 + 44; 256 + 256 + 88 (a carried dbeta)
def test_float64_emulation_of_the_kernels_passes_matches_the_plain_form(S):
    """The kernels' decomposition in float64 against the plain chunk form (whose
    chunk is the largest divisor of S up to 256: 150 or 200) and autograd
    through it: the chunked algebra is exact, so within 1e-10 of each
    output's largest magnitude."""
    q, k, v, lf, ig, g = _inputs(2, S, 16)
    h, grads = _emulate(q, k, v, lf, ig, g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, lf, ig)]
    want_h = mlstm_chunk_ref(*leaves)
    want = torch.autograd.grad(want_h, leaves, g)
    for name, a, b in zip(("h", "dq", "dk", "dv", "dlf", "dig"), (h, *grads),
                          (want_h.detach(), *want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-10 * float(b.abs().max()), err_msg=name)


def test_tf32_rna_rounds_to_nearest_with_ties_away_from_zero():
    """10 fraction bits kept: 1 + 2^-11 is a tie and goes away from zero, 1 +
    2^-12 goes down, 1 + 3 * 2^-12 up; every result is within 2^-11 of its
    input, relatively, and has its low 13 bits 0."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 3.0, 0.0])
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 3.0, 0.0])
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    t = tf32_rna(y)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((t - y).abs() <= 2.0**-11 * y.abs())


@pytest.mark.parametrize("K", [256, 512])     # a chunk; the head dim of the path
def test_split_tf32_products_keep_fp32_accuracy(K):
    """A 64 x K by K x 64 product, N(0, 1) by N(0, 1/K): split TF32 (three
    products a k-step) within 4x the error of fp32 FMA against float64; one
    TF32 product far outside it."""
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, 64)) / np.sqrt(K)).astype(np.float32))
    exact = a.double() @ b.double()
    fma = torch.zeros(64, 64, dtype=torch.float32)
    for kk in range(K):      # the FMA units: one rounding per step, the product exact
        fma = (fma.double() + a[:, kk:kk + 1].double() * b[kk:kk + 1, :].double()).float()
    fp32_err = float((fma.double() - exact).abs().max())
    split_err = float((split_tf32_matmul(a, b).double() - exact).abs().max())
    single_err = float((split_tf32_matmul(a, b, products=1).double() - exact).abs().max())
    assert split_err <= 4 * fp32_err, (split_err, fp32_err)
    assert single_err > 4 * fp32_err, (single_err, fp32_err)
