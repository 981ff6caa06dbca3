"""The arithmetic of K4's fp32 kernels (``csrc/flash_attention.cu``,
``flash_tf32_*``) on the CPU.

The kernels cannot run here, so their arithmetic is emulated and held to
the tolerances the card holds them to (fp32: 2e-5 forward, 1e-4 backward,
``tests/test_torch_kernels.py``). Every product runs on the tensor cores in
split TF32 (``kernels/ref.py::split_tf32_matmul``, rounding as
``cvt.rna.tf32.f32`` does): each operand big = tf32(x) plus small =
tf32(x - big), three TF32 products per fp32 one. The emulation follows the
kernels' blocking: Q K^T and dO V^T (and K Q^T, V dO^T) summed over the
head dim in the tensor cores' fragments; P V over keys, dS K over keys,
P^T dO and dS^T Q over the G heads' queries with a fresh fragment every 32
rows, added to the fp32 sum with one rounding (``group=4``); the tensor
cores' own additions taken as rounding toward zero, the worse case. The
online softmax runs tile by tile over the forward's key tiles (64 keys up
to hd 64, 32 above), p = 2^(s scale log2(e) - m scale log2(e)); the
backward's P = 2^(s scale log2(e) - lse log2(e)); across lengths the
backward goes through the wrapper's query chunks
(``kernels/flash_attention.py::_cross_backward``).

The emulation must agree with the plain fp32 versions
(``attention_ref``, ``attention_bwd_ref``) and with the JAX package (its
jnp attention and ``jax.grad`` of it at every case, its Pallas kernel in
interpret mode at one case of each forward key tile) within those
tolerances; with one TF32 product (``products=1``) its forward must not.
Inputs are made with numpy from a seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import (_visible, attention_bwd_ref, attention_ref,
                                     split_tf32_matmul)

torch.set_num_threads(2)
LOG2E = np.float32(1.4426950408889634)
FWD_TOL, BWD_TOL = 2e-5, 1e-4     # (atol = rtol), the card's fp32 tolerances
# (N, Sq, Sk, H, KV, hd, causal, window)
CASES = {
    "causal, G = 2": (1, 128, 128, 4, 2, 64, True, 0),
    "window": (1, 96, 96, 2, 1, 64, True, 40),
    "Sq != Sk": (1, 40, 96, 2, 1, 64, False, 0),
    "ragged S": (1, 72, 72, 2, 2, 64, True, 0),
    "hd 160": (1, 72, 72, 2, 1, 160, True, 0),
}
# the square cases also held to the Pallas kernel (interpret mode), one for
# each of the forward's key tiles (64 keys up to hd 64, 32 above)
PALLAS_CASES = ("causal, G = 2", "hd 160")


def _inputs(N, Sq, Sk, H, KV, hd, seed=0):
    """q, k, v, dO as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((N, Sq, H, hd), (N, Sk, KV, hd), (N, Sk, KV, hd), (N, Sq, H, hd))]


def _scales(hd):
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    return scale, scale * torch.tensor(LOG2E)


def _fma(x, y, z):
    """fp32 x * y + z with one rounding."""
    return (x.double() * y.double() + z.double()).float()


def _heads(t, KV):
    """(N, S, H, hd) -> (N, KV, G, S, hd)."""
    N, S, H, hd = t.shape
    return t.reshape(N, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def _pad_rows(t, dim, mult):
    """Zero rows along ``dim`` up to a multiple of ``mult`` (the tiles' ragged edge)."""
    extra = -t.shape[dim] % mult
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def emulate_forward(q, k, v, causal, window, products=3):
    """flash_tf32_fwd: (o, lse) for fp32 q (N, Sq, H, hd), k, v (N, Sk, KV, hd)."""
    N, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    KR = 64 if hd <= 64 else 32                    # the kernel's key tile
    scale, sl2 = _scales(hd)
    kt, vt = (_pad_rows(t.permute(0, 2, 1, 3)[:, :, None], 3, KR) for t in (k, v))
    s_all = split_tf32_matmul(_heads(q, KV), kt.transpose(-1, -2), products, group=0)
    vis = _pad_rows(_visible(Sq, Sk, causal, window, q.device), 1, KR)
    m = torch.full(s_all.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(s_all.shape[:-1] + (hd,))
    for k0 in range(0, s_all.shape[-1], KR):
        s = torch.where(vis[:, k0:k0 + KR], s_all[..., k0:k0 + KR], -torch.inf)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        mb = torch.where(mx == -torch.inf, 0.0, mx * sl2)
        alpha = torch.exp2(m * sl2 - mb)
        p = torch.exp2(_fma(s, sl2, -mb))
        l = alpha * l + p.sum(-1, keepdim=True)
        m = mx
        acc = split_tf32_matmul(p, vt[..., k0:k0 + KR, :], products, acc=acc * alpha, group=4)
    lc = torch.clamp_min(l, 1e-30)
    o = (acc / lc).permute(0, 3, 1, 2, 4).reshape(N, Sq, H, hd)
    return o, (m * scale + torch.log(lc)).reshape(N, H, Sq)


def emulate_square_backward(q, k, v, o, lse, do, causal, window, products=3):
    """flash_tf32_bwd_dq, then flash_tf32_bwd_dkdv, at Sq = Sk: (dq, dk, dv)."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale, sl2 = _scales(hd)
    qh, doh = (_pad_rows(_heads(t, KV), 3, 32) for t in (q, do))       # (N, KV, G, Sp, hd)
    kt, vt = (_pad_rows(t.permute(0, 2, 1, 3)[:, :, None], 3, 32) for t in (k, v))
    Sp = qh.shape[3]
    vis = _pad_rows(_pad_rows(_visible(S, S, causal, window, q.device), 0, 32), 1, 32)
    D = _pad_rows((do * o).sum(-1).reshape(N, S, KV, G).permute(0, 2, 3, 1), 3, 32)[..., None]
    lrow = _pad_rows(lse.reshape(N, KV, G, S) * torch.tensor(LOG2E), 3, 32)[..., None]

    def probs(s, lrows):
        return torch.where(vis, torch.exp2(_fma(s, sl2, -lrows)), 0.0)

    # dQ: S = Q K^T and dP = dO V^T over the head dim, dQ += dS K over keys
    s = split_tf32_matmul(qh, kt.transpose(-1, -2), products, group=0)
    dp = split_tf32_matmul(doh, vt.transpose(-1, -2), products, group=0)
    ds = probs(s, lrow) * (dp - D)
    dq = split_tf32_matmul(ds, kt, products, group=4) * scale
    # dK, dV: S^T = K Q^T and dP^T = V dO^T, then over the G heads' queries
    # in order (g, q): dV += P^T dO, dK += dS^T Q
    st = split_tf32_matmul(kt, qh.transpose(-1, -2), products, group=0)     # (N, KV, G, Sp, Sp)
    dpt = split_tf32_matmul(vt, doh.transpose(-1, -2), products, group=0)
    pt = torch.where(vis.T, torch.exp2(_fma(st, sl2, -lrow.transpose(-1, -2))), 0.0)
    dst = pt * (dpt - D.transpose(-1, -2))

    def over_heads(x):   # (N, KV, G, Sp keys, Sp queries) -> (N, KV, Sp, G * Sp)
        return x.permute(0, 1, 3, 2, 4).reshape(N, KV, Sp, G * Sp)

    rows = lambda t: t.reshape(N, KV, G * Sp, hd)                        # noqa: E731
    dv = split_tf32_matmul(over_heads(pt), rows(doh), products, group=4)
    dk = split_tf32_matmul(over_heads(dst), rows(qh), products, group=4) * scale
    dq = dq[:, :, :, :S].permute(0, 3, 1, 2, 4).reshape(N, S, H, hd)
    return dq, dk[:, :, :S].transpose(1, 2), dv[:, :, :S].transpose(1, 2)


def emulate_backward(q, k, v, o, lse, do, causal, window, products=3, monkeypatch=None):
    """The backward as the wrapper runs the kernels: at Sq != Sk over its
    query chunks (``_cross_backward``) with the square emulation in place of
    the kernels."""
    square = lambda *a: emulate_square_backward(*a, products=products)   # noqa: E731
    if q.shape[1] == k.shape[1]:
        return square(q, k, v, o, lse, do, causal, window)
    monkeypatch.setattr(fa, "_square_backward", square)
    return fa._cross_backward(q, k, v, o, lse, do)


def _pallas_forward(q, k, v, causal, window):
    """The JAX package's Pallas kernel in interpret mode, one head per row
    with the KV heads repeated."""
    N, S, H, hd = q.shape
    rows = lambda t: jnp.asarray(t).transpose(0, 2, 1, 3).reshape(N * H, S, hd)   # noqa: E731
    kx, vx = (np.repeat(t, H // k.shape[2], axis=2) for t in (k, v))
    out = jflash(rows(q), rows(kx), rows(vx), causal=causal, window=window, interpret=True)
    return np.asarray(out).reshape(N, H, S, hd).transpose(0, 2, 1, 3)


def _jax_attention(q, k, v, do, causal, window):
    """The JAX package's jnp attention and ``jax.grad`` of sum(o * dO): (o, dq, dk, dv)."""
    def run(q, k, v):
        o, vjp = jax.vjp(lambda *x: jlayers.attention(*x, causal=causal, window=window), q, k, v)
        return (o, *vjp(jnp.asarray(do)))

    return [np.asarray(x) for x in jax.jit(run)(*map(jnp.asarray, (q, k, v)))]


def _close(got, want, tol):
    return torch.allclose(got.float(), torch.as_tensor(np.array(want)).float(), rtol=tol,
                          atol=tol)


def _err(got, want):
    return float((got.float() - torch.as_tensor(np.array(want)).float()).abs().max())


@pytest.mark.parametrize("case", CASES)
def test_split_tf32_emulation_holds_fp32_tolerances(case, monkeypatch):
    """Forward and backward in split TF32 within 2e-5 / 1e-4 of the plain
    fp32 versions and of the JAX package; one TF32 product breaks the
    forward's bound."""
    N, Sq, Sk, H, KV, hd, causal, window = CASES[case]
    qn, kn, vn, don = _inputs(N, Sq, Sk, H, KV, hd)
    q, k, v, do = map(torch.from_numpy, (qn, kn, vn, don))
    jo, *jgrads = _jax_attention(qn, kn, vn, don, causal, window)
    o_want, lse_want = attention_ref(q, k, v, causal=causal, window=window)
    o, lse = emulate_forward(q, k, v, causal, window)
    assert _close(o, o_want, FWD_TOL), _err(o, o_want)
    assert torch.allclose(lse, lse_want, rtol=1e-5, atol=1e-5), _err(lse, lse_want)
    assert _close(o, jo, FWD_TOL), _err(o, jo)
    if case in PALLAS_CASES:
        po = _pallas_forward(qn, kn, vn, causal, window)
        assert _close(o, po, FWD_TOL), _err(o, po)

    # the backward on the plain forward's (o, lse), as the card's checks take it
    want = attention_bwd_ref(q, k, v, o_want, lse_want, do, causal=causal, window=window)
    grads = emulate_backward(q, k, v, o_want, lse_want, do, causal, window,
                             monkeypatch=monkeypatch)
    for name, g, w, j in zip(("dq", "dk", "dv"), grads, want, jgrads):
        assert g.shape == w.shape and _close(g, w, BWD_TOL), (name, _err(g, w))
        assert _close(g, j, BWD_TOL), (name, _err(g, j))

    # one TF32 product (big.big) keeps 11 bits: the forward's bound breaks
    o1, _ = emulate_forward(q, k, v, causal, window, products=1)
    assert not _close(o1, o_want, FWD_TOL), _err(o1, o_want)
