"""K4's plain backward at hd 160 (pixtral-12b's heads), the function its
hand-written kernels are held to on the card (``tests/test_torch_kernels.py``)
and that every attention runs on the CPU.

``kernels/ref.py::attention_bwd_ref`` at (2, S, 8 query heads over 2, 160),
causal, with a window of 48, and across lengths (96 queries over 40 keys,
no mask), fp32, against:
  * autograd through the same attention materialized in fp64
    (``attention_ref``'s function: grouped heads, scores scaled by
    1 / sqrt(hd), masked, softmax; the product with dO summed);
  * ``jax.grad`` of the JAX package's jnp attention
    (``repro/models/layers.py::attention``, the function the JAX package
    trains pixtral-12b through) on the same numpy inputs.
Tolerance: atol = rtol = 1e-4, as ``tests/test_torch_kernels.py`` holds the
plain backward at hd 16: fp32 sums over 160 products and up to 128 keys
in another order than fp64's or XLA's, a few ulps of the largest term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

torch.set_num_threads(2)
N, H, KV, HD = 2, 8, 2, 160
# (Sq, Sk, causal, window)
CASES = {"causal": (128, 128, True, 0), "window": (128, 128, True, 48),
         "across lengths": (96, 40, False, 0)}
TOL = 1e-4


def _inputs(Sq, Sk):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((N, Sq, H, HD), (N, Sk, KV, HD), (N, Sk, KV, HD), (N, Sq, H, HD))]


def _plain_grads(q, k, v, do, causal, window):
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = attention_ref(q, k, v, causal=causal, window=window)
    return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_at_hd160_equals_fp64_autograd(case):
    Sq, Sk, causal, window = CASES[case]
    q, k, v, do = _inputs(Sq, Sk)
    qa, ka, va = (torch.from_numpy(x).double().requires_grad_(True) for x in (q, k, v))
    kr, vr = (t.repeat_interleave(H // KV, dim=2) for t in (ka, va))
    s = torch.einsum("nqhd,nkhd->nhqk", qa, kr) / HD ** 0.5
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    vis = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        vis &= qpos >= kpos
    if window:
        vis &= qpos - kpos < window
    o = torch.einsum("nhqk,nkhd->nqhd", torch.softmax(s.masked_fill(~vis, -torch.inf), -1), vr)
    want = torch.autograd.grad((o * torch.from_numpy(do).double()).sum(), (qa, ka, va))
    for name, a, b in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, do, causal, window), want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a, b, name)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_at_hd160_equals_jax_grad(case):
    Sq, Sk, causal, window = CASES[case]
    q, k, v, do = _inputs(Sq, Sk)

    def loss(q, k, v):
        o = jlayers.attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for name, a, b in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, do, causal, window), want):
        _close(a.numpy(), np.asarray(b), name)
