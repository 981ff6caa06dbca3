"""K3 and K4's plain versions, and the port's ``attention`` and
``token_xent``, against the JAX package on the CPU (the kernels themselves
are held against these plain versions on the card in
``test_torch_kernels.py``).

The JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do, and its jnp functions under ``jax.jit``; inputs are
made with numpy from a seed and handed to both.

Tolerances, with their reasons:
  * fp32: atol 1e-5 (rtol 1e-5) on outputs: both sides sum the same fp32
    products in other orders (a few ulps of values of order 1). Gradients:
    atol 1e-5 of the largest magnitude, rtol 1e-4 (sums over S keys of
    products of such sums).
  * bf16: 2e-2, the JAX package's own tolerance for its flash kernel in
    bf16 (``tests/test_kernels.py:27``): both sides round q, k, v and the
    output to bf16, and cast p to bf16, at places that differ (the JAX
    model normalizes p before the product with v, the kernel after).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.local_loss import token_xent as jtoken_xent
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.fused_xent import fused_xent as jfused_xent
from repro.models import layers as jlayers
from repro_torch.core.local_loss import token_xent
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_xent as fx
from repro_torch.kernels.ref import attention_ref, fused_xent_ref
from repro_torch.models import layers

torch.set_num_threads(2)
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


def _inputs(shapes, dtype, seed=0):
    """numpy fp32 normals, rounded to ``dtype`` the same way on both sides
    (through JAX's cast), as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    _, jdt, tdt = DTYPES[dtype]
    js = [jnp.asarray(rng.normal(0, 1, s).astype(np.float32)).astype(jdt) for s in shapes]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in js]
    return js, ts


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
def test_plain_flash_attention_matches_pallas_kernel_and_ref(dtype, causal, window):
    """K4's plain forward against the Pallas kernel (interpret mode) and the
    JAX oracle at (BH, S, hd) = (2, 128, 64): one head per sequence."""
    (jq, jk, jv), (tq, tk, tv) = _inputs([(2, 128, 64)] * 3, dtype)
    want_kernel = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    got, lse = attention_ref(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                             causal=causal, window=window)
    assert got.dtype == tq.dtype and lse.shape == (2, 1, 128)
    tol = _tol(dtype)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(_np32(got[:, :, 0]), _np32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,causal,window", [
    (64, 4, 2, True, 0), (64, 4, 4, True, 0), (50, 6, 2, True, 16), (40, 4, 1, False, 0)])
def test_attention_and_grads_match_jax(dtype, S, H, KV, causal, window):
    """The port's ``attention`` (K4's plain versions through the autograd
    Function) against ``repro.models.layers.attention`` and ``jax.grad`` of
    it, grouped heads (query head h reads KV head h // G), ragged S."""
    shapes = [(3, S, H, 32), (3, S, KV, 32), (3, S, KV, 32), (3, S, H, 32)]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(shapes, dtype, seed=1)

    def f(q, k, v):
        o = jlayers.attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32)), o

    (_, jo), jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    ts = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    to = layers.attention(*ts, causal=causal, window=window)
    tg = torch.autograd.grad((to.float() * tdo.float()).sum(), ts)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np32(to), _np32(jo), atol=tol, rtol=tol)
    for got, want in zip(tg, jg):
        want = _np32(want)
        scale = float(np.abs(want).max())
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), want, atol=1e-5 * scale, rtol=1e-4)
        else:
            np.testing.assert_allclose(_np32(got), want, atol=tol * scale, rtol=tol)


@pytest.mark.parametrize("T,V,dtype", [
    pytest.param(64, 512, "float32", id="float32"),
    pytest.param(64, 512, "bfloat16", id="bfloat16"),
    pytest.param(64, 10, "float32", id="resnet-classifier-float32"),   # V = 10, one block
    pytest.param(16, 1_027, "bfloat16", id="odd-vocab-bfloat16"),      # rows off 16 bytes
])
def test_plain_fused_xent_matches_pallas_kernel_and_ref(T, V, dtype):
    """K3's plain forward against the Pallas kernel (interpret mode; its
    blocks divide T and V) and the JAX oracle; the first label at column 0,
    the last at column V - 1."""
    (jl,), (tl,) = _inputs([(T, V)], dtype, seed=2)
    labels = np.random.default_rng(3).integers(0, V, T).astype(np.int32)
    labels[0], labels[-1] = 0, V - 1
    want_kernel = jfused_xent(jl, jnp.asarray(labels), interpret=True)
    want_ref = jref.fused_xent_ref(jl, jnp.asarray(labels))
    got, lse = fused_xent_ref(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(
        jl.astype(jnp.float32), axis=-1)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_token_xent_and_grad_match_jax(dtype, masked):
    """The port's ``token_xent`` (K3's plain versions through the autograd
    Function, then the weighted mean) against ``jax.grad`` of the JAX
    function, one call per client, with and without a pad mask."""
    (jl,), (tl,) = _inputs([(3, 4, 16, 300)], dtype, seed=4)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 300, (3, 4, 16)).astype(np.int32)
    mask = np.ones((3, 4), np.float32)
    if masked:
        mask[1, 2:] = 0.0
        mask[2, :] = 0.0   # a client of padding only: loss and gradient 0
    jw = jnp.asarray(mask) if masked else None

    def one(lg, lb, w):
        return jtoken_xent(lg, lb, w)

    jloss, jgrad = jax.jit(jax.vmap(jax.value_and_grad(one), in_axes=(0, 0, 0 if masked else None)))(
        jl, jnp.asarray(labels), jw)
    tl = tl.clone().requires_grad_(True)
    tloss = token_xent(tl, torch.from_numpy(labels), torch.from_numpy(mask) if masked else None)
    (tgrad,) = torch.autograd.grad(tloss.sum(), tl)
    assert tgrad.dtype == tl.dtype
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss), atol=1e-5, rtol=1e-5)
    scale = float(np.abs(_np32(jgrad)).max())
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np32(tgrad), _np32(jgrad), atol=tol * scale, rtol=tol)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers launch nothing: the launch counts stay."""
    before = (dict(fa.LAUNCHES), dict(fx.LAUNCHES))
    q = torch.randn(2, 8, 4, 16, requires_grad=True)
    kv = torch.randn(2, 8, 2, 16, requires_grad=True)
    fa.flash_attention(q, kv, kv).sum().backward()
    logits = torch.randn(8, 10, requires_grad=True)
    fx.fused_xent(logits, torch.zeros(8, dtype=torch.int64)).sum().backward()
    assert (dict(fa.LAUNCHES), dict(fx.LAUNCHES)) == before
