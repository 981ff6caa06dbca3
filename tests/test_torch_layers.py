"""The port's SiLU and SwiGLU MLP against the JAX package's, bit for bit in bf16.

``jax.nn.silu`` computes ``x * (1 / (1 + exp(-x)))`` and, in bf16, rounds
after each step; PyTorch's fused silu rounds once. The port's
``models/layers.py::silu`` takes the reference's steps, and both the dense
MLP and the mLSTM's output gate use it.

  * EXACT: ``silu`` over every bf16 value with 1e-30 <= |x| <= 80 (below,
    XLA on the CPU flushes subnormal results to zero; above, both give x or
    -0), and its gradient there under a seeded bf16 cotangent, against
    ``jax.vjp(jax.nn.silu)`` (autograd of the forward's ops differs in
    about 3% of these values).
  * EXACT: ``mlp_apply`` at bf16 on inputs whose products and sums are
    exact in bf16 (multiples of 1/16 against weights in {-1, 0, 1}, a
    permutation for w2), so that only SiLU's rounding could differ.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers

torch.set_num_threads(2)


def _bf16_range(lo: float, hi: float) -> np.ndarray:
    """Every bf16 value with lo <= |x| <= hi, as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    return x[np.isfinite(x) & (np.abs(x) >= lo) & (np.abs(x) <= hi)]


def _bits(t) -> np.ndarray:
    return np.asarray(t).astype(np.float32).view(np.uint32)


def test_silu_equals_jax_nn_silu_on_every_bf16_value():
    x = _bf16_range(1e-30, 80.0)
    assert x.size > 27_000
    want = np.asarray(jax.jit(jax.nn.silu)(jnp.asarray(x, dtype=jnp.bfloat16)))
    got = layers.silu(torch.from_numpy(x).bfloat16()).float().numpy()
    differ = np.flatnonzero(_bits(got) != _bits(want.astype(np.float32)))
    assert differ.size == 0, (f"{differ.size} of {x.size} values differ, e.g. x = "
                              f"{x[differ[:5]]}: {got[differ[:5]]} vs {want[differ[:5]]}")


def test_silu_gradient_equals_jax_on_every_bf16_value():
    x = _bf16_range(1e-30, 80.0)
    g = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    xb, gb = jnp.asarray(x, dtype=jnp.bfloat16), jnp.asarray(g, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a, b: jax.vjp(jax.nn.silu, a)[1](b)[0])(xb, gb))
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    layers.silu(xt).backward(torch.from_numpy(np.asarray(gb, dtype=np.float32)).bfloat16())
    got = xt.grad.float().numpy()
    differ = np.flatnonzero(_bits(got) != _bits(want.astype(np.float32)))
    assert differ.size == 0, (f"{differ.size} of {x.size} gradients differ, e.g. x = "
                              f"{x[differ[:5]]}: {got[differ[:5]]} vs {want[differ[:5]]}")


def test_mlp_apply_equals_jax_bit_for_bit_in_bf16():
    rng = np.random.default_rng(0)
    B, S, d, f = 4, 64, 8, 8
    # |h @ w1| <= 8 * 2 in steps of 1/16: at most 256 steps, exact in bf16,
    # as is every partial sum; w2 a permutation, so each output is one up value
    x = rng.integers(-32, 33, size=(B, S, d)).astype(np.float32) / 16
    w1 = rng.integers(-1, 2, size=(d, f)).astype(np.float32)
    w3 = rng.integers(-1, 2, size=(d, f)).astype(np.float32)
    w2 = np.eye(f, d, dtype=np.float32)[rng.permutation(f)]
    cfg = types.SimpleNamespace(dtype="bfloat16")
    want = jax.jit(lambda x, p: jlayers.mlp_apply(x, p, cfg))(
        jnp.asarray(x), {"w1": jnp.asarray(w1), "w3": jnp.asarray(w3), "w2": jnp.asarray(w2)})
    got = layers.mlp_apply(torch.from_numpy(x)[None],
                           {k: torch.from_numpy(v)[None] for k, v in
                            (("w1", w1), ("w3", w3), ("w2", w2))}, cfg)[0]
    pre = x @ w1
    assert len(np.unique(pre)) > 100, "the inputs should reach many SiLU arguments"
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
