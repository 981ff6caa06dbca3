"""One DTFL step of the port against the JAX package's, on a cohort of two
clients, from the same bridged state and the same batch; the second client's
batch is partial (pad mask), as ``data/pipeline.py`` makes it.

The JAX side is the JAX trainer's own step (``DTFLTrainer._raw_step``) under
``jax.vmap``; the port's is its trainer's step on the explicit client axis.

Tolerances, with their reasons:
  * losses and gradients: rtol 1e-4 and atol 1e-5 times the leaf's largest
    magnitude. fp32 GEMMs and reductions summed in another order (the
    forward agrees to ~1e-6 relative, see test_torch_resnet.py) and a
    backward through GroupNorm amplify that by up to ~10x.
  * updated parameters: Adam's first step is ``lr * m_hat / (sqrt(v_hat) +
    eps)``, which is about ``lr * sign(g)``. Where |g| is large next to its
    own rounding error the update agrees to atol 1e-7 (relative rounding of
    a 1e-3 step); where a gradient element lies within rounding of zero
    (|g| <= 1e-4 of its leaf's largest magnitude, or exactly 0 on one side)
    its sign is noise, so such elements are allowed up to the full step
    difference 2 * lr.
  * int8: the uplink ``z`` is quantized with one scale per client. Inputs
    that differ by one ulp can land on either side of a rounding boundary
    and flip one quantization step; the server side is compared after that
    round trip with the same tolerances, and the two round-tripped ``z``
    may differ by one step (s = max|z| / 127 of that client) in at most
    1e-3 of their elements; elsewhere they differ by ulps of s.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.resnet_cifar import RESNET_MICRO
from repro.core import codec as jcodec
from repro.fed import cohort as jcohort
from repro.fed.adapter import DTFLStepState as JState
from repro.fed.adapter import ResNetAdapter as JAdapter
from repro.fed.dtfl import DTFLTrainer as JTrainer
from repro_torch import optim as toptim
from repro_torch.bridge import from_numpy_tree, to_numpy_tree
from repro_torch.core import codec as tcodec
from repro_torch.fed import cohort as tcohort
from repro_torch.fed.adapter import DTFLStepState as TState
from repro_torch.fed.adapter import ResNetAdapter as TAdapter
from repro_torch.fed.dtfl import DTFLTrainer as TTrainer
from repro_torch.fed.dtfl import _value_and_grad
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
CFG = RESNET_MICRO
LR = 1e-3
TIER = 1          # 0-based: client keeps md1..md2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return from_numpy_tree(_np(tree), "cpu")


def _assert_close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol * scale)


def _batch(n_clients=2, bs=8, n_real_last=5):
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (n_clients, bs, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, CFG.n_classes, (n_clients, bs)).astype(np.int32)
    mask = np.ones((n_clients, bs), np.float32)
    mask[-1, n_real_last:] = 0.0      # a partial batch, zero-padded
    images[-1, n_real_last:] = 0.0
    labels[-1, n_real_last:] = 0
    return {"images": images, "labels": labels, "mask": mask}


def _setup(codec):
    jad, tad = JAdapter(CFG), TAdapter(CFG)
    params = jax.jit(jad.init_global)(jax.random.PRNGKey(0))
    aux = jax.jit(lambda k: jad.aux_init(k, TIER))(jax.random.PRNGKey(1))
    jc, js = jad.split(params, TIER)
    tc, ts = tad.split(_port(params), TIER)
    ta = _port(aux)
    jopt, topt = joptim.adam(LR), toptim.adam(LR)
    jstate = jax.jit(lambda c, a, s: jcohort.broadcast_state(
        JState(c, a, s, jopt.init(c), jopt.init(a), jopt.init(s)), 2))(jc, aux, js)
    tstate = tcohort.broadcast_state(
        TState(tc, ta, ts, topt.init(tc), topt.init(ta), topt.init(ts)), 2)
    jstep = JTrainer._raw_step(types.SimpleNamespace(
        adapter=jad, opt=jopt, codec=jcodec.make_codec(codec)), TIER)
    tstep = TTrainer._raw_step(types.SimpleNamespace(
        adapter=tad, opt=topt, codec=tcodec.make_codec(codec)), TIER)
    return jad, tad, jstate, tstate, jstep, tstep


def _assert_adam_step_close(got, want, before, grad):
    """Updated parameters, with the near-zero-gradient allowance above."""
    got, want, before, grad = (np.asarray(a) for a in (got, want, before, grad))
    noisy = np.abs(grad) <= 1e-4 * max(float(np.abs(grad).max()), 1e-30)
    diff = np.abs(got - want)
    assert diff[~noisy].max(initial=0.0) <= 1e-7 + 1e-6 * np.abs(want[~noisy]).max(initial=0.0)
    assert diff[noisy].max(initial=0.0) <= 2 * LR * (1 + 1e-3)
    # every parameter moved by at most one Adam step on both sides
    assert np.abs(got - before).max() <= LR * (1 + 1e-3) + 1e-6


def _jax_step_refs(jad, jstep, codec, jstate, jb):
    """Everything the JAX side computes, in one jitted program (compiling
    is most of this file's time): client loss, z and gradients; the
    round-tripped z; server gradients on it; the step's results."""
    c = jcodec.make_codec(codec)

    def one(s, b):
        (cl, z), g = jax.value_and_grad(
            lambda cp, ap: jad.client_loss(cp, ap, b), argnums=(0, 1), has_aux=True,
        )(s.client, s.aux)
        zr = c.tree_rt(jax.lax.stop_gradient(z))
        sg = jax.grad(lambda sp: jad.server_loss(sp, zr, b, TIER))(s.server)
        return cl, z, g, zr, sg, jstep(s, b)

    return _np(jax.jit(jax.vmap(one))(jstate, jb))


@pytest.mark.parametrize("codec", ["identity", "int8"])
def test_dtfl_step_matches_jax(codec):
    jad, tad, jstate, tstate, jstep, tstep = _setup(codec)
    batch = _batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jcl, jz, jg, jzr, jsg, (jnew, (jcl2, jsl)) = _jax_step_refs(
        jad, jstep, codec, jstate, jax.tree.map(jnp.asarray, batch))

    # client loss, z and gradients (client half + aux head)
    tcl, tz, tg = _value_and_grad(lambda ca: tad.client_loss(ca[0], ca[1], tb),
                                  (tstate.client, tstate.aux))
    tz = tz.detach()
    _assert_close(tcl.numpy(), jcl)
    _assert_close(tz.numpy(), jz)
    jax.tree.map(_assert_close, to_numpy_tree(tg), jg)

    # the uplink round trip: at most a few one-step flips under int8
    tzr = tcodec.make_codec(codec).rt(tz).numpy()
    step = np.abs(jzr).max(axis=tuple(range(1, jzr.ndim)), keepdims=True) / 127
    diff = np.abs(tzr - jzr)
    assert (diff > 0.5 * step).mean() <= 1e-3
    assert (diff <= step * (1 + 1e-4)).all()

    # the whole step: losses, updated halves, optimizer state
    tnew, (tcl2, tsl) = tstep(tstate, tb)
    _assert_close(tcl2.numpy(), jcl2)
    _assert_close(tsl.numpy(), jsl)
    for half, grads in (("client", jg[0]), ("aux", jg[1]), ("server", jsg)):
        jax.tree.map(_assert_adam_step_close,
                     to_numpy_tree(getattr(tnew, half)), getattr(jnew, half),
                     _np(getattr(jstate, half)), grads)
    np.testing.assert_array_equal(tnew.c_opt["t"].numpy(), jnew.c_opt["t"])
    for opt in ("c_opt", "a_opt", "s_opt"):
        jax.tree.map(_assert_close, to_numpy_tree(getattr(tnew, opt)["m"]),
                     getattr(jnew, opt)["m"])


def test_masked_client_keeps_its_state():
    """A step whose mask excludes a client leaves that client's state
    exactly as it was (``torch.where`` in place of ``tree_select``)."""
    tad, topt = TAdapter(CFG), toptim.adam(LR)
    gen = torch.Generator().manual_seed(0)
    tc, ts = tad.split(tad.init_global(gen), TIER)
    ta = tad.aux_init(gen, TIER)
    one = TState(tc, ta, ts, topt.init(tc), topt.init(ta), topt.init(ts))
    tstep = TTrainer._raw_step(types.SimpleNamespace(
        adapter=tad, opt=topt, codec=tcodec.make_codec("int8")), TIER)
    batches = {k: torch.from_numpy(v)[None] for k, v in _batch().items()}
    final, _ = tcohort.run_cohort(tstep, one, batches, np.array([[True, False]]))
    for a, b in zip(tree_leaves(final.client), tree_leaves(tc)):
        assert torch.equal(a[1], b)
        assert not torch.equal(a[0], b)
    assert final.c_opt["t"].tolist() == [1, 0]
